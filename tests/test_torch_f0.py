"""PyTorch port's host F0 tracker (numpy) vs the JAX Praat-AC tracker on
synthetic tones: voicing agrees on >= 99% of frames, and the F0 of frames
both call voiced agrees within 5 cents on >= 99% of them."""

import numpy as np
import pytest
import torch

from svc_inference_pipeline_tpu.ops import f0 as jf0
from svc_inference_pipeline_tpu_torch.ops import f0

FS, HOP = 24000, 256


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this module runs: the suite runs in several
    worker processes at once, and PyTorch's thread pools, each as wide as the
    machine, slow one another down many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class _Cfg:
    fs, hop_length, f0_min, f0_max = FS, HOP, 65, 800
    pitch_bin, pitch_min, pitch_max = 256, 50.0, 1100.0


def _tone(f0_hz, dur=1.0, vibrato=0.0, gap=None, noise=0.0, seed=0):
    t = np.arange(int(dur * FS)) / FS
    inst = f0_hz * 2 ** (vibrato / 12 * np.sin(2 * np.pi * 5.5 * t))
    phase = 2 * np.pi * np.cumsum(inst) / FS
    x = sum((0.6 / k) * np.sin(k * phase) for k in range(1, 7))
    if gap is not None:
        x[(t > gap[0]) & (t < gap[1])] = 0.0
    x = x + noise * np.random.default_rng(seed).standard_normal(len(t))
    return x.astype(np.float32)


def _agreement(ours, ref):
    voicing = np.mean((ours > 0) == (ref > 0))
    both = (ours > 0) & (ref > 0)
    cents = 1200 * np.abs(np.log2(ours[both] / ref[both]))
    return voicing, np.mean(cents <= 5.0) if both.any() else 1.0


@pytest.mark.parametrize("signal", [
    dict(f0_hz=110.0), dict(f0_hz=220.0, vibrato=0.5), dict(f0_hz=440.0, noise=0.01),
    dict(f0_hz=330.0, dur=1.5, vibrato=1.0, gap=(0.6, 0.9), noise=1e-3),
])
def test_praat_ac_matches_jax_tracker(signal):
    x = _tone(**signal)
    ref = np.asarray(jf0.praat_pitch_ac(x, FS, HOP, 65.0, 800.0, voicing_threshold=0.6))
    ours = f0.praat_pitch_ac(x, FS, HOP, 65.0, 800.0, voicing_threshold=0.6)
    assert ours.shape == ref.shape
    voicing, cents_ok = _agreement(ours, ref)
    assert voicing >= 0.99 and cents_ok >= 0.99, (voicing, cents_ok)


def test_get_f0_features_matches_jax():
    x = _tone(250.0, dur=1.2, vibrato=0.7, gap=(0.5, 0.7))
    mel_len = 1 + (len(x) + 768 - 1024) // HOP
    ref, ref_coarse = jf0.get_f0_features(x, mel_len, _Cfg)
    ours, coarse = f0.get_f0_features(x, mel_len, _Cfg)
    assert ours.shape == ref.shape == (mel_len,)
    voicing, cents_ok = _agreement(ours, np.asarray(ref))
    assert voicing >= 0.99 and cents_ok >= 0.99
    assert np.mean(coarse == ref_coarse) >= 0.99
    np.testing.assert_array_equal(f0.f0_to_coarse(np.asarray(ref), 256, 50.0, 1100.0), ref_coarse)


def test_too_short_clip_is_refused():
    with pytest.raises(ValueError, match="too short"):
        f0.get_f0_features(np.zeros(10, np.float32), 0, _Cfg)
