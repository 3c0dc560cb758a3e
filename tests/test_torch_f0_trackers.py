"""The port's pYIN, DIO + StoneMask and Harvest trackers (numpy copies) and
``get_f0_features(method=)`` against the JAX package's: bit-equal tracks
(``np.array_equal``) on constant tones, vibrato, silence, a tone in silence
and noise; the Praat method within the voicing/cents tolerance of
tests/test_torch_f0.py; ``get_log_f0`` and ``interpolate_unvoiced`` equal;
unknown methods raise in both."""

import numpy as np
import pytest
import torch

from svc_inference_pipeline_tpu.ops import f0 as jf0
from svc_inference_pipeline_tpu.ops import f0_dio as jdio
from svc_inference_pipeline_tpu_torch.ops import f0
from svc_inference_pipeline_tpu_torch.ops import f0_dio

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
    fs, hop_length, win_length, f0_min, f0_max = FS, HOP, 1024, 65, 800
    pitch_bin, pitch_min, pitch_max = 256, 50.0, 1100.0


def _signal(kind: str, dur: float = 0.6) -> np.ndarray:
    t = np.arange(int(dur * FS)) / FS
    rng = np.random.default_rng(0)
    if kind == "silence":
        return np.zeros(len(t), np.float32)
    if kind == "noise":
        return (0.3 * rng.standard_normal(len(t))).astype(np.float32)
    f0_hz = {"tone_110": 110.0, "tone_440": 440.0}.get(kind, 220.0)
    depth = 0.5 / 12 if kind == "vibrato" else 0.0  # +-1/2 semitone at 5.5 Hz
    inst = f0_hz * 2 ** (depth * np.sin(2 * np.pi * 5.5 * t))
    phase = 2 * np.pi * np.cumsum(inst) / FS
    x = sum((0.6 / k) * np.sin(k * phase) for k in range(1, 7))
    if kind == "tone_in_silence":
        x = np.where((t > 0.15) & (t < 0.45), x, 0.0)
    return x.astype(np.float32)


SIGNALS = ["tone_110", "tone_440", "vibrato", "silence", "tone_in_silence", "noise"]


def _tracks(mod, x, which):
    if which == "pyin":
        return (mod.get_f0_features_using_pyin(x, FS, 1024, HOP, 65.0, 800.0),)
    if which == "harvest":
        return (mod.get_f0_features_using_harvest(x, 10**9, FS, HOP, 65.0, 800.0),)
    dio_mod = jdio if mod is jf0 else f0_dio
    coarse, t = dio_mod.dio(x.astype(np.float64), FS, f0_floor=65.0, f0_ceil=800.0, channels_in_octave=2.0,
                            frame_period=1000.0 * HOP / FS)
    return coarse, t, mod.get_f0_features_using_dio(x, 10**9, FS, HOP, 65.0, 800.0)


@pytest.mark.parametrize("which", ["pyin", "dio", "harvest"])
@pytest.mark.parametrize("kind", SIGNALS)
def test_tracker_bit_equal_to_jax(which, kind):
    x = _signal(kind)
    ours, theirs = _tracks(f0, x, which), _tracks(jf0, x, which)
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    track = ours[-1]
    if kind in ("tone_110", "tone_440"):  # the trackers work, not only agree
        assert (track > 0).mean() > 0.8


def _agreement(ours, ref):
    voicing = np.mean((ours > 0) == (ref > 0))
    both = (ours > 0) & (ref > 0)
    cents = 1200 * np.abs(np.log2(ours[both] / ref[both]))
    return voicing, np.mean(cents <= 5.0) if both.any() else 1.0


@pytest.mark.parametrize("method", ["dio", "pyin", "harvest", "parselmouth", "ac"])
@pytest.mark.parametrize("kind", ["vibrato", "tone_in_silence"])
def test_get_f0_features_method_matches_jax(method, kind):
    """dio/pyin/harvest bit-equal with equal coarse pitch; Praat within
    tests/test_torch_f0.py's tolerance: voicing agrees on >= 99% of frames
    and the F0 of frames both call voiced within 5 cents on >= 99%."""
    x = _signal(kind, dur=0.8)
    mel_len = 1 + (len(x) + 768 - 1024) // HOP
    ref, ref_coarse = jf0.get_f0_features(x, mel_len, _Cfg, method=method)
    ours, coarse = f0.get_f0_features(x, mel_len, _Cfg, method=method)
    assert ours.shape == np.shape(ref) == (mel_len,)
    if method in ("parselmouth", "ac"):
        voicing, cents_ok = _agreement(ours, np.asarray(ref))
        assert voicing >= 0.99 and cents_ok >= 0.99, (voicing, cents_ok)
        assert np.mean(coarse == ref_coarse) >= 0.99
    else:
        assert ours.dtype == ref.dtype and np.array_equal(ours, ref)
        np.testing.assert_array_equal(coarse, ref_coarse)
    assert (ours > 0).mean() > 0.3


@pytest.mark.parametrize("method", ["crepe", "bogus"])
def test_unknown_method_raises_in_both(method):
    x = _signal("vibrato")
    for mod in (f0, jf0):
        with pytest.raises(NotImplementedError, match="get_f0_features_using_crepe"):
            mod.get_f0_features(x, 50, _Cfg, method=method)


@pytest.mark.parametrize("kind", ["tone_in_silence", "silence", "edges"])
def test_log_f0_and_interpolate_unvoiced_equal_jax(kind):
    track = f0.get_f0_features_using_dio(_signal("tone_in_silence"), 10**9, FS, HOP, 65.0, 800.0)
    if kind == "silence":
        track = np.zeros_like(track)
    elif kind == "edges":
        track = np.array([0.0, 0.0, 200.0, 0.0, 210.0, 0.0, 0.0])
    np.testing.assert_array_equal(f0.get_log_f0(track), jf0.get_log_f0(track))
    for a, b in zip(f0.interpolate_unvoiced(track), jf0.interpolate_unvoiced(track)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_parselmouth_alias_equals_default():
    x = _signal("vibrato")
    mel_len = 1 + (len(x) + 768 - 1024) // HOP
    a = f0.get_f0_features_using_parselmouth(x, mel_len, _Cfg)
    b = f0.get_f0_features(x, mel_len, _Cfg)
    for u, v in zip(a, b):
        np.testing.assert_array_equal(u, v)
