"""K9's plain PyTorch version (``ops/f0.py::praat_f0_device`` on CPU
tensors): Praat's tracker with the median shift onto the mel grid, against
the JAX tracker and against the host route (numpy ``get_f0_features`` and
``pitch_shift``), batched against alone, the shift's arithmetic, and the
pipeline's route on the CPU. The kernel itself is checked on the card in
``tests/test_torch_f0_cuda.py``."""

import time

import numpy as np
import pytest
import torch

from portbench.traffic import synth_phrase
from svc_inference_pipeline_tpu.ops import f0 as jf0
from svc_inference_pipeline_tpu_torch.config import HParams, load_config
from svc_inference_pipeline_tpu_torch.ops import f0
from svc_inference_pipeline_tpu_torch.pipeline.convert import SVCPipeline, mel_frame_count
from svc_inference_pipeline_tpu_torch.utils import observability as obs
from svc_inference_pipeline_tpu_torch.utils.artifacts import get_target_f0_median, pitch_shift

from test_torch_f0 import _agreement, _tone

FS, HOP = 24000, 256
CONFIG = "config/config.json"
SINGER = "svcc_CDF1"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this module runs: the suite runs in several
    worker processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def cfg(repo_root):
    d = load_config(f"{repo_root}/{CONFIG}").to_dict()
    for k in ("singer_file", "min_mel_file", "max_mel_file", "target_f0_file"):
        d[k] = f"{repo_root}/{d[k].lstrip('./')}"
    return HParams(**d)


SIGNALS = {
    "110": lambda: _tone(110.0),
    "220_vibrato": lambda: _tone(220.0, vibrato=0.5),
    "440_noise": lambda: _tone(440.0, noise=0.01),
    "330_gap": lambda: _tone(330.0, dur=1.5, vibrato=1.0, gap=(0.6, 0.9), noise=1e-3),
    "phrase": lambda: synth_phrase(2.5, FS, np.random.default_rng(2718281828)).astype(np.float32) / 32768.0,
}


def _device_route(x, cfg, pitch_factor=None, extra=0):
    n = len(x)
    m = mel_frame_count(cfg, n)
    out = f0.praat_f0_device(torch.as_tensor(x)[None], [n], [m], m + extra, cfg, pitch_factor)
    assert out.shape == (1, m + extra) and out.dtype == torch.float32
    return out[0].numpy(), m


def _shift_agreement(ours, ref):
    """Share of frames with the same voicing and, where voiced, within 5 cents."""
    same = (ours > 0) == (ref > 0)
    both = (ours > 0) & (ref > 0)
    cents = np.zeros_like(ours, dtype=np.float64)
    cents[both] = 1200 * np.abs(np.log2(ours[both] / ref[both]))
    return float(np.mean(same & (cents <= 5.0)))


@pytest.mark.parametrize("signal", list(SIGNALS))
def test_plain_matches_jax_tracker(cfg, signal):
    x = SIGNALS[signal]()
    ours, m = _device_route(x, cfg, pitch_factor=1.0)
    ref, _ = jf0.get_f0_features(x, m, cfg)
    voicing, cents_ok = _agreement(ours, np.asarray(ref))
    assert voicing >= 0.99 and cents_ok >= 0.99, (voicing, cents_ok)


@pytest.mark.parametrize("signal", list(SIGNALS))
def test_plain_matches_the_host_route_after_the_shift(cfg, signal):
    x = SIGNALS[signal]()
    ours, m = _device_route(x, cfg, extra=7)
    host, _ = f0.get_f0_features(x, m, cfg)
    assert _shift_agreement(ours[:m], pitch_shift(host, cfg)) >= 0.995
    assert not ours[m:].any()


@pytest.mark.parametrize("signal", list(SIGNALS))
def test_the_pcm16_upload_keeps_the_host_routes_melody(cfg, signal):
    """K9 on a PCM16 upload reads the int16 signal scaled by 1/32768 (as the
    device front-end does); the host route reads the float signal."""
    x = SIGNALS[signal]()
    pcm = torch.as_tensor(np.clip(np.round(x * 32768.0), -32768, 32767).astype(np.int16))
    ours, m = _device_route((pcm.float() * (1.0 / 32768.0)).numpy(), cfg)
    host, _ = f0.get_f0_features(x, m, cfg)
    assert _shift_agreement(ours, pitch_shift(host, cfg)) >= 0.995


def test_a_batch_of_three_equals_each_clip_alone(cfg):
    clips = [_tone(180.0, dur=0.7), SIGNALS["phrase"](), _tone(300.0, dur=1.3, vibrato=0.8)]
    n = [len(c) for c in clips]
    m = [mel_frame_count(cfg, k) for k in n]
    padded = -(-max(m) // 64) * 64
    block = torch.zeros(3, max(n))
    for i, c in enumerate(clips):
        block[i, : len(c)] = torch.as_tensor(c)
    batch = f0.praat_f0_device(block, n, m, padded, cfg)
    for i, c in enumerate(clips):
        alone = f0.praat_f0_device(torch.as_tensor(c)[None], [n[i]], [m[i]], padded, cfg)[0]
        assert torch.equal(batch[i], alone), i
        assert not batch[i, m[i]:].any()


@pytest.mark.parametrize("case", ["even", "odd", "unvoiced", "pitch_factor"])
def test_the_shift_repeats_pitch_shift(cfg, case):
    """numpy's median (even count: the two middle values' mean in float32),
    the factor rounded to float32, no shift without a voiced frame."""
    target = get_target_f0_median(cfg.target_f0_file)
    track = {
        "even": [0.0, 101.3, 0.0, 257.77, 199.9, 0.0, 310.01, 199.91, 88.8],
        "odd": [0.0, 101.3, 257.77, 199.9, 0.0, 310.01, 123.4],
        "unvoiced": [0.0] * 9,
        "pitch_factor": [0.0, 101.3, 257.77, 199.9],
    }[case]
    x = np.asarray(track, np.float32)
    if case == "pitch_factor":
        want = x * 1.37
        got = f0.shift_plain(torch.as_tensor(x), None, 1.37)
    else:
        want = pitch_shift(x, cfg)
        got = f0.shift_plain(torch.as_tensor(x), target, None)
    np.testing.assert_array_equal(got.numpy(), want)


def test_an_unvoiced_clip_and_a_pitch_factor(cfg):
    silent, m = _device_route(np.zeros(FS, np.float32), cfg)
    assert not silent.any() and len(silent) == m
    x = _tone(250.0, dur=1.0, vibrato=0.5)
    unshifted, _ = _device_route(x, cfg, pitch_factor=1.0)
    fixed, _ = _device_route(x, cfg, pitch_factor=1.37)
    np.testing.assert_array_equal(fixed, unshifted * np.float32(1.37))


def test_too_short_clip_is_refused(cfg):
    with pytest.raises(ValueError, match="too short"):
        f0.praat_f0_device(torch.zeros(1, 10), [10], [0], 64, cfg)
    with pytest.raises(ValueError, match="too short"):
        f0.get_f0_features(np.zeros(10, np.float32), 0, cfg)


@pytest.fixture(scope="module")
def tiny_pipe(cfg):
    d = cfg.to_dict()
    d["mapper"].update(noise_schedule_factors=[0.0001, 0.02, 4], residual_layer_num=2, residual_channels=64)
    d["vocoder"]["upsample_initial_channel"] = 64
    return SVCPipeline.from_config(HParams(**d), random_weights=True, device="cpu")


@pytest.mark.parametrize("batched", [False, True])
def test_extract_features_on_the_cpu_takes_the_host_route(tiny_pipe, batched):
    counters = obs.Metrics.default().counters
    before = {k: counters[f"frontend/f0_clips_{k}"] for k in ("host", "device")}
    clips = [_tone(220.0, dur=1.0, vibrato=0.5), _tone(330.0, dur=0.8)]
    t0 = time.perf_counter_ns()
    if batched:
        batch, frames = tiny_pipe.extract_features_batch(clips, [SINGER, SINGER])
    else:
        clips = clips[:1]
        batch, n = tiny_pipe.extract_features(clips[0], SINGER)
        frames = [n]
    assert counters["frontend/f0_clips_host"] - before["host"] == len(clips)
    assert counters["frontend/f0_clips_device"] == before["device"]
    spans = obs.spans(t0, name="frontend.f0")
    assert len(spans) == len(clips) and all(s.attrs["route"] == "host" for s in spans)
    assert tiny_pipe.timings["f0_s"] > 0 and "f0_wait_s" in tiny_pipe.timings
    for i, (c, n) in enumerate(zip(clips, frames)):
        host, _ = f0.get_f0_features(c, n, tiny_pipe.cfg)
        np.testing.assert_array_equal(batch["melody"][i, :n].numpy(), pitch_shift(host, tiny_pipe.cfg))
