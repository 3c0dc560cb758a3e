"""K9 (``csrc/f0.cu``, ``ops/f0.py::praat_f0_device``) on the card: against
its plain PyTorch version and the host route's numpy tracker on sung
phrases of 2-16 s, a batch against each clip alone, the refusals, and the
pipeline's device route (its counter, timings and melody), also for a
PCM16 upload.

Every test here needs an NVIDIA GPU and skips without one. This file
imports neither JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_f0_cuda.py
"""

import os
import time

import numpy as np
import pytest
import torch

from portbench.traffic import synth_phrase
from svc_inference_pipeline_tpu_torch.config import HParams, load_config
from svc_inference_pipeline_tpu_torch.ops import f0
from svc_inference_pipeline_tpu_torch.pipeline.convert import SVCPipeline, mel_frame_count
from svc_inference_pipeline_tpu_torch.utils import observability as obs
from svc_inference_pipeline_tpu_torch.utils.artifacts import pitch_shift

pytestmark = pytest.mark.cuda
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SECONDS = (2.0, 5.7, 10.0, 16.0)
SINGER = "svcc_CDF1"
VOICING, CENTS_SHARE, CENTS = 0.995, 0.99, 5.0  # the bar of the host tracker against JAX's, voicing raised


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card with pytest -m cuda")
    return torch.device("cuda")


def _cfg(top=None, vocoder_channels=None, **mapper):
    d = load_config(os.path.join(REPO, "config", "config.json")).to_dict()
    for k in ("singer_file", "min_mel_file", "max_mel_file", "target_f0_file"):
        d[k] = os.path.join(REPO, d[k].lstrip("./"))
    d.update(top or {})
    d["mapper"].update(mapper)
    if vocoder_channels:
        d["vocoder"]["upsample_initial_channel"] = vocoder_channels
    return HParams(**d)


def _phrase(seconds, seed=1414213562):
    return synth_phrase(seconds, 24000, np.random.default_rng(seed)).astype(np.float32) / 32768.0


def _check_agreement(ours, ref):
    """Voicing agrees on VOICING of the frames, and CENTS_SHARE of the frames
    both call voiced lie within CENTS."""
    voicing = float(np.mean((ours > 0) == (ref > 0)))
    both = (ours > 0) & (ref > 0)
    cents = 1200 * np.abs(np.log2(ours[both] / ref[both]))
    share = float(np.mean(cents <= CENTS)) if both.any() else 1.0
    assert voicing >= VOICING and share >= CENTS_SHARE, (voicing, share)


@pytest.mark.parametrize("seconds", SECONDS)
def test_k9_against_its_plain_version_and_the_host_tracker(dev, seconds):
    cfg = _cfg()
    x = _phrase(seconds)
    n, m = len(x), mel_frame_count(cfg, len(x))
    padded = -(-m // 64) * 64
    got = f0.praat_f0_device(torch.as_tensor(x, device=dev)[None], [n], [m], padded, cfg)
    torch.cuda.synchronize()
    got = got.cpu().numpy()[0]
    plain = f0.praat_f0_device(torch.as_tensor(x)[None], [n], [m], padded, cfg).numpy()[0]
    host, _ = f0.get_f0_features(x, m, cfg)
    assert not got[m:].any()
    _check_agreement(got[:m], plain[:m])
    _check_agreement(got[:m], pitch_shift(host, cfg))


def test_k9_batch_of_four_equals_each_clip_alone(dev):
    cfg = _cfg()
    clips = [_phrase(s, seed=7 + i) for i, s in enumerate(SECONDS)]
    n = [len(c) for c in clips]
    m = [mel_frame_count(cfg, k) for k in n]
    padded = -(-max(m) // 64) * 64
    block = torch.zeros(len(clips), max(n))
    for i, c in enumerate(clips):
        block[i, : len(c)] = torch.as_tensor(c)
    batch = f0.praat_f0_device(block.to(dev), n, m, padded, cfg).cpu()
    for i, c in enumerate(clips):
        alone = f0.praat_f0_device(torch.as_tensor(c, device=dev)[None], [n[i]], [m[i]], padded, cfg).cpu()
        assert torch.equal(batch[i], alone[0]), i


def test_k9_refuses_what_it_does_not_take(dev):
    cfg = _cfg()
    x = torch.as_tensor(_phrase(2.0), device=dev)
    n, m = x.numel(), mel_frame_count(cfg, x.numel())
    with pytest.raises(ValueError, match="float32"):
        f0.praat_f0_device(x.double()[None], [n], [m], m, cfg)
    with pytest.raises(ValueError, match="contiguous"):
        f0.praat_f0_device(torch.stack([x, x], 1).t()[:1], [n], [m], m, cfg)
    # a 10 Hz floor: a 7200-sample window and 3600 lags, more than a frame block evaluates; the launch is refused
    low = _cfg(top={"f0_min": 10})
    with pytest.raises(RuntimeError, match="svc_praat_f0: CUDA error"):
        f0.praat_f0_device(x[None], [n], [m], m, low)


def test_extract_features_batch_on_the_card_takes_the_device_route(dev):
    # K2 takes multiples of 8 channels: 8 at the last stage of a 512-channel vocoder
    cfg = _cfg(vocoder_channels=512, noise_schedule_factors=[0.0001, 0.02, 4], residual_layer_num=2,
               residual_channels=128, sampler="ddpm")
    pipe = SVCPipeline.from_config(cfg, random_weights=True, device="cuda")
    clips = [_phrase(2.0, seed=3), _phrase(3.3, seed=4)]
    pipe.convert_batch(clips, [SINGER, SINGER], generator=torch.Generator(device=dev).manual_seed(0))  # first calls
    counters = obs.Metrics.default().counters
    before = (counters["frontend/f0_clips_device"], counters["frontend/f0_clips_host"])
    t0 = time.perf_counter_ns()
    pipe.convert_batch(clips, [SINGER, SINGER], generator=torch.Generator(device=dev).manual_seed(1))
    assert (counters["frontend/f0_clips_device"] - before[0], counters["frontend/f0_clips_host"] - before[1]) == (2, 0)
    assert pipe.timings["f0_wait_s"] == 0.0 and pipe.timings["f0_s"] > 0
    (span,) = obs.spans(t0, name="frontend.f0")
    (call,) = obs.spans(t0, name="pipeline.call")
    assert span.attrs["route"] == "device" and span.thread == call.thread
    batch, frames = pipe.extract_features_batch(clips, [SINGER, SINGER])
    for i, (c, k) in enumerate(zip(clips, frames)):
        host, _ = f0.get_f0_features(c, k, pipe.cfg)
        _check_agreement(batch["melody"][i, :k].cpu().numpy(), pitch_shift(host, pipe.cfg))


def test_a_pcm16_upload_on_the_card_takes_the_device_route(dev):
    cfg = _cfg(vocoder_channels=512, noise_schedule_factors=[0.0001, 0.02, 4], residual_layer_num=2,
               residual_channels=128, sampler="ddpm")
    pipe = SVCPipeline.from_config(cfg, random_weights=True, device="cuda")
    clip = _phrase(5.7, seed=5)
    counters = obs.Metrics.default().counters
    before = (counters["frontend/f0_clips_device"], counters["frontend/f0_clips_host"])
    wave = pipe.convert(clip, SINGER, generator=torch.Generator(device=dev).manual_seed(0), upload_pcm16=True)
    assert np.isfinite(wave).all()
    assert (counters["frontend/f0_clips_device"] - before[0], counters["frontend/f0_clips_host"] - before[1]) == (1, 0)
    assert pipe.timings["f0_wait_s"] == 0.0 and pipe.timings["f0_s"] > 0
    batch, k = pipe.extract_features(clip, SINGER, upload_pcm16=True)
    host, _ = f0.get_f0_features(clip, k, pipe.cfg)
    _check_agreement(batch["melody"][0, :k].cpu().numpy(), pitch_shift(host, pipe.cfg))
