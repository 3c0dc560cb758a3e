"""The port's spans on the device trace's clock, on the card: a host sleep
between two kernels is put down to the span around it, and the CLI's
``--profile`` of a warm 10 s conversion at full width puts the device's
idle time under named spans.

Every test here needs an NVIDIA GPU and skips without one. This file
imports neither JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider -m cuda -s tests/test_torch_tracing_cuda.py
"""

import glob
import json
import os
import time

import pytest
import torch

from svc_inference_pipeline_tpu_torch import cli
from svc_inference_pipeline_tpu_torch.measure import synth_clip
from svc_inference_pipeline_tpu_torch.utils import observability as obs
from svc_inference_pipeline_tpu_torch.utils.audio_io import write_wav

pytestmark = pytest.mark.cuda
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COVERED = 0.9  # share of the idle time that has to fall under named spans


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card with pytest -m cuda")
    return torch.device("cuda")


def test_host_sleep_between_kernels_goes_to_its_span(dev):
    from torch.profiler import ProfilerActivity, profile

    x = torch.randn(1024, 1024, device=dev)
    (x @ x).sum().item()  # cuBLAS's set-up before the profile
    sleep_s = 0.03
    t0 = time.perf_counter_ns()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        y = x @ x
        with obs.trace("test.host_sleep"):
            time.sleep(sleep_s)
        y = y @ x
        torch.cuda.synchronize()
    got = obs.idle_by_span(prof, obs.spans(t0))
    print(json.dumps(got))
    assert got["by_span"].get("test.host_sleep", 0.0) >= COVERED * sleep_s, got


def test_cli_profile_puts_the_idle_time_under_spans(dev, tmp_path):
    """One warm offline 10 s conversion at the config's width (Whisper
    medium, DDPM-1000) under the CLI's ``--profile``."""
    wav = str(tmp_path / "in.wav")
    write_wav(wav, synth_clip(24000, 10.0), 24000)
    args = ["--config", os.path.join(REPO, "config", "config.json"), "--input", wav, "--singer", "svcc_CDF1",
            "--output", str(tmp_path / "out.wav"), "--random-weights", "--whisper-size", "medium",
            "--device", "cuda"]
    assert cli.main(args) == 0  # the kernels' build and every shape's first call
    assert cli.main(args + ["--profile", str(tmp_path / "prof")]) == 0
    (path,) = glob.glob(str(tmp_path / "prof" / "idle_*.json"))
    with open(path) as f:
        idle = json.load(f)
    print(json.dumps(idle))
    assert idle["idle_s"] > 0 and idle["covered_share"] >= COVERED, idle


@pytest.mark.parametrize("seconds", [1.0, 4.0])
@pytest.mark.parametrize("quantize", [None, "int8-w1"])
@pytest.mark.parametrize("c,layers,fc,tile", [(512, 40, 512, "PfShape<8>"), (384, 20, 128, "PfShape<6>")])
def test_sampling_span_counts_the_k1_launches_of_a_conversion(dev, c, layers, fc, tile, quantize, seconds):
    """A 1 s and a 4 s conversion (2 and 6 row tiles) over 4 DDPM steps on
    K1, with the denoiser at Amphion's BiDilConv widths (512 x 40) and at the
    reference's (384 x 20), on a bf16 and an int8-w1 stack: its ``sampling``
    span names the widths and counts 4 (L + 3) launches on the bf16 stack
    (one fused launch a layer), 4 (2L + 3) on the int8 one;
    ``denoiser/launches`` grows by as many and ``denoiser/fused_layers`` by
    4 L on the bf16 stack, 0 on the int8 one. As the C entry points report
    their launches, every bf16 ``step_pf_kernel`` is on the tile it picks for the
    width (``PfShape<8>``, the wide one, at 512; ``PfShape<6>`` at 384): 4 x
    3 of them beside 4 L of the fused layer; the int8 stack's launches are
    neither (its ring and s8 tiles)."""
    from svc_inference_pipeline_tpu_torch.config import HParams, load_config
    from svc_inference_pipeline_tpu_torch.ops.pallas import denoiser_step
    from svc_inference_pipeline_tpu_torch.pipeline.convert import SVCPipeline

    d = load_config(os.path.join(REPO, "config", "config.json")).to_dict()
    for k in ("singer_file", "min_mel_file", "max_mel_file", "target_f0_file"):
        d[k] = os.path.join(REPO, d[k].lstrip("./"))
    d["mapper"].update(noise_schedule_factors=[0.0001, 0.02, 4], residual_layer_num=layers, residual_channels=c,
                       diffusion_fc_size=fc, sampler="ddpm")
    d["vocoder"]["upsample_initial_channel"] = 512  # K2 takes multiples of 8 channels: 8 at the last stage
    pipe = SVCPipeline.from_config(HParams(**d), random_weights=True, device="cuda")
    if quantize:
        pipe.set_quantize(quantize)
    counters = obs.Metrics.default().counters
    clip = synth_clip(24000, seconds)
    pipe.convert(clip, "svcc_CDF1", generator=torch.Generator(device=dev).manual_seed(0))  # build, first calls
    before = (counters["denoiser/launches"], counters["denoiser/fused_layers"])
    t0 = time.perf_counter_ns()
    _, tiles = denoiser_step.launched_tiles(
        lambda: pipe.convert(clip, "svcc_CDF1", generator=torch.Generator(device=dev).manual_seed(1)))
    (sampling,) = obs.spans(t0, name="sampling")
    n = 4 * ((2 if quantize else 1) * layers + 3)
    assert sampling.attrs == {"channels": c, "layers": layers, "launches": n}
    assert counters["denoiser/launches"] - before[0] == n
    assert counters["denoiser/fused_layers"] - before[1] == (0 if quantize else 4 * layers)
    assert tiles == ({} if quantize else {tile: 4 * 3, "layer": 4 * layers})
