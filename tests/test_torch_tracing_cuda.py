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
