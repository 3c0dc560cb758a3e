"""PyTorch port skeleton: it never imports JAX, its config / registry /
artifact / WAV copies agree with the JAX package, the weights bridge and
random init, and the CLI on CPU."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from svc_inference_pipeline_tpu.config import load_config as jax_load_config
from svc_inference_pipeline_tpu.utils import artifacts as jart
from svc_inference_pipeline_tpu.utils import audio_io as jaudio
from svc_inference_pipeline_tpu.utils.registry import get_singer_id as jax_singer_id
from svc_inference_pipeline_tpu_torch.checkpoints.from_jax import load_jax_params, random_init_
from svc_inference_pipeline_tpu_torch.config import load_config
from svc_inference_pipeline_tpu_torch.pipeline.convert import mel_frame_count, pad_to_bucket, resolve_device
from svc_inference_pipeline_tpu_torch.utils import artifacts, audio_io
from svc_inference_pipeline_tpu_torch.utils.registry import get_singer_id

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "config", "config.json")

# every module of the port, then one tiny conversion on CPU, in a fresh
# interpreter that must end without jax loaded
_NO_JAX = """
import importlib, pkgutil, sys
import numpy as np, torch
import svc_inference_pipeline_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
from svc_inference_pipeline_tpu_torch.config import HParams, load_config
from svc_inference_pipeline_tpu_torch.pipeline.convert import SVCPipeline
d = load_config(sys.argv[1]).to_dict()
for k in ("singer_file", "min_mel_file", "max_mel_file", "target_f0_file"):
    d[k] = sys.argv[2] + d[k].lstrip(".")
d["mapper"].update(noise_schedule_factors=[0.0001, 0.02, 3], residual_layer_num=2, residual_channels=64)
d["vocoder"]["upsample_initial_channel"] = 64
pipe = SVCPipeline.from_config(HParams(**d), random_weights=True, device="cpu")
wave = pipe.convert(np.sin(np.arange(12000) / 10).astype(np.float32), "svcc_CDF1",
                    generator=torch.Generator().manual_seed(0))
assert wave.shape == (46 * 256,) and np.isfinite(wave).all(), wave.shape
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "svc_inference_pipeline_tpu.")))
assert not bad, bad
print("NO_JAX_OK")
"""


def test_port_never_imports_jax():
    out = subprocess.run([sys.executable, "-c", _NO_JAX, CONFIG, REPO], capture_output=True, text=True,
                         timeout=300, cwd=REPO)
    assert out.returncode == 0 and "NO_JAX_OK" in out.stdout, out.stderr[-3000:]


def test_config_matches_jax_loader_without_json5(monkeypatch):
    """The port reads config.json like the JAX package, also where json5 is
    not installed (comments and trailing commas stripped)."""
    monkeypatch.setitem(sys.modules, "json5", None)
    assert load_config(CONFIG).to_dict() == jax_load_config(CONFIG).to_dict()


@pytest.mark.parametrize("name,want", [("tpu", "cuda"), ("cuda", "cuda"), ("gpu", "cuda"), ("cpu", "cpu")])
def test_resolve_device(name, want):
    assert resolve_device(name).type == want


def test_frame_math(cfg):
    assert pad_to_bucket(1) == 64 and pad_to_bucket(64) == 64 and pad_to_bucket(65) == 128
    assert mel_frame_count(cfg, 96000) == 375  # 4 s at 24 kHz -> padded to 384


def test_registry_and_artifacts_match_jax(cfg):
    for name in ("svcc_CDF1", "svcc_IDM1"):
        assert get_singer_id(cfg, name).tolist() == jax_singer_id(cfg, name).tolist()
    with pytest.raises(KeyError):
        get_singer_id(cfg, "nobody")
    lo, hi = artifacts.load_mel_min_max(cfg.min_mel_file, cfg.max_mel_file)
    jlo, jhi = jart.load_mel_min_max(cfg.min_mel_file, cfg.max_mel_file)
    np.testing.assert_array_equal(lo, jlo)
    np.testing.assert_array_equal(hi, jhi)
    f0 = np.array([0.0, 100.0, 120.0, 0.0, 150.0], np.float32)
    np.testing.assert_array_equal(artifacts.pitch_shift(f0, cfg), jart.pitch_shift(f0, cfg))


@pytest.mark.parametrize("dtype", ["int16", "float32"])
def test_wav_load_and_save_match_jax(tmp_path, dtype):
    """RIFF read + reference normalisation + resample to 24 kHz, and the
    writer's peak-normalise/silence/PCM16 contract."""
    rng = np.random.default_rng(0)
    x = 0.5 * np.sin(2 * np.pi * 330 * np.arange(16000) / 16000) + 0.01 * rng.standard_normal(16000)
    path = str(tmp_path / "in.wav")
    if dtype == "int16":
        jaudio.write_wav(path, x, 16000)
    else:
        import struct

        body = x.astype("<f4").tobytes()
        with open(path, "wb") as f:
            f.write(b"RIFF" + struct.pack("<I", 36 + len(body)) + b"WAVEfmt ")
            f.write(struct.pack("<IHHIIHH", 16, 3, 1, 16000, 64000, 4, 32) + b"data")
            f.write(struct.pack("<I", len(body)) + body)
    ours, sr = audio_io.load_audio(path, 24000)
    ref, jsr = jaudio.load_audio(path, 24000)
    assert sr == jsr == 24000 and ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, atol=1e-5)
    out = str(tmp_path / "out.wav")
    audio_io.save_audio(out, ours, 24000)
    samples, sr = audio_io.read_wav(out)
    jaudio.save_audio(str(tmp_path / "ref.wav"), ref, 24000)
    ref_samples, _ = jaudio.read_wav(str(tmp_path / "ref.wav"))
    assert sr == 24000 and samples.shape == ref_samples.shape == (len(ours) + 2 * 1200, 1)
    assert np.abs(samples.astype(np.int32) - ref_samples.astype(np.int32)).max() <= 1


def test_bridge_is_strict_and_random_init_follows_the_jax_scheme():
    lin = torch.nn.Sequential()
    lin.add_module("proj", torch.nn.Linear(4, 3))
    lin.add_module("ln", torch.nn.LayerNorm(3))
    params = {"proj": {"kernel": np.arange(12, dtype=np.float32).reshape(4, 3), "bias": np.ones(3, np.float32)},
              "ln": {"scale": np.full(3, 2.0, np.float32), "bias": np.zeros(3, np.float32)}}
    load_jax_params(lin, params)
    np.testing.assert_array_equal(lin.proj.weight.detach().numpy(), params["proj"]["kernel"].T)
    np.testing.assert_array_equal(lin.ln.weight.detach().numpy(), params["ln"]["scale"])
    with pytest.raises(KeyError, match="missing"):
        load_jax_params(lin, {"proj": params["proj"]})
    conv = torch.nn.Conv1d(64, 256, 3)
    random_init_(conv, torch.Generator().manual_seed(0))
    assert abs(conv.weight.std().item() - 1 / np.sqrt(64 * 3)) < 0.01 and conv.bias.abs().max() == 0
    random_init_(lin, torch.Generator().manual_seed(0))
    assert torch.all(lin.ln.weight == 1) and torch.all(lin.ln.bias == 0)


def test_cli_writes_wav_on_cpu(tmp_path):
    """The port's CLI end to end on CPU at a tiny config writes a WAV of
    n_frames * hop samples between the writer's 50 ms silences."""
    d = load_config(CONFIG).to_dict()
    for k in ("singer_file", "min_mel_file", "max_mel_file", "target_f0_file"):
        d[k] = os.path.join(REPO, d[k].lstrip("./"))
    d["mapper"].update(noise_schedule_factors=[0.0001, 0.02, 4], residual_layer_num=2, residual_channels=64)
    d["vocoder"]["upsample_initial_channel"] = 64
    (tmp_path / "cfg.json").write_text(json.dumps(d))
    t = np.arange(30000) / 24000
    audio_io.write_wav(str(tmp_path / "in.wav"), 0.4 * np.sin(2 * np.pi * 200 * t), 24000)
    from svc_inference_pipeline_tpu_torch import cli

    rc = cli.main(["--config", str(tmp_path / "cfg.json"), "--input", str(tmp_path / "in.wav"),
                   "--singer", "svcc_CDF1", "--output", str(tmp_path / "out.wav"), "--random-weights",
                   "--device", "cpu", "--timings-json", str(tmp_path / "t.json")])
    assert rc == 0
    samples, sr = audio_io.read_wav(str(tmp_path / "out.wav"))
    assert sr == 24000 and len(samples) == mel_frame_count(load_config(CONFIG), 30000) * 256 + 2 * 1200
    timings = json.loads((tmp_path / "t.json").read_text())
    assert set(timings) >= {"frontend_s", "ddpm_s", "vocoder_s", "total_s", "audio_s"}
    assert cli.main(["--input", "x.wav", "--singer", "s", "--output", "o.wav", "--device", "cpu"]) == 2
