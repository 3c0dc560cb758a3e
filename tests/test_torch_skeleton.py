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


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this module runs: the suite runs in several
    worker processes at once, and PyTorch's thread pools, each as wide as the
    machine, slow one another down many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# every module of the port (checkpoint loading, the native codecs, eval,
# Whisper decoding, the F0 trackers, CREPE and HuBERT among them), then one
# tiny conversion, one tiny transcription, a tracker, a tiny CREPE, a
# reduced ContentVec and a tiny Whisper ``extract`` on CPU, in a fresh
# interpreter that must end without jax or transformers loaded
_NO_JAX = """
import importlib, pkgutil, sys
import numpy as np, torch
torch.set_num_threads(1)  # beside the suite's other workers, as their one_torch_thread fixtures do
import svc_inference_pipeline_tpu_torch as pkg
names = {m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")}
for name in sorted(names):
    importlib.import_module(name)
new = {"eval", "checkpoints.torch_convert", "checkpoints.native_io", "checkpoints.fetch", "native.wav_codec",
       "models.whisper_decoding", "models.text_normalizers", "transcribe", "ops.f0_dio", "ops.f0_pyin",
       "ops.f0_harvest", "ops.f0_crepe", "models.hubert", "checkpoints.hubert_convert", "training",
       "training.diffusion", "training.loop", "training.gan", "training.data", "training.elastic",
       "models.discriminators"}
assert {pkg.__name__ + "." + m for m in new} <= names, names
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
import dataclasses, os, tempfile
import chip_smoke
from svc_inference_pipeline_tpu_torch import transcribe
from svc_inference_pipeline_tpu_torch.checkpoints.from_jax import random_init_
from svc_inference_pipeline_tpu_torch.models.whisper import WhisperAudioEncoder, WhisperDims
from svc_inference_pipeline_tpu_torch.utils.audio_io import write_wav
dims = WhisperDims(80, 1500, 64, 4, 1, 51865, 448, 64, 4, 1)
enc = random_init_(WhisperAudioEncoder(dims), torch.Generator().manual_seed(0))
with tempfile.TemporaryDirectory() as tmp:
    model = os.path.join(tmp, "w.pt")
    torch.save(chip_smoke.whisper_checkpoint(dataclasses.asdict(dims), chip_smoke.module_tree(enc),
                                             np.random.default_rng(0)), model)
    write_wav(os.path.join(tmp, "in.wav"), 0.3 * np.sin(np.arange(16000) / 7), 16000)
    assert transcribe.main([os.path.join(tmp, "in.wav"), "--model", model, "--device", "cpu", "--beam_size", "2",
                            "--logprob_threshold=-inf", "--compression_ratio_threshold", "inf", "-o", tmp]) == 0
    assert open(os.path.join(tmp, "in.wav.vtt")).read().startswith("WEBVTT")
from svc_inference_pipeline_tpu_torch.models.hubert import HubertConfig
from svc_inference_pipeline_tpu_torch.ops import f0, f0_crepe
from svc_inference_pipeline_tpu_torch.pipeline.content import ContentVecExtractor, WhisperPPGExtractor
tone = (0.5 * np.sin(2 * np.pi * 220 * np.arange(12000) / 24000)).astype(np.float32)
track, _ = f0.get_f0_features(tone, 46, HParams(**d), method="dio")
assert track.shape == (46,) and (track > 0).mean() > 0.5, track
net = f0_crepe.build_crepe(None, "tiny", "cpu")
crepe = f0_crepe.get_f0_features_using_crepe(tone, 46, 24000, 256, 160, 50.0, 1100.0, threshold=0.0, model="tiny",
                                             params=chip_smoke.module_tree(net), device="cpu")
assert crepe.shape == (46,) and np.isfinite(crepe).all()
cv = ContentVecExtractor.random_init(HubertConfig(conv_layers=((32, 10, 5),) + ((32, 3, 2),) * 4 + ((32, 2, 2),) * 2,
                                                  encoder_dim=32, encoder_layers=2, encoder_heads=2,
                                                  encoder_ffn_dim=64, final_dim=16),
                                     device="cpu", output_layer=2)
assert cv.extract(tone, 46).shape == (46, 16)
ppg = WhisperPPGExtractor.random_init(dims, device="cpu", compute_dtype=torch.float32)
assert ppg.extract(tone, 46).shape == (46, 64)
from svc_inference_pipeline_tpu_torch.ops import mel
from svc_inference_pipeline_tpu_torch.training import gan
from svc_inference_pipeline_tpu_torch.training.loop import train_diffusion
stft = mel.STFT(24000, 100, 1024, 1024, 256, 0, 12000)
assert stft.get_mel(torch.from_numpy(tone)[None], keyshift=12).shape == (1, 100, 46)
d2 = dict(d, mapper=dict(d["mapper"], input_content_dim={"whisper": 16}))
rng = np.random.default_rng(0)
batch = {"mel": rng.standard_normal((2, 8, 100)).astype(np.float32), "singer": np.zeros((2, 1), np.int32),
         "content_whisper": rng.standard_normal((2, 8, 16)).astype(np.float32),
         "melody": np.full((2, 8), 220.0, np.float32), "loudness": np.full((2, 8), 0.5, np.float32)}
assert train_diffusion(HParams(**d2), [batch], num_steps=2, device="cpu").step == 2
d3 = dict(d, vocoder=dict(d["vocoder"], upsample_initial_channel=32, upsample_rates=[4, 4, 4, 4],
                          upsample_kernel_sizes=[8, 8, 8, 8], resblock_kernel_sizes=[3],
                          resblock_dilation_sizes=[[1, 3, 5]], discriminator_channel_mult=0.125))
state, gopt, dopt = gan.init_gan_train_state(HParams(**d3), torch.Generator().manual_seed(0), device="cpu")
disc_step, gen_step = gan.make_gan_train_steps(HParams(**d3), gopt, dopt)
wave_batch = {"mel": batch["mel"][:, :4], "wave": 0.1 * rng.standard_normal((2, 4 * 256)).astype(np.float32)}
state, d_loss = disc_step(state, wave_batch)
state, g_loss, _ = gen_step(state, wave_batch)
assert np.isfinite(float(d_loss)) and np.isfinite(float(g_loss)) and state.step == 1
bad = sorted(m for m in sys.modules if m in ("jax", "transformers")
             or m.startswith(("jax.", "transformers.", "svc_inference_pipeline_tpu.")))
assert not bad, bad
print("NO_JAX_OK")
"""


def test_port_never_imports_jax():
    out = subprocess.run([sys.executable, "-c", _NO_JAX, CONFIG, REPO], capture_output=True, text=True,
                         timeout=300, cwd=REPO)
    assert out.returncode == 0 and "NO_JAX_OK" in out.stdout, out.stderr[-3000:]


@pytest.mark.parametrize("size", ["tiny", "base", "small", "medium", "large-v1", "large-v2", "large"])
def test_whisper_sizes_equal_jax(size):
    """Every size's ten fields, the text decoder's among them."""
    import dataclasses

    from svc_inference_pipeline_tpu.models.whisper import WHISPER_SIZES as JAX_SIZES
    from svc_inference_pipeline_tpu_torch.models.whisper import WHISPER_SIZES

    assert set(WHISPER_SIZES) == set(JAX_SIZES)
    assert dataclasses.asdict(WHISPER_SIZES[size]) == dataclasses.asdict(JAX_SIZES[size])


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


def test_cli_writes_wav_on_cpu(tmp_path, monkeypatch):
    """The port's CLI end to end on CPU at a tiny config writes a WAV of
    n_frames * hop samples between the writer's 50 ms silences. Without
    --random-weights it loads the config's checkpoints, and with none there
    (Whisper "medium" not cached, downloads off) it raises as the JAX CLI
    does; mismatched --input/--singer/--output counts give rc 2."""
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
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    monkeypatch.delenv("SVC_ALLOW_DOWNLOAD", raising=False)
    monkeypatch.delenv("SVC_ALLOW_RANDOM_WHISPER", raising=False)
    with pytest.raises(FileNotFoundError, match="whisper checkpoint 'medium' unavailable"):
        cli.main(["--input", "x.wav", "--singer", "s", "--output", "o.wav", "--device", "cpu"])
    assert cli.main(["--input", "x.wav", "--singer", "s", "--output", "o.wav", "--output", "p.wav",
                     "--device", "cpu"]) == 2
