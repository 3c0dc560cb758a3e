"""The port's eval.py against the JAX package's: each metric on the same
waveforms, and ``golden_eval`` / ``main --golden`` end to end from synthetic
reference-layout checkpoints (written by ``chip_smoke.py``'s exporter) and a
FLAC input, scored against a synthetic golden WAV."""

import json
import os

import numpy as np
import pytest
import torch

import chip_smoke
from flac_fixture import write_flac
from svc_inference_pipeline_tpu import eval as jeval
from svc_inference_pipeline_tpu.config import load_config as jax_load_config
from svc_inference_pipeline_tpu_torch import eval as peval
from svc_inference_pipeline_tpu_torch.checkpoints.from_jax import random_init_
from svc_inference_pipeline_tpu_torch.config import HParams, load_config
from svc_inference_pipeline_tpu_torch.models.whisper import WhisperAudioEncoder, WhisperDims
from svc_inference_pipeline_tpu_torch.pipeline.convert import SVCPipeline
from svc_inference_pipeline_tpu_torch.utils.audio_io import save_audio

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "config", "config.json")
FS = 24000
METRIC_KEYS = ("mel_mae", "mcd_db", "snr_db", "f0_rmse_cents", "voicing_agreement")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this module runs: the suite runs in several
    worker processes at once, and PyTorch's thread pools, each as wide as the
    machine, slow one another down many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _harmonic(f0, seconds=1.0, seed=0, noise=0.0):
    t = np.arange(int(seconds * FS)) / FS
    phase = 2 * np.pi * np.cumsum(f0 * 2 ** (0.5 / 12 * np.sin(2 * np.pi * 5.5 * t))) / FS
    x = sum((0.4 / k) * np.sin(k * phase) for k in range(1, 6))
    x[(t > 0.45) & (t < 0.55)] = 0.0
    return (x + noise * np.random.default_rng(seed).standard_normal(len(t))).astype(np.float32)


@pytest.fixture(scope="module")
def pair():
    return _harmonic(220.0, noise=1e-3), _harmonic(226.0, seed=1, noise=2e-2)


@pytest.fixture(scope="module")
def cfgs():
    return load_config(CONFIG), jax_load_config(CONFIG)


def _check_f0(got, want):
    """The F0 rule of tests/test_torch_pipeline.py: the port's Praat tracker
    may call a frame voiced differently on 1% of frames and land 5 cents
    away, so the metrics over those tracks agree that far."""
    assert abs(got["voicing_agreement"] - want["voicing_agreement"]) <= 0.01
    assert abs(got["f0_rmse_cents"] - want["f0_rmse_cents"]) <= 5.0


@pytest.mark.parametrize("metric", ["mel_mae", "mcd_db"])
def test_mel_metrics_equal_jax(pair, cfgs, metric):
    got = getattr(peval, metric)(*pair, cfgs[0])
    want = getattr(jeval, metric)(*pair, cfgs[1])
    assert got > 0 and abs(got - want) <= 1e-5 * abs(want)


def test_mcd_from_mels_and_snr_equal_jax(pair):
    rng = np.random.default_rng(2)
    ma, mb = rng.standard_normal((100, 40)), rng.standard_normal((100, 37))
    assert peval.mcd_from_mels(ma, mb) == jeval.mcd_from_mels(ma, mb)
    assert peval.waveform_snr_db(*pair) == jeval.waveform_snr_db(*pair)
    assert peval.waveform_snr_db(pair[0], pair[0]) == float("inf")


def test_f0_rmse_cents_follows_jax(pair, cfgs):
    got, want = peval.f0_rmse_cents(*pair, cfgs[0]), jeval.f0_rmse_cents(*pair, cfgs[1])
    assert 40 < got["f0_rmse_cents"] < 60  # 226 Hz against 220 Hz is 46.6 cents
    _check_f0(got, want)
    same = peval.f0_rmse_cents(pair[0], pair[0], cfgs[0])
    assert same["f0_rmse_cents"] == 0.0 and same["voicing_agreement"] == 1.0


def test_evaluate_pair_equals_jax(pair, cfgs, tmp_path):
    paths = [str(tmp_path / f"{k}.wav") for k in ("ref", "test")]
    for path, wav in zip(paths, pair):
        save_audio(path, wav, FS, add_silence=False)
    got, want = peval.evaluate_pair(*paths, cfgs[0]), jeval.evaluate_pair(*paths, cfgs[1])
    assert sorted(got) == sorted(want) == sorted(METRIC_KEYS)
    for k in ("mel_mae", "mcd_db"):
        assert abs(got[k] - want[k]) <= 1e-5 * abs(want[k]), k
    assert got["snr_db"] == want["snr_db"]
    _check_f0(got, want)
    assert peval.mel_mae(pair[0], pair[0], cfgs[0]) == 0.0


def test_pair_mode_main_prints_metrics(pair, tmp_path, capsys):
    paths = [str(tmp_path / f"{k}.wav") for k in ("ref", "test")]
    for path, wav in zip(paths, pair):
        save_audio(path, wav, FS)
    assert peval.main(paths) == 0
    out = json.loads(capsys.readouterr().out)
    assert sorted(out) == sorted(METRIC_KEYS) and all(np.isfinite(out[k]) for k in out)


@pytest.fixture(scope="module")
def golden(tmp_path_factory):
    """Tiny random models written as reference-layout checkpoints, a FLAC
    input and a synthetic golden WAV; the config runs on the CPU."""
    tmp = tmp_path_factory.mktemp("golden")
    d = load_config(CONFIG).to_dict()
    for k in ("singer_file", "min_mel_file", "max_mel_file", "target_f0_file"):
        d[k] = os.path.normpath(os.path.join(REPO, d[k]))
    d.update(device="cpu", compute_dtype="float32")
    d["mapper"].update(noise_schedule_factors=[0.0001, 0.02, 4], residual_layer_num=2, residual_channels=64)
    d["mapper"]["input_content_dim"]["whisper"] = 64
    d["vocoder"]["upsample_initial_channel"] = 64
    cfg = HParams(**d)
    dims = WhisperDims(80, 1500, 64, 4, 2, n_vocab=100, n_text_ctx=16, n_text_state=64, n_text_head=4,
                       n_text_layer=1)
    g = torch.Generator().manual_seed(0)
    cond, den, voc = SVCPipeline._models(cfg, torch.float32)
    enc = WhisperAudioEncoder(dims)
    for m in (cond, den, voc, enc):
        random_init_(m, g)
        chip_smoke.randomize_vectors_(m, g)
    rng = np.random.default_rng(0)
    paths = {k: str(tmp / f"{k}.pt") for k in ("mapper", "vocoder", "whisper")}
    torch.save(chip_smoke.mapper_checkpoint(chip_smoke.module_tree(cond), chip_smoke.module_tree(den)),
               paths["mapper"])
    torch.save(chip_smoke.vocoder_checkpoint(chip_smoke.module_tree(voc), cfg.vocoder, rng), paths["vocoder"])
    torch.save(chip_smoke.whisper_checkpoint(vars(dims), chip_smoke.module_tree(enc), rng), paths["whisper"])
    paths["input"] = str(tmp / "clip.flac")
    write_flac(paths["input"], np.round(_harmonic(220.0, seconds=0.5) * 32767).astype(np.int64), FS)
    paths["golden"] = str(tmp / "golden.wav")
    save_audio(paths["golden"], _harmonic(233.0, seconds=0.5, seed=3, noise=1e-2), FS)
    paths["config"] = str(tmp / "cfg.json")
    with open(paths["config"], "w") as f:
        json.dump(d, f)
    return cfg, paths


def test_golden_eval_end_to_end(golden, tmp_path):
    cfg, p = golden
    cfg = cfg.replace(svc_model_path=p["mapper"], vocoder_model_path=p["vocoder"], whisper_model=p["whisper"])
    out_wav = tmp_path / "converted.wav"
    metrics = peval.golden_eval(cfg, input_path=p["input"], golden_path=p["golden"], output_path=str(out_wav))
    for key in METRIC_KEYS + ("rtf", "duration_s"):
        assert np.isfinite(metrics[key]), (key, metrics[key])
    assert metrics["duration_s"] == 0.5 and out_wav.exists()
    json.dumps(metrics)


def test_main_golden_prints_metrics(golden, tmp_path, capsys):
    _, p = golden
    out_wav = str(tmp_path / "converted.wav")
    rc = peval.main(["--golden", "--config", p["config"], "--mapper", p["mapper"], "--vocoder", p["vocoder"],
                     "--whisper", p["whisper"], "--input", p["input"], "--singer", "svcc_CDM1",
                     "--golden-wav", p["golden"], "--output", out_wav])
    assert rc == 0 and os.path.exists(out_wav)
    metrics = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    for key in METRIC_KEYS + ("rtf", "duration_s"):
        assert np.isfinite(metrics[key]), (key, metrics[key])


def test_golden_eval_missing_mapper_raises(golden, tmp_path):
    """No silent random fallback in the golden run."""
    cfg, p = golden
    cfg = cfg.replace(svc_model_path=str(tmp_path / "absent" / "mapper.pt"), vocoder_model_path=p["vocoder"])
    with pytest.raises(FileNotFoundError, match="mapper .*not publicly downloadable"):
        peval.golden_eval(cfg, input_path=p["input"], golden_path=p["golden"])
    cfg = cfg.replace(svc_model_path=p["mapper"], vocoder_model_path=str(tmp_path / "vocoder.pt"))
    with pytest.raises(FileNotFoundError, match="vocoder"):
        peval.golden_eval(cfg, input_path=p["input"], golden_path=p["golden"])
