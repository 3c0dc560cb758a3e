"""PyTorch port vs the JAX package: the device front-end (mel, resample,
Whisper log-mel, remap), the plain K4 attention and a 2-layer Whisper
encoder (f32, CPU, same inputs and weights)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svc_inference_pipeline_tpu.models.whisper import WhisperAudioEncoder as JaxEncoder
from svc_inference_pipeline_tpu.models.whisper import WhisperDims as JaxDims
from svc_inference_pipeline_tpu.ops import mel as jmel
from svc_inference_pipeline_tpu.ops import remap as jremap
from svc_inference_pipeline_tpu.ops.resample import _resample_conv as jax_resample_conv
from svc_inference_pipeline_tpu.ops import whisper_mel as jwmel
from svc_inference_pipeline_tpu.ops.pallas.attention import encoder_attention as jax_encoder_attention
from svc_inference_pipeline_tpu.utils.devices import fast_random_params
from svc_inference_pipeline_tpu_torch.checkpoints.from_jax import load_jax_params, unstack_blocks
from svc_inference_pipeline_tpu_torch.config import HParams
from svc_inference_pipeline_tpu_torch.models.whisper import WhisperAudioEncoder, WhisperDims
from svc_inference_pipeline_tpu_torch.ops import mel, remap, resample, whisper_mel
from svc_inference_pipeline_tpu_torch.ops.pallas import attention


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this module runs: the suite runs in several
    worker processes at once, and PyTorch's thread pools, each as wide as the
    machine, slow one another down many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _audio(n, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 24000
    return (0.4 * np.sin(2 * np.pi * 220 * t) + 0.05 * rng.standard_normal(n)).astype(np.float32)


def test_mel_features_match_jax(cfg):
    """log-mel <= 1e-4 and energy <= 1e-4 relative (float32 FFTs on both sides)."""
    audio = _audio(24000 + 77)
    jm, je = jmel.extract_mel_features(jnp.asarray(audio), cfg)
    m, e = mel.extract_mel_features(torch.from_numpy(audio), HParams(**cfg.to_dict()))
    np.testing.assert_allclose(m.numpy(), np.asarray(jm), atol=1e-4)
    np.testing.assert_allclose(e.numpy(), np.asarray(je), rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal(mel.mel_filterbank(24000, 1024, 100, 0.0, 12000.0),
                                  jmel.mel_filterbank(24000, 1024, 100, 0.0, 12000.0))


def test_resample_matches_jax():
    """24 -> 16 kHz conv form and host form, <= 1e-5, same length."""
    audio = _audio(24000 + 5, seed=1)
    ref = np.asarray(jax_resample_conv(jnp.asarray(audio), 24000, 16000, "kaiser_best"))
    got = resample._resample_conv(torch.from_numpy(audio), 24000, 16000).numpy()
    assert got.shape == ref.shape == (resample._out_len(len(audio), 2, 3),)
    np.testing.assert_allclose(got, ref, atol=1e-5)
    np.testing.assert_allclose(resample.resample_host(audio, 24000, 16000), ref, atol=1e-5)


def test_whisper_log_mel_matches_jax():
    """[W, 80, 3000] log-mel of 30 s windows, <= 1e-4."""
    audio = np.zeros((2, jwmel.N_SAMPLES), np.float32)
    audio[0, :40000] = _audio(40000, seed=2)
    audio[1, :7000] = _audio(7000, seed=3)
    ref = np.asarray(jwmel.log_mel_spectrogram(jnp.asarray(audio)))
    got = whisper_mel.log_mel_spectrogram(torch.from_numpy(audio)).numpy()
    assert got.shape == ref.shape == (2, 80, 3000)
    np.testing.assert_allclose(got, ref, atol=1e-4)


@pytest.mark.parametrize("target_len", [1, 99, 2812])
def test_remap_matches_jax(target_len):
    feats = np.random.default_rng(4).standard_normal((1500, 16)).astype(np.float32)
    ref = np.asarray(jremap.remap_features_device(jnp.asarray(feats), target_len))
    got = remap.remap_features_device(torch.from_numpy(feats), target_len).numpy()
    assert got.shape == ref.shape == (target_len, 16)
    np.testing.assert_allclose(got, ref, atol=1e-6)


def test_plain_k4_matches_pallas_interpret():
    """Plain K4 at T=300 (q blocks pad to 512: masked keys) vs
    encoder_attention(interpret=True), <= 1e-5."""
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal((2, 300, 128)).astype(np.float32) for _ in range(3))
    ref = np.asarray(jax_encoder_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 2, interpret=True))
    got = attention.encoder_attention(*(torch.from_numpy(a) for a in (q, k, v)), 2).numpy()
    assert np.abs(got - ref).max() <= 1e-5


@pytest.mark.parametrize("stacked", [False, True])
def test_two_layer_encoder_matches_jax(stacked):
    """2-layer, width-128 Whisper encoder vs WhisperAudioEncoder, <= 1e-4;
    the bridge takes both the per-block and the scanned parameter layouts."""
    dims = JaxDims(80, 1500, 128, 2, 2)
    mel_in = np.random.default_rng(6).standard_normal((1, 80, 3000)).astype(np.float32)
    jenc = JaxEncoder(dims, scan_layers=stacked)
    params = fast_random_params(lambda: jenc.init(jax.random.PRNGKey(0), jnp.zeros((1, 80, 3000))), seed=7)["params"]
    rng = np.random.default_rng(8)
    params = jax.tree_util.tree_map_with_path(
        lambda p, x: np.asarray(x, np.float32) if np.ndim(x) >= 2 or "scale" in str(p[-1])
        else (0.1 * rng.standard_normal(np.shape(x))).astype(np.float32), params)
    ref = np.asarray(jenc.apply({"params": params}, jnp.asarray(mel_in)))
    port = WhisperAudioEncoder(WhisperDims(80, 1500, 128, 2, 2))
    load_jax_params(port, unstack_blocks(params, 2))
    with torch.no_grad():
        got = port(torch.from_numpy(mel_in)).numpy()
    assert got.shape == ref.shape == (1, 1500, 128)
    assert np.abs(got - ref).max() <= 1e-4
