"""The slice end to end: the JAX SVCPipeline (tiny config, CPU, f32) against
the PyTorch port built from the same weights through the bridge, with the
sampler noise of the JAX key discipline (10-step DDPM)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svc_inference_pipeline_tpu.config import HParams as JaxHParams
from svc_inference_pipeline_tpu.pipeline.convert import SVCPipeline as JaxPipeline
from svc_inference_pipeline_tpu.models.bigvgan import vocoder_output_finalize
from svc_inference_pipeline_tpu.models.diffsvc_fast import make_fast_denoise_fn
from svc_inference_pipeline_tpu.sampling.ddpm import INIT_NOISE_STD, ddpm_sample
from svc_inference_pipeline_tpu_torch.config import HParams
from svc_inference_pipeline_tpu_torch.models.whisper import WHISPER_SIZES
from svc_inference_pipeline_tpu_torch.pipeline.convert import SVCPipeline

STEPS = 10
SINGER = "svcc_CDF1"


def _randomize_vectors(tree, rng):
    return jax.tree_util.tree_map_with_path(
        lambda p, x: np.asarray(x, np.float32) if np.ndim(x) >= 2 or "scale" in str(p[-1])
        else (0.1 * rng.standard_normal(np.shape(x))).astype(np.float32),
        tree,
    )


@pytest.fixture(scope="module")
def pipes(cfg):
    d = cfg.to_dict()
    d["compute_dtype"] = "float32"
    d["mapper"].update(noise_schedule_factors=[0.0001, 0.02, STEPS], residual_layer_num=2,
                       residual_channels=128)
    d["vocoder"]["upsample_initial_channel"] = 64
    jpipe = JaxPipeline.from_config(JaxHParams(**d), random_weights=True, whisper_size="tiny")
    rng = np.random.default_rng(0)
    trees = [_randomize_vectors(jax.device_get(t), rng) for t in
             (jpipe.cond_params, jpipe.denoiser_params, jpipe.vocoder_params, jpipe.whisper.params)]
    jpipe.cond_params, jpipe.denoiser_params, jpipe.vocoder_params, jpipe.whisper.params = (
        jax.device_put(t) for t in trees)
    port = SVCPipeline.from_jax_params(HParams(**jpipe.cfg.to_dict()), *trees[:3], WHISPER_SIZES["tiny"],
                                       trees[3], device="cpu")
    return jpipe, port


@pytest.fixture(scope="module")
def clip():
    fs = 24000
    t = np.arange(int(1.5 * fs)) / fs
    phase = 2 * np.pi * np.cumsum(220.0 * 2 ** (0.5 / 12 * np.sin(2 * np.pi * 5.5 * t))) / fs
    x = sum((0.3 / k) * np.sin(k * phase) for k in range(1, 7))
    x[(t > 0.7) & (t < 0.9)] = 0.0
    return (x + 1e-3 * np.random.default_rng(1).standard_normal(len(t))).astype(np.float32)


def test_extract_features_matches_jax(pipes, clip):
    """Front-end outputs: content <= 1e-3 (float32 FFTs and a 4-layer
    encoder), loudness <= 1e-4 relative, F0 voicing >= 99% equal and within
    5 cents on >= 99% of frames both call voiced, singer id equal."""
    jpipe, port = pipes
    jbatch, jn = jpipe.extract_features(clip, SINGER)
    batch, n = port.extract_features(clip, SINGER)
    assert n == jn and batch["melody"].shape == jbatch["melody"].shape
    np.testing.assert_allclose(batch["content_whisper"].numpy(), np.asarray(jbatch["content_whisper"]), atol=1e-3)
    np.testing.assert_allclose(batch["loudness"].numpy(), np.asarray(jbatch["loudness"]), rtol=1e-4, atol=1e-6)
    ours, ref = batch["melody"].numpy()[0], np.asarray(jbatch["melody"])[0]
    assert np.mean((ours > 0) == (ref > 0)) >= 0.99
    both = (ours > 0) & (ref > 0)
    assert np.mean(1200 * np.abs(np.log2(ours[both] / ref[both])) <= 5.0) >= 0.99
    assert batch["singer"].tolist() == np.asarray(jbatch["singer"]).tolist()


def test_convert_core_matches_jax(pipes, clip):
    """_convert_core (condition encoder, 10-step DDPM, denormalisation,
    vocoder, finalize) on the same batch and noise.

    Against the JAX modules applied one by one: waveform <= 1e-3. Against
    the JAX pipeline's single-jit ``_core``: <= 0.1 and correlation >= 0.999,
    because on this input XLA's fused core itself differs from the same
    modules applied one by one by ~0.04 (the random-weight vocoder runs
    activations up to ~200)."""
    jpipe, port = pipes
    jbatch, n_frames = jpipe.extract_features(clip, SINGER)
    padded = jbatch["melody"].shape[1]
    key = jax.random.PRNGKey(3)
    n_true = jnp.asarray([n_frames], jnp.int32)
    core = np.asarray(jpipe._core(jpipe.cond_params, jpipe.denoiser_params, jpipe.vocoder_params,
                                  jbatch, key, n_true, n_frames=padded, sampler="ddpm", speedup=1))
    shape = (1, padded, 100)
    cond = jpipe.cond_encoder.apply({"params": jpipe.cond_params}, jbatch)
    fn = make_fast_denoise_fn(jpipe.denoiser_params, cond, STEPS, jpipe.cfg.mapper, compute_dtype=jnp.float32)
    mel_norm = ddpm_sample(fn, cond, key, shape, jpipe.schedule)
    mel = (mel_norm + 1.0) / 2.0 * (jpipe._mel_max - jpipe._mel_min + 1e-12) + jpipe._mel_min
    wave = jpipe.vocoder.apply({"params": jpipe.vocoder_params}, mel)
    chain = np.asarray(vocoder_output_finalize(wave[..., : padded * 256], n_true, 256))

    k2, init_key = jax.random.split(key)
    noise = (torch.from_numpy(np.array(INIT_NOISE_STD * jax.random.normal(init_key, shape))),
             torch.from_numpy(np.stack([np.asarray(jax.random.normal(k, shape)) for k in jax.random.split(k2, STEPS)])))
    batch = {k: torch.from_numpy(np.array(v)) for k, v in jbatch.items()}
    got = port._convert_core(batch, torch.tensor([n_frames]), padded, noise=noise).numpy()
    assert got.shape == chain.shape == core.shape == (1, padded * 256)
    assert np.abs(got - chain).max() <= 1e-3
    assert np.abs(got - core).max() <= 0.1 and np.corrcoef(got[0], core[0])[0, 1] >= 0.999
    assert np.all(got[0, n_frames * 256:] == 0.0)
