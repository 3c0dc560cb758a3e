"""Batched conversion of the port against the JAX SVCPipeline (tiny config,
CPU, f32, the same weights through the bridge): the batched front-end, a
clip longer than one Whisper window, ``convert_batch`` and
``convert_multi_singer`` on the JAX key discipline's noise, the
single-clip options (``pitch_factor``, ``upload_pcm16``, ``bucket``) and the
device PCM16 finalize."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svc_inference_pipeline_tpu.config import HParams as JaxHParams
from svc_inference_pipeline_tpu.models.bigvgan import vocoder_output_finalize as jax_finalize
from svc_inference_pipeline_tpu.models.diffsvc_fast import make_fast_denoise_fn
from svc_inference_pipeline_tpu.pipeline.convert import SVCPipeline as JaxPipeline
from svc_inference_pipeline_tpu.sampling.ddpm import INIT_NOISE_STD, ddpm_sample
from svc_inference_pipeline_tpu.utils.registry import get_singer_id
from svc_inference_pipeline_tpu_torch.config import HParams
from svc_inference_pipeline_tpu_torch.measure import synth_clip
from svc_inference_pipeline_tpu_torch.models.whisper import WHISPER_SIZES
from svc_inference_pipeline_tpu_torch.pipeline import convert as port_convert
from svc_inference_pipeline_tpu_torch.pipeline.convert import SVCPipeline
from svc_inference_pipeline_tpu_torch.utils.audio_io import read_wav

STEPS = 10
HOP = 256
SINGERS = ("svcc_CDF1", "svcc_CDM1", "svcc_IDF1")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this module runs: the suite runs in several
    worker processes at once, and PyTorch's thread pools, each as wide as the
    machine, slow one another down many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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
    jpipe.vocode_clip = jax.jit(lambda p, mel: jpipe.vocoder.apply({"params": p}, mel))
    return jpipe, port


@pytest.fixture(scope="module")
def clips():
    a = synth_clip(24000, 1.5)
    b = 0.5 * synth_clip(24000, 1.0)[::-1].copy()
    return a, b


def _assert_features(ours, ref, n):
    """Content <= 1e-3 (float32 FFTs and a 4-layer encoder), loudness 1e-4
    relative, F0 voicing >= 99% equal and within 5 cents on >= 99% of the
    frames both call voiced, over the clip's n true frames; padding equal."""
    np.testing.assert_allclose(ours["content_whisper"], ref["content_whisper"], atol=1e-3)
    np.testing.assert_allclose(ours["loudness"], ref["loudness"], rtol=1e-4, atol=1e-6)
    f0, f0_ref = ours["melody"][:n], ref["melody"][:n]
    assert np.mean((f0 > 0) == (f0_ref > 0)) >= 0.99
    both = (f0 > 0) & (f0_ref > 0)
    assert np.mean(1200 * np.abs(np.log2(f0[both] / f0_ref[both])) <= 5.0) >= 0.99
    assert np.all(ours["melody"][n:] == 0) and np.all(ref["melody"][n:] == 0)


def _numpy(batch):
    return {k: np.asarray(v) for k, v in batch.items()}


def test_extract_features_batch_matches_jax(pipes, clips):
    jpipe, port = pipes
    jbatch, jn = jpipe.extract_features_batch(list(clips), SINGERS[:2])
    batch, n = port.extract_features_batch(list(clips), SINGERS[:2])
    assert n == list(jn)
    jbatch, batch = _numpy(jbatch), _numpy(batch)
    assert batch["melody"].shape == jbatch["melody"].shape
    for i, n_i in enumerate(n):
        _assert_features({k: v[i] for k, v in batch.items()}, {k: v[i] for k, v in jbatch.items()}, n_i)
        assert np.all(batch["content_whisper"][i, n_i:] == 0) and np.all(batch["loudness"][i, n_i:] == 0)
    assert batch["singer"].tolist() == jbatch["singer"].tolist()


def test_long_clip_front_end_matches_jax(pipes):
    """31 s: two Whisper windows, encoded in one call on both sides."""
    jpipe, port = pipes
    clip = synth_clip(24000, 31.0)
    jbatch, jn = jpipe.extract_features(clip, SINGERS[0])
    batch, n = port.extract_features(clip, SINGERS[0])
    assert n == jn and n > 1500 * 15 // 8 // 2
    jbatch, batch = _numpy(jbatch), _numpy(batch)
    assert batch["melody"].shape == jbatch["melody"].shape
    _assert_features({k: v[0] for k, v in batch.items()}, {k: v[0] for k, v in jbatch.items()}, n)


def test_single_clip_options_match_jax(pipes, clips):
    """pitch_factor, upload_pcm16 and a 128-frame bucket through extract_features."""
    jpipe, port = pipes
    jpipe.bucket = port.bucket = 128
    try:
        jbatch, jn = jpipe.extract_features(clips[0], SINGERS[1], upload_pcm16=True, pitch_factor=1.25)
        batch, n = port.extract_features(clips[0], SINGERS[1], upload_pcm16=True, pitch_factor=1.25)
    finally:
        jpipe.bucket = port.bucket = port_convert.DEFAULT_BUCKET
    assert n == jn == 140 and batch["melody"].shape[1] == 256  # 192 at the 64-frame bucket
    jbatch, batch = _numpy(jbatch), _numpy(batch)
    assert batch["melody"].shape == jbatch["melody"].shape
    _assert_features({k: v[0] for k, v in batch.items()}, {k: v[0] for k, v in jbatch.items()}, n)
    # the int16 upload reaches the device front-end: loudness moves by the
    # quantisation, which is below the tolerance but not zero
    plain, _ = port.extract_features(clips[0], SINGERS[1], pitch_factor=1.25)
    assert not torch.equal(plain["loudness"], torch.from_numpy(batch["loudness"]))


def _jax_noise(key, shape):
    """The draws of the JAX DDPM sampler for ``key``: (x_T, z [steps, ...])."""
    k2, init_key = jax.random.split(key)
    return (torch.from_numpy(np.array(INIT_NOISE_STD * jax.random.normal(init_key, shape))),
            torch.from_numpy(np.stack([np.asarray(jax.random.normal(k, shape)) for k in jax.random.split(k2, STEPS)])))


def _jax_chain(jpipe, jbatch, key, n_true, padded):
    """The JAX modules applied one by one (condition encoder, DDPM over the
    plain denoiser, denormalisation, vocoder, finalize). The vocoder runs
    clip by clip (it mixes no clips) under one jit of its own, which every
    test of this module shares at one padded length."""
    cond = jpipe.cond_encoder.apply({"params": jpipe.cond_params}, jbatch)
    fn = make_fast_denoise_fn(jpipe.denoiser_params, cond, STEPS, jpipe.cfg.mapper, compute_dtype=jnp.float32)
    mel_norm = ddpm_sample(fn, cond, key, (cond.shape[0], padded, 100), jpipe.schedule)
    mel = (mel_norm + 1.0) / 2.0 * (jpipe._mel_max - jpipe._mel_min + 1e-12) + jpipe._mel_min
    wave = jnp.concatenate([jpipe.vocode_clip(jpipe.vocoder_params, mel[i:i + 1]) for i in range(mel.shape[0])])
    return np.asarray(jax_finalize(wave[..., : padded * HOP], jnp.asarray(n_true, jnp.int32), HOP))


def _run_port(monkeypatch, port, noise, features_method, features, call):
    """Call ``call()`` with the port's features replaced by the JAX ones and
    the sampler's draws by ``noise``; returns its result and the core's
    padded waveform."""
    core = port._convert_core
    seen = {}

    def injected(*args, **kw):
        seen["wave"] = core(*args, **dict(kw, noise=noise))
        return seen["wave"]

    monkeypatch.setattr(port, features_method, lambda *a, **kw: features)
    monkeypatch.setattr(port, "_convert_core", injected)
    return call(), seen["wave"].numpy()


def _assert_waves(got, chain, core, n_true):
    """Each clip: <= 1e-3 from the JAX modules applied one by one; <= 0.1 and
    correlation >= 0.999 from the single-jit ``_core`` (on this input XLA's
    fused core differs from its own op-by-op chain by ~0.04, see
    test_torch_pipeline.py)."""
    for i, n in enumerate(n_true):
        g, c, k = got[i], chain[i, : n * HOP], core[i]
        assert g.shape == c.shape == k.shape == (n * HOP,)
        assert np.abs(g - c).max() <= 1e-3
        assert np.abs(g - k).max() <= 0.1 and np.corrcoef(g, k)[0, 1] >= 0.999


def test_convert_batch_matches_jax(pipes, clips, monkeypatch):
    jpipe, port = pipes
    jbatch, n_true = jpipe.extract_features_batch(list(clips), SINGERS[:2])
    padded = jbatch["melody"].shape[1]
    key = jax.random.PRNGKey(5)
    core = [np.asarray(w) for w in jpipe.convert_batch(list(clips), SINGERS[:2], key=key)]
    chain = _jax_chain(jpipe, jbatch, key, n_true, padded)
    batch = {k: torch.from_numpy(np.array(v)) for k, v in jbatch.items()}
    got, padded_wave = _run_port(monkeypatch, port, _jax_noise(key, (2, padded, 100)), "extract_features_batch",
                                 (batch, list(n_true)),
                                 lambda: port.convert_batch(list(clips), SINGERS[:2], sampler="ddpm"))
    _assert_waves(got, chain, core, n_true)
    assert padded_wave.shape == (2, padded * HOP)
    for i, n in enumerate(n_true):
        assert np.all(padded_wave[i, n * HOP:] == 0.0)


def test_convert_multi_singer_matches_jax(pipes, clips, monkeypatch):
    jpipe, port = pipes
    jbatch, n = jpipe.extract_features(clips[0], SINGERS[0])
    padded = jbatch["melody"].shape[1]
    key = jax.random.PRNGKey(6)
    core = [np.asarray(w) for w in jpipe.convert_multi_singer(clips[0], SINGERS, key=key)]
    tiled = {k: jnp.tile(v, (3,) + (1,) * (v.ndim - 1)) for k, v in jbatch.items()}
    tiled["singer"] = jnp.asarray(np.concatenate([get_singer_id(jpipe.cfg, s) for s in SINGERS])[:, None])
    chain = _jax_chain(jpipe, tiled, key, [n] * 3, padded)
    batch = {k: torch.from_numpy(np.array(v)) for k, v in jbatch.items()}
    got, padded_wave = _run_port(monkeypatch, port, _jax_noise(key, (3, padded, 100)), "extract_features",
                                 (batch, n), lambda: port.convert_multi_singer(clips[0], SINGERS))
    _assert_waves(got, chain, core, [n] * 3)
    assert np.all(padded_wave[:, n * HOP:] == 0.0)
    assert not np.allclose(got[0], got[1])


def test_pcm16_is_the_device_finalize(pipes, clips, monkeypatch, tmp_path):
    """convert(pcm16=True) returns int16 equal to the JAX finalize with
    pcm16=True of the same f32 vocoder output; output_path writes it as is."""
    _, port = pipes
    seen = {}
    finalize = port_convert.vocoder_output_finalize

    def spy(wave, n_true, hop, pcm16=False):
        seen["args"] = (wave.numpy().copy(), n_true.numpy().copy(), hop)
        return finalize(wave, n_true, hop, pcm16=pcm16)

    monkeypatch.setattr(port_convert, "vocoder_output_finalize", spy)
    path = tmp_path / "out.wav"
    got = port.convert(clips[1], SINGERS[0], generator=torch.Generator().manual_seed(0), pcm16=True,
                       output_path=str(path))
    wave, n_true, hop = seen["args"]
    ref = np.asarray(jax_finalize(jnp.asarray(wave), jnp.asarray(n_true, jnp.int32), hop, pcm16=True))
    assert got.dtype == np.int16 and got.shape == (n_true[0] * hop,)
    np.testing.assert_array_equal(got, ref[0, : n_true[0] * hop])
    samples, _ = read_wav(str(path))
    np.testing.assert_array_equal(samples[1200:-1200, 0], got)
