"""The port's per-clip Whisper content API, ``WhisperPPGExtractor.extract``,
against the JAX package's on the same weights at a tiny width (f32, CPU):
a 2 s clip, and a 35 s clip encoded as two 30 s windows (``chunked=True``)
or cut to its first window (``chunked=False``). The JAX encoder's attention
on the CPU is K4's plain reference (einsum), the port's K4 wrapper takes its
plain version on CPU tensors."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svc_inference_pipeline_tpu.models.whisper import WhisperAudioEncoder as JaxEncoder
from svc_inference_pipeline_tpu.models.whisper import WhisperDims as JaxDims
from svc_inference_pipeline_tpu.pipeline.content import WhisperPPGExtractor as JaxExtractor
from svc_inference_pipeline_tpu.utils.devices import fast_random_params
from svc_inference_pipeline_tpu_torch.models.whisper import WhisperDims
from svc_inference_pipeline_tpu_torch.ops.pallas import attention
from svc_inference_pipeline_tpu_torch.pipeline.content import WhisperPPGExtractor

# of max|JAX|: f32 on both sides; the resampler, the log-mel (<= 1e-4,
# tests/test_torch_frontend.py) and two encoder layers sum in another order
REL_TOL = 1e-4
DIMS = (80, 1500, 64, 4, 2)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this module runs: the suite runs in several
    worker processes at once, and PyTorch's thread pools, each as wide as the
    machine, slow one another down many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def extractors():
    """One random tiny encoder (every vector drawn, so a bias or LayerNorm
    mix-up shows) held by both packages' extractors in f32."""
    jenc = JaxEncoder(JaxDims(*DIMS))
    params = fast_random_params(lambda: jenc.init(jax.random.PRNGKey(0), jnp.zeros((1, 80, 3000))), seed=3)["params"]
    rng = np.random.default_rng(4)
    params = jax.tree_util.tree_map_with_path(
        lambda p, x: np.asarray(x, np.float32) if np.ndim(x) >= 2
        else (("scale" in str(p[-1])) + 0.1 * rng.standard_normal(np.shape(x))).astype(np.float32), params)
    theirs = JaxExtractor(JaxDims(*DIMS), params, compute_dtype=jnp.float32)
    ours = WhisperPPGExtractor.from_jax_params(WhisperDims(*DIMS), params, device="cpu", compute_dtype=torch.float32)
    return ours, theirs


def _clip(seconds, seed=0):
    n = int(seconds * 24000)
    t = np.arange(n) / 24000
    rng = np.random.default_rng(seed)
    return (0.4 * np.sin(2 * np.pi * 220 * t * (1 + 0.02 * np.sin(2 * np.pi * 3 * t)))
            + 0.05 * rng.standard_normal(n)).astype(np.float32)


@pytest.mark.parametrize("seconds,chunked", [(2.0, True), (35.0, True), (35.0, False)])
def test_extract_matches_jax(extractors, seconds, chunked):
    ours, theirs = extractors
    audio = _clip(seconds)
    mel_len = len(audio) // 256
    launches = attention.encoder_attention.launches
    got = ours.extract(audio, mel_len, chunked=chunked)
    want = np.asarray(theirs.extract(audio, mel_len, chunked=chunked))
    # chunked: every frame of the clip; one window: the cap of 1500 source frames
    n_out = mel_len if chunked else min(mel_len, 1500 * 15 // 8)
    assert got.shape == want.shape == (n_out, 64) and got.dtype == np.float32
    err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert err <= REL_TOL * scale, (err, scale)
    assert attention.encoder_attention.launches == launches  # the plain version on CPU tensors: no launch
    if seconds > 30 and chunked:  # the second window's frames come from the second window
        solo = ours.extract(audio[: 30 * 24000], 30 * 24000 // 256)
        assert np.abs(got[: len(solo) - 8] - solo[:-8]).max() <= REL_TOL * scale
        assert not np.allclose(got[-100:], got[len(solo) - 200: len(solo) - 100])
