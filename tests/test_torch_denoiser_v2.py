"""PyTorch port vs the JAX harness: K8's plain version (the eps function of
``denoiser_v2.build_v2_fn``, ``denoise_plain`` over the bf16 stacks) against
``perf_kernel3.build_v2_fn``, the one-launch concat-tap Pallas denoiser, in
interpret mode (CPU, same weights, bf16).

Tolerance: 1e-2 x max|eps| (K1's and K5's limit on the card). Both sides
are bf16 chains (h stored bf16 after every layer) whose f32 sums round in
other orders, so almost every element differs by more than 1e-6; the chain
keeps the difference at a few 1e-3 of max|eps|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import perf_kernel3
from svc_inference_pipeline_tpu.models.diffsvc import DiffSVCDenoiser as JaxDenoiser
from svc_inference_pipeline_tpu.utils.devices import fast_random_params
from svc_inference_pipeline_tpu_torch.checkpoints.from_jax import load_jax_params
from svc_inference_pipeline_tpu_torch.config import HParams
from svc_inference_pipeline_tpu_torch.models.diffsvc import DiffSVCDenoiser
from svc_inference_pipeline_tpu_torch.ops.pallas import denoiser_v2

L, C, T, STEPS = 4, 128, 64, 50


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
def fns(cfg):
    """(JAX harness fn, port fn, cond) over the same weights and conditioning."""
    mcfg = cfg.mapper.replace(residual_layer_num=L, residual_channels=C, conditioner_size=C)
    model = JaxDenoiser(mcfg, compute_dtype=jnp.float32)
    params = fast_random_params(
        lambda: model.init(jax.random.PRNGKey(0), jnp.zeros((1, T, 100)), jnp.zeros((1, T, C)),
                           jnp.zeros((1, 1), jnp.int32)), seed=21)["params"]
    rng = np.random.default_rng(22)
    params = jax.tree_util.tree_map(  # random 1-D leaves: the init zeroes them
        lambda x: (0.1 * rng.standard_normal(x.shape)).astype(np.float32) if np.ndim(x) == 1
        else np.asarray(x, np.float32), params)
    cond = np.random.default_rng(23).standard_normal((1, T, C)).astype(np.float32)
    jax_fn = perf_kernel3.build_v2_fn(params, jnp.asarray(cond), STEPS, mcfg)
    port = load_jax_params(DiffSVCDenoiser(HParams(**mcfg.to_dict()), torch.bfloat16), params)
    with torch.no_grad():
        port_fn = denoiser_v2.build_v2_fn(port, torch.from_numpy(cond), STEPS, torch.bfloat16)
    return jax_fn, port_fn, cond


@pytest.mark.parametrize("t_step", [0, 25, STEPS - 1])
def test_plain_k8_matches_pallas_interpret(fns, t_step):
    jax_fn, port_fn, cond = fns
    x = (np.random.default_rng(24 + t_step).standard_normal((1, T, 100))).astype(np.float32)
    ref = np.asarray(jax_fn(jnp.asarray(x), jnp.asarray(cond), jnp.full((1, 1), t_step, jnp.int32)))
    launches = denoiser_v2.denoise_v2.launches
    with torch.no_grad():
        got = port_fn(torch.from_numpy(x), None, torch.full((1, 1), t_step)).numpy()
    assert denoiser_v2.denoise_v2.launches == launches  # CPU tensor: the plain version, no launch
    assert got.shape == ref.shape == (1, T, 100) and got.dtype == np.float32
    assert np.abs(got - ref).max() <= 1e-2 * np.abs(ref).max(), (np.abs(got - ref).max(), np.abs(ref).max())


def test_k8_takes_one_clip_only(cfg):
    mcfg = cfg.mapper.replace(residual_layer_num=2, residual_channels=64, conditioner_size=64)
    den = DiffSVCDenoiser(HParams(**mcfg.to_dict()), torch.bfloat16)
    with pytest.raises(ValueError, match="one clip only"):
        denoiser_v2.build_v2_fn(den, torch.zeros((2, 8, 64)), 4)
    fn = denoiser_v2.build_v2_fn(den, torch.zeros((1, 8, 64)), 4)
    with pytest.raises(ValueError, match="one clip only"):
        fn(torch.zeros((2, 8, 100)), None, torch.zeros((1, 1), dtype=torch.int64))
