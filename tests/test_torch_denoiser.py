"""PyTorch port vs the JAX package: condition encoder, DiffSVC denoiser, the
plain K1 step, and the DDPM samplers (f32, CPU, same weights and noise)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svc_inference_pipeline_tpu.models.diffsvc import DiffSVCDenoiser as JaxDenoiser
from svc_inference_pipeline_tpu.models.diffsvc_fast import precompute as jax_precompute
from svc_inference_pipeline_tpu.models.encoder import ConditionEncoder as JaxConditionEncoder
from svc_inference_pipeline_tpu.ops.pallas import denoiser_step as jax_step
from svc_inference_pipeline_tpu.sampling.ddpm import INIT_NOISE_STD
from svc_inference_pipeline_tpu.sampling.ddpm import ddpm_sample as jax_ddpm_sample
from svc_inference_pipeline_tpu.sampling.schedule import DiffusionSchedule as JaxSchedule
from svc_inference_pipeline_tpu.utils.devices import fast_random_params
from svc_inference_pipeline_tpu_torch.checkpoints.from_jax import load_jax_params
from svc_inference_pipeline_tpu_torch.config import HParams
from svc_inference_pipeline_tpu_torch.models.diffsvc import DiffSVCDenoiser
from svc_inference_pipeline_tpu_torch.models.encoder import ConditionEncoder
from svc_inference_pipeline_tpu_torch.ops.pallas import denoiser_step
from svc_inference_pipeline_tpu_torch.sampling.ddpm import ddpm_sample
from svc_inference_pipeline_tpu_torch.sampling.schedule import DiffusionSchedule

L, C, T, STEPS = 4, 128, 64, 10


def randomize_vectors(tree, rng, scale=0.1):
    """Random 1-D leaves: fast_random_params zeroes them, which would hide a
    bias mix-up."""
    return jax.tree_util.tree_map(
        lambda x: (scale * rng.standard_normal(x.shape)).astype(np.float32)
        if np.ndim(x) == 1 else np.asarray(x, np.float32),
        tree,
    )


@pytest.fixture(scope="module")
def mcfg(cfg):
    return cfg.mapper.replace(residual_layer_num=L, residual_channels=C, conditioner_size=C)


@pytest.fixture(scope="module")
def den_params(mcfg):
    model = JaxDenoiser(mcfg, compute_dtype=jnp.float32)
    params = fast_random_params(
        lambda: model.init(jax.random.PRNGKey(0), jnp.zeros((1, T, mcfg.n_mel)),
                           jnp.zeros((1, T, C)), jnp.zeros((1, 1), jnp.int32)),
        seed=3,
    )["params"]
    return randomize_vectors(params, np.random.default_rng(4))


@pytest.fixture(scope="module")
def port_den(mcfg, den_params):
    return load_jax_params(DiffSVCDenoiser(HParams(**mcfg.to_dict()), torch.float32), den_params)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((1, T, 100)).astype(np.float32)
    cond = rng.standard_normal((1, T, C)).astype(np.float32)
    return x, cond


@pytest.mark.parametrize("t_step", [0, 7])
def test_eager_denoiser_matches_jax(mcfg, den_params, port_den, inputs, t_step):
    x, cond = inputs
    ref = JaxDenoiser(mcfg, compute_dtype=jnp.float32).apply(
        {"params": den_params}, jnp.asarray(x), jnp.asarray(cond), jnp.full((1, 1), t_step, jnp.int32)
    )
    with torch.no_grad():
        got = port_den(torch.from_numpy(x), torch.from_numpy(cond), torch.full((1, 1), t_step))
    assert np.abs(got.numpy() - np.asarray(ref)).max() < 5e-4


def test_precompute_matches_jax(mcfg, den_params, port_den, inputs):
    _, cond = inputs
    pre = jax_precompute(den_params, jnp.asarray(cond), STEPS, mcfg, jnp.float32)
    with torch.no_grad():
        cond_projs, step_rows = port_den.precompute(torch.from_numpy(cond), STEPS, torch.float32)
    np.testing.assert_allclose(cond_projs.numpy(), np.asarray(pre.cond_projs), atol=1e-5)
    np.testing.assert_allclose(step_rows.numpy(), np.asarray(pre.step_rows), atol=1e-5)


def _jax_kernel_operands(mcfg, den_params, cond):
    pre = jax_precompute(den_params, jnp.asarray(cond), STEPS, mcfg, jnp.float32)
    stacked = jax_step.stack_denoiser_params(den_params, mcfg, jnp.float32)
    condb = jnp.swapaxes(pre.cond_projs + stacked.b1[:, None, None, :], 0, 1)
    cfg_key = (L, mcfg.dilation_cycle_length, C, mcfg.n_mel, T)
    return pre, stacked, condb, cfg_key


def _port_kernel_operands(port_den, cond):
    with torch.no_grad():
        cond_projs, step_rows = port_den.precompute(torch.from_numpy(cond), STEPS, torch.float32)
        st = denoiser_step.stack_denoiser_params(port_den, torch.float32)
        condb = denoiser_step.fold_conditioner(port_den, cond_projs, torch.float32)
    return st, condb, step_rows


@pytest.mark.parametrize("i_step", [0, 5, STEPS - 1])
def test_plain_k1_step_matches_pallas_interpret(mcfg, den_params, port_den, inputs, i_step):
    """Plain K1 (L=4, C=128, T=64) vs _ddpm_step_pallas(interpret=True), <= 5e-4."""
    x, cond = inputs
    rng = np.random.default_rng(6 + i_step)
    xp = np.zeros((1, T, 128), np.float32)
    zp = np.zeros((1, T, 128), np.float32)
    xp[..., :100] = x
    zp[..., :100] = rng.standard_normal((1, T, 100))
    sched = DiffusionSchedule.from_factors([0.0001, 0.02, STEPS])
    srow = denoiser_step.schedule_rows(sched)[i_step]
    t = STEPS - 1 - i_step
    pre, stacked, condb, cfg_key = _jax_kernel_operands(mcfg, den_params, cond)
    ref = jax_step._ddpm_step_pallas(stacked, condb, pre.step_rows[t], jnp.asarray(xp), jnp.asarray(zp),
                                     jnp.asarray(srow), cfg_key, interpret=True)
    st, condb_t, step_rows = _port_kernel_operands(port_den, cond)
    with torch.no_grad():
        got = denoiser_step.ddpm_step(st, condb_t, step_rows[t], torch.from_numpy(xp),
                                      torch.from_numpy(zp), srow)
    assert np.abs(got.numpy() - np.asarray(ref)).max() <= 5e-4
    assert np.all(got.numpy()[..., 100:] == 0.0)  # pad lanes stay zero


def _jax_fused_noise(key, shape, steps):
    """The draws of _ddpm_sample_fused / ddpm_sample for ``key``."""
    key, init_key = jax.random.split(key)
    x_t = INIT_NOISE_STD * jax.random.normal(init_key, shape, dtype=jnp.float32)
    zs = np.stack([np.asarray(jax.random.normal(k, shape, dtype=jnp.float32))
                   for k in jax.random.split(key, steps)])
    return torch.from_numpy(np.array(x_t)), torch.from_numpy(zs)


def test_fused_sampler_matches_pallas_interpret(mcfg, den_params, port_den, inputs):
    """10-step DDPM with injected noise vs _ddpm_sample_fused(interpret=True), <= 1e-3."""
    _, cond = inputs
    shape = (1, T, 100)
    key = jax.random.PRNGKey(11)
    jsched = JaxSchedule.from_factors([0.0001, 0.02, STEPS])
    pre, stacked, condb, cfg_key = _jax_kernel_operands(mcfg, den_params, cond)
    ref = jax_step._ddpm_sample_fused(stacked, condb, pre.step_rows, key, shape, jsched, cfg_key,
                                      interpret=True)
    sample = denoiser_step.make_fused_sampler(port_den, torch.from_numpy(cond), STEPS, torch.float32)
    with torch.no_grad():
        got = sample(DiffusionSchedule.from_factors([0.0001, 0.02, STEPS]), shape,
                     noise=_jax_fused_noise(key, shape, STEPS))
    assert np.abs(got.numpy() - np.asarray(ref)).max() <= 1e-3


def test_eager_sampler_matches_jax_ddpm_sample(mcfg, den_params, port_den, inputs):
    """Module-level DDPM (eager denoiser) vs the JAX scan sampler, same draws."""
    _, cond = inputs
    shape = (1, T, 100)
    key = jax.random.PRNGKey(12)
    jmodel = JaxDenoiser(mcfg, compute_dtype=jnp.float32)
    ref = jax_ddpm_sample(lambda x, c, t: jmodel.apply({"params": den_params}, x, c, t),
                          jnp.asarray(cond), key, shape, JaxSchedule.from_factors([0.0001, 0.02, STEPS]))
    with torch.no_grad():
        got = ddpm_sample(port_den, torch.from_numpy(cond), shape,
                          DiffusionSchedule.from_factors([0.0001, 0.02, STEPS]),
                          noise=_jax_fused_noise(key, shape, STEPS))
    assert np.abs(got.numpy() - np.asarray(ref)).max() <= 1e-3


def test_schedule_matches_jax():
    ours = DiffusionSchedule.from_factors([0.0001, 0.02, 1000])
    ref = JaxSchedule.from_factors([0.0001, 0.02, 1000])
    for name in ("sqrt_recip_alphas_cumprod", "sqrt_recipm1_alphas_cumprod", "posterior_mean_coef1",
                 "posterior_mean_coef2", "posterior_log_variance_clipped"):
        np.testing.assert_array_equal(getattr(ours, name), np.asarray(getattr(ref, name)))
    rows = denoiser_step.schedule_rows(ours)
    assert rows.shape == (1000, 5) and rows[-1, 4] == 0.0 and rows[0, 4] > 0.0


def test_condition_encoder_matches_jax(cfg):
    mcfg = cfg.mapper
    rng = np.random.default_rng(8)
    t_len = 40
    batch = {
        "content_whisper": rng.standard_normal((2, t_len, 1024)).astype(np.float32),
        "melody": np.where(rng.random((2, t_len)) < 0.2, 0.0, rng.uniform(60, 900, (2, t_len))).astype(np.float32),
        "loudness": rng.uniform(0, 1.6, (2, t_len)).astype(np.float32),
        "singer": np.array([[1], [7]], np.int32),
    }
    jmodel = JaxConditionEncoder(mcfg)
    params = fast_random_params(lambda: jmodel.init(jax.random.PRNGKey(0), {k: jnp.asarray(v) for k, v in batch.items()}),
                                seed=9)["params"]
    params = randomize_vectors(params, np.random.default_rng(10))
    ref = jmodel.apply({"params": params}, {k: jnp.asarray(v) for k, v in batch.items()})
    port = load_jax_params(ConditionEncoder(HParams(**mcfg.to_dict())), params)
    with torch.no_grad():
        got = port({k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
