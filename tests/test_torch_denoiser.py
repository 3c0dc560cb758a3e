"""PyTorch port vs the JAX package: condition encoder, DiffSVC denoiser, the
plain K1 step, and the DDPM samplers (f32, CPU, same weights and noise)."""

import ctypes
import re
from pathlib import Path

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
from svc_inference_pipeline_tpu_torch.ops.pallas import _build, denoiser_step
from svc_inference_pipeline_tpu_torch.sampling.ddpm import ddpm_sample
from svc_inference_pipeline_tpu_torch.sampling.schedule import DiffusionSchedule

L, C, T, STEPS = 4, 128, 64, 10


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this module runs: the suite runs in several
    worker processes at once, and PyTorch's thread pools, each as wide as the
    machine, slow one another down many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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


def test_step_timescales_equal_jax_bit_for_bit():
    """The step embedding's timescales come from a host table equal to JAX's
    f32 pow on the CPU bit for bit, whatever the device, so the sines'
    arguments t * timescale of every DDPM step are JAX's bit for bit (the
    sines themselves are two libraries' f32 sin, within 2 ulps)."""
    from svc_inference_pipeline_tpu.models.diffsvc import step_embedding as jax_step_embedding
    from svc_inference_pipeline_tpu_torch.models.diffsvc import step_embedding, step_timescales

    half = 64
    want = np.asarray(10.0 ** (jnp.arange(half, dtype=jnp.float32) * 4.0 / (half - 1)))
    np.testing.assert_array_equal(step_timescales(half), want)
    ts = np.arange(1000, dtype=np.float32)
    np.testing.assert_array_equal(ts[:, None] * step_timescales(half), np.asarray(jnp.asarray(ts)[:, None] * want))
    np.testing.assert_allclose(step_embedding(torch.from_numpy(ts)).numpy(),
                               np.asarray(jax_step_embedding(jnp.asarray(ts), 128)), rtol=0, atol=2.4e-7)


def test_wgmma_matmul_models_the_tiles_sums():
    """``wgmma_matmul`` (the int8 plain version's bf16 products, summed as
    the kernel's wgmma tile sums them): exact where every term is exact,
    within f32 rounding of the exact product, and its truncation shows: an
    accumulator of 1 plus a later chunk's 3 * 2^-25 stays 1, where a sum
    rounded to nearest gives 1 + 2^-23."""
    ints = torch.randint(-8, 9, (5, 48)).float()
    w = torch.randint(-8, 9, (48, 7)).float()
    np.testing.assert_array_equal(denoiser_step.wgmma_matmul(ints, w).numpy(), (ints @ w).numpy())
    a = torch.randn(64, 384, generator=torch.Generator().manual_seed(0)).bfloat16().float()
    b = torch.randn(384, 96, generator=torch.Generator().manual_seed(1)).bfloat16().float()
    exact = a.double() @ b.double()
    got = denoiser_step.wgmma_matmul(a, b).double()
    assert ((got - exact).abs() <= 1e-5 * exact.abs().max()).all()
    a1 = torch.zeros(1, 32)
    a1[0, 0], a1[0, 16] = 1.0, 3 * 2.0 ** -13
    w1 = torch.zeros(32, 1)
    w1[0, 0], w1[16, 0] = 1.0, 2.0 ** -12
    assert float(denoiser_step.wgmma_matmul(a1, w1)) == 1.0
    assert float((a1.double() @ w1.double()).float()) == 1.0 + 2.0 ** -23


def test_forward_plain_traces_the_int8_codes():
    """``forward_plain``'s trace: each layer's input h, and on an int8 stack
    the conv input's scale and codes, the codes within [-127, 127] and one
    of them at +-127 in each clip (the clip's abs max)."""
    g = torch.Generator().manual_seed(2)
    cfg = HParams(residual_channels=64, residual_layer_num=3, n_mel=100, conditioner_size=64,
                  diffusion_fc_size=128, dilation_cycle_length=4, residual_kernel_size=3)
    den = DiffSVCDenoiser(cfg, torch.bfloat16)
    with torch.no_grad():
        for p in den.parameters():
            p.copy_(torch.randn(p.shape, generator=g) / (p.shape[-1] ** 0.5 if p.dim() > 1 else 10))
        den = den.to(torch.bfloat16)
        cond = torch.randn((2, 16, 64), generator=g)
        cp, rows = den.precompute(cond, 10, torch.bfloat16)
        st = denoiser_step.stack_denoiser_params(den, torch.bfloat16, "int8-w1")
        condb = denoiser_step.fold_conditioner(den, cp, torch.bfloat16)
    x = torch.nn.functional.pad(torch.randn((2, 16, 100), generator=g), (0, 28))
    trace = []
    eps = denoiser_step.forward_plain(st, condb, rows[3], x, trace)
    assert len(trace) == 3 and torch.isfinite(eps).all()
    for layer in trace:
        assert layer["yq"].abs().max() <= 127 and layer["s_y"].shape == (2, 1, 1)
        assert all(float(layer["yq"][i].abs().max()) == 127.0 for i in range(2))
    f32 = denoiser_step.forward_plain(st, condb, rows[3], x, kernel_order=False)
    assert (eps - f32).abs().max() <= 2e-2 * f32.abs().max()


def _small_stack(quantize, c=64, layers=3):
    g = torch.Generator().manual_seed(2)
    cfg = HParams(residual_channels=c, residual_layer_num=layers, n_mel=100, conditioner_size=c,
                  diffusion_fc_size=128, dilation_cycle_length=4, residual_kernel_size=3)
    den = DiffSVCDenoiser(cfg, torch.bfloat16).to(torch.bfloat16)
    with torch.no_grad():
        cp, rows = den.precompute(torch.randn((1, 16, c), generator=g), 10, torch.bfloat16)
        return (denoiser_step.stack_denoiser_params(den, torch.bfloat16, quantize),
                denoiser_step.fold_conditioner(den, cp, torch.bfloat16), rows)


def _reported(quantize, calls, layers):
    """What ``calls`` K1/K5 calls on a stack of ``layers`` layers add to the
    C entry points' ``launched`` ints: on a bf16 stack L + 3 launches, L of
    them the fused layer and 3 on the narrow prefetching tile; on an int8 one
    2L + 3 launches on its ring and s8 tiles."""
    launched = denoiser_step._launch_report()
    if quantize is None:
        launched[:] = [calls * (layers + 3), calls * layers, calls * 3, 6]
    else:
        launched[:] = [calls * (2 * layers + 3), 0, 0, 0]
    return launched


@pytest.mark.parametrize("quantize", [None, "int8-w1", "int8"])
def test_launch_counter_counts_2l_plus_3_launches_a_call(quantize):
    """``denoiser/launches`` adds the kernel launches that the C entry points
    report for K1 or K5 calls: L + 3 a call on a bf16 stack (one fused
    launch a layer), 2L + 3 on an int8 stack (the gate and the residual)."""
    from svc_inference_pipeline_tpu_torch.utils.observability import Metrics

    counters = Metrics.default().counters
    before = counters["denoiser/launches"]
    denoiser_step._count_launches(_reported(quantize, 7, 3))
    assert counters["denoiser/launches"] - before == 7 * (3 + 3 if quantize is None else 2 * 3 + 3)


@pytest.mark.parametrize("quantize", [None, "int8-w1", "int8"])
def test_fused_layers_counter_counts_the_bf16_layers(quantize):
    """``denoiser/fused_layers`` adds the fused layer launches that the C
    entry points report: L for each K1 or K5 call on a bf16 stack, nothing
    on an int8 stack, whose gate and residual stay two launches."""
    from svc_inference_pipeline_tpu_torch.utils.observability import Metrics

    counters = Metrics.default().counters
    before = counters["denoiser/fused_layers"]
    denoiser_step._count_launches(_reported(quantize, 7, 3))
    assert counters["denoiser/fused_layers"] - before == (7 * 3 if quantize is None else 0)


@pytest.mark.parametrize("quantize", [None, "int8-w1", "int8"])
def test_launched_tiles_reads_what_the_entry_points_report(quantize):
    """``launched_tiles(run)`` gives the K1/K5 launches by kernel that the C
    entry points reported while ``run`` ran: 7 bf16 calls at L = 3 launched
    21 of the fused layer and 21 on the narrow prefetching tile; int8 calls
    launch neither kernel."""
    denoiser_step._count_launches(_reported(None, 2, 3))  # before the run: not counted
    out, tiles = denoiser_step.launched_tiles(lambda: denoiser_step._count_launches(_reported(quantize, 7, 3)))
    assert out is None
    assert tiles == ({"PfShape<6>": 21, "layer": 21} if quantize is None else {})


def test_fused_sampler_refuses_fewer_step_rows_than_steps():
    """The sampler reads step row k for each of its steps: a schedule longer
    than the step rows made for it is refused before any step runs."""
    st, condb, rows = _small_stack(None)
    with pytest.raises(ValueError, match="10 step rows for 20 steps"):
        denoiser_step.ddpm_sample_fused(st, condb, rows, DiffusionSchedule.from_factors([1e-4, 0.02, 20]),
                                        (1, 16, 100))


def _c_params(name):
    """The kinds ("p" pointer, "i" int, "f" float) of the parameters of the C
    entry point ``name`` as ``csrc/*.cu`` defines it, macros of parameters
    expanded."""
    csrc = Path(_build.__file__).resolve().parents[2] / "csrc"
    src = "\n".join(p.read_text() for p in sorted(csrc.glob("*.cu")))
    macros = {m.group(1): m.group(2).replace("\\\n", " ")
              for m in re.finditer(r"#define (SVC_\w+_PARAMS)\s+((?:.*\\\n)*.*)", src)}
    head = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", src)
    assert head is not None, name
    params = head.group(1)
    for key, body in macros.items():
        params = params.replace(key, body)
    kinds = []
    for p in params.split(","):
        p = p.strip()
        kinds.append("p" if "*" in p else "f" if p.startswith("float") else "i")
    return kinds


@pytest.mark.parametrize("name", sorted(_build._SIGNATURES))
def test_c_entry_points_take_the_bound_arguments(name):
    """The ctypes signature each C entry point is bound with has the
    parameters its definition takes, one for one: a pointer, an int or a
    float in each place (a missing one shifts every argument after it)."""
    kinds = {ctypes.c_void_p: "p", ctypes.c_int: "i", ctypes.c_float: "f"}
    assert [kinds[t] for t in _build._SIGNATURES[name]] == _c_params(name)


def test_bf16_tile_refuses_widths_past_its_resident_k():
    """The prefetching tiles hold K up to 512: a bf16 stack of 512 channels
    (the wide tile) passes the check, the first width past it (576) is
    refused before any launch; an int8 stack of that width is not (its
    tiles take C up to 1024)."""
    assert denoiser_step.BF16_MAX_K == 512
    x = torch.zeros((1, 16, 128))
    st, condb, rows = _small_stack(None, c=512, layers=1)
    denoiser_step._check_cuda_args("ddpm_step", st, condb, rows[3], x)
    for quantize in (None, "int8-w1"):
        st, condb, rows = _small_stack(quantize, c=576, layers=1)
        if quantize is None:
            with pytest.raises(ValueError, match="bf16 tile needs C, M_pad <= 512"):
                denoiser_step._check_cuda_args("ddpm_step", st, condb, rows[3], x)
        else:
            denoiser_step._check_cuda_args("ddpm_step", st, condb, rows[3], x)
