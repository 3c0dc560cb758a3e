"""PyTorch port vs the JAX package: the plain versions of K5 (the denoiser
forward returning eps) and K6 (its int8 matmuls, in K5 and in K1 form), the
int8 weight stacks, the int8 DDPM chain with a full-precision tail, the
int8-w1 quality gate, and the slice end to end (PLMS over int8-w1) —
f32 compute on the CPU, the JAX kernels in interpret mode.

Tolerances: f32 plain K5 against the interpret-mode kernel 5e-4, as for K1.
The int8 forms quantise y = h + step_row with rint; h comes out of f32
matmuls that XLA and PyTorch sum in different orders, so a value within an
f32 rounding of a .5 tie may quantise one step apart on the two sides.
The same holds for the int8 gate rint(g * 127), whose sigmoid and tanh
differ by ulps between the two libraries. A flip moves one int8 operand by
one step and the eps of a few frames with it: measured on these inputs,
int8-w1 agrees to 3.5e-7 of max|eps|, "int8" to 2.7e-3 (one gate flip in
5 of 64 frames). The int8 checks allow 1e-2 of max|eps| per batch element
and at most a quarter of the frames off by more than 1e-5 of it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svc_inference_pipeline_tpu.config import HParams as JaxHParams
from svc_inference_pipeline_tpu.models.bigvgan import vocoder_output_finalize
from svc_inference_pipeline_tpu.models.diffsvc import DiffSVCDenoiser as JaxDenoiser
from svc_inference_pipeline_tpu.models.diffsvc_fast import precompute as jax_precompute
from svc_inference_pipeline_tpu.ops.pallas import denoiser_step as jax_step
from svc_inference_pipeline_tpu.pipeline.convert import SVCPipeline as JaxPipeline
from svc_inference_pipeline_tpu.sampling.ddpm import INIT_NOISE_STD
from svc_inference_pipeline_tpu.sampling.plms import plms_sample as jax_plms
from svc_inference_pipeline_tpu.sampling.schedule import DiffusionSchedule as JaxSchedule
from svc_inference_pipeline_tpu.utils.devices import fast_random_params
from svc_inference_pipeline_tpu_torch.checkpoints.from_jax import load_jax_params
from svc_inference_pipeline_tpu_torch.config import HParams
from svc_inference_pipeline_tpu_torch.models.diffsvc import DiffSVCDenoiser
from svc_inference_pipeline_tpu_torch.models.whisper import WHISPER_SIZES
from svc_inference_pipeline_tpu_torch.ops.pallas import denoiser_step
from svc_inference_pipeline_tpu_torch.pipeline.convert import SVCPipeline
from svc_inference_pipeline_tpu_torch.sampling.schedule import DiffusionSchedule

L, C, T, STEPS = 5, 128, 64, 10
FACTORS = [0.0001, 0.02, STEPS]
INT8_TOL = 1e-2  # x max|eps|, see the module docstring


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this module runs: the suite runs in several
    worker processes at once, and PyTorch's thread pools, each as wide as the
    machine, slow one another down many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _random_params(mcfg, t_len, seed):
    model = JaxDenoiser(mcfg, compute_dtype=jnp.float32)
    params = fast_random_params(
        lambda: model.init(jax.random.PRNGKey(0), jnp.zeros((1, t_len, mcfg.n_mel)),
                           jnp.zeros((1, t_len, mcfg.conditioner_size)), jnp.zeros((1, 1), jnp.int32)),
        seed=seed)["params"]
    rng = np.random.default_rng(seed + 1)
    return jax.tree_util.tree_map(  # random 1-D leaves: the init zeroes them
        lambda x: (0.1 * rng.standard_normal(x.shape)).astype(np.float32) if np.ndim(x) == 1
        else np.asarray(x, np.float32), params)


@pytest.fixture(scope="module")
def setup(cfg):
    mcfg = cfg.mapper.replace(residual_layer_num=L, residual_channels=C, conditioner_size=C)
    params = _random_params(mcfg, T, 31)
    port = load_jax_params(DiffSVCDenoiser(HParams(**mcfg.to_dict()), torch.float32), params)
    return mcfg, params, port


def _cond(b, seed=32):
    return np.random.default_rng(seed).standard_normal((b, T, C)).astype(np.float32)


def _x(b, seed=33):
    """[b, T, 100] with element i scaled by 8^i: the second element's int8
    scale is ~8x the first's, which a single scale over the batch would miss."""
    x = np.random.default_rng(seed).standard_normal((b, T, 100)).astype(np.float32)
    return x * (8.0 ** np.arange(b, dtype=np.float32))[:, None, None]


def _jax_operands(mcfg, params, cond, quantize):
    pre = jax_precompute(params, jnp.asarray(cond), STEPS, mcfg, jnp.float32)
    stacked = jax_step.stack_denoiser_params(params, mcfg, jnp.float32, quantize=quantize)
    condb = jnp.swapaxes(pre.cond_projs + stacked.b1[:, None, None, :], 0, 1)
    return pre, stacked, condb, (L, mcfg.dilation_cycle_length, C, mcfg.n_mel, T)


def _port_operands(port, cond, quantize):
    with torch.no_grad():
        cond_projs, step_rows = port.precompute(torch.from_numpy(cond), STEPS, torch.float32)
        st = denoiser_step.stack_denoiser_params(port, torch.float32, quantize)
        condb = denoiser_step.fold_conditioner(port, cond_projs, torch.float32)
    return st, condb, step_rows


@pytest.mark.parametrize("quantize", ["int8", "int8-w1"])
def test_int8_stacks_match_jax(setup, quantize):
    """q equal to JAX's, scales within 1 f32 ulp; int8-w1 keeps wout in f32."""
    mcfg, params, port = setup
    ref = jax_step.stack_denoiser_params(params, mcfg, jnp.float32, quantize=quantize)
    st = denoiser_step.stack_denoiser_params(port, torch.float32, quantize)
    assert st.w1.dtype == torch.int8 and st.mode == quantize
    np.testing.assert_array_equal(st.w1.numpy(), np.asarray(ref.w1))
    np.testing.assert_array_max_ulp(st.w1s.numpy(), np.asarray(ref.w1s)[:, 0], maxulp=1)
    if quantize == "int8":
        np.testing.assert_array_equal(st.wout.numpy(), np.asarray(ref.wout))
        np.testing.assert_array_max_ulp(st.wouts.numpy(), np.asarray(ref.wouts)[:, 0], maxulp=1)
    else:
        assert st.wouts is None and st.wout.dtype == torch.float32
        np.testing.assert_array_equal(st.wout.numpy(), np.asarray(ref.wout))
    with pytest.raises(ValueError, match="quantize mode"):
        denoiser_step.stack_denoiser_params(port, torch.float32, "int4")


@pytest.mark.parametrize("t_step", [0, 7])
def test_plain_k5_matches_pallas_interpret(setup, t_step):
    """Plain K5 (L=5, C=128, T=64, f32) vs _denoise_pallas(interpret=True), <= 5e-4."""
    mcfg, params, port = setup
    cond, x = _cond(1), _x(1)
    pre, stacked, condb, cfg_key = _jax_operands(mcfg, params, cond, None)
    ref = jax_step._denoise_pallas(stacked, condb, pre.step_rows[t_step], jnp.asarray(x), cfg_key,
                                   interpret=True)
    st, condb_t, step_rows = _port_operands(port, cond, None)
    with torch.no_grad():
        got = denoiser_step.denoise(st, condb_t, step_rows[t_step], torch.from_numpy(x))
    assert got.shape == x.shape and got.dtype == torch.float32
    assert np.abs(got.numpy() - np.asarray(ref)).max() <= 5e-4


def _int8_close(got, ref, one_call=True):
    """Per batch element: max|got - ref| <= INT8_TOL x max|ref|; for one
    forward also at most a quarter of the frames off by more than 1e-5 x
    max|ref| (a tie flip reaches a few frames through the dilated convs, a
    wrong scale all of them; over a chain of steps a flip spreads further)."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    for g, r in zip(got, ref):
        err, top = np.abs(g - r), np.abs(r).max()
        assert err.max() <= INT8_TOL * top, err.max() / top
        assert not one_call or np.mean(err.max(axis=-1) > 1e-5 * top) <= 0.25


@pytest.mark.parametrize("quantize", ["int8", "int8-w1"])
@pytest.mark.parametrize("b", [1, 2])
def test_plain_k6_k5_form_matches_pallas_interpret(setup, quantize, b):
    mcfg, params, port = setup
    cond, x = _cond(b), _x(b)
    pre, stacked, condb, cfg_key = _jax_operands(mcfg, params, cond, quantize)
    ref = jax_step._denoise_pallas(stacked, condb, pre.step_rows[4], jnp.asarray(x), cfg_key, interpret=True)
    st, condb_t, step_rows = _port_operands(port, cond, quantize)
    with torch.no_grad():
        got = denoiser_step.denoise(st, condb_t, step_rows[4], torch.from_numpy(x))
    _int8_close(got.numpy(), ref)


@pytest.mark.parametrize("quantize", ["int8", "int8-w1"])
@pytest.mark.parametrize("b", [1, 2])
def test_plain_k6_ddpm_form_matches_pallas_interpret(setup, quantize, b):
    """One fused DDPM step on the int8 stack, held on x' - s3 x - s4 z (eps
    scaled by s2 s1c)."""
    mcfg, params, port = setup
    cond = _cond(b)
    xp = np.zeros((b, T, 128), np.float32)
    zp = np.zeros((b, T, 128), np.float32)
    xp[..., :100] = _x(b)
    zp[..., :100] = np.random.default_rng(34).standard_normal((b, T, 100))
    srow = (0.0, -1.0 / 16.0, 16.0, 0.5, 0.5)  # x' = eps + x/2 + z/2 for |eps| < 16
    pre, stacked, condb, cfg_key = _jax_operands(mcfg, params, cond, quantize)
    ref = jax_step._ddpm_step_pallas(stacked, condb, pre.step_rows[4], jnp.asarray(xp), jnp.asarray(zp),
                                     jnp.asarray(srow, jnp.float32), cfg_key, interpret=True)
    st, condb_t, step_rows = _port_operands(port, cond, quantize)
    with torch.no_grad():
        got = denoiser_step.ddpm_step(st, condb_t, step_rows[4], torch.from_numpy(xp), torch.from_numpy(zp), srow)
    _int8_close(got.numpy() - 0.5 * xp - 0.5 * zp, np.asarray(ref) - 0.5 * xp - 0.5 * zp)
    assert np.all(got.numpy()[..., 100:] == 0.0)


def _jax_fused_noise(key, shape, steps):
    key, init_key = jax.random.split(key)
    x_t = INIT_NOISE_STD * jax.random.normal(init_key, shape, dtype=jnp.float32)
    zs = np.stack([np.asarray(jax.random.normal(k, shape, dtype=jnp.float32))
                   for k in jax.random.split(key, steps)])
    return torch.from_numpy(np.array(x_t)), torch.from_numpy(zs)


def test_quantize_tail_full_equals_unquantized(setup):
    """tail == steps runs every step on the full-precision stack: the chain
    equals quantize=None exactly."""
    _mcfg, _params, port = setup
    cond = torch.from_numpy(_cond(1))
    sched = DiffusionSchedule.from_factors(FACTORS)
    noise = _jax_fused_noise(jax.random.PRNGKey(5), (1, T, 100), STEPS)
    with torch.no_grad():
        ref = denoiser_step.make_denoise_fn(port, cond, STEPS, torch.float32).fused_ddpm(sched, (1, T, 100),
                                                                                       noise=noise)
        got = denoiser_step.make_denoise_fn(port, cond, STEPS, torch.float32, "int8", STEPS).fused_ddpm(
            sched, (1, T, 100), noise=noise)
    assert torch.equal(got, ref)


@pytest.mark.parametrize("quantize", ["int8", "int8-w1"])
def test_partial_tail_matches_jax(setup, quantize):
    """10-step int8 DDPM whose last 4 steps run unquantised, against
    _ddpm_sample_fused(stacked_fp=..., tail=4) in interpret mode."""
    mcfg, params, port = setup
    cond = _cond(1)
    shape = (1, T, 100)
    key = jax.random.PRNGKey(17)
    pre, stacked, condb, cfg_key = _jax_operands(mcfg, params, cond, quantize)
    stacked_fp = jax_step.stack_denoiser_params(params, mcfg, jnp.float32)
    ref = jax_step._ddpm_sample_fused(stacked, condb, pre.step_rows, key, shape, JaxSchedule.from_factors(FACTORS),
                                      cfg_key, interpret=True, stacked_fp=stacked_fp, tail=4)
    fn = denoiser_step.make_denoise_fn(port, torch.from_numpy(cond), STEPS, torch.float32, quantize, 4)
    with torch.no_grad():
        got = fn.fused_ddpm(DiffusionSchedule.from_factors(FACTORS), shape,
                            noise=_jax_fused_noise(key, shape, STEPS))
    _int8_close(got.numpy(), ref, one_call=False)


def test_int8_w1_quality_gate(cfg):
    """int8-w1 keeps the 100-step DDPM chain's final mel at correlation
    >= 0.9999 with the f32 chain, at the shape of the JAX package's gate
    (L=6, C=384, T=64, every weight N(0, 0.05); same draws on both chains)."""
    mcfg = cfg.mapper.replace(residual_layer_num=6)
    model = JaxDenoiser(mcfg, compute_dtype=jnp.float32)
    params = fast_random_params(lambda: model.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 100)),
                                                   jnp.zeros((1, 64, 384)), jnp.zeros((1, 1), jnp.int32)))["params"]
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(lambda p: (rng.standard_normal(p.shape) * 0.05).astype(np.float32), params)
    port = load_jax_params(DiffSVCDenoiser(HParams(**mcfg.to_dict()), torch.float32), params)
    cond = torch.from_numpy(np.random.default_rng(1).standard_normal((1, 64, 384)).astype(np.float32))
    sched = DiffusionSchedule.from_factors([0.0001, 0.02, 100])

    def final_mel(quantize):
        fn = denoiser_step.make_denoise_fn(port, cond, 100, torch.float32, quantize)
        with torch.no_grad():
            return fn.fused_ddpm(sched, (1, 64, 100), generator=torch.Generator().manual_seed(3)).numpy()

    corr = np.corrcoef(final_mel("int8-w1").ravel(), final_mel(None).ravel())[0, 1]
    assert corr >= 0.9999, corr


def test_slice_plms_int8_w1_matches_jax(cfg):
    """The JAX SVCPipeline (tiny config, fused Pallas denoiser, PLMS@2 over
    int8-w1, f32) against the port built from the same weights, with the JAX
    key's x_T: _convert_core's waveform against the JAX modules applied one
    by one, and against the single-jit _core (see tests/test_torch_pipeline.py
    for why that one is looser)."""
    d = cfg.to_dict()
    d.update(compute_dtype="float32", use_pallas_denoiser=True, denoiser_quantize="int8-w1")
    d["mapper"].update(noise_schedule_factors=FACTORS, residual_layer_num=2, residual_channels=128,
                       sampler="plms", plms_speedup=2)
    d["vocoder"]["upsample_initial_channel"] = 64
    jpipe = JaxPipeline.from_config(JaxHParams(**d), random_weights=True, whisper_size="tiny")
    rng = np.random.default_rng(0)
    trees = [jax.tree_util.tree_map_with_path(
        lambda p, x: np.asarray(x, np.float32) if np.ndim(x) >= 2 or "scale" in str(p[-1])
        else (0.1 * rng.standard_normal(np.shape(x))).astype(np.float32), jax.device_get(t))
        for t in (jpipe.cond_params, jpipe.denoiser_params, jpipe.vocoder_params, jpipe.whisper.params)]
    jpipe.cond_params, jpipe.denoiser_params, jpipe.vocoder_params, jpipe.whisper.params = (
        jax.device_put(t) for t in trees)
    port = SVCPipeline.from_jax_params(HParams(**jpipe.cfg.to_dict()), *trees[:3], WHISPER_SIZES["tiny"],
                                       trees[3], device="cpu")
    assert (port.sampler, port.plms_speedup, port.denoiser_quantize) == ("plms", 2, "int8-w1")

    fs = 24000
    t = np.arange(int(1.0 * fs)) / fs
    clip = sum((0.3 / k) * np.sin(2 * np.pi * 220.0 * k * t) for k in range(1, 5)).astype(np.float32)
    jbatch, n_frames = jpipe.extract_features(clip, "svcc_CDF1")
    padded = jbatch["melody"].shape[1]
    shape = (1, padded, 100)
    key = jax.random.PRNGKey(3)
    n_true = jnp.asarray([n_frames], jnp.int32)
    core = np.asarray(jpipe._core(jpipe.cond_params, jpipe.denoiser_params, jpipe.vocoder_params, jbatch, key,
                                  n_true, n_frames=padded, sampler="plms", speedup=2))
    jcond = jpipe.cond_encoder.apply({"params": jpipe.cond_params}, jbatch)
    fn = jax_step.make_pallas_denoise_fn(jpipe.denoiser_params, jcond, STEPS, jpipe.cfg.mapper,
                                         compute_dtype=jnp.float32, interpret=True, quantize="int8-w1")
    mel_norm = jax_plms(fn, jcond, key, shape, jpipe.schedule, speedup=2)
    mel = (mel_norm + 1.0) / 2.0 * (jpipe._mel_max - jpipe._mel_min + 1e-12) + jpipe._mel_min
    wave = jpipe.vocoder.apply({"params": jpipe.vocoder_params}, mel)
    chain = np.asarray(vocoder_output_finalize(wave[..., : padded * 256], n_true, 256))

    x_t = torch.from_numpy(np.array(INIT_NOISE_STD * jax.random.normal(key, shape, dtype=jnp.float32)))
    batch = {k: torch.from_numpy(np.array(v)) for k, v in jbatch.items()}
    launches = denoiser_step.denoise.launches
    got = port._convert_core(batch, torch.tensor([n_frames]), padded, noise=x_t).numpy()
    assert denoiser_step.denoise.launches == launches  # CPU tensors: the plain version, no launch
    assert got.shape == chain.shape == core.shape == (1, padded * 256)
    assert np.abs(got - chain).max() <= 1e-3, np.abs(got - chain).max()
    # the single-jit core differs from the same JAX modules applied one by one
    # (0.126 on this input); the port must be no further from it than that
    drift = np.abs(chain - core).max()
    assert np.abs(got - core).max() <= drift + 1e-3 and np.corrcoef(got[0], core[0])[0, 1] >= 0.999
