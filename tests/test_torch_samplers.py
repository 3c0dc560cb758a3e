"""PyTorch port vs the JAX package: the fast samplers PLMS, DDIM and DPM++
over the eager denoiser (f32, CPU, same weights and the JAX key
discipline's draws), the DPM++ grid, the pipeline's sampler and int8
plumbing, the CLI with a fast sampler and int8, and the builders' device
defaults."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svc_inference_pipeline_tpu.models.diffsvc import DiffSVCDenoiser as JaxDenoiser
from svc_inference_pipeline_tpu.models.diffsvc_fast import make_fast_denoise_fn
from svc_inference_pipeline_tpu.sampling.ddim import ddim_sample as jax_ddim
from svc_inference_pipeline_tpu.sampling.ddpm import INIT_NOISE_STD
from svc_inference_pipeline_tpu.sampling.dpmpp import dpmpp_sample as jax_dpmpp
from svc_inference_pipeline_tpu.sampling.dpmpp import dpmpp_timesteps as jax_dpmpp_timesteps
from svc_inference_pipeline_tpu.sampling.plms import plms_sample as jax_plms
from svc_inference_pipeline_tpu.sampling.schedule import DiffusionSchedule as JaxSchedule
from svc_inference_pipeline_tpu.utils.devices import fast_random_params
from svc_inference_pipeline_tpu_torch.checkpoints.from_jax import load_jax_params
from svc_inference_pipeline_tpu_torch.config import HParams, load_config
from svc_inference_pipeline_tpu_torch.models.diffsvc import DiffSVCDenoiser
from svc_inference_pipeline_tpu_torch.models.whisper import WHISPER_SIZES
from svc_inference_pipeline_tpu_torch.ops.pallas import denoiser_step
from svc_inference_pipeline_tpu_torch.pipeline import content, convert
from svc_inference_pipeline_tpu_torch.sampling.ddim import ddim_sample
from svc_inference_pipeline_tpu_torch.sampling.dpmpp import dpmpp_sample, dpmpp_timesteps
from svc_inference_pipeline_tpu_torch.sampling.plms import plms_sample
from svc_inference_pipeline_tpu_torch.sampling.schedule import DiffusionSchedule
from svc_inference_pipeline_tpu_torch.utils import audio_io
from svc_inference_pipeline_tpu_torch.utils.devices import resolve_device

L, C, T, STEPS, SPEEDUP = 4, 128, 64, 50, 5
SHAPE = (1, T, 100)
FACTORS = [0.0001, 0.02, STEPS]
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


@pytest.fixture(scope="module")
def setup(cfg):
    mcfg = cfg.mapper.replace(residual_layer_num=L, residual_channels=C, conditioner_size=C)
    model = JaxDenoiser(mcfg, compute_dtype=jnp.float32)
    params = fast_random_params(
        lambda: model.init(jax.random.PRNGKey(0), jnp.zeros(SHAPE), jnp.zeros((1, T, C)),
                           jnp.zeros((1, 1), jnp.int32)), seed=13)["params"]
    rng = np.random.default_rng(14)
    params = jax.tree_util.tree_map(  # random 1-D leaves: the init zeroes them
        lambda x: (0.1 * rng.standard_normal(x.shape)).astype(np.float32) if np.ndim(x) == 1
        else np.asarray(x, np.float32), params)
    cond = np.random.default_rng(15).standard_normal((1, T, C)).astype(np.float32)
    jax_fn = make_fast_denoise_fn(params, jnp.asarray(cond), STEPS, mcfg, compute_dtype=jnp.float32)
    port = load_jax_params(DiffSVCDenoiser(HParams(**mcfg.to_dict()), torch.float32), params)
    return jax_fn, port, cond


def _x_t(key):
    return INIT_NOISE_STD * jax.random.normal(key, SHAPE, dtype=jnp.float32)


def _split_noise(key, n):
    """x_T and the per-step z of DDIM/DPM++: split first, x_T from the init key."""
    key, init_key = jax.random.split(key)
    zs = np.stack([np.asarray(jax.random.normal(k, SHAPE, dtype=jnp.float32))
                   for k in jax.random.split(key, n)])
    return torch.from_numpy(np.array(_x_t(init_key))), torch.from_numpy(zs)


def _check(got, ref):
    assert got.shape == ref.shape == SHAPE
    assert np.abs(got.numpy() - np.asarray(ref)).max() <= 1e-4


def test_plms_matches_jax(setup):
    """PLMS at s=5: warm-up with two evaluations, then orders 2-4; x_T from the key itself."""
    jax_fn, port, cond = setup
    key = jax.random.PRNGKey(21)
    ref = jax_plms(jax_fn, jnp.asarray(cond), key, SHAPE, JaxSchedule.from_factors(FACTORS), speedup=SPEEDUP)
    calls = []

    def counted(x, c, t):
        calls.append(int(t[0, 0]))
        return port(x, c, t)

    with torch.no_grad():
        got = plms_sample(counted, torch.from_numpy(cond), SHAPE, DiffusionSchedule.from_factors(FACTORS),
                          SPEEDUP, noise=torch.from_numpy(np.array(_x_t(key))))
    _check(got, ref)
    assert calls[:3] == [45, 40, 40] and calls[-1] == 0 and len(calls) == STEPS // SPEEDUP + 1


@pytest.mark.parametrize("eta", [0.0, 0.5])
def test_ddim_matches_jax(setup, eta):
    """DDIM at s=5 with the JAX draws, deterministic and stochastic."""
    jax_fn, port, cond = setup
    key = jax.random.PRNGKey(22)
    ref = jax_ddim(jax_fn, jnp.asarray(cond), key, SHAPE, JaxSchedule.from_factors(FACTORS),
                   speedup=SPEEDUP, eta=eta)
    with torch.no_grad():
        got = ddim_sample(port, torch.from_numpy(cond), SHAPE, DiffusionSchedule.from_factors(FACTORS),
                          SPEEDUP, eta=eta, noise=_split_noise(key, STEPS // SPEEDUP))
    _check(got, ref)


@pytest.mark.parametrize("order", [1, 2])
def test_dpmpp_matches_jax(setup, order):
    """DPM-Solver++ first order and 2M at s=5, x_T from the split key."""
    jax_fn, port, cond = setup
    key = jax.random.PRNGKey(23)
    ref = jax_dpmpp(jax_fn, jnp.asarray(cond), key, SHAPE, JaxSchedule.from_factors(FACTORS),
                    speedup=SPEEDUP, order=order)
    with torch.no_grad():
        got = dpmpp_sample(port, torch.from_numpy(cond), SHAPE, DiffusionSchedule.from_factors(FACTORS),
                           SPEEDUP, order=order, noise=_split_noise(key, 1)[0])
    _check(got, ref)


@pytest.mark.parametrize("num_steps,speedup", [(1000, 1), (1000, 10), (1000, 37), (1000, 999), (50, 3), (7, 100)])
def test_dpmpp_grid_matches_jax(num_steps, speedup):
    np.testing.assert_array_equal(dpmpp_timesteps(num_steps, speedup), jax_dpmpp_timesteps(num_steps, speedup))


def _tiny_cfg_dict():
    d = load_config(CONFIG).to_dict()
    for k in ("singer_file", "min_mel_file", "max_mel_file", "target_f0_file"):
        d[k] = os.path.join(REPO, d[k].lstrip("./"))
    d["mapper"].update(noise_schedule_factors=[0.0001, 0.02, 20], residual_layer_num=2, residual_channels=64)
    d["vocoder"]["upsample_initial_channel"] = 64
    return d


def test_pipeline_sampler_and_quantize_plumbing():
    """Config defaults, per-call overrides, validation, and that every
    sampler and int8 mode runs through _convert_core on the CPU."""
    d = _tiny_cfg_dict()
    d["mapper"].update(sampler="plms", plms_speedup=4)
    d.update(denoiser_quantize="int8-w1", denoiser_quantize_tail=3)
    pipe = convert.SVCPipeline.from_config(HParams(**d), random_weights=True, device="cpu")
    assert (pipe.sampler, pipe.plms_speedup) == ("plms", 4)
    assert (pipe.denoiser_quantize, pipe.denoiser_quantize_tail) == ("int8-w1", 3)
    assert pipe._resolve_sampler(None, None) == ("plms", 4)
    assert pipe._resolve_sampler("ddpm", 7) == ("ddpm", 1)
    assert pipe._resolve_sampler("dpmpp", 2) == ("dpmpp", 2)
    for bad in (("euler", None), ("ddim", 0)):
        with pytest.raises(ValueError):
            pipe._resolve_sampler(*bad)
    with pytest.raises(ValueError):
        pipe.set_sampler("euler")
    with pytest.raises(ValueError, match="denoiser_quantize"):
        pipe.set_quantize("int4")
    with pytest.raises(ValueError, match="denoiser_quantize"):
        convert.SVCPipeline.from_config(HParams(**dict(d, denoiser_quantize="fp8")), random_weights=True,
                                        device="cpu")
    t = np.arange(12000) / 24000
    wav = (0.3 * np.sin(2 * np.pi * 220 * t)).astype(np.float32)
    outs = {}
    for sampler, quantize in (("plms", "int8-w1"), ("ddim", None), ("dpmpp", "int8"), ("ddpm", "int8")):
        pipe.set_quantize(quantize, 3)
        outs[sampler] = pipe.convert(wav, "svcc_CDF1", generator=torch.Generator().manual_seed(0),
                                     sampler=sampler)
        assert outs[sampler].shape == (46 * 256,) and np.isfinite(outs[sampler]).all()
    assert not np.array_equal(outs["plms"], outs["ddim"])


@pytest.mark.parametrize("quantize,tail", [(None, 0), ("int8-w1", 0), ("int8", 3)])
def test_pipeline_makes_weight_stacks_once(monkeypatch, quantize, tail):
    """set_quantize makes the kernels' weight stacks (the unquantised one
    only for an int8 mode with a DDPM tail); a conversion makes none and
    gives what stacks made inside the conversion give."""
    pipe = convert.SVCPipeline.from_config(HParams(**_tiny_cfg_dict()), random_weights=True, device="cpu")
    pipe.set_quantize(quantize, tail)
    st, st_fp = pipe._stacks
    assert st.mode == (quantize or "bf16") and (st_fp is not None) == (tail > 0)
    made = []
    stack = denoiser_step.stack_denoiser_params
    monkeypatch.setattr(denoiser_step, "stack_denoiser_params", lambda *a: made.append(a[2:]) or stack(*a))
    wav = (0.3 * np.sin(2 * np.pi * 220 * np.arange(12000) / 24000)).astype(np.float32)

    def run():
        return pipe.convert(wav, "svcc_CDF1", generator=torch.Generator().manual_seed(0), sampler="ddpm")

    got = run()
    assert made == []
    pipe._stacks = None  # make_denoise_fn then makes them itself
    ref = run()
    assert made == [(quantize,)] + [()] * (tail > 0)
    np.testing.assert_array_equal(got, ref)


def test_cli_fast_sampler_int8_writes_wav_on_cpu(tmp_path):
    (tmp_path / "cfg.json").write_text(json.dumps(_tiny_cfg_dict()))
    t = np.arange(30000) / 24000
    audio_io.write_wav(str(tmp_path / "in.wav"), 0.4 * np.sin(2 * np.pi * 200 * t), 24000)
    from svc_inference_pipeline_tpu_torch import cli

    built = {}
    rc = cli.main(["--config", str(tmp_path / "cfg.json"), "--input", str(tmp_path / "in.wav"),
                   "--singer", "svcc_CDF1", "--output", str(tmp_path / "out.wav"), "--random-weights",
                   "--device", "cpu", "--sampler", "plms", "--speedup", "5", "--quantize", "int8-w1",
                   "--quantize-tail", "2"], built=built)
    assert rc == 0
    pipe = built["pipeline"]
    assert (pipe.sampler, pipe.plms_speedup, pipe.denoiser_quantize, pipe.denoiser_quantize_tail) == (
        "plms", 5, "int8-w1", 2)
    samples, sr = audio_io.read_wav(str(tmp_path / "out.wav"))
    assert sr == 24000 and len(samples) == convert.mel_frame_count(load_config(CONFIG), 30000) * 256 + 2 * 1200


def test_builders_default_to_the_gpu(monkeypatch):
    """device=None resolves to cuda in the three builders (spied: the spy
    records the request and hands back the CPU, so no GPU is needed)."""
    assert resolve_device(None).type == "cuda"
    asked = []

    def spy(name):
        asked.append(name)
        return torch.device("cpu")

    monkeypatch.setattr(content, "resolve_device", spy)
    monkeypatch.setattr(convert, "resolve_device", spy)
    monkeypatch.setattr(content, "load_jax_params", lambda module, tree: module)
    monkeypatch.setattr(convert, "load_jax_params", lambda module, tree: module)
    dims = WHISPER_SIZES["tiny"]
    content.WhisperPPGExtractor.random_init(dims, compute_dtype=torch.float32)
    content.WhisperPPGExtractor.from_jax_params(dims, {})
    pipe = convert.SVCPipeline.from_jax_params(HParams(**_tiny_cfg_dict()), {}, {}, {}, dims, {})
    # the pipeline resolves its device once and hands the result to the encoder's builder
    assert asked == [None, None, None, torch.device("cpu")] and pipe.device.type == "cpu"
