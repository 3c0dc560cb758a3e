"""Diffusion training in the port against the JAX package: q_sample,
predict_start_from_noise and the training loss given JAX's draws, one and
two train steps (loss, gradients, parameters after AdamW, EMA) from the same
weights, the loop's checkpoint and bit-exact resume, the non-finite guard,
the pre-EMA migration, and the kernels' weight copies after a change of
weights (f32, CPU; tiny mapper)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from svc_inference_pipeline_tpu.config import HParams as JaxHParams
from svc_inference_pipeline_tpu.models.diffsvc import DiffSVCDenoiser as JaxDenoiser
from svc_inference_pipeline_tpu.models.encoder import ConditionEncoder as JaxEncoder
from svc_inference_pipeline_tpu.sampling import ddpm as jddpm
from svc_inference_pipeline_tpu.sampling.schedule import DiffusionSchedule as JaxSchedule
from svc_inference_pipeline_tpu.training.diffusion import (
    init_diffusion_train_state as jax_init,
    make_diffusion_train_step as jax_make_step,
)
from svc_inference_pipeline_tpu.utils import artifacts as jart
from svc_inference_pipeline_tpu_torch.checkpoints.from_jax import jax_tree_to_torch, train_state_from_jax
from svc_inference_pipeline_tpu_torch.checkpoints.native_io import save_checkpoint
from svc_inference_pipeline_tpu_torch.config import HParams
from svc_inference_pipeline_tpu_torch.sampling.ddpm import ddpm_training_loss
from svc_inference_pipeline_tpu_torch.sampling.schedule import DiffusionSchedule
from svc_inference_pipeline_tpu_torch.training import (
    DiffusionTrainState,
    init_diffusion_train_state,
    make_diffusion_train_step,
)
from svc_inference_pipeline_tpu_torch.training.loop import state_dict_of, train_diffusion
from svc_inference_pipeline_tpu_torch.utils import artifacts

LR = 1e-4
LOSS_RTOL = 1e-5  # loss, relative
GRAD_RTOL = 1e-4  # gradients, relative L2 per leaf
PARAM_ATOL = 1e-2 * LR  # parameters after one AdamW step
SMALL_GRAD, SMALL_GRAD_ATOL = 1e-6, 2 * LR  # where |g_jax| < 1e-6: lr g/(|g| + eps) turns rounding into O(lr)
EMA_ATOL = 1e-6


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
def small_cfg(cfg):
    """``tests/test_training_loop.py``'s small_cfg."""
    d = cfg.to_dict()
    d["mapper"]["residual_layer_num"] = 2
    d["mapper"]["noise_schedule_factors"] = [0.0001, 0.02, 10]
    d["mapper"]["input_content_dim"] = {"whisper": 16}
    d["mapper"]["content_feature"] = ["whisper"]
    return JaxHParams(**d)


@pytest.fixture(scope="module")
def port_cfg(small_cfg):
    return HParams(**small_cfg.to_dict())


def _fake_loader(n_batches=4, b=2, t=32, content_dim=16):
    rng = np.random.default_rng(0)
    return [{
        "mel": rng.standard_normal((b, t, 100)).astype(np.float32) * 0.1,
        "content_whisper": rng.standard_normal((b, t, content_dim)).astype(np.float32),
        "melody": np.abs(rng.uniform(0, 500, (b, t))).astype(np.float32),
        "loudness": np.abs(rng.uniform(0, 1, (b, t))).astype(np.float32),
        "singer": np.zeros((b, 1), dtype=np.int32),
    } for _ in range(n_batches)]


def _jax_draws(key, x0_shape, steps):
    """The JAX step's t and noise of ``key`` (its loss's split, randint, normal)."""
    t_key, n_key = jax.random.split(key)
    t = jax.random.randint(t_key, (x0_shape[0],), 0, steps)
    noise = jax.random.normal(n_key, x0_shape, dtype=jnp.float32)
    return torch.from_numpy(np.array(t)).long(), torch.from_numpy(np.array(noise))


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _port_state(port_cfg, jax_state):
    state, opt = init_diffusion_train_state(port_cfg, torch.Generator().manual_seed(0), device="cpu")
    return train_state_from_jax(jax.device_get(jax_state), state), opt


def _assert_params_after_adam(state, jax_new, grads):
    for key, module in state.modules().items():
        want = jax_tree_to_torch(module, jax.device_get(jax_new[key]))
        for name, p in module.named_parameters():
            diff = np.abs(p.detach().numpy() - want[name].numpy())
            small = np.abs(grads[key][name]) < SMALL_GRAD
            assert diff[~small].max(initial=0.0) <= PARAM_ATOL, (key, name, diff[~small].max())
            assert diff[small].max(initial=0.0) <= SMALL_GRAD_ATOL, (key, name, diff[small].max())


def _assert_ema(state, jax_ema, grads, d):
    """EMA within EMA_ATOL of JAX's, and where the gradient was tiny within
    (1 - d) of the parameters' allowance (the EMA takes 1 - d of them)."""
    for key, module in state.modules().items():
        want = jax_tree_to_torch(module, jax.device_get(jax_ema[key]))
        for name in want:
            diff = np.abs(state.ema[key][name].numpy() - want[name].numpy())
            small = np.abs(grads[key][name]) < SMALL_GRAD
            assert diff[~small].max(initial=0.0) <= EMA_ATOL, (key, name, diff[~small].max())
            assert diff[small].max(initial=0.0) <= EMA_ATOL + (1 - d) * SMALL_GRAD_ATOL, (key, name)


# --------------------------------------------------------------- schedule


def test_q_sample_and_predict_start_match_jax(small_cfg, port_cfg):
    js = JaxSchedule.from_config(small_cfg.mapper)
    ps = DiffusionSchedule.from_config(port_cfg.mapper)
    rng = np.random.default_rng(1)
    x0 = rng.standard_normal((3, 7, 100)).astype(np.float32)
    noise = rng.standard_normal((3, 7, 100)).astype(np.float32)
    t = np.array([0, 4, 9], dtype=np.int32)
    want = np.asarray(js.q_sample(jnp.asarray(x0), jnp.asarray(t), jnp.asarray(noise)))
    got = ps.q_sample(torch.from_numpy(x0), torch.from_numpy(t), torch.from_numpy(noise)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    for step in (0, 5, 9):
        want = np.asarray(js.predict_start_from_noise(jnp.asarray(x0), step, jnp.asarray(noise)))
        got = ps.predict_start_from_noise(torch.from_numpy(x0), torch.tensor(step), torch.from_numpy(noise)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)


def test_normalize_mel_channel_matches_jax(cfg):
    mn, mx = artifacts.load_mel_min_max(cfg.min_mel_file, cfg.max_mel_file)
    mel = np.random.default_rng(2).uniform(-11, 2, (100, 40)).astype(np.float32)
    np.testing.assert_array_equal(artifacts.normalize_mel_channel(mel, mn, mx),
                                  jart.normalize_mel_channel(mel, mn, mx))


def test_training_loss_matches_jax_with_its_draws(small_cfg, port_cfg):
    """ddpm_training_loss with JAX's t and noise, through a fixed linear
    denoiser on both sides."""
    js = JaxSchedule.from_config(small_cfg.mapper)
    ps = DiffusionSchedule.from_config(port_cfg.mapper)
    rng = np.random.default_rng(3)
    x0 = rng.standard_normal((2, 9, 100)).astype(np.float32)
    cond = rng.standard_normal((2, 9, 100)).astype(np.float32)
    w = (0.1 * rng.standard_normal((100, 100))).astype(np.float32)
    key = jax.random.PRNGKey(7)
    want, want_t = jddpm.ddpm_training_loss(lambda x, c, t: x @ w + c * t[..., None] / 10.0,
                                           jnp.asarray(x0), jnp.asarray(cond), key, js)
    t, noise = _jax_draws(key, x0.shape, js.num_steps)
    wt = torch.from_numpy(w)
    got, got_t = ddpm_training_loss(lambda x, c, tt: x @ wt + c * tt[..., None] / 10.0, torch.from_numpy(x0),
                                    torch.from_numpy(cond), ps, t=t, noise=noise)
    assert got_t.tolist() == np.asarray(want_t).tolist()
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)
    # without given draws they come from the generator, reproducibly
    a, ta = ddpm_training_loss(lambda x, c, tt: x, torch.from_numpy(x0), None, ps,
                               generator=torch.Generator().manual_seed(5))
    b, tb = ddpm_training_loss(lambda x, c, tt: x, torch.from_numpy(x0), None, ps,
                               generator=torch.Generator().manual_seed(5))
    assert float(a) == float(b) and ta.tolist() == tb.tolist() and 0 <= int(ta.min()) <= int(ta.max()) < 10
    with pytest.raises(ValueError, match="explicit generator"):
        ddpm_training_loss(lambda x, c, tt: x, torch.from_numpy(x0), None, ps, t=t)


# ------------------------------------------------------------ train steps


def _randomize(tree, rng):
    """flax's init zeroes the biases and DiffSVC's output projection, which
    leaves every gradient but the output projection's 0 at step 1: draw
    them at random (0.1 and 0.02 scale) so every leaf has a gradient."""
    def leaf(path, x):
        name = "/".join(str(getattr(k, "key", k)) for k in path)
        if np.ndim(x) < 2:
            return (0.1 * rng.standard_normal(np.shape(x))).astype(np.float32)
        if name.endswith("output_projection/kernel") and not np.any(x):
            return (0.02 * rng.standard_normal(np.shape(x))).astype(np.float32)
        return np.asarray(x, np.float32)
    return jax.tree_util.tree_map_with_path(leaf, tree)


@pytest.fixture(scope="module")
def jax_run(small_cfg):
    """JAX: a state at step 0 with every leaf drawn (:func:`_randomize`),
    two steps on batches 0 and 1 with keys 1 and 2, and each step's
    gradients (the step's loss on the same draws, differentiated apart).

    The JAX step runs op by op (``jax.disable_jit``): XLA's jit of the whole
    step on the CPU puts the denoiser's output 5.9e-4 (1e-3 of max|eps|)
    from a float64 evaluation of the same weights and inputs, and its
    gradients 1.8% (relative L2) from the op-by-op ones; op by op, the
    output is 2.4e-7 from float64, and the port is held to that."""
    from svc_inference_pipeline_tpu.training.diffusion import DiffusionTrainState as JaxState

    init, opt = jax_init(small_cfg, jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(jnp.asarray, _randomize(
        jax.device_get({"enc": init.enc_params, "den": init.den_params}), np.random.default_rng(11)))
    state0 = JaxState(step=init.step, enc_params=params["enc"], den_params=params["den"],
                      opt_state=opt.init(params), ema_params=params)
    step = jax_make_step(small_cfg, opt, ema_decay=0.999)
    batches = _fake_loader(2)
    arrays = [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]
    keys = [jax.random.PRNGKey(1), jax.random.PRNGKey(2)]
    with jax.disable_jit():
        state1, loss1 = step(state0, arrays[0], keys[0])
        state2, loss2 = step(state1, arrays[1], keys[1])

    enc, den = JaxEncoder(small_cfg.mapper), JaxDenoiser(small_cfg.mapper)
    sched = JaxSchedule.from_config(small_cfg.mapper)

    def grads_of(state, batch, key):
        def loss_fn(params):
            cond = enc.apply({"params": params["enc"]}, batch)
            return jddpm.ddpm_training_loss(lambda x, c, t: den.apply({"params": params["den"]}, x, c, t),
                                            batch["mel"], cond, key, sched)[0]
        return jax.device_get(jax.grad(loss_fn)({"enc": state.enc_params, "den": state.den_params}))

    with jax.disable_jit():
        grads = (grads_of(state0, arrays[0], keys[0]), grads_of(state1, arrays[1], keys[1]))
    return dict(states=(state0, state1, state2), losses=(float(loss1), float(loss2)), batches=batches,
                keys=keys, grads=grads, steps=sched.num_steps)


def _assert_grads(state, jax_grads) -> dict:
    """Relative L2 per leaf; returns JAX's gradients in the port's layout."""
    out = {}
    for key, module in state.modules().items():
        want = jax_tree_to_torch(module, jax_grads[key])
        out[key] = {n: v.numpy() for n, v in want.items()}
        for name, p in module.named_parameters():
            rel = _rel(p.grad.numpy(), out[key][name])
            assert rel <= GRAD_RTOL, (key, name, rel)
    return out


def test_one_train_step_matches_jax(port_cfg, jax_run):
    state, opt = _port_state(port_cfg, jax_run["states"][0])
    assert state.step == 0 and {int(s['step']) for s in opt.state.values()} == {0}
    step = make_diffusion_train_step(port_cfg, opt, ema_decay=0.999)
    batch = jax_run["batches"][0]
    t, noise = _jax_draws(jax_run["keys"][0], batch["mel"].shape, jax_run["steps"])
    state, loss = step(state, batch, t=t, noise=noise)
    np.testing.assert_allclose(float(loss), jax_run["losses"][0], rtol=LOSS_RTOL)
    grads = _assert_grads(state, jax_run["grads"][0])
    new = jax_run["states"][1]
    _assert_params_after_adam(state, {"enc": new.enc_params, "den": new.den_params}, grads)
    _assert_ema(state, new.ema_params, grads, d=0.1)  # min(0.999, (1 + 0)/(10 + 0))
    assert state.step == 1
    assert all(int(s["step"]) == 1 for s in opt.state.values())


def test_second_step_from_jax_state_matches_jax(port_cfg, jax_run):
    """JAX's state after step 1 (parameters, EMA, Adam moments and count)
    carried into the port gives JAX's step 2."""
    state, opt = _port_state(port_cfg, jax_run["states"][1])
    assert state.step == 1 and all(int(s["step"]) == 1 for s in opt.state.values())
    step = make_diffusion_train_step(port_cfg, opt, ema_decay=0.999)
    batch = jax_run["batches"][1]
    t, noise = _jax_draws(jax_run["keys"][1], batch["mel"].shape, jax_run["steps"])
    state, loss = step(state, batch, t=t, noise=noise)
    np.testing.assert_allclose(float(loss), jax_run["losses"][1], rtol=LOSS_RTOL)
    grads = _assert_grads(state, jax_run["grads"][1])
    new = jax_run["states"][2]
    _assert_params_after_adam(state, {"enc": new.enc_params, "den": new.den_params}, grads)
    _assert_ema(state, new.ema_params, grads, d=2 / 11)
    assert state.step == 2


def test_step_refuses_another_optimizer(port_cfg):
    state, _ = init_diffusion_train_state(port_cfg, torch.Generator().manual_seed(0), device="cpu")
    _, other = init_diffusion_train_state(port_cfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError):
        make_diffusion_train_step(port_cfg, other)(state, _fake_loader(1)[0])


def test_step_enables_grad_under_no_grad(port_cfg):
    state, opt = init_diffusion_train_state(port_cfg, torch.Generator().manual_seed(0), device="cpu")
    before = {n: p.detach().clone() for n, p in state.denoiser.named_parameters()}
    with torch.no_grad():
        state, loss = make_diffusion_train_step(port_cfg, opt)(state, _fake_loader(1)[0],
                                                               torch.Generator().manual_seed(1))
    assert np.isfinite(float(loss)) and state.step == 1
    assert all(not torch.equal(before[n], p) for n, p in state.denoiser.named_parameters() if p.dim() >= 2)


# ------------------------------------------------------------------ loop


def _flat(state: DiffusionTrainState) -> dict:
    sd = state_dict_of(state)
    out = {f"enc.{k}": v for k, v in sd["enc"].items()}
    out.update({f"den.{k}": v for k, v in sd["den"].items()})
    out.update({f"ema.{k}.{n}": v for k, tree in sd["ema"].items() for n, v in tree.items()})
    for i, s in sd["optimizer"]["state"].items():
        out.update({f"opt.{i}.{k}": v for k, v in s.items()})
    return out


def test_resume_is_bit_exact(port_cfg, tmp_path):
    """5 unbroken steps equal 3 steps, a checkpoint, and a resumed run of 2
    (its loader positioned at step 3), bit for bit."""
    batches = _fake_loader(5)
    whole = train_diffusion(port_cfg, batches, num_steps=5, seed=3, device="cpu")
    ckpt = str(tmp_path / "ckpts")
    first = train_diffusion(port_cfg, batches[:3], num_steps=3, checkpoint_dir=ckpt, checkpoint_every=3,
                            seed=3, device="cpu")
    assert first.step == 3 and (tmp_path / "ckpts" / "latest").is_file()
    resumed = train_diffusion(port_cfg, batches[3:], num_steps=5, checkpoint_dir=ckpt, checkpoint_every=100,
                              seed=3, device="cpu")
    assert resumed.step == whole.step == 5
    a, b = _flat(whole), _flat(resumed)
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(torch.as_tensor(a[k]), torch.as_tensor(b[k])), k


def test_nan_guard_skips_the_update_and_adams_step(port_cfg):
    batches = _fake_loader(4)
    batches[1]["mel"][:] = np.nan
    state = train_diffusion(port_cfg, batches, num_steps=4, device="cpu")
    assert state.step == 3
    assert {int(s["step"]) for s in state.optimizer.state.values()} == {3}
    for tree in state.ema.values():
        assert all(torch.isfinite(v).all() for v in tree.values())
    assert all(torch.isfinite(p).all() for p in state.denoiser.parameters())


def test_injected_nan_fault_is_skipped(port_cfg, monkeypatch):
    """SVC_FAULT_INJECT="nan@1" poisons step 1's target mel: the guard skips
    it and counts it."""
    from svc_inference_pipeline_tpu_torch.training.elastic import _reset_injector_for_tests
    from svc_inference_pipeline_tpu_torch.utils.observability import Metrics

    monkeypatch.setenv("SVC_FAULT_INJECT", "nan@1")
    _reset_injector_for_tests()
    before = Metrics.default().counters["train/skipped_nonfinite"]
    try:
        state = train_diffusion(port_cfg, _fake_loader(3), num_steps=3, device="cpu")
    finally:
        _reset_injector_for_tests()
    assert state.step == 2
    assert Metrics.default().counters["train/skipped_nonfinite"] == before + 1


def test_nan_guard_aborts_after_max_bad_steps(port_cfg):
    batches = _fake_loader(3)
    for b in batches:
        b["mel"][:] = np.nan
    with pytest.raises(RuntimeError, match="consecutive non-finite"):
        train_diffusion(port_cfg, batches, num_steps=3, max_bad_steps=1, device="cpu")


def test_resume_from_pre_ema_checkpoint(port_cfg, tmp_path):
    """A checkpoint without ``ema`` restores with the EMA seeded from the
    restored parameters (then updated by the resumed steps)."""
    state, _ = init_diffusion_train_state(port_cfg, torch.Generator().manual_seed(4), device="cpu")
    legacy = state_dict_of(state)
    legacy["step"] = 3
    del legacy["ema"]
    save_checkpoint(str(tmp_path / "ckpts" / "latest"), legacy)
    same = train_diffusion(port_cfg, _fake_loader(), num_steps=3, checkpoint_dir=str(tmp_path / "ckpts"),
                           device="cpu")
    assert same.step == 3
    for key, module in same.modules().items():
        for name, p in module.named_parameters():
            assert torch.equal(same.ema[key][name], p.detach()), (key, name)
    out = train_diffusion(port_cfg, _fake_loader(), num_steps=5, checkpoint_dir=str(tmp_path / "ckpts"),
                          device="cpu")
    assert out.step == 5
    assert all(torch.isfinite(v).all() for tree in out.ema.values() for v in tree.values())


# ------------------------------------------------ kernel copies of weights


def test_refresh_kernel_params_follows_changed_weights(cfg):
    """A pipeline's kernel copies (the vocoder's K2/K7 form, the denoiser's
    stacks) are made when it is built; after the weights change in place,
    ``refresh_kernel_params`` makes the conversion equal that of a pipeline
    built from the changed weights."""
    import copy

    from svc_inference_pipeline_tpu_torch.pipeline.convert import SVCPipeline

    d = cfg.to_dict()
    d["compute_dtype"] = "float32"
    d["mapper"].update(noise_schedule_factors=[0.0001, 0.02, 4], residual_layer_num=2, residual_channels=64)
    d["vocoder"]["upsample_initial_channel"] = 64
    pipe = SVCPipeline.from_config(HParams(**d), random_weights=True, device="cpu")
    rng = np.random.default_rng(0)
    batch = {"content_whisper": torch.from_numpy(rng.standard_normal((1, 16, 384)).astype(np.float32)),
             "melody": torch.full((1, 16), 220.0), "loudness": torch.full((1, 16), 0.5),
             "singer": torch.zeros((1, 1), dtype=torch.int32)}
    n_true = torch.tensor([16])

    def run(p):
        return p._convert_core(batch, n_true, 16, torch.Generator().manual_seed(0))

    before = run(pipe)
    with torch.no_grad():
        for module in (pipe.denoiser, pipe.vocoder):
            for p in module.parameters():
                p.add_(0.05 * torch.randn(p.shape, generator=torch.Generator().manual_seed(p.numel())))
    pipe.refresh_kernel_params()
    after = run(pipe)
    fresh = SVCPipeline(pipe.cfg, copy.deepcopy(pipe.cond_encoder), copy.deepcopy(pipe.denoiser),
                        copy.deepcopy(pipe.vocoder), pipe.whisper, "cpu")
    assert not torch.equal(before, after)
    assert torch.equal(after, run(fresh))
