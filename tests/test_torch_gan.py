"""GAN training in the port against the JAX package at
``tests/test_gan_training.py``'s TINY config: each discriminator's logits
and feature maps (at a length no period divides), the three losses, one
discriminator step and one generator step from JAX's own state carried
across (loss, gradients, parameters after AdamW), and the generator's
training route (``use_kernels=False``): every parameter gets a gradient,
and its output equals the kernel route's (f32, CPU)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from svc_inference_pipeline_tpu.config import HParams as JaxHParams
from svc_inference_pipeline_tpu.models import discriminators as jdisc
from svc_inference_pipeline_tpu.models.bigvgan import BigVGANGenerator as JaxGenerator
from svc_inference_pipeline_tpu.ops.mel import mel_spectrogram as jax_mel_spectrogram
from svc_inference_pipeline_tpu.training import gan as jgan
from svc_inference_pipeline_tpu_torch.checkpoints.from_jax import (
    jax_tree_to_torch,
    load_jax_params,
    random_init_,
    train_state_from_jax,
)
from svc_inference_pipeline_tpu_torch.config import HParams
from svc_inference_pipeline_tpu_torch.models import discriminators as disc
from svc_inference_pipeline_tpu_torch.models.bigvgan import BigVGANGenerator
from svc_inference_pipeline_tpu_torch.training import gan

TINY = JaxHParams(
    fs=24000, n_fft=256, n_mels=20, hop_length=64, win_length=256, fmin=0, fmax=12000,
    vocoder=dict(
        resblock_kernel_sizes=[3],
        upsample_rates=[4, 4, 2, 2],  # x64 == hop
        input_dim=20,
        upsample_initial_channel=32,
        resblock="1",
        upsample_kernel_sizes=[8, 8, 4, 4],
        resblock_dilation_sizes=[[1, 3, 5]],
        activation="snakebeta",
        snake_logscale=True,
        discriminator_channel_mult=0.125,
        mpd_reshapes=[2, 3],
        use_spectral_norm=False,
        mrd_override=False,
        resolutions=[[128, 32, 128], [64, 16, 64]],
    ),
)
PORT_TINY = HParams(**TINY.to_dict())
LENGTH = 1009  # a prime: no period divides it
T_FRAMES = 8
LR = gan.LR
FMAP_TOL = 1e-5  # logits and feature maps, of max|JAX| per map
LOSS_RTOL = 1e-5  # losses, relative
GRAD_RTOL = 1e-3  # gradients, relative L2 per leaf
PARAM_ATOL = 1e-2 * LR  # parameters after one AdamW step
SMALL_GRAD, SMALL_GRAD_ATOL = 1e-6, 2 * LR  # |g_jax| < 1e-6: lr g/(|g| + eps) turns rounding into O(lr)
ROUTE_TOL = 1e-4  # each route against float64, of max|out| (f32 sums in other orders; measured 8.3e-5, 4.7e-5)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this module runs: the suite runs in several
    worker processes at once, and PyTorch's thread pools, each as wide as the
    machine, slow one another down many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.fixture(scope="module")
def jax_state():
    """JAX's GAN state from its own init (jitted: flax's eager init of the
    generator takes half a minute) and its default optimizers."""
    state = jax.jit(lambda k: jgan.init_gan_train_state(TINY, k)[0])(jax.random.PRNGKey(0))
    opt = optax.adamw(2e-4, b1=0.8, b2=0.99)  # the init's defaults
    return jax.device_get(state), opt


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(0)
    return {"mel": rng.standard_normal((2, T_FRAMES, 20)).astype(np.float32),
            "wave": (0.1 * rng.standard_normal((2, T_FRAMES * TINY.hop_length))).astype(np.float32)}


def _port_state(jax_state):
    state, _, _ = gan.init_gan_train_state(PORT_TINY, torch.Generator().manual_seed(0), device="cpu")
    return train_state_from_jax(jax_state, state)


# ---------------------------------------------------------- discriminators


def _waves():
    rng = np.random.default_rng(1)
    # noise, not silence: the MRD's magnitude has no floor, so an exactly
    # zero bin has an infinite gradient (as in JAX)
    return (0.3 * rng.standard_normal((2, LENGTH))).astype(np.float32), \
        (0.3 * rng.standard_normal((2, LENGTH))).astype(np.float32)


@pytest.mark.parametrize("kind", ["mpd", "mrd"])
def test_discriminator_matches_jax(jax_state, kind):
    y, y_hat = _waves()
    params = jax_state[0].mpd_params if kind == "mpd" else jax_state[0].mrd_params
    jmod = (jdisc.MultiPeriodDiscriminator if kind == "mpd" else jdisc.MultiResolutionDiscriminator)(TINY.vocoder)
    want = jmod.apply({"params": params}, jnp.asarray(y), jnp.asarray(y_hat))
    pmod = (disc.MultiPeriodDiscriminator if kind == "mpd" else disc.MultiResolutionDiscriminator)(PORT_TINY.vocoder)
    load_jax_params(pmod, params)
    got = pmod(torch.from_numpy(y), torch.from_numpy(y_hat))
    for w_list, g_list in zip(want[:2], got[:2]):  # logits of y and y_hat, per branch
        for w, g in zip(w_list, g_list):
            w = np.asarray(w)
            assert g.shape == w.shape
            assert np.abs(g.detach().numpy() - w).max() <= FMAP_TOL * np.abs(w).max()
    for w_maps, g_maps in zip(want[2] + want[3], got[2] + got[3]):  # feature maps, NHWC vs NCHW
        assert len(w_maps) == len(g_maps) == 6
        for w, g in zip(w_maps, g_maps):
            w = np.asarray(w)
            g = g.detach().permute(0, 2, 3, 1).numpy()
            assert g.shape == w.shape
            assert np.abs(g - w).max() <= FMAP_TOL * np.abs(w).max()


def test_period_pad_repeats_the_last_sample():
    """JAX pads with x[:, -pad:][:, ::-1], which repeats the last sample;
    torch's reflect pad would not."""
    d = disc.PeriodDiscriminator(3, d_mult=0.125)
    x = torch.arange(7, dtype=torch.float32)[None]
    seen = {}
    d.conv_0.register_forward_pre_hook(lambda m, i: seen.update(x=i[0]))
    d(x)
    assert seen["x"].reshape(-1).tolist() == [0, 1, 2, 3, 4, 5, 6, 6, 5]


# ------------------------------------------------------------------ losses


def test_losses_match_jax():
    rng = np.random.default_rng(3)
    reals = [rng.standard_normal((2, n)).astype(np.float32) for n in (5, 9)]
    fakes = [rng.standard_normal((2, n)).astype(np.float32) for n in (5, 9)]
    maps_r = [[rng.standard_normal((2, 3, n)).astype(np.float32) for n in (4, 6)] for _ in range(2)]
    maps_g = [[rng.standard_normal((2, 3, n)).astype(np.float32) for n in (4, 6)] for _ in range(2)]

    def t(xs):
        return [torch.from_numpy(x) for x in xs]

    def j(xs):
        return [jnp.asarray(x) for x in xs]

    cases = [
        (gan.ls_disc_loss(t(reals), t(fakes)), jgan._ls_disc_loss(j(reals), j(fakes))),
        (gan.ls_gen_loss(t(fakes)), jgan._ls_gen_loss(j(fakes))),
        (gan.feature_matching([t(m) for m in maps_r], [t(m) for m in maps_g]),
         jgan._feature_matching([j(m) for m in maps_r], [j(m) for m in maps_g])),
    ]
    for got, want in cases:
        np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)
    assert gan.MEL_LOSS_WEIGHT == jgan.MEL_LOSS_WEIGHT


# ------------------------------------------------------------------ steps


def _jax_grads(jax_state, batch, side, cfg=TINY):
    """Gradients of JAX's discriminator or generator loss (the steps'
    closures, with the package's loss helpers) at ``jax_state``."""
    vcfg = cfg.vocoder
    g, mpd, mrd = JaxGenerator(vcfg), jdisc.MultiPeriodDiscriminator(vcfg), jdisc.MultiResolutionDiscriminator(vcfg)
    y, mel = jnp.asarray(batch["wave"]), jnp.asarray(batch["mel"])

    def mel_of(w):
        return jax_mel_spectrogram(w, cfg.n_fft, cfg.n_mels, cfg.fs, cfg.hop_length, cfg.win_length,
                                   cfg.fmin, cfg.fmax)

    def disc_loss(dp):
        y_hat = jax.lax.stop_gradient(g.apply({"params": jax_state.gen_params}, mel))
        a = mpd.apply({"params": dp["mpd"]}, y, y_hat)
        b = mrd.apply({"params": dp["mrd"]}, y, y_hat)
        return jgan._ls_disc_loss(a[0], a[1]) + jgan._ls_disc_loss(b[0], b[1])

    def gen_loss(gp):
        y_hat = g.apply({"params": gp}, mel)
        a = mpd.apply({"params": jax_state.mpd_params}, y, y_hat)
        b = mrd.apply({"params": jax_state.mrd_params}, y, y_hat)
        adv = jgan._ls_gen_loss(a[1]) + jgan._ls_gen_loss(b[1])
        fm = jgan._feature_matching(a[2], a[3]) + jgan._feature_matching(b[2], b[3])
        return adv + 2.0 * fm + jgan.MEL_LOSS_WEIGHT * jnp.mean(jnp.abs(mel_of(y_hat) - mel_of(y)))

    if side == "disc":
        return jax.device_get(jax.jit(jax.grad(disc_loss))(
            {"mpd": jax_state.mpd_params, "mrd": jax_state.mrd_params}))
    return jax.device_get(jax.jit(jax.grad(gen_loss))(jax_state.gen_params))


def _assert_step(modules, jax_grads, jax_new):
    """Per module: gradients within GRAD_RTOL, parameters within PARAM_ATOL
    of JAX's after the step (SMALL_GRAD_ATOL where |g_jax| < SMALL_GRAD)."""
    for module, grads, new in zip(modules, jax_grads, jax_new):
        want_g = jax_tree_to_torch(module, grads)
        want_p = jax_tree_to_torch(module, new)
        for name, p in module.named_parameters():
            g = want_g[name].numpy()
            assert p.grad is not None and _rel(p.grad.numpy(), g) <= GRAD_RTOL, (name, _rel(p.grad.numpy(), g))
            diff = np.abs(p.detach().numpy() - want_p[name].numpy())
            small = np.abs(g) < SMALL_GRAD
            assert diff[~small].max(initial=0.0) <= PARAM_ATOL, (name, diff[~small].max())
            assert diff[small].max(initial=0.0) <= SMALL_GRAD_ATOL, name


def test_disc_step_matches_jax(jax_state, batch):
    state0, opt = jax_state
    disc_step, _ = jgan.make_gan_train_steps(TINY, opt, opt)
    new, loss = disc_step(state0, {k: jnp.asarray(v) for k, v in batch.items()})
    new = jax.device_get(new)
    grads = _jax_grads(state0, batch, "disc")

    state = _port_state(state0)
    p_disc, _ = gan.make_gan_train_steps(PORT_TINY, state.gen_optimizer, state.disc_optimizer)
    gen_before = {n: p.detach().clone() for n, p in state.generator.named_parameters()}
    state, got = p_disc(state, batch)
    np.testing.assert_allclose(float(got), float(loss), rtol=LOSS_RTOL)
    _assert_step((state.mpd, state.mrd), (grads["mpd"], grads["mrd"]), (new.mpd_params, new.mrd_params))
    assert state.step == 0 and all(p.grad is None for p in state.generator.parameters())
    assert all(torch.equal(gen_before[n], p) for n, p in state.generator.named_parameters())


def test_gen_step_matches_jax(jax_state, batch):
    state0, opt = jax_state
    _, gen_step = jgan.make_gan_train_steps(TINY, opt, opt)
    new, loss, aux = gen_step(state0, {k: jnp.asarray(v) for k, v in batch.items()})
    new = jax.device_get(new)
    grads = _jax_grads(state0, batch, "gen")

    state = _port_state(state0)
    _, p_gen = gan.make_gan_train_steps(PORT_TINY, state.gen_optimizer, state.disc_optimizer)
    disc_before = {n: p.detach().clone() for n, p in state.mpd.named_parameters()}
    state, got, got_aux = p_gen(state, batch)
    np.testing.assert_allclose(float(got), float(loss), rtol=LOSS_RTOL)
    for k in ("adv", "fm", "mel_l1"):
        np.testing.assert_allclose(float(got_aux[k]), float(aux[k]), rtol=LOSS_RTOL)
    _assert_step((state.generator,), (grads,), (new.gen_params,))
    assert state.step == 1 and all(p.grad is None for p in state.mpd.parameters())
    assert all(torch.equal(disc_before[n], p) for n, p in state.mpd.named_parameters())


def test_steps_refuse_other_optimizers(jax_state, batch):
    state = _port_state(jax_state[0])
    other, gopt, dopt = gan.init_gan_train_state(PORT_TINY, torch.Generator().manual_seed(1), device="cpu")
    disc_step, gen_step = gan.make_gan_train_steps(PORT_TINY, gopt, dopt)
    with pytest.raises(ValueError):
        disc_step(state, batch)
    state, loss = disc_step(other, batch)
    assert np.isfinite(float(loss))


INIT_STD_RTOL = 0.25  # per-leaf std of two draws of >= INIT_MIN_SIZE values (sampling error ~3.5%)
INIT_MIN_SIZE = 400


def test_init_draws_at_jax_scales(jax_state):
    """The port's init draws every leaf at the scale JAX's ``init`` draws it:
    the same leaves zero, and each leaf of INIT_MIN_SIZE values or more with
    a standard deviation within INIT_STD_RTOL of JAX's (the up-convs at
    N(0, 0.01^2), not at 1/fan_in)."""
    ours, _, _ = gan.init_gan_train_state(PORT_TINY, torch.Generator().manual_seed(0), device="cpu")
    theirs, _, _ = gan.init_gan_train_state(PORT_TINY, torch.Generator().manual_seed(1), device="cpu")
    train_state_from_jax(jax_state[0], theirs)
    compared = 0
    for kind in ("generator", "mpd", "mrd"):
        ref = dict(getattr(theirs, kind).named_parameters())
        for name, p in getattr(ours, kind).named_parameters():
            a, b = p.detach().numpy(), ref[name].detach().numpy()
            assert (not a.any()) == (not b.any()), f"{kind}.{name}"
            if a.size >= INIT_MIN_SIZE and b.any():
                assert abs(a.std() / b.std() - 1.0) < INIT_STD_RTOL, (f"{kind}.{name}", a.std(), b.std())
                compared += 1
    ups = [n for n, _ in ours.generator.named_parameters() if n.startswith("up_") and n.endswith("weight")]
    assert ups and compared > len(ups)


# ----------------------------------------------------- the training route


def _generator(use_kernels):
    g = BigVGANGenerator(PORT_TINY.vocoder, use_kernels=use_kernels)
    random_init_(g, torch.Generator().manual_seed(4))
    rng = np.random.default_rng(4)
    with torch.no_grad():  # 1-D leaves (biases, snake alpha/beta) drawn too
        for p in g.parameters():
            if p.dim() == 1:
                p.copy_(torch.from_numpy((0.1 * rng.standard_normal(p.shape)).astype(np.float32)))
    return g


def test_training_route_reaches_every_parameter(batch):
    """With use_kernels=False every generator parameter gets a non-zero
    gradient; the kernel route's AMP blocks run on kernel-form copies made
    without autograd, so their parameters get none."""
    mel = torch.from_numpy(batch["mel"])
    g = _generator(False)
    g(mel).square().mean().backward()
    for name, p in g.named_parameters():
        assert p.grad is not None and bool(p.grad.abs().max() > 0), name
    assert all(getattr(blk, "kernel_pairs", None) is None for blk in g.modules())

    k = _generator(True)
    k(mel).square().mean().backward()
    missed = [n for n, p in k.named_parameters() if p.grad is None]
    assert missed and all(n.startswith("resblock_") for n in missed)


def test_tp_group_refused_on_the_kernel_route(batch):
    """Channel TP shards the training route only: a ``tp_group`` given to
    the kernel route raises before any collective."""
    mel = torch.from_numpy(batch["mel"])
    with pytest.raises(ValueError, match="training route"):
        _generator(True)(mel, tp_group=object())


def test_training_route_equals_kernel_route(batch):
    """Both routes at f32 against the training route in float64 (the
    pre-tanh output reaches 74 here, so each lands some f32 ulps of that
    from it; they are within 2 ROUTE_TOL of each other)."""
    mel = torch.from_numpy(batch["mel"])
    with torch.no_grad():
        train = _generator(False)(mel)
        serve = _generator(True)(mel)
        exact = _generator(False).double()(mel.double())
    assert train.shape == serve.shape == exact.shape == (2, T_FRAMES * TINY.hop_length)
    scale = float(exact.abs().max())
    for out in (train, serve):
        assert float((out.double() - exact).abs().max()) <= ROUTE_TOL * scale


def test_vocoder_output_to_audio_matches_jax():
    from svc_inference_pipeline_tpu.models.bigvgan import vocoder_output_to_audio as jax_fn
    from svc_inference_pipeline_tpu_torch.models.bigvgan import vocoder_output_to_audio

    wave = np.random.default_rng(5).standard_normal((2, 64 * 30 + 17)).astype(np.float32)
    got = vocoder_output_to_audio(torch.from_numpy(wave), 30, 64).numpy()
    # jnp.linspace and torch.linspace round some fade factors 1 ulp apart
    np.testing.assert_allclose(got, np.asarray(jax_fn(jnp.asarray(wave), 30, 64)), rtol=0,
                               atol=2 * np.spacing(np.abs(wave).max()))
