"""PyTorch port vs the JAX package: BigVGAN pieces, the plain K3 and K2
versions, a tiny generator, AMPBlock2 and a tiny resblock-"2" generator, and
the per-block route against the K2 route (f32, CPU, same weights)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svc_inference_pipeline_tpu.models import bigvgan as jbg
from svc_inference_pipeline_tpu.ops.pallas.amp_stage import fused_amp_stage as jax_fused_amp_stage
from svc_inference_pipeline_tpu.ops.pallas.snake import fused_activation1d as jax_fused_activation1d
from svc_inference_pipeline_tpu.utils.devices import fast_random_params
from svc_inference_pipeline_tpu_torch.checkpoints.from_jax import load_jax_params, random_init_
from svc_inference_pipeline_tpu_torch.config import HParams
from svc_inference_pipeline_tpu_torch.models import bigvgan
from svc_inference_pipeline_tpu_torch.ops.pallas import amp_pair, amp_stage, snake

KS = (3, 7, 11)
DILS = ((1, 3, 5),) * 3


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this module runs: the suite runs in several
    worker processes at once, and PyTorch's thread pools, each as wide as the
    machine, slow one another down many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _act_params(c, rng):
    return (rng.standard_normal(c) * 0.3).astype(np.float32), (rng.standard_normal(c) * 0.3).astype(np.float32)


@pytest.mark.parametrize("t_len,c", [(300, 24), (37, 8), (10, 4)])
def test_plain_k3_matches_pallas_interpret_and_xla(t_len, c):
    """Plain K3 (polyphase form, global edges) vs fused_activation1d
    (interpret) and the composed XLA Activation1d, <= 1e-5."""
    rng = np.random.default_rng(t_len)
    x = (rng.standard_normal((2, t_len, c)) * 2.0).astype(np.float32)
    alpha, beta = _act_params(c, rng)
    fused = np.asarray(jax_fused_activation1d(jnp.asarray(x), jnp.asarray(alpha), jnp.asarray(beta),
                                              "snakebeta", True, interpret=True))
    xla = np.asarray(jbg.downsample1d(jbg.snake_beta(jbg.upsample1d(jnp.asarray(x), 2, 12), alpha, beta, True), 2, 12))
    got = snake.fused_activation1d(_t(x), _t(alpha), _t(beta), "snakebeta", True).numpy()
    assert np.abs(got - fused).max() <= 1e-5
    assert np.abs(got - xla).max() <= 1e-5


def test_composed_activation_matches_xla():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((1, 50, 6)).astype(np.float32)
    alpha, beta = _act_params(6, rng)
    up = bigvgan.upsample1d(_t(x), 2, 12)
    np.testing.assert_allclose(up.numpy(), np.asarray(jbg.upsample1d(jnp.asarray(x), 2, 12)), atol=1e-6)
    down = bigvgan.downsample1d(up, 2, 12)
    np.testing.assert_allclose(down.numpy(), np.asarray(jbg.downsample1d(jnp.asarray(up.numpy()), 2, 12)), atol=1e-6)
    for kind in ("snake", "snakebeta"):
        got = bigvgan.activation1d_composed(_t(x), _t(alpha), _t(beta), kind, True)
        y = jbg.upsample1d(jnp.asarray(x), 2, 12)
        y = jbg.snake(y, alpha, True) if kind == "snake" else jbg.snake_beta(y, alpha, beta, True)
        np.testing.assert_allclose(got.numpy(), np.asarray(jbg.downsample1d(y, 2, 12)), atol=1e-5)
    np.testing.assert_array_equal(bigvgan.kaiser_sinc_filter1d(0.25, 0.3, 12),
                                  jbg.kaiser_sinc_filter1d(0.25, 0.3, 12))


def _stage_params(c, rng):
    def pair(k):
        return (
            (rng.standard_normal((k, c, c)) * 0.1).astype(np.float32),
            (rng.standard_normal(c) * 0.05).astype(np.float32),
            (rng.standard_normal((k, c, c)) * 0.1).astype(np.float32),
            (rng.standard_normal(c) * 0.05).astype(np.float32),
            *[(rng.standard_normal(c) * 0.2).astype(np.float32) for _ in range(4)],
        )

    return tuple(tuple(pair(k) for _ in d) for k, d in zip(KS, DILS))


def test_plain_k2_matches_pallas_interpret():
    """Plain K2 (3 blocks k=3/7/11, dilations 1/3/5) vs
    fused_amp_stage(t_tile=256, interpret=True): relative max error <= 1e-4
    (three residual pairs grow the activations ~10x each with these weights,
    as in tests/test_pallas_amp_stage.py)."""
    rng = np.random.default_rng(1)
    c, t_len = 16, 300
    x = (rng.standard_normal((1, t_len, c)) * 0.5).astype(np.float32)
    params = _stage_params(c, rng)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    ref = np.asarray(jax_fused_amp_stage(jnp.asarray(x), jparams, KS, DILS, "snakebeta", True,
                                         t_tile=256, interpret=True))
    tparams = jax.tree_util.tree_map(_t, params)
    kparams = amp_stage.kernel_params(tparams, "snakebeta", True, torch.float32)
    got = amp_stage.fused_amp_stage(_t(x), kparams, KS, DILS).numpy()
    assert np.abs(got - ref).max() / np.abs(ref).max() <= 1e-4


@pytest.fixture(scope="module")
def tiny_vocoder(cfg):
    d = cfg.vocoder.to_dict()
    d["upsample_initial_channel"] = 64
    vcfg = cfg.vocoder.replace(**d)
    model = jbg.BigVGANGenerator(vcfg)
    params = fast_random_params(lambda: model.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 100))), seed=2)["params"]
    rng = np.random.default_rng(7)
    params = jax.tree_util.tree_map(
        lambda v: (0.1 * rng.standard_normal(v.shape)).astype(np.float32) if np.ndim(v) == 1
        else np.asarray(v, np.float32), params)
    return vcfg, params


def test_tiny_generator_matches_jax(tiny_vocoder):
    """Whole generator (conv_pre, transposed convs, six K2 stages, K3,
    conv_post, tanh) vs BigVGANGenerator, < 2e-4."""
    vcfg, params = tiny_vocoder
    mel = np.random.default_rng(8).standard_normal((1, 8, 100)).astype(np.float32)
    ref = np.asarray(jbg.BigVGANGenerator(vcfg).apply({"params": params}, jnp.asarray(mel)))
    port = load_jax_params(bigvgan.BigVGANGenerator(HParams(**vcfg.to_dict())), params)
    with torch.no_grad():
        got = port(_t(mel)).numpy()
    assert got.shape == ref.shape == (1, 8 * 256)
    assert np.abs(got - ref).max() < 2e-4


def test_prepare_kernel_params_shares_the_weights(tiny_vocoder):
    """K2's kernel-form conv weights are the module's own storage laid out
    [k, Cin, Cout] (nothing duplicated), the snake parameters are the
    effective ones, and the state_dict keeps its values."""
    vcfg, params = tiny_vocoder
    port = load_jax_params(bigvgan.BigVGANGenerator(HParams(**vcfg.to_dict())), params)
    before = {k: v.clone() for k, v in port.state_dict().items()}
    port.prepare_kernel_params()
    after = port.state_dict()
    assert before.keys() == after.keys() and all(torch.equal(before[k], after[k]) for k in before)
    w1, b1, w2, b2, a1, ib1, a2, ib2 = port.kernel_stages[1][2][1]  # stage 1, block 2, pair 1
    blk = port.resblock_1_2
    for w, conv in ((w1, blk.conv1_1), (w2, blk.conv2_1)):
        assert w.is_contiguous() and w.data_ptr() == conv.conv.weight.data_ptr()
        assert torch.equal(w, conv.conv.weight.permute(2, 1, 0))
    assert torch.equal(b1, blk.conv1_1.conv.bias) and torch.equal(b2, blk.conv2_1.conv.bias)
    for (a, ib), act in (((a1, ib1), blk.act1_1), ((a2, ib2), blk.act2_1)):
        ref_a, ref_ib = snake.effective_params(*act.params())
        assert torch.equal(a, ref_a) and torch.equal(ib, ref_ib)


def _random_tree(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(  # random 1-D leaves: the init zeroes them
        lambda v: (0.1 * rng.standard_normal(v.shape)).astype(np.float32) if np.ndim(v) == 1
        else np.asarray(v, np.float32), params)


def test_amp_block2_matches_jax(cfg):
    """AMPBlock2 (x <- conv_j(act_j(x)) + x, k=7, dilations 1/3) vs JAX, f32, < 2e-4."""
    c, k, dils = 16, 7, (1, 3)
    x = np.random.default_rng(11).standard_normal((1, 100, c)).astype(np.float32)
    model = jbg.AMPBlock2(cfg.vocoder, c, k, dils)
    params = _random_tree(fast_random_params(lambda: model.init(jax.random.PRNGKey(0), jnp.asarray(x)),
                                             seed=12)["params"], 13)
    ref = np.asarray(model.apply({"params": params}, jnp.asarray(x)))
    port = load_jax_params(bigvgan.AMPBlock2(HParams(**cfg.vocoder.to_dict()), c, k, dils), params)
    with torch.no_grad():
        got = port(_t(x)).numpy()
    assert sorted(dict(port.named_children())) == ["act_0", "act_1", "conv_0", "conv_1"]
    assert np.abs(got - ref).max() < 2e-4


def test_tiny_resblock2_generator_matches_jax(cfg):
    """A resblock-"2" generator (AMPBlock2's own dilations [1, 3] in every
    block, BigVGAN 64 wide, six stages): the block route vs JAX, f32, < 2e-4;
    the random init covers every AMPBlock2 leaf."""
    d = cfg.vocoder.to_dict()
    d.update(upsample_initial_channel=64, resblock="2", resblock_dilation_sizes=[[1, 3]] * 3)
    vcfg = cfg.vocoder.replace(**d)
    model = jbg.BigVGANGenerator(vcfg)
    params = _random_tree(fast_random_params(lambda: model.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 100))),
                                             seed=14)["params"], 15)
    mel = np.random.default_rng(16).standard_normal((1, 8, 100)).astype(np.float32)
    ref = np.asarray(model.apply({"params": params}, jnp.asarray(mel)))
    port = load_jax_params(bigvgan.BigVGANGenerator(HParams(**vcfg.to_dict())), params)
    with torch.no_grad():
        got = port(_t(mel)).numpy()
    assert got.shape == ref.shape == (1, 8 * 256)
    assert np.abs(got - ref).max() < 2e-4
    port.prepare_kernel_params()  # nothing to put in K2's form
    assert port.kernel_stages is None
    drawn = random_init_(bigvgan.BigVGANGenerator(HParams(**vcfg.to_dict())), torch.Generator().manual_seed(0))
    assert all(torch.all(p == 0) for n, p in drawn.named_parameters() if n.endswith(("alpha", "beta")))
    assert all(p.std() > 0 for n, p in drawn.named_parameters() if ".conv_" in n and p.dim() == 3)


def test_per_block_route_matches_k2_route(cfg):
    """A resblock-"1" generator of two stages (64 wide, random weights and
    1-D leaves): forward_per_block (every AMPBlock1 on its own, each pair
    through K7's plain version, summed and divided by 3) vs forward (each
    stage through K2's plain version), f32, <= 1e-4 of the output's range."""
    d = cfg.vocoder.to_dict()
    d.update(upsample_initial_channel=64, upsample_rates=[4, 4], upsample_kernel_sizes=[8, 8])
    g = torch.Generator().manual_seed(18)
    port = random_init_(bigvgan.BigVGANGenerator(HParams(**d)), g)
    with torch.no_grad():
        for p in port.parameters():
            if p.dim() == 1:
                p.copy_(0.1 * torch.randn(p.shape, generator=g))
    mel = _t(np.random.default_rng(17).standard_normal((1, 8, 100)))
    launches = amp_pair.fused_amp_pair.launches
    with torch.no_grad():
        stage, block = port(mel), port.forward_per_block(mel)
    assert amp_pair.fused_amp_pair.launches == launches  # CPU: plain versions, nothing launched
    assert stage.shape == block.shape == (1, 8 * 16)
    assert (stage - block).abs().max() <= 1e-4 * stage.abs().max()


def test_conv_transpose_polyphase_matches_jax():
    rng = np.random.default_rng(9)
    x = rng.standard_normal((1, 12, 10)).astype(np.float32)
    model = jbg.TorchConvTranspose1d(6, 8, 4)
    params = {"kernel": rng.standard_normal((8, 6, 10)).astype(np.float32),
              "bias": rng.standard_normal(6).astype(np.float32)}
    ref = np.asarray(model.apply({"params": params}, jnp.asarray(x)))
    port = load_jax_params(bigvgan.TorchConvTranspose1d(10, 6, 8, 4), params)
    with torch.no_grad():
        got = port(_t(x)).numpy()
        torch_ref = torch.nn.functional.conv_transpose1d(
            _t(x).transpose(1, 2), port.weight, port.bias, stride=4, padding=2).transpose(1, 2)
    np.testing.assert_allclose(got, ref, atol=1e-5)
    np.testing.assert_allclose(got, torch_ref.numpy(), atol=1e-5)
    with pytest.raises(ValueError, match="polyphase"):
        bigvgan.TorchConvTranspose1d(4, 4, 5, 2)


@pytest.mark.parametrize("pcm16", [False, True])
def test_vocoder_output_finalize_matches_jax(pcm16):
    rng = np.random.default_rng(10)
    wave = (rng.standard_normal((2, 64 * 30)) * 0.3).astype(np.float32)
    n_true = np.array([30, 25], np.int32)
    ref = np.asarray(jbg.vocoder_output_finalize(jnp.asarray(wave), jnp.asarray(n_true), 64, pcm16=pcm16))
    got = bigvgan.vocoder_output_finalize(_t(wave), torch.from_numpy(n_true), 64, pcm16=pcm16).numpy()
    if pcm16:
        assert got.dtype == np.int16 and np.abs(got.astype(np.int32) - ref.astype(np.int32)).max() <= 1
    else:
        np.testing.assert_allclose(got, ref, atol=1e-6)
