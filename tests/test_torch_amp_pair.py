"""PyTorch port vs the JAX package: the plain K7 (one AMPBlock1 pair,
``amp_pair_plain``) against ``fused_amp_pair`` in interpret mode, the
port's AMPBlock1 against ``AMPBlock1(use_pallas=True)`` (CPU, same
weights), and the layout and argument check of K7's host call.

Tolerances: f32 5e-4 abs, the JAX test's own limit
(tests/test_pallas_amp_pair.py); bf16 0.05 abs, its bf16 limit (the JAX
kernel patches its edge rows with the composition in bf16, which rounds at
other places).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svc_inference_pipeline_tpu.models import bigvgan as jbg
from svc_inference_pipeline_tpu.ops.pallas.amp_pair import fused_amp_pair as jax_fused_amp_pair
from svc_inference_pipeline_tpu.utils.devices import fast_random_params
from svc_inference_pipeline_tpu_torch.checkpoints.from_jax import load_jax_params
from svc_inference_pipeline_tpu_torch.config import HParams
from svc_inference_pipeline_tpu_torch.models import bigvgan
from svc_inference_pipeline_tpu_torch.ops.pallas import amp_pair, amp_stage


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this module runs: the suite runs in several
    worker processes at once, and PyTorch's thread pools, each as wide as the
    machine, slow one another down many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _params(c, k, seed=0):
    """Pair parameters as the modules hold them (log-scale alpha/beta)."""
    rng = np.random.default_rng(seed)
    w = lambda: (rng.standard_normal((k, c, c)) / np.sqrt(k * c)).astype(np.float32)  # noqa: E731
    v = lambda s: (rng.standard_normal(c) * s).astype(np.float32)  # noqa: E731
    return dict(w1=w(), b1=v(0.05), w2=w(), b2=v(0.05), alpha1=v(0.2), beta1=v(0.2), alpha2=v(0.2), beta2=v(0.2))


def _both(x, p, k, d, dtype):
    """(JAX fused_amp_pair in interpret mode, the port's plain K7) as f32 numpy."""
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    ref = jax_fused_amp_pair(jnp.asarray(x, jdt), **{n: jnp.asarray(a) for n, a in p.items()}, k=k, d=d,
                             kind="snakebeta", logscale=True, t_tile=256, interpret=True)
    pair = amp_stage.kernel_params(((tuple(torch.from_numpy(p[n]) for n in p),),), "snakebeta", True, dtype)[0][0]
    launches = amp_pair.fused_amp_pair.launches
    got = amp_pair.fused_amp_pair(torch.from_numpy(x).to(dtype), pair, k, d)
    assert amp_pair.fused_amp_pair.launches == launches  # CPU tensor: the plain version, no launch
    assert got.dtype == dtype and got.shape == x.shape
    return np.asarray(ref.astype(jnp.float32)), got.float().numpy()


@pytest.mark.parametrize("c", [24, 96, 384])
@pytest.mark.parametrize("k,d", [(3, 1), (7, 3), (11, 5)])
def test_plain_k7_matches_pallas_interpret(k, d, c):
    x = (np.random.default_rng(1).standard_normal((1, 300, c)) * 0.5).astype(np.float32)
    ref, got = _both(x, _params(c, k), k, d, torch.float32)
    assert np.abs(got - ref).max() <= 5e-4, np.abs(got - ref).max()


@pytest.mark.parametrize("b,t_len,c,k,d", [
    (2, 300, 24, 7, 3),   # two clips
    (1, 30, 96, 11, 5),   # T < 2H: every output row sees both edges' padding
    (2, 7, 24, 3, 1),     # a clip shorter than one activation halo on each side
])
def test_plain_k7_batches_and_short_clips(b, t_len, c, k, d):
    assert t_len < 2 * amp_pair.pair_halo(k, d) or b > 1
    x = (np.random.default_rng(2).standard_normal((b, t_len, c)) * 0.3).astype(np.float32)
    ref, got = _both(x, _params(c, k, seed=3), k, d, torch.float32)
    assert np.abs(got - ref).max() <= 5e-4, np.abs(got - ref).max()


def test_plain_k7_bf16_matches_pallas_interpret():
    x = (np.random.default_rng(4).standard_normal((1, 400, 48)) * 0.5).astype(np.float32)
    ref, got = _both(x, _params(48, 3, seed=5), 3, 1, torch.bfloat16)
    assert np.abs(got - ref).max() <= 0.05, np.abs(got - ref).max()


def test_amp_block1_matches_jax_pallas_block(cfg):
    """The port's AMPBlock1 (three K7 pairs on its per-block route) vs JAX
    AMPBlock1(use_pallas=True) in interpret mode: C=96, k=11, dilations 1/3/5,
    f32, <= 5e-4."""
    c, k, dils = 96, 11, (1, 3, 5)
    x = (np.random.default_rng(6).standard_normal((1, 200, c)) * 0.5).astype(np.float32)
    model = jbg.AMPBlock1(cfg.vocoder, c, k, dils, use_pallas=True)
    params = fast_random_params(lambda: model.init(jax.random.PRNGKey(0), jnp.asarray(x)), seed=7)["params"]
    rng = np.random.default_rng(8)
    params = jax.tree_util.tree_map(  # random 1-D leaves: the init zeroes them
        lambda v: (0.2 * rng.standard_normal(v.shape)).astype(np.float32) if np.ndim(v) == 1
        else np.asarray(v, np.float32), params)
    ref = np.asarray(model.apply({"params": params}, jnp.asarray(x)))
    port = load_jax_params(bigvgan.AMPBlock1(HParams(**cfg.vocoder.to_dict()), c, k, dils), params)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert np.abs(got - ref).max() <= 5e-4, np.abs(got - ref).max()
    # the kernel-form weights are the module's own storage
    w1 = port.kernel_pairs[2][0]
    assert w1.data_ptr() == port.conv1_2.conv.weight.data_ptr() and w1.is_contiguous()


def _vocoder_kd(cfg):
    """Every (k, d) of the config's AMPBlock1 pairs."""
    return [(k, d) for k, dils in zip(cfg.vocoder.resblock_kernel_sizes, cfg.vocoder.resblock_dilation_sizes)
            for d in dils]


@pytest.mark.parametrize("c", [384, 192, 96, 48, 24])
def test_k7_scratch_covers_every_vocoder_pair(c, cfg):
    """For every (k, d) of the config's vocoder at every K7 width (two clips,
    T = 37 < 2H at k = 11, d = 5, and a 4 s stage's T): the halo is the
    pair's d(k-1)/2; buf holds bf16 [B, T + 2H, C] and conv_out f32
    [B, T, C], 256-byte aligned and apart in one allocation; and every tap
    box of conv_d and conv_1 (rows H - d'(k-1)/2 + m d' + [0, T) of a clip,
    d' = d or 1) lies inside the clip's rows of buf."""
    kd = _vocoder_kd(cfg)
    assert {k for k, _ in kd} == {3, 7, 11} and {d for _, d in kd} == {1, 3, 5}
    for b, t_len in ((2, 37), (1, 98304 * 24 // c)):
        for k, d in kd:
            lay = amp_pair.scratch_layout(b, t_len, c, k, d)
            assert lay.halo == d * (k - 1) // 2
            assert lay.sizes == (2 * b * (t_len + 2 * lay.halo) * c, 4 * b * t_len * c)
            offsets, nbytes = amp_stage.slab_offsets(lay.sizes)
            assert all(o % 256 == 0 for o in offsets)
            assert offsets[0] + lay.sizes[0] <= offsets[1] and offsets[1] + lay.sizes[1] <= nbytes
            for dil in (d, 1):
                first = lay.halo - dil * (k - 1) // 2
                assert first >= 0 and first + (k - 1) * dil + t_len <= t_len + 2 * lay.halo


@pytest.mark.parametrize("case", ["c12", "c392", "even k", "d0", "weight shape", "bf16 bias"])
def test_k7_refuses_what_the_kernel_does_not_take(case):
    """The wrapper's argument check (pure Python, run before any launch)
    refuses C not a multiple of 8, C > 384, an even k, d = 0, a conv weight
    of the wrong shape and a bias that is not f32."""
    def pair_of(c, k):
        return amp_stage.kernel_params(((tuple(torch.from_numpy(v) for v in _params(c, k).values()),),))[0][0]

    amp_pair.check_args(torch.zeros((1, 16, 96), dtype=torch.bfloat16), pair_of(96, 3), 3, 1)  # what it takes
    c, k, d = {"c12": (12, 3, 1), "c392": (392, 3, 1), "even k": (96, 4, 1), "d0": (96, 3, 0)}.get(case, (96, 3, 1))
    pair = list(pair_of(c, k))
    if case == "weight shape":
        pair[2] = torch.zeros((k, c, c + 8), dtype=torch.bfloat16)
    elif case == "bf16 bias":
        pair[1] = pair[1].to(torch.bfloat16)
    x = torch.zeros((1, 16, c), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="amp pair"):
        amp_pair.check_args(x, tuple(pair), k, d)
