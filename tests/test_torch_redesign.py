"""The numerics and layouts of the redesigned K4 and K1 kernels, rehearsed on
the CPU where the kernels cannot run.

- K4 runs one pass over the keys: per 64-key tile it keeps the running row
  max, rounds exp(s - m_running) to bf16 before P @ V, rescales O when the
  max moves, and divides by the f32 row sum at the end. The plain version
  (and the TPU kernel) round P after the full normalisation. The emulation
  below follows the kernel's order and must stay within the card's limit
  for K4: 2 bf16 ulps of max|plain|.
- K1/K5's gate reads its conv taps as plain row boxes of a buffer
  [B, T + 2*halo, C] that holds y = bf16(h + step_row) between zero halo
  rows (``denoiser_step.conv_input_buffer``), in 64-row tiles per clip whose
  rows past T read nothing. The emulation reads the buffer as the kernel
  does and must give ``_taps(r(h + row), d)`` exactly.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svc_inference_pipeline_tpu.ops.pallas.attention import encoder_attention as jax_encoder_attention
from svc_inference_pipeline_tpu_torch.ops.pallas import attention, denoiser_step

BF = torch.bfloat16
TILE = 64  # K4's keys per tile and K1's rows per tile


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this module runs: the suite runs in several
    worker processes at once, and PyTorch's thread pools, each as wide as the
    machine, slow one another down many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _two_ulps(m: float) -> float:
    return 2 * 2.0 ** (math.floor(math.log2(m)) - 7)


def one_pass_attention(q, k, v, n_head):
    """K4's order of operations in plain PyTorch: q, k, v [B, T, D] bf16 ->
    [B, T, D] bf16."""
    b, t, d = q.shape
    hd = d // n_head
    scale = attention._split_scale(hd, q.dtype)

    def heads(x, s):
        x = (x.float() * s).to(x.dtype) if s != 1.0 else x
        return x.reshape(b, t, n_head, hd).transpose(1, 2).float()

    qh, kh, vh = heads(q, scale), heads(k, scale), heads(v, 1.0)
    m = torch.full((b, n_head, t, 1), -math.inf)
    l = torch.zeros((b, n_head, t, 1))
    o = torch.zeros((b, n_head, t, hd))
    for k0 in range(0, t, TILE):
        s = qh @ kh[:, :, k0:k0 + TILE].transpose(-1, -2)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        o = o * alpha + p.to(BF).float() @ vh[:, :, k0:k0 + TILE]
        m = m_new
    return (o / l).transpose(1, 2).reshape(b, t, d).to(q.dtype)


def _qkv(shape, seed):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(BF) for _ in range(3))


@pytest.mark.parametrize("t_len,heads", [(1500, 16), (70, 1)])
def test_one_pass_k4_order_within_card_limit(t_len, heads):
    """The kernel's rounding order at the main path's [1, 1500, 1024] and at
    a single head with a partial last tile, against the plain version."""
    q, k, v = _qkv((1, t_len, heads * 64), seed=t_len)
    got = one_pass_attention(q, k, v, heads).float()
    ref = attention.encoder_attention_plain(q, k, v, heads).float()
    assert got.shape == ref.shape
    assert (got - ref).abs().max().item() <= _two_ulps(ref.abs().max().item())


def test_one_pass_k4_order_matches_pallas_interpret():
    """The same order against the TPU kernel itself (interpret mode), bf16,
    two clips of 70 frames and 2 heads: 2 bf16 ulps of max|TPU kernel|."""
    q, k, v = _qkv((2, 70, 128), seed=7)
    ref = np.asarray(jax_encoder_attention(*(jnp.asarray(x.float().numpy(), dtype=jnp.bfloat16) for x in (q, k, v)),
                                           2, interpret=True).astype(jnp.float32))
    got = one_pass_attention(q, k, v, 2).float().numpy()
    assert np.abs(got - ref).max() <= _two_ulps(float(np.abs(ref).max()))


def _gate_taps_from_buffer(buf, t_len, d):
    """[B, T, 3C] as K1's split gate reads it: for each clip and 64-row tile
    t0, tap m is the box of rows halo + t0 + (m-1)*d + [0, 64) of the clip,
    with the rows of the tile at or past T zero (they read nothing)."""
    b, rows, c = buf.shape
    halo = denoiser_step.halo_rows(4)
    assert rows == t_len + 2 * halo
    out = torch.zeros((b, -(-t_len // TILE) * TILE, 3 * c), dtype=buf.dtype)
    for t0 in range(0, t_len, TILE):
        nvalid = min(TILE, t_len - t0)
        for m in range(3):
            r0 = halo + t0 + (m - 1) * d
            assert 0 <= r0 and r0 + nvalid <= rows  # inside the clip's own rows
            out[:, t0:t0 + nvalid, m * c:(m + 1) * c] = buf[:, r0:r0 + nvalid]
    return out[:, :t_len]


def _prologue_halo_zeros(buf, t_len, halo):
    """What the prologue's blocks write into the buffer: the halo rows above
    a clip's first 64-row tile and below its last."""
    for t0 in range(0, t_len, TILE):
        if t0 == 0:
            buf[:, :halo] = 0
        if t0 + TILE >= t_len:
            buf[:, halo + t_len:] = 0


@pytest.mark.parametrize("t_len", [9, 100])
@pytest.mark.parametrize("d", [1, 2, 4, 8])
def test_zero_halo_conv_input_gives_the_taps(t_len, d):
    """B = 2 clips, C = 16, dilation cycle 4 (halo 8): the uninitialised
    buffer (NaN here), after the prologue's halo zeros and the epilogue's
    bf16(h + row), reproduces the plain version's ``_taps(r(h + row), d)``
    bit for bit, for every dilation of the cycle."""
    rng = np.random.default_rng(100 * t_len + d)
    c = 16
    h = torch.from_numpy(rng.standard_normal((2, t_len, c)).astype(np.float32)).to(BF).float()
    row = torch.from_numpy(rng.standard_normal(c).astype(np.float32)).to(BF).float()
    buf = denoiser_step.conv_input_buffer(2, t_len, c, 4, "cpu").fill_(math.nan)
    halo = denoiser_step.halo_rows(4)
    _prologue_halo_zeros(buf, t_len, halo)
    buf[:, halo:halo + t_len] = (h + row).to(BF)  # what the epilogue that writes h writes
    got = _gate_taps_from_buffer(buf, t_len, d)
    want = denoiser_step._taps((h + row).to(BF).float(), d)
    assert torch.equal(got.float(), want)
    assert torch.all(buf[:, :halo] == 0) and torch.all(buf[:, halo + t_len:] == 0)
