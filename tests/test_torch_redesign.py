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
- K6's int8 gate: a cluster of 3 taps x 2 column tiles quantises the union
  of its three taps' 64-row boxes of y = h + step_row once and stores each
  row into the K-major int8 tile of every block whose tap box holds it (K
  padded to the 128-wide chunk with zeros, rows outside the clip 0); each
  block multiplies its tile by its tap's slice of the K-major weight copy
  (``w1_kmajor``), and the three int32 partials are summed in int32. The
  emulation follows those steps and must give the plain version's
  concat-tap product bit for bit.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svc_inference_pipeline_tpu.ops.pallas.attention import encoder_attention as jax_encoder_attention
from svc_inference_pipeline_tpu_torch.config import HParams
from svc_inference_pipeline_tpu_torch.models.diffsvc import DiffSVCDenoiser
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


# --- K6: the int8 gate on the wgmma s8 tile ---------------------------------

INT8_CHUNK = 128  # int8 K elements per 128-byte swizzle row: the s8 tile's K chunk


def _int8_stack(quantize, c=64, layers=5, seed=0):
    """A DiffSVC denoiser with weights N(0, 1/n) from numpy, stacked in f32
    with ``quantize``."""
    rng = np.random.default_rng(seed)
    cfg = HParams(residual_channels=c, residual_layer_num=layers, n_mel=100, conditioner_size=c,
                  diffusion_fc_size=128, dilation_cycle_length=4, residual_kernel_size=3)
    den = DiffSVCDenoiser(cfg, torch.float32)
    with torch.no_grad():
        for p in den.parameters():
            scale = p.shape[-1] ** -0.5 if p.dim() > 1 else 0.1
            p.copy_(torch.from_numpy((scale * rng.standard_normal(p.shape)).astype(np.float32)))
    return denoiser_step.stack_denoiser_params(den, torch.float32, quantize)


@pytest.mark.parametrize("quantize", ["int8-w1", "int8"])
def test_int8_kmajor_copies_are_the_transposed_weights(quantize):
    """w1_kmajor[l, m, n, c] = w1[l, m*C + c, n] and wout_kmajor[l] = wout[l]^T
    (int8 stacks only; "int8-w1" has no int8 wout, bf16 none at all)."""
    st = _int8_stack(quantize)
    n_layers, k3, c2 = st.w1.shape
    c = c2 // 2
    assert st.w1_kmajor.dtype == torch.int8 and st.w1_kmajor.is_contiguous()
    assert tuple(st.w1_kmajor.shape) == (n_layers, 3, c2, c)
    for m in range(3):
        assert torch.equal(st.w1_kmajor[:, m], st.w1[:, m * c:(m + 1) * c].transpose(1, 2))
    if quantize == "int8":
        assert st.wout_kmajor.dtype == torch.int8 and st.wout_kmajor.is_contiguous()
        assert torch.equal(st.wout_kmajor, st.wout.transpose(1, 2))
    else:
        assert st.wout_kmajor is None
    assert _int8_stack(None).w1_kmajor is None


def _kernel_tap_tiles(h, row, t_len, d):
    """The s8 gate's resident A tiles, as its clusters write them: for each
    clip b and 64-row tile t0, the union of the three taps' boxes, rows
    [t0 - d, t0 + 64 + d) of y = h + row (f32 add of the bf16 values), is
    quantised once with 1/s_y, s_y = max(max|y| of the clip, 1e-12)/127, rows
    outside [0, T) 0; tap m's tile row i is union row i + m*d, or 0 at or past
    T's last row in the tile; K is padded with zero columns to the 128-wide
    chunk. Returns [B, tiles*64, 3, Kpad] float (integer values)."""
    b, _, c = h.shape
    y = h + row
    s_y = torch.clamp(y.abs().amax(dim=(1, 2)), min=1e-12) * denoiser_step.INV_127
    inv = 1.0 / s_y  # f32, one division per clip, as the kernel's 1.0f / quant_scale(amax)
    k_pad = -(-c // INT8_CHUNK) * INT8_CHUNK
    n_tiles = -(-t_len // TILE)
    out = torch.full((b, n_tiles * TILE, 3, k_pad), math.nan)
    for t0 in range(0, t_len, TILE):
        nvalid = min(TILE, t_len - t0)
        union = torch.zeros((b, TILE + 2 * d, k_pad))
        for u in range(TILE + 2 * d):
            ts = t0 - d + u
            if 0 <= ts < t_len:
                union[:, u, :c] = torch.clamp(torch.round(y[:, ts] * inv[:, None]), -127.0, 127.0)
        for m in range(3):
            for i in range(TILE):
                out[:, t0 + i, m] = union[:, i + m * d] if i < nvalid else 0.0
    return out


def _gate_inputs(t_len, c, seed):
    """bf16-valued h [2, T, C] and step row [C] (f32); the second clip's h is
    8x the first's, so the clips' int8 scales differ."""
    rng = np.random.default_rng(seed)
    h = torch.from_numpy(rng.standard_normal((2, t_len, c)).astype(np.float32))
    h = (h * torch.tensor([1.0, 8.0]).view(2, 1, 1)).to(BF).float()
    row = torch.from_numpy(rng.standard_normal(c).astype(np.float32)).to(BF).float()
    return h, row


@pytest.mark.parametrize("t_len", [9, 100])
@pytest.mark.parametrize("d", [1, 2, 4, 8])
def test_int8_gate_taps_outside_a_clip_are_zero(t_len, d):
    """B = 2 clips, C = 64, dilations up to 8 against T = 9 (one partial tile)
    and 100: the quantised tap boxes are the plain version's
    ``_taps(yq, d)`` (which pads the quantised input with zeros), rows past
    T and the K padding are 0, and nothing is left unwritten."""
    c = 64
    h, row = _gate_inputs(t_len, c, seed=10 * t_len + d)
    tiles = _kernel_tap_tiles(h, row, t_len, d)
    assert not torch.isnan(tiles).any()
    y = h + row  # forward_plain's quantiser
    s_y = torch.clamp(y.abs().amax(dim=(1, 2), keepdim=True), min=1e-12) * denoiser_step.INV_127
    yq = torch.clamp(torch.round(y * (1.0 / s_y)), -127.0, 127.0)
    want = denoiser_step._taps(yq, d).view(2, t_len, 3, c)
    assert torch.equal(tiles[:, :t_len, :, :c], want)
    assert torch.all(tiles[:, t_len:] == 0) and torch.all(tiles[..., c:] == 0)


@pytest.mark.parametrize("quantize", ["int8-w1", "int8"])
@pytest.mark.parametrize("c,t_len,layer", [(64, 100, 3), (192, 37, 2)])
def test_int8_gate_tap_partials_sum_to_the_concat_tap_product(quantize, c, t_len, layer):
    """The three per-tap int32 partials (quantised box @ w1_kmajor[l, m]^T),
    summed in int32 and converted once to f32, equal forward_plain's
    concat-tap product ``_int8_matmul(_taps(yq, d), w1[l])`` bit for bit;
    C = 192 leaves half of
    the second 128-wide K chunk as padding. Two clips, scales 8x apart."""
    st = _int8_stack(quantize, c=c, layers=layer + 1)
    d = 2 ** (layer % st.cycle)
    h, row = _gate_inputs(t_len, c, seed=c + layer)
    tiles = _kernel_tap_tiles(h, row, t_len, d)[:, :t_len]
    k_pad = tiles.shape[-1]
    w_k = torch.zeros((3, 2 * c, k_pad), dtype=torch.int64)
    w_k[..., :c] = st.w1_kmajor[layer].long()
    partials = [tiles[:, :, m].long() @ w_k[m].T for m in range(3)]
    assert all(p.abs().max() < 2 ** 31 for p in partials)
    acc_i32 = (partials[0].int() + partials[1].int()) + partials[2].int()
    y = h + row  # forward_plain's lines for the gate of layer ``layer``
    s_y = torch.clamp(y.abs().amax(dim=(1, 2), keepdim=True), min=1e-12) * denoiser_step.INV_127
    yq = torch.clamp(torch.round(y * (1.0 / s_y)), -127.0, 127.0)
    ref = denoiser_step._int8_matmul(denoiser_step._taps(yq, d), st.w1[layer])
    assert torch.equal(acc_i32.float(), ref)
