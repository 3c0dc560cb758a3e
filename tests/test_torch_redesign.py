"""The numerics and layouts of the redesigned K4 and K1 kernels, rehearsed on
the CPU where the kernels cannot run.

- K4 runs one pass over the keys: per 64-key tile it keeps the running row
  max, rounds exp(s - m_running) to bf16 before P @ V, rescales O when the
  max moves, and divides by the f32 row sum at the end. The plain version
  (and the TPU kernel) round P after the full normalisation. The emulation
  below follows the kernel's order and must stay within the card's limit
  for K4: 2 bf16 ulps of max|plain|.
- K1/K5's fused layer reads its conv taps as plain row boxes of one of two
  buffers [B, T + 2*halo, C] (by layer parity) that hold y = bf16(h +
  step_row) between zero halo rows (``denoiser_step.conv_input_buffer``),
  in 64-row tiles per clip whose rows past T read nothing. The emulation
  reads a buffer as the kernel does and must give ``_taps(r(h + row), d)``
  exactly.
- K6's int8 gate: a cluster of 3 taps x 2 column tiles quantises the union
  of its three taps' 64-row boxes of y = h + step_row once and stores each
  row into the K-major int8 tile of every block whose tap box holds it (K
  padded to the 128-wide chunk with zeros, rows outside the clip 0); each
  block multiplies its tile by its tap's slice of the K-major weight copy
  (``w1_kmajor``), and the three int32 partials are summed in int32. The
  emulation follows those steps and must give the plain version's
  concat-tap product bit for bit.
- K2's stage and K7's pair run each AMPBlock1 pair as four launches: act1
  into a zero-halo buffer, conv_d, act2 into the buffer, conv_1 with its
  epilogue. The emulation reads the buffer's tap boxes as the conv's loader
  does and must stay within the card's limit (2 bf16 ulps of max|plain|)
  of the plain stage and the plain pair.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svc_inference_pipeline_tpu.ops.pallas.attention import encoder_attention as jax_encoder_attention
from svc_inference_pipeline_tpu_torch.config import HParams
from svc_inference_pipeline_tpu_torch.models.diffsvc import DiffSVCDenoiser
from svc_inference_pipeline_tpu_torch.ops.pallas import amp_pair, amp_stage, attention, denoiser_step, snake

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


def _prologue_halo_zeros(bufs, t_len, halo):
    """What the prologue's blocks write into both parity buffers: the halo
    rows above a clip's first 64-row tile and below its last."""
    for t0 in range(0, t_len, TILE):
        if t0 == 0:
            bufs[:, :, :halo] = 0
        if t0 + TILE >= t_len:
            bufs[:, :, halo + t_len:] = 0


@pytest.mark.parametrize("t_len", [9, 100])
@pytest.mark.parametrize("d", [1, 2, 4, 8])
def test_zero_halo_conv_input_gives_the_taps(t_len, d):
    """B = 2 clips, C = 16, dilation cycle 4 (halo 8): each of the two
    uninitialised parity buffers (NaN here), after the prologue's halo zeros
    and the epilogue's bf16(h + row) into it, reproduces the plain version's
    ``_taps(r(h + row), d)`` bit for bit, for every dilation of the cycle,
    and writing one leaves the other's rows as they were."""
    rng = np.random.default_rng(100 * t_len + d)
    c = 16
    h = torch.from_numpy(rng.standard_normal((2, t_len, c)).astype(np.float32)).to(BF).float()
    row = torch.from_numpy(rng.standard_normal(c).astype(np.float32)).to(BF).float()
    bufs = denoiser_step.conv_input_buffer(2, t_len, c, 4, "cpu").fill_(math.nan)
    assert bufs.shape[0] == 2
    halo = denoiser_step.halo_rows(4)
    _prologue_halo_zeros(bufs, t_len, halo)
    want = denoiser_step._taps((h + row).to(BF).float(), d)
    for parity in range(2):
        buf = bufs[parity]
        buf[:, halo:halo + t_len] = (h + row).to(BF)  # what the epilogue that writes h writes
        got = _gate_taps_from_buffer(buf, t_len, d)
        assert torch.equal(got.float(), want)
        assert torch.all(buf[:, :halo] == 0) and torch.all(buf[:, halo + t_len:] == 0)
        assert parity or torch.all(bufs[1, :, halo:halo + t_len].isnan())


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


# --- K3's register pass, K2's stage and K7's pair on the zero-halo buffer ----

KS = (3, 7, 11)  # config/config.json's resblock "1" kernels and dilations
DILS = ((1, 3, 5),) * 3
K_CHUNK = 64  # the wgmma tile's K chunk (csrc/gemm_wg.cuh)


def _fma(a, b, c):
    """fmaf(a, b, c) in float32: the exact product (float64 holds the
    product of two float32) plus c, rounded to float64 and then to float32,
    which differs from one rounding only in rare ties."""
    return (torch.as_tensor(a).double() * torch.as_tensor(b).double() + c.double()).float()


def _register_pass(x, alpha_eff, inv_beta, rows, kernel_arith=False):
    """The activation kernel's order of operations (csrc/snake.cuh): each
    thread's run of ``rows`` output rows forms the upsampled pairs
    t0-3 .. t1+2 (virtual pairs past the clip's ends are its edge samples
    s[0] and s[2T-1]) and keeps the 7 outputs a pair feeds as running sums,
    each summed from h[0] to h[11]. Vectorised over runs, clips and
    channels; f32.

    By default every product is rounded before it is added and the sine is
    torch.sin, as in the plain version. ``kernel_arith``: the kernel's own
    arithmetic instead, as far as the CPU can model it: every product-sum a
    fused multiply-add (nvcc contracts them), the sine of the clip's inner
    pairs ``sin_sq`` (:func:`_sin_sq_f32`), of its virtual edge pairs
    torch.sin for the card's sinf. Arguments past sin_sq's range
    (|alpha u| > 105615) are not modelled."""
    h = snake.fir12()
    b, t_len, c = x.shape
    xf = x.float()
    j = torch.arange(t_len)

    def tap(m):
        return xf[:, (j + m - 5).clamp(0, t_len - 1)]

    if kernel_arith:
        def fsum(terms):
            acc = torch.zeros_like(xf)
            for hv, t in terms:
                acc = _fma(hv, t, acc)
            return acc

        def snake_of(u, inner):
            a = u * alpha_eff
            sq = torch.from_numpy(_sin_sq_f32(a.numpy())[1]) if inner else torch.sin(a) * torch.sin(a)
            return _fma(inv_beta, sq, u)

        def add(acc, hv, v):
            return _fma(hv, v, acc)

        u_even = 2.0 * fsum((h[15 - 2 * m], tap(m)) for m in range(2, 8))
        u_odd = 2.0 * fsum((h[16 - 2 * m], tap(m)) for m in range(3, 9))
        se_all, so_all = snake_of(u_even, True), snake_of(u_odd, True)
        edge_lo, edge_hi = snake_of(u_even[:, 0], False), snake_of(u_odd[:, -1], False)
    else:
        def add(acc, hv, v):
            return acc + hv * v

        u_even = 2.0 * sum(h[15 - 2 * m] * tap(m) for m in range(2, 8))
        u_odd = 2.0 * sum(h[16 - 2 * m] * tap(m) for m in range(3, 9))
        se_all = u_even + inv_beta * torch.sin(alpha_eff * u_even) ** 2
        so_all = u_odd + inv_beta * torch.sin(alpha_eff * u_odd) ** 2
        edge_lo, edge_hi = se_all[:, 0], so_all[:, -1]
    t0 = torch.arange(0, t_len, rows)
    t1 = (t0 + rows).clamp(max=t_len)
    out = torch.full((b, t_len, c), math.nan)
    acc = [torch.zeros((len(t0), b, c)) for _ in range(7)]
    for step in range(rows + 6):
        jj = t0 - 3 + step  # this step's pair of every run
        inside = jj.clamp(0, t_len - 1)
        se = torch.where((jj < 0).view(-1, 1, 1), edge_lo.unsqueeze(0),
                         torch.where((jj >= t_len).view(-1, 1, 1), edge_hi.unsqueeze(0),
                                     se_all[:, inside].transpose(0, 1)))
        so = torch.where((jj < 0).view(-1, 1, 1), edge_lo.unsqueeze(0),
                         torch.where((jj >= t_len).view(-1, 1, 1), edge_hi.unsqueeze(0),
                                     so_all[:, inside].transpose(0, 1)))
        for q in range(7):
            if q < 6:
                acc[q] = add(acc[q], h[11 - 2 * q], se)
            if q > 0:
                acc[q] = add(acc[q], h[12 - 2 * q], so)
        t = jj - 3
        for r in range(len(t0)):
            if t0[r] <= t[r] < t1[r]:
                out[:, t[r]] = acc[0][r]
        acc = acc[1:] + [torch.zeros_like(acc[0])]
    return out


def _activation_inputs(t_len):
    rng = np.random.default_rng(t_len)
    x = torch.from_numpy(rng.standard_normal((2, t_len, 24)).astype(np.float32))
    alpha, beta = (torch.from_numpy(0.3 * rng.standard_normal(24).astype(np.float32)) for _ in range(2))
    return (x, *snake.effective_params(alpha, beta))


REGISTER_PASS_CASES = [(1, 8), (2, 8), (5, 8), (17, 8), (40, 16), (101, 32)]


@pytest.mark.parametrize("t_len,rows", REGISTER_PASS_CASES)
def test_k3_register_pass_is_the_plain_activation(t_len, rows):
    """The kernel's sliding-window decimation with virtual edge pairs, for
    clips shorter than one run, runs that end mid-clip and runs that touch
    both edges, B = 2, C = 24: given the plain version's sine and a rounding
    after every product, bit for bit the plain version (the same sums in the
    same order). The kernel's own sine and fused multiply-adds are the next
    test's."""
    x, a_eff, inv_b = _activation_inputs(t_len)
    got = _register_pass(x, a_eff, inv_b, rows)
    assert torch.equal(got, snake.activation1d_plain(x, a_eff, inv_b))


@pytest.mark.parametrize("t_len,rows", REGISTER_PASS_CASES)
def test_k3_register_pass_in_the_kernels_arithmetic(t_len, rows):
    """The same passes with the kernel's arithmetic as the CPU models it
    (``sin_sq``, fused multiply-adds): within 1e-5 x max|plain| of the plain
    version, the f32 limit the card tests hold the kernel to. The model is
    not the kernel bit for bit (nvcc's contraction is its choice); the card
    tests are the real check."""
    x, a_eff, inv_b = _activation_inputs(t_len)
    got = _register_pass(x, a_eff, inv_b, rows, kernel_arith=True)
    ref = snake.activation1d_plain(x, a_eff, inv_b)
    assert not torch.isnan(got).any()
    assert (got - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()


def _loader_columns(k, c):
    """(tap, channel) of every column of the conv's K = k*C axis, padded to
    whole 64-wide chunks, as the kernel's A loader walks it: thread chunk
    j (8 columns) starts at tap 0, channel 8j, normalised, and advances by 64
    channels per chunk, wrapping into the next tap with no division; None
    past the last tap."""
    n_chunks = -(-k * c // K_CHUNK)
    cols = [None] * (n_chunks * K_CHUNK)
    for j in range(K_CHUNK // 8):
        m, ch = 0, 8 * j
        while ch >= c:
            ch, m = ch - c, m + 1
        for kt in range(n_chunks):
            for e in range(8):
                cols[kt * K_CHUNK + 8 * j + e] = (m, ch + e) if m < k else None
            ch += K_CHUNK
            while ch >= c:
                ch, m = ch - c, m + 1
    return cols


def _tap_matrix(buf, t_len, halo, k, d, c):
    """[B, T, Kpad] A operand as the conv's 64-row tiles copy it from the
    zero-halo buffer: column (m, ch) of row t is buffer row
    halo - d(k-1)/2 + m*d + t, channel ch; padded columns 0."""
    cols = _loader_columns(k, c)
    pad = d * (k - 1) // 2
    a = torch.zeros((buf.shape[0], t_len, len(cols)), dtype=buf.dtype)
    for kk, mc in enumerate(cols):
        if mc is not None:
            m, ch = mc
            r0 = halo - pad + m * d
            assert 0 <= r0 and r0 + t_len <= buf.shape[1]  # inside the clip's own rows
            a[:, :, kk] = buf[:, r0:r0 + t_len, ch]
    return a


def _weight_matrix(w):
    """[k, C, C] -> the row-major [k*C, C] matrix the tile reads, padded with
    zero rows to the 64-wide K chunks."""
    k, c, _ = w.shape
    out = torch.zeros((-(-k * c // K_CHUNK) * K_CHUNK, c), dtype=w.dtype)
    out[:k * c] = w.reshape(k * c, c)
    return out


def _conv_buffer(x, alpha_eff, inv_beta, halo, cd):
    """The activation's output in the conv-input buffer, as the kernel writes
    it into an uninitialised one (NaN here): rows [halo, halo + T) and zero
    halo rows."""
    b, t_len, c = x.shape
    buf = torch.full((b, t_len + 2 * halo, c), math.nan, dtype=cd)
    buf[:, :halo] = 0
    buf[:, halo + t_len:] = 0
    buf[:, halo:halo + t_len] = snake.activation1d_plain(x, alpha_eff, inv_beta).to(cd)
    return buf


def _stage_params(c, seed, dtype=torch.float32):
    rng = np.random.default_rng(seed)

    def t(shape, scale):
        return torch.from_numpy((scale * rng.standard_normal(shape)).astype(np.float32))

    def pair(k):
        return (t((k, c, c), (k * c) ** -0.5), t(c, 0.05), t((k, c, c), (k * c) ** -0.5), t(c, 0.05),
                *(t(c, 0.2) for _ in range(4)))

    return amp_stage.kernel_params(tuple(tuple(pair(k) for _ in d) for k, d in zip(KS, DILS)),
                                   dtype=dtype)


@pytest.mark.parametrize("c", [24, 48, 96])
@pytest.mark.parametrize("t_len", [7, 65, 129])
def test_k2_tap_boxes_of_the_zero_halo_buffer(t_len, c):
    """B = 2, odd T (T = 7 < H = 25): for every (k, d) of the config the
    loader's tap matrix equals the zero-padded gather of the bf16 operand
    bit for bit, and its product with the padded weight matrix equals
    ``conv1d_plain`` of that operand (f32 sums in another order, 1e-5 of
    max|plain|)."""
    rng = np.random.default_rng(t_len + c)
    x = torch.from_numpy(rng.standard_normal((2, t_len, c)).astype(np.float32))
    params = _stage_params(c, seed=c)
    halo = amp_stage.halo_rows(KS, DILS)
    assert halo == 25
    w1, b1, _, _, al1, ib1, _, _ = params[0][0]
    buf = _conv_buffer(x, al1, ib1, halo, BF)
    assert not torch.isnan(buf.float()).any()
    operand = buf[:, halo:halo + t_len]
    for blk, (k, dils) in enumerate(zip(KS, DILS)):
        w = params[blk][0][0].to(BF)
        for d in dils:
            a = _tap_matrix(buf, t_len, halo, k, d, c)
            pad = d * (k - 1) // 2
            padded = torch.nn.functional.pad(operand.float(), (0, 0, pad, pad))
            gather = torch.cat([padded[:, m * d:m * d + t_len] for m in range(k)], dim=-1)
            assert torch.equal(a[..., :k * c].float(), gather)
            assert torch.all(a[..., k * c:] == 0)
            got = a.float() @ _weight_matrix(w).float()
            ref = amp_stage.conv1d_plain(operand, w, torch.zeros(c), d)
            assert (got - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()


def _emulated_pair(src, pair, k, d, halo, cd):
    """One pair's four launches (csrc/amp_stage.cu::issue_pair) on src (in
    x's dtype or the f32 carry): act1 into the zero-halo buffer (conv
    operands in ``cd``), conv_d as the tap matrix times the padded weight
    matrix (f32) + b1, act2 into the buffer, conv_1 + b2, + f32(src): the
    f32 value before the final conv's epilogue adds a running sum or
    rounds."""
    w1, b1, w2, b2, al1, ib1, al2, ib2 = pair
    t_len, c = src.shape[1], src.shape[2]
    buf = _conv_buffer(src, al1, ib1, halo, cd)
    conv_out = _tap_matrix(buf, t_len, halo, k, d, c).float() @ _weight_matrix(w1.to(cd)).float() + b1
    buf = _conv_buffer(conv_out, al2, ib2, halo, cd)
    v = _tap_matrix(buf, t_len, halo, k, 1, c).float() @ _weight_matrix(w2.to(cd)).float() + b2
    return v + src.float()


def _emulated_stage(x, block_params, halo):
    """K2's stage as svc_amp_stage runs it: per pair :func:`_emulated_pair`
    (conv operands in x's dtype), then the epilogue's order: + running block
    sum, * scale."""
    cd = x.dtype
    n_blocks = len(block_params)
    carry = total = out = None
    for bi, (pairs, k, dils) in enumerate(zip(block_params, KS, DILS)):
        src = x
        for j, (pair, d) in enumerate(zip(pairs, dils)):
            v = _emulated_pair(src, pair, k, d, halo, cd)
            if j < len(pairs) - 1:
                carry = v
            elif bi == n_blocks - 1:
                out = ((v + total) * (1.0 / n_blocks)).to(cd)
            else:
                total = v if bi == 0 else v + total
            src = carry
    return out


@pytest.mark.parametrize("dtype", [torch.float32, BF])
@pytest.mark.parametrize("t_len,c", [(7, 24), (65, 48)])
def test_k2_emulated_stage_matches_the_plain_stage(dtype, t_len, c):
    """The emulated stage against ``amp_stage_plain``, B = 2: in f32 within
    1e-6 x max|plain| (the convs' f32 sums in another order), in bf16 within
    2 bf16 ulps of max|plain|, the card's limit for K2."""
    rng = np.random.default_rng(3 * t_len + c)
    x = torch.from_numpy((0.5 * rng.standard_normal((2, t_len, c))).astype(np.float32)).to(dtype)
    params = _stage_params(c, seed=t_len, dtype=dtype)
    got = _emulated_stage(x, params, amp_stage.halo_rows(KS, DILS)).float()
    ref = amp_stage.amp_stage_plain(x, params, KS, DILS).float()
    m = ref.abs().max().item()
    assert (got - ref).abs().max().item() <= (1e-6 * m if dtype == torch.float32 else _two_ulps(m))


@pytest.mark.parametrize("dtype", [torch.float32, BF])
@pytest.mark.parametrize("k,d", [(3, 1), (7, 3), (11, 5)])
def test_k7_emulated_pair_matches_the_plain_pair(k, d, dtype):
    """K7 as ``svc_amp_pair`` runs it: the four launches of one pair with
    the pair's own halo H = d(k-1)/2 (conv_d's first tap box starts at the
    buffer's first row), + b2 + f32(x) rounded once, against
    ``amp_pair_plain``; B = 2, T = 37 < 2H at k = 11, d = 5. In f32 within
    1e-6 x max|plain|, in bf16 within 2 bf16 ulps of max|plain|, the card's
    limit for K7."""
    rng = np.random.default_rng(10 * k + d)
    x = torch.from_numpy((0.5 * rng.standard_normal((2, 37, 48))).astype(np.float32)).to(dtype)
    pair = _stage_params(48, seed=k, dtype=dtype)[KS.index(k)][0]
    halo = amp_pair.scratch_layout(2, 37, 48, k, d).halo
    got = _emulated_pair(x, pair, k, d, halo, dtype).to(dtype).float()
    ref = amp_pair.amp_pair_plain(x, pair, k, d).float()
    m = ref.abs().max().item()
    assert (got - ref).abs().max().item() <= (1e-6 * m if dtype == torch.float32 else _two_ulps(m))


def test_k2_stage_plan_of_the_full_width_config():
    """The plan of the six stages of BigVGAN-1536 for a 4 s clip (384
    frames), against values worked out by hand: H = 25 (k = 11, d = 5),
    buffer channels = C, conv grid (T/64 row tiles, C/64 column tiles
    rounded up)."""
    want = [(1536, 768, (24, 12)), (6144, 384, (96, 6)), (12288, 192, (192, 3)),
            (24576, 96, (384, 2)), (49152, 48, (768, 1)), (98304, 24, (1536, 1))]
    for t_len, c, conv_grid in want:
        plan = amp_stage.stage_plan(1, t_len, c, KS, DILS)
        assert plan == (25, c, conv_grid), (t_len, c, plan)
    # two clips of 4099 rows at C = 24: 65 row tiles each, the last one partial
    assert amp_stage.stage_plan(2, 4099, 24, KS, DILS) == (25, 24, (2 * 65, 1))
    with pytest.raises(ValueError, match="multiple of 8"):
        amp_stage.stage_plan(1, 64, 12, KS, DILS)


def _sin_sq_f32(a):
    """csrc/snake.cuh::sin_sq in float32 numpy, each fmaf as the exact
    product plus the addend, rounded once (float64 holds the product of two
    float32 exactly)."""
    f = np.float32

    def fma(x, y, z):
        return (x.astype(np.float64) * y + z).astype(f)

    a = a.astype(f)
    j = np.rint(a * f(0.636619772)).astype(f)
    r = fma(j, f(-1.57079601e+00), a)
    r = fma(j, f(-3.13916473e-07), r)
    r = fma(j, f(-5.39030253e-15), r)
    s = r * r
    ps = fma(fma(np.full_like(s, -1.95152959e-4), s, f(8.33216087e-3)), s, f(-1.66666546e-1))
    ps = fma(ps * s, r, r)
    pc = fma(fma(fma(np.full_like(s, 2.44331571e-5), s, f(-1.38873163e-3)), s, f(4.16666457e-2)), s, f(-0.5))
    pc = fma(pc, s, f(1.0))
    v = np.where(j.astype(np.int64) & 1, pc, ps)
    return v, v * v


def test_k3_branchless_sine_is_within_two_ulps_of_sin():
    """The activation's sine without sinf's slow-path branch (sin_sq, for
    |alpha u| <= 105615): |v| within 2 f32 ulps of |sin| in float64 over the
    kernel's range, and v^2 within 1e-6 of sin^2, so the snake's output
    matches the plain version's torch.sin to f32 rounding."""
    rng = np.random.default_rng(0)
    a = np.concatenate([rng.uniform(-10, 10, 20000), rng.uniform(-105615, 105615, 20000),
                        1e-3 * rng.standard_normal(2000)]).astype(np.float32)
    v, sq = _sin_sq_f32(a)
    ref = np.sin(a.astype(np.float64))
    ulp = np.spacing(np.abs(ref).astype(np.float32)).astype(np.float64)
    assert np.max(np.abs(np.abs(v.astype(np.float64)) - np.abs(ref)) / ulp) <= 2.0
    assert np.max(np.abs(sq.astype(np.float64) - ref ** 2)) <= 1e-6
