"""The DiffSVC denoiser's kernels: K1, K5 and their int8 form K6.

Counterpart of ``svc_inference_pipeline_tpu/ops/pallas/denoiser_step.py``:

- K1 (``_ddpm_step_pallas``, driven by ``_ddpm_sample_fused``): one whole
  ancestral DDPM reverse step, :func:`ddpm_step`;
- K5 (``_denoise_pallas``, the forward returning eps for PLMS, DDIM and
  DPM++), :func:`denoise`;
- K6 (the ``quant1``/``quant2`` variants of the body K1 and K5 share): the
  same two entry points on a stack made with ``quantize="int8"`` or
  ``"int8-w1"``.

All are ``csrc/denoiser_step.cu``, GEMM launches with fused epilogues. On a
bf16 stack a call is L + 3 launches: the prologue, skip and output
projections on a prefetching wgmma tile (all that the launch before does
not write in flight before its dependent-launch wait, the epilogue from the
accumulator registers), and one launch a residual layer
(``step_layer_kernel``): a cluster of C/64 blocks owns a 64-row tile, each
block's three warpgroups multiply the gate's three taps, read by TMA from
the zero-halo buffers of :func:`conv_input_buffer`, the gated g crosses the
cluster through distributed shared memory and the residual GEMM runs from
it, so g never goes to device memory. On an int8 stack a call is 2L + 3
launches: the bf16 launches on the ring tile of ``csrc/gemm_wg.cuh``, the
int8 GEMMs on the wgmma s8 tile of ``csrc/gemm_wg_s8.cuh``, whose K-major
weights the int8 stacks carry as copies, the gate split over its taps in
clusters of 3 taps x 2 column tiles that quantise the union of their tap
boxes from h once, the three int32 partials summed exactly. One forward:
mel preprocess, L gated dilated-conv layers over the precomputed
conditioner and step rows, skip and output projections; K1 then applies
x0 = clamp(c0 x - c1 eps, +-1), x' = c2 x0 + c3 x + sigma z.

Numerics follow the TPU kernel: operands rounded to the compute dtype, f32
accumulation, f32 gates and skip sum, h stored at the compute dtype, the
carry x in f32 with the mel padded to ``LANE`` channels (pad lanes stay 0).
int8 (K6): the conv input y = h + step_row (f32, not rounded first) is
quantised with s_y = max(max|y|, 1e-12)/127 per batch element, the weights
per output column (:func:`quantize_cols`); the int32 sums are scaled by
s_y * w1s[col]. In "int8" mode the gate g is quantised with the static
scale 127 and the output projection runs in int8 too (wouts[col]/127);
"int8-w1" keeps the output projection at the compute dtype.

The plain versions compute the int8 products exactly, in float64 (a sum
is at most 3C * 127^2, about 1.9e7 at C = 384, far inside float64's 2^53)
and round it to f32 as the kernel's int32 -> f32 conversion does. On an
int8 stack in bf16 they also sum the bf16 products as the kernel's wgmma
tile does (:func:`wgmma_matmul`): a bf16 h summed in another order moves
a value across a rounding tie of the quantiser, and where that value is a
clip's abs max, the clip's scale and with it most of its codes.

CPU tensors take the plain versions; CUDA tensors launch the kernels (bf16
compute only) or raise.
"""

from __future__ import annotations

import collections
import ctypes
import math
from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from svc_inference_pipeline_tpu_torch.models.diffsvc import INV_SQRT2, DiffSVCDenoiser
from svc_inference_pipeline_tpu_torch.sampling.ddpm import initial_noise
from svc_inference_pipeline_tpu_torch.sampling.schedule import DiffusionSchedule
from svc_inference_pipeline_tpu_torch.utils.observability import Metrics

LANE = 128  # mel channels padded to this width in the carry
QUANTIZE_MODES = (None, "int8", "int8-w1")
INV_127 = np.float32(1.0 / 127.0)
INT8_MAX_CHANNELS = 1024  # the int8 tile holds a tap's whole K = C (csrc/gemm_wg_s8.cuh W8_MAX_K)
# the prefetching tiles take K = C or M_pad up to this (csrc/denoiser_step.cu PF_MAX_K; the
# kernel picks the narrow or the wide tile by K itself)
BF16_MAX_K = 512


class StackedDenoiser(NamedTuple):
    """Per-layer weights stacked for the kernels, in the compute dtype, except
    the int8 weights of a quantised stack and their f32 column scales."""

    w1: torch.Tensor     # [L, 3C, 2C]  tap-major rows: [left; mid; right]
    wout: torch.Tensor   # [L, C, 2C]
    bout: torch.Tensor   # [L, 2C]
    wmel: torch.Tensor   # [M_pad, C]
    bmel: torch.Tensor   # [C]
    wskip: torch.Tensor  # [C, C]
    bskip: torch.Tensor  # [C]
    wo: torch.Tensor     # [C, M_pad]
    bo: torch.Tensor     # [M_pad]
    cycle: int           # dilation 2^(layer mod cycle)
    w1s: Optional[torch.Tensor] = None    # [L, 2C] f32 when w1 is int8
    wouts: Optional[torch.Tensor] = None  # [L, 2C] f32 when wout is int8
    # K-major copies of the int8 weights, the layout the kernels' int8 tile
    # reads (the plain version reads w1 and wout): [l, m, n, c] = w1[l, m*C + c, n]
    # and wout[l] transposed
    w1_kmajor: Optional[torch.Tensor] = None    # [L, 3, 2C, C] int8 when w1 is int8
    wout_kmajor: Optional[torch.Tensor] = None  # [L, 2C, C] int8 when wout is int8

    @property
    def mode(self) -> str:
        """Launch-counter key: "bf16" (no int8 matmul), "int8-w1" or "int8"."""
        if self.wouts is not None:
            return "int8"
        return "int8-w1" if self.w1s is not None else "bf16"


def quantize_cols(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-column int8: w [K, N] ~ q * s, q in [-127, 127],
    s = max(max_k |w|, 1e-12) / 127 (f32)."""
    w = w.float()
    s = torch.clamp(w.abs().amax(dim=0), min=1e-12) / 127.0
    q = torch.clamp(torch.round(w / s), -127, 127).to(torch.int8)
    return q, s


def stack_denoiser_params(den: DiffSVCDenoiser, dtype=torch.bfloat16,
                          quantize: Optional[str] = None) -> StackedDenoiser:
    """Stack the denoiser for the kernels. ``quantize`` "int8" makes w1 and
    wout int8 with column scales, "int8-w1" only w1; the int8 weights are
    quantised from the stored weights cast to f32 and also kept K-major
    (``w1_kmajor``, ``wout_kmajor``) for the kernels."""
    if quantize not in QUANTIZE_MODES:
        raise ValueError(f"unknown quantize mode {quantize!r} (use None, 'int8' or 'int8-w1')")
    cfg = den.cfg
    n_mel = cfg.n_mel
    m_pad = -(-n_mel // LANE) * LANE
    blocks = [den.block(i) for i in range(den.n_layers)]
    c = cfg.residual_channels

    def cast(x):
        return x.detach().to(dtype).contiguous()

    def stack_q(ws):
        qs = [quantize_cols(w) for w in ws]
        return torch.stack([q for q, _ in qs]), torch.stack([s for _, s in qs])

    w1_f = [b.dilated_conv.weight.detach().permute(2, 1, 0).reshape(-1, 2 * c).float() for b in blocks]
    wout_f = [b.output_projection.weight.detach().t().float() for b in blocks]
    w1s = wouts = None
    if quantize is None:
        w1 = cast(torch.stack(w1_f))
    else:
        w1, w1s = stack_q(w1_f)
    if quantize == "int8":
        wout, wouts = stack_q(wout_f)
    else:
        wout = cast(torch.stack(wout_f))
    bout = torch.stack([b.output_projection.bias for b in blocks])
    wmel = F.pad(den.mel_preprocess.weight.t(), (0, 0, 0, m_pad - n_mel))
    wo = F.pad(den.output_projection.weight.t(), (0, m_pad - n_mel))
    bo = F.pad(den.output_projection.bias, (0, m_pad - n_mel))
    w1_kmajor = None if w1s is None else w1.view(len(blocks), 3, c, 2 * c).transpose(-1, -2).contiguous()
    wout_kmajor = None if wouts is None else wout.transpose(-1, -2).contiguous()
    return StackedDenoiser(
        w1.contiguous(), wout.contiguous(), cast(bout), cast(wmel), cast(den.mel_preprocess.bias),
        cast(den.skip_projection.weight.t()), cast(den.skip_projection.bias),
        cast(wo), cast(bo), cfg.dilation_cycle_length, w1s, wouts, w1_kmajor, wout_kmajor,
    )


def fold_conditioner(den: DiffSVCDenoiser, cond_projs: torch.Tensor,
                     dtype=torch.bfloat16) -> torch.Tensor:
    """cond_projs [L,B,T,2C] + the dilated-conv bias (f32) -> [L, B, T, 2C]
    in ``dtype``: one add per layer instead of two."""
    b1 = torch.stack([den.block(i).dilated_conv.bias.detach().float() for i in range(den.n_layers)])
    return (cond_projs.float() + b1[:, None, None, :]).to(dtype).contiguous()


def schedule_rows(schedule: DiffusionSchedule) -> np.ndarray:
    """[steps, 5] f32 rows (c0, c1, c2, c3, sigma) in sampling order
    (t = steps-1 ... 0); sigma = 0 at t = 0."""
    ts = np.arange(schedule.num_steps - 1, -1, -1)
    sigma = np.where(ts > 0, np.exp(0.5 * schedule.posterior_log_variance_clipped[ts]), 0.0)
    return np.stack([
        schedule.sqrt_recip_alphas_cumprod[ts],
        schedule.sqrt_recipm1_alphas_cumprod[ts],
        schedule.posterior_mean_coef1[ts],
        schedule.posterior_mean_coef2[ts],
        sigma,
    ], axis=1).astype(np.float32)


def _taps(y: torch.Tensor, d: int) -> torch.Tensor:
    """[B, T, C] -> [B, T, 3C]: rows t-d, t, t+d, zero outside [0, T)."""
    t_len = y.shape[1]
    yp = F.pad(y, (0, 0, d, d))
    return torch.cat([yp[:, :t_len], yp[:, d:d + t_len], yp[:, 2 * d:2 * d + t_len]], dim=-1)


def halo_rows(cycle: int) -> int:
    """Zero rows on each side of a clip in the gate's conv-input buffer: the
    largest dilation, 2^(cycle-1)."""
    return 2 ** (cycle - 1)


def conv_input_buffer(b: int, t_len: int, c: int, cycle: int, device) -> torch.Tensor:
    """The bf16 kernels' conv-input scratch [2, B, T + 2*halo, C],
    uninitialised: two buffers by layer parity, layer l reading buffer
    l % 2 and writing layer l + 1's input into the other. The prologue
    kernel writes zeros into each clip's halo rows of both and y_0 into
    buffer 0; the epilogue that writes h writes y = bf16(h + step_row) into
    rows [halo, halo + T); so tap m of the gate at dilation d is the T-row
    box that starts at row halo + (m-1)*d: ``_taps(r(y), d)`` of the plain
    version."""
    return torch.empty((2, b, t_len + 2 * halo_rows(cycle), c), dtype=torch.bfloat16, device=device)


def _int8_matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Exact product of integer-valued a and int8 w, rounded once to f32."""
    return (a.double() @ w.double()).float()


WG_K = 16        # K of one wgmma.m64n64k16 instruction
WG_ALIGN_BITS = 25  # the aligned terms keep 2 bits below the f32 mantissa


def _exponent(v: torch.Tensor) -> torch.Tensor:
    """floor(log2|v|), and -1e4 for 0."""
    return torch.where(v != 0, torch.floor(torch.log2(v.abs())), torch.full_like(v, -1e4))


def wgmma_matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a [..., K] @ w [K, N] of bf16 values, summed as the bf16 tile of
    ``csrc/gemm_wg.cuh`` sums them (wgmma m64n64k16, f32 accumulators): K
    in chunks of 16 in order; in each, the accumulator and the 16 exact
    products are aligned to the largest of the accumulator's exponent and
    the products' exponent sums (floor(log2|a|) + floor(log2|w|)), each
    truncated toward zero at 2^(that - 25), summed exactly, and the sum
    truncated to f32. This model reproduced every element of 40,200 tile
    results on an H100 (three stacks: K = 384 and 128, bf16, int8-w1 and
    int8). f32 result; computed in float64 on a's device."""
    lead, k = a.shape[:-1], a.shape[-1]
    a2, w2 = a.reshape(-1, k).double(), w.double()
    ea, ew = _exponent(a2), _exponent(w2)
    acc = torch.zeros((a2.shape[0], w2.shape[1]), dtype=torch.float64, device=a.device)
    for k0 in range(0, k, WG_K):
        p = a2[:, k0:k0 + WG_K, None] * w2[None, k0:k0 + WG_K, :]
        e = torch.maximum((ea[:, k0:k0 + WG_K, None] + ew[None, k0:k0 + WG_K, :]).amax(1), _exponent(acc))
        q = torch.exp2(e.clamp(min=-900) - WG_ALIGN_BITS)  # all-zero terms: any q
        s = (torch.trunc(acc / q) + torch.trunc(p / q[:, None]).sum(1)) * q  # exact: |terms| < 2^27 q
        f = s.float()
        acc = torch.where(f.double().abs() > s.abs(), torch.nextafter(f, torch.zeros_like(f)), f).double()
    return acc.float().reshape(*lead, w2.shape[1])


def forward_plain(st: StackedDenoiser, condb: torch.Tensor, step_rows_t: torch.Tensor,
                  x: torch.Tensor, trace: Optional[list] = None,
                  kernel_order: Optional[bool] = None) -> torch.Tensor:
    """Plain PyTorch version of the shared forward: x [B, T, M_pad] f32 ->
    eps [B, T, M_pad] f32. ``trace``, a list, receives one dict per layer:
    its input ``h`` (bf16 values in f32) and, on an int8 stack, the conv
    input's scale ``s_y`` [B, 1, 1] and codes ``yq``. ``kernel_order``
    sums the bf16 products as the kernel's tile does (default: on an int8
    stack in bf16)."""
    cd = st.wmel.dtype

    def r(a):  # round to the compute dtype, keep computing in f32
        return a.to(cd).float()

    # the int8 forms quantise, so an ulp of h can move a code, and one at a
    # clip's abs max its scale: their bf16 products are summed in the
    # kernel's order (wgmma_matmul); the bf16 forms sum in f32
    if kernel_order is None:
        kernel_order = st.w1s is not None and cd == torch.bfloat16
    if kernel_order:
        mm = wgmma_matmul
    else:
        def mm(a, w):
            return a @ w.float()

    n_layers = st.w1.shape[0]
    c = st.wskip.shape[0]
    h = r(torch.relu(mm(r(x), st.wmel) + st.bmel.float()))
    skip = torch.zeros(x.shape[:-1] + (c,), dtype=torch.float32, device=x.device)
    for i in range(n_layers):
        d = 2 ** (i % st.cycle)
        y = h + step_rows_t[i].float()
        if st.w1s is not None:
            s_y = torch.clamp(y.abs().amax(dim=(1, 2), keepdim=True), min=1e-12) * INV_127
            yq = torch.clamp(torch.round(y * (1.0 / s_y)), -127.0, 127.0)
            acc = _int8_matmul(_taps(yq, d), st.w1[i]) * (s_y * st.w1s[i])
            if trace is not None:
                trace.append({"h": h, "s_y": s_y, "yq": yq})
        else:
            acc = _taps(r(y), d) @ st.w1[i].float()
            if trace is not None:
                trace.append({"h": h})
        acc = acc + condb[i].float()
        g = torch.sigmoid(acc[..., :c]) * torch.tanh(acc[..., c:])
        if st.wouts is not None:
            gq = torch.clamp(torch.round(g * 127.0), -127.0, 127.0)
            yo = _int8_matmul(gq, st.wout[i]) * (st.wouts[i] * INV_127)
        else:
            yo = mm(r(g), st.wout[i])
        yo = yo + st.bout[i].float()
        h = r((h + yo[..., :c]) * INV_SQRT2)
        skip = skip + yo[..., c:]
    inv_sqrt_l = float(np.float32(1.0 / math.sqrt(n_layers)))
    s1 = torch.relu(mm(r(skip * inv_sqrt_l), st.wskip) + st.bskip.float())
    return mm(r(s1), st.wo) + st.bo.float()


def ddpm_step_plain(st: StackedDenoiser, condb: torch.Tensor, step_rows_t: torch.Tensor,
                    x: torch.Tensor, z: torch.Tensor, srow: Sequence[float]) -> torch.Tensor:
    """Plain PyTorch version of K1: x, z [B, T, M_pad] f32 -> x' [B, T, M_pad] f32."""
    eps = forward_plain(st, condb, step_rows_t, x)
    s0, s1c, s2, s3, s4 = (float(v) for v in srow)
    x0 = torch.clamp(s0 * x - s1c * eps, -1.0, 1.0)
    return s2 * x0 + s3 * x + s4 * z


def denoise_plain(st: StackedDenoiser, condb: torch.Tensor, step_rows_t: torch.Tensor,
                  x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K5: x [B, T, n_mel] f32 -> eps [B, T, n_mel] f32."""
    n_mel = x.shape[-1]
    eps = forward_plain(st, condb, step_rows_t, F.pad(x, (0, st.wmel.shape[0] - n_mel)))
    return eps[..., :n_mel].contiguous()


def _check_cuda_args(name, st, condb, step_rows_t, x) -> None:
    b, t_len = x.shape[:2]
    n_layers, k3, c2 = st.w1.shape
    c = c2 // 2
    m_pad = st.wmel.shape[0]
    if k3 != 3 * c or c % 64 or m_pad % 64:
        raise ValueError(f"{name}: kernel needs k=3 and C, M_pad multiples of 64 (C={c}, M_pad={m_pad})")
    if st.w1s is not None and c > INT8_MAX_CHANNELS:
        raise ValueError(f"{name}: the int8 tile needs C <= {INT8_MAX_CHANNELS} (C={c})")
    if st.w1s is None and max(c, m_pad) > BF16_MAX_K:
        raise ValueError(f"{name}: the bf16 tile needs C, M_pad <= {BF16_MAX_K} (C={c}, M_pad={m_pad})")
    bf, i8, f32 = torch.bfloat16, torch.int8, torch.float32
    want = {
        "w1": ((n_layers, 3 * c, 2 * c), bf if st.w1s is None else i8),
        "wout": ((n_layers, c, 2 * c), bf if st.wouts is None else i8),
        "bout": ((n_layers, 2 * c), bf), "wmel": ((m_pad, c), bf), "bmel": ((c,), bf),
        "wskip": ((c, c), bf), "bskip": ((c,), bf), "wo": ((c, m_pad), bf), "bo": ((m_pad,), bf),
        "condb": ((n_layers, b, t_len, 2 * c), bf), "step_rows_t": ((n_layers, c), bf),
    }
    if st.w1s is not None:
        want["w1s"] = ((n_layers, 2 * c), f32)
        want["w1_kmajor"] = ((n_layers, 3, 2 * c, c), i8)
    if st.wouts is not None:
        want["wouts"] = ((n_layers, 2 * c), f32)
        want["wout_kmajor"] = ((n_layers, 2 * c, c), i8)
    tensors = dict(st._asdict(), condb=condb, step_rows_t=step_rows_t)
    for key, (shape, dtype) in want.items():
        v = tensors[key]
        if v is None:
            raise ValueError(f"{name}: {key} is missing from the {st.mode} stack")
        if v.dtype != dtype or tuple(v.shape) != shape or not v.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous {dtype} {shape}, got {v.dtype} {tuple(v.shape)}")
        if v.device != x.device:
            raise ValueError(f"{name}: {key} is on {v.device}, x on {x.device}")


def _check_f32(name, key, v, shape) -> None:
    if v.dtype != torch.float32 or tuple(v.shape) != tuple(shape) or not v.is_contiguous():
        raise ValueError(f"{name}: {key} must be contiguous f32 {tuple(shape)}, got {v.dtype} {tuple(v.shape)}")


def _ptr(v: Optional[torch.Tensor]) -> Optional[int]:
    return None if v is None else v.data_ptr()


def _forward_operands(st, condb, step_rows_t, x):
    """Scratch buffers and the pointer arguments every entry point shares:
    h, skip, the int8 stack's gate g, s1, the bf16 stack's conv-input
    buffers y (:func:`conv_input_buffer`), step rows, the weights (the
    K-major copies of the int8 ones), the scales and the [L, B] per-layer
    abs-max buffer of the int8 conv input."""
    b, t_len = x.shape[:2]
    n_layers, _, c2 = st.w1.shape
    c = c2 // 2
    h = torch.empty((b * t_len, c), dtype=torch.bfloat16, device=x.device)
    s1 = torch.empty_like(h)
    skip = torch.empty((b * t_len, c), dtype=torch.float32, device=x.device)
    g = amax = y = None
    if st.w1s is None:
        y = conv_input_buffer(b, t_len, c, st.cycle, x.device)
    else:
        g = torch.empty_like(h)  # bf16 gate, or int8 gate in its first half
        amax = torch.empty((n_layers, b), dtype=torch.float32, device=x.device)
    ptrs = (h.data_ptr(), skip.data_ptr(), _ptr(g), s1.data_ptr(), _ptr(y), step_rows_t.data_ptr(),
            (st.w1 if st.w1s is None else st.w1_kmajor).data_ptr(), condb.data_ptr(),
            (st.wout if st.wouts is None else st.wout_kmajor).data_ptr(), st.bout.data_ptr(),
            st.wmel.data_ptr(), st.bmel.data_ptr(), st.wskip.data_ptr(), st.bskip.data_ptr(),
            st.wo.data_ptr(), st.bo.data_ptr(), _ptr(st.w1s), _ptr(st.wouts), _ptr(amax))
    dims = (b, t_len, c, n_layers, st.cycle, st.wmel.shape[0])
    return (h, g, s1, skip, amax, y), ptrs, dims


def _count(fn, mode: str, calls: int = 1) -> None:
    fn.launches += calls
    fn.launches_by_mode[mode] += calls


# K1/K5 launches by kernel, as the C entry points report them (_count_launches):
# "PfShape<NK>" those of step_pf_kernel on the prefetching tile of NK resident K
# chunks of 64, "layer" those of step_layer_kernel
_by_kernel: Dict[str, int] = collections.Counter()


def _launch_report():
    """The host ints a K1/K5 entry point adds its launches to: [0] all, [1]
    ``step_layer_kernel``'s, [2] ``step_pf_kernel``'s, and [3] the NK of that
    prefetching tile."""
    return (ctypes.c_int * 4)()


def _count_launches(launched) -> None:
    """``denoiser/launches`` and ``denoiser/fused_layers`` from what K1/K5
    calls launched, as their C entry points report it in ``launched``
    (:func:`_launch_report`): L + 3 and L a call on a bf16 stack, 2L + 3 and
    0 on an int8 one; and the launches by kernel that
    :func:`launched_tiles` reads."""
    metrics = Metrics.default()
    metrics.incr("denoiser/launches", launched[0])
    metrics.incr("denoiser/fused_layers", launched[1])
    if launched[1]:
        _by_kernel["layer"] += launched[1]
    if launched[2]:
        _by_kernel[f"PfShape<{launched[3]}>"] += launched[2]


def launched_tiles(run) -> Tuple[Any, Dict[str, int]]:
    """(``run()``, the K1/K5 kernels its calls launched by kernel), as the C
    entry points report their launches (the C++ side's choice of kernel and
    tile): ``"PfShape<NK>"`` counts the launches of ``step_pf_kernel`` on the
    prefetching tile of NK resident K chunks of 64, ``"layer"`` those of
    ``step_layer_kernel``, the fused residual layer. A bf16 K1/K5 call on L
    layers makes 3 of the first and L of the second; an int8 one neither."""
    before = dict(_by_kernel)
    out = run()
    grown = {k: v - before.get(k, 0) for k, v in _by_kernel.items()}
    return out, {k: n for k, n in grown.items() if n}


class _StepChain:
    """K1 on one stack over a run of steps of one shape: the operands checked
    and the scratch allocated once, then one C call a step. The scratch is
    reused from step to step, which the stream's order makes safe.
    ``launched`` sums what the steps issued (:func:`_count_launches`)."""

    def __init__(self, st: StackedDenoiser, condb: torch.Tensor, step_rows: torch.Tensor,
                 x: torch.Tensor, z: torch.Tensor):
        from svc_inference_pipeline_tpu_torch.ops.pallas import _build

        _build.refuse_autograd("ddpm_step", st, condb, step_rows, x, z)
        step_rows = step_rows.contiguous()  # kept: the launches read it
        _check_cuda_args("ddpm_step", st, condb, step_rows[0], x)
        for key, v in (("x", x), ("z", z)):
            _check_f32("ddpm_step", key, v, (x.shape[0], x.shape[1], st.wmel.shape[0]))
        self.st = st
        self.steps = 0
        self.launched = _launch_report()
        self._scratch, ptrs, self._dims = _forward_operands(st, condb, step_rows[0], x)
        self._head, self._tail = ptrs[:5], ptrs[6:]  # around the step row's pointer
        self._step_rows = step_rows
        self._rows = step_rows.data_ptr()
        self._row_bytes = step_rows[0].numel() * step_rows.element_size()
        self._fn = _build.lib().svc_ddpm_step
        self._check = _build.check
        self._stream = torch.cuda.current_stream(x.device).cuda_stream

    def step(self, k: int, x: torch.Tensor, z: torch.Tensor, out: torch.Tensor, srow: Sequence[float]) -> None:
        """out = one reverse step of x with noise z on step row k and the five
        schedule scalars srow; x, z and out as the chain was made for, out
        not x."""
        status = self._fn(x.data_ptr(), z.data_ptr(), out.data_ptr(), *self._head,
                          self._rows + k * self._row_bytes, *self._tail, *self._dims, *srow, self.launched,
                          self._stream)
        self._check(status, "svc_ddpm_step")
        self.steps += 1


def ddpm_step(st: StackedDenoiser, condb: torch.Tensor, step_rows_t: torch.Tensor,
              x: torch.Tensor, z: torch.Tensor, srow: Sequence[float]) -> torch.Tensor:
    """One reverse step x_t -> x_{t-1} (K1; K6 on an int8 stack).

    st: stacked weights; condb [L, B, T, 2C] (conditioner + conv bias);
    step_rows_t [L, C] (this step's rows); x, z [B, T, M_pad] f32; srow the
    five schedule scalars of this step. CUDA launches are counted in
    ``ddpm_step.launches`` and, by ``st.mode``, ``ddpm_step.launches_by_mode``.
    """
    if x.device.type == "cpu":
        return ddpm_step_plain(st, condb, step_rows_t, x, z, srow)
    chain = _StepChain(st, condb, step_rows_t[None], x, z)
    out = torch.empty_like(x)
    chain.step(0, x, z, out, [float(v) for v in srow])
    _count(ddpm_step, st.mode)
    _count_launches(chain.launched)
    return out


def denoise(st: StackedDenoiser, condb: torch.Tensor, step_rows_t: torch.Tensor,
            x: torch.Tensor) -> torch.Tensor:
    """The denoiser forward (K5; K6 on an int8 stack): x [B, T, n_mel] f32,
    rounded to the compute dtype, -> eps [B, T, n_mel] f32. CUDA launches are
    counted in ``denoise.launches`` and ``denoise.launches_by_mode``."""
    if x.device.type == "cpu":
        return denoise_plain(st, condb, step_rows_t, x)
    from svc_inference_pipeline_tpu_torch.ops.pallas import _build

    _build.refuse_autograd("denoise", st, condb, step_rows_t, x)
    _check_cuda_args("denoise", st, condb, step_rows_t, x)
    b, t_len, n_mel = x.shape
    m_pad = st.wmel.shape[0]
    if n_mel > m_pad:
        raise ValueError(f"denoise: x has {n_mel} mel channels, the stack {m_pad}")
    _check_f32("denoise", "x", x, (b, t_len, n_mel))

    xp = F.pad(x, (0, m_pad - n_mel))
    eps = torch.empty_like(x)
    _scratch, ptrs, dims = _forward_operands(st, condb, step_rows_t, x)  # alive until enqueued
    launched = _launch_report()
    status = _build.lib().svc_denoise(
        xp.data_ptr(), eps.data_ptr(), *ptrs, *dims, n_mel, launched,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(status, "svc_denoise")
    _count(denoise, st.mode)
    _count_launches(launched)
    return eps


for _fn in (ddpm_step, denoise):
    _fn.launches = 0
    _fn.launches_by_mode = {"bf16": 0, "int8": 0, "int8-w1": 0}


def ddpm_sample_fused(st: StackedDenoiser, condb: torch.Tensor, step_rows: torch.Tensor,
                      schedule: DiffusionSchedule, shape: Tuple[int, int, int],
                      generator: Optional[torch.Generator] = None,
                      noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                      st_fp: Optional[StackedDenoiser] = None, tail: int = 0) -> torch.Tensor:
    """Full ancestral DDPM reverse process with the update inside each step.

    shape (B, T, M). Step i runs t = steps-1-i with noise z[i]. Noise comes
    from ``generator`` on the carry's device, or from ``noise = (x_T [B,T,M],
    z [steps, B, T, M])`` (x_T already scaled by INIT_NOISE_STD), which tests
    use to feed both frameworks the same draws. With ``st_fp``, the last
    ``tail`` steps run on it (the full-precision stack of an int8 ``st``).
    Returns x_0 [B, T, M] f32. On CUDA each stack's steps are one
    :class:`_StepChain`: checked and given scratch once, the carry
    alternating between two buffers.
    """
    b, t_len, n_mel = shape
    m_pad = st.wmel.shape[0]
    device = condb.device
    num_steps = schedule.num_steps
    if step_rows.shape[0] < num_steps:
        raise ValueError(f"ddpm_sample_fused: {step_rows.shape[0]} step rows for {num_steps} steps")
    tail = min(max(int(tail), 0), num_steps) if st_fp is not None else 0
    x_t = initial_noise(shape, device, generator, None if noise is None else noise[0])
    x = F.pad(x_t, (0, m_pad - n_mel)).contiguous()
    z = torch.zeros_like(x)
    rows = schedule_rows(schedule).tolist()
    carry = (x, torch.empty_like(x))
    chains = {}
    for i in range(num_steps):
        if noise is None:
            z[..., :n_mel].normal_(generator=generator)
        else:
            z[..., :n_mel] = noise[1][i].to(device=device, dtype=torch.float32)
        stack = st if i < num_steps - tail else st_fp
        k = num_steps - 1 - i
        if device.type == "cpu":
            x = ddpm_step(stack, condb, step_rows[k], x, z, rows[i])
            continue
        chain = chains.get(id(stack))
        if chain is None:
            chain = chains[id(stack)] = _StepChain(stack, condb, step_rows, x, z)
        chain.step(k, carry[i % 2], z, carry[(i + 1) % 2], rows[i])
        x = carry[(i + 1) % 2]
    for chain in chains.values():
        _count(ddpm_step, chain.st.mode, chain.steps)
        _count_launches(chain.launched)
    return x[..., :n_mel]


def denoiser_stacks(den: DiffSVCDenoiser, dtype=torch.bfloat16, quantize: Optional[str] = None,
                    quantize_tail: int = 0) -> Tuple[StackedDenoiser, Optional[StackedDenoiser]]:
    """(st, st_fp): the stack of the ``quantize`` mode and, for an int8 mode
    with a DDPM tail, the unquantised stack the tail runs on (else None).
    They depend on the weights only, so a pipeline makes them once. They are
    copies of the weights as they are now: after changing the denoiser's
    weights, make them anew."""
    st = stack_denoiser_params(den, dtype, quantize)
    st_fp = stack_denoiser_params(den, dtype) if quantize and quantize_tail > 0 else None
    return st, st_fp


def make_denoise_fn(den: DiffSVCDenoiser, cond: torch.Tensor, num_steps: int,
                    dtype=torch.bfloat16, quantize: Optional[str] = None, quantize_tail: int = 0,
                    stacks: Optional[Tuple[StackedDenoiser, Optional[StackedDenoiser]]] = None):
    """Sampler-compatible ``fn(x, cond, t) -> eps`` over the hoisted
    conditioning and the stacked (optionally int8) weights; ``t`` is the
    [B, 1] step argument of which ``t[0, 0]`` is read. ``fn.fused_ddpm(
    schedule, shape, generator=None, noise=None)`` runs the whole DDPM chain
    on K1, its last ``quantize_tail`` steps on the unquantised stack.
    ``stacks`` passes :func:`denoiser_stacks` made earlier for the same
    ``quantize`` and ``quantize_tail``; without it they are made here."""
    cond_projs, step_rows = den.precompute(cond, num_steps, dtype)
    st, st_fp = stacks or denoiser_stacks(den, dtype, quantize, quantize_tail)
    condb = fold_conditioner(den, cond_projs, dtype)
    step_rows = step_rows.contiguous()

    def fn(x, _cond_unused, t):
        return denoise(st, condb, step_rows[int(t[0, 0])], x)

    def fused_ddpm(schedule, shape, generator=None, noise=None):
        return ddpm_sample_fused(st, condb, step_rows, schedule, shape, generator, noise,
                                 st_fp=st_fp, tail=quantize_tail)

    fn.fused_ddpm = fused_ddpm
    return fn


def make_fused_sampler(den: DiffSVCDenoiser, cond: torch.Tensor, num_steps: int,
                       dtype=torch.bfloat16):
    """The DDPM chain of :func:`make_denoise_fn` at the compute dtype:
    ``sample(schedule, shape, generator=None, noise=None) -> x_0``."""
    return make_denoise_fn(den, cond, num_steps, dtype).fused_ddpm
