"""K7: one BigVGAN AMPBlock1 pair, ``x + conv_1(act2(conv_d(act1(x))))``.

Counterpart of ``svc_inference_pipeline_tpu/ops/pallas/amp_pair.py``
(``fused_amp_pair``), the kernel ``AMPBlock1`` runs for C <= 384 on its
per-block route. On a CUDA tensor (bf16) the pair is ONE launch of
``csrc/amp_pair.cu``; on a CPU tensor :func:`fused_amp_pair` runs
:func:`amp_pair_plain`.

Precision (as the TPU kernel): act1 on f32(x); conv operands rounded to x's
dtype (the weights are in it too), f32 accumulation and bias; act2 on the
f32 conv output; ``+ b2 + f32(x)`` rounded once to x's dtype. Edges follow
the composed module globally: the resamplers replicate the edge sample, the
convs pad with zeros.

``pair`` is one entry of :func:`amp_stage.kernel_params`'s per-block tuple:
``(w1 [k,C,C], b1, w2 [k,C,C], b2, alpha1, inv_beta1, alpha2, inv_beta2)``,
conv weights contiguous in the JAX [k, Cin, Cout] layout, the rest f32.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from svc_inference_pipeline_tpu_torch.ops.pallas.amp_stage import pair_plain
from svc_inference_pipeline_tpu_torch.ops.pallas.snake import fir12

MAX_CHANNELS = 384  # AMPBlock1 takes the pair kernel up to this width, as in JAX
ACT_HALO = 5  # input rows an activation output reads on each side (csrc/snake.cuh)
SMEM_LIMIT = 232448  # dynamic shared memory one block may use on an H100
# tile constants of csrc/amp_pair.cu
_CG, _KB, _LDB = 32, 64, 128 + 8


class Plan(NamedTuple):
    """K7's tile and shared-memory layout for one (C, k, d) (all sizes in
    elements or bytes as csrc/amp_pair.cu reads them)."""

    cp: int       # C padded to a multiple of 16 (zero weights past C)
    lda: int      # bf16 row stride of the activation buffers A1 and A3
    ldf: int      # f32 row stride of the conv_d output A2 and the output tile
    tt: int       # output rows per block
    mp1: int      # conv_d output rows per block (act2's input), padded to 16
    off_ss2: int  # byte offset of act2's snake samples, after A3 in region 1
    off2: int     # byte offset of region 2 (act1's samples, A2, output tile)
    offb: int     # byte offset of the staged weight chunk
    smem: int     # dynamic shared memory bytes


def _up(n: int, m: int) -> int:
    return -(-n // m) * m


def pair_halo(k: int, d: int) -> int:
    """Input rows a pair's output row depends on, on each side."""
    return 2 * ACT_HALO + (d + 1) * (k - 1) // 2


def plan(c: int, k: int, d: int) -> Plan:
    """The widest output tile (32 or 16 rows) whose buffers fit in shared
    memory: A1 = act1 on tt + k - 1 + 2 ACT_HALO + d (k - 1) rows (plus the
    rows conv_d's padded rows read), A2 (f32) on mp1 rows, A3 on tt + k - 1
    rows, act1's and act2's snake samples and a 64-row weight chunk."""
    if c % 8 or not 0 < c <= MAX_CHANNELS or k % 2 == 0 or k < 1 or d < 1:
        raise ValueError(f"amp pair: needs C % 8 == 0, C <= {MAX_CHANNELS}, odd k, d >= 1 "
                         f"(got C={c}, k={k}, d={d})")
    cp = _up(c, 16)
    lda, ldf = cp + 16, cp + 4
    for tt in (32, 16):
        n3 = tt + k - 1
        n2 = n3 + 2 * ACT_HALO
        n1 = n2 + d * (k - 1)
        mp1 = _up(n2, 16)
        if mp1 > 64:
            continue
        off_ss2 = _up(n3 * lda * 2, 128)
        reg1 = max((mp1 + d * (k - 1)) * lda * 2, off_ss2 + (2 * n3 + 12) * _CG * 4)
        reg2 = max(mp1 * ldf * 4, (2 * n1 + 12) * _CG * 4, tt * ldf * 4)
        off2 = _up(reg1, 128)
        offb = off2 + _up(reg2, 128)
        smem = offb + _KB * _LDB * 2
        if smem <= SMEM_LIMIT:
            return Plan(cp, lda, ldf, tt, mp1, off_ss2, off2, offb, smem)
    raise ValueError(f"amp pair: k={k}, d={d} at C={c} needs more shared memory than a block has")


def amp_pair_plain(x: torch.Tensor, pair, k: int, d: int) -> torch.Tensor:
    """Plain PyTorch version of the pair on x [B, T, C], with K7's rounding
    points; returns x's dtype."""
    if pair[0].shape[0] != k:
        raise ValueError(f"amp pair: weight has {pair[0].shape[0]} taps, k={k}")
    return pair_plain(x.float(), pair, d, x.dtype).to(x.dtype)


def _check_cuda_args(x, pair, k, d) -> Plan:
    if x.dim() != 3 or x.dtype != torch.bfloat16 or not x.is_contiguous():
        raise ValueError(f"amp pair: x must be contiguous bf16 [B, T, C], got {x.dtype} {tuple(x.shape)}")
    c = x.shape[2]
    p = plan(c, k, d)
    w1, b1, w2, b2, *acts = pair
    for w in (w1, w2):
        if w.shape != (k, c, c) or w.dtype != torch.bfloat16 or not w.is_contiguous() or w.device != x.device:
            raise ValueError(f"amp pair: conv weight {w.dtype} {tuple(w.shape)} is not contiguous bf16 "
                             f"[{k}, {c}, {c}] on {x.device} (see amp_stage.kernel_params)")
    for v in (b1, b2, *acts):
        if v.shape != (c,) or v.dtype != torch.float32 or not v.is_contiguous() or v.device != x.device:
            raise ValueError(f"amp pair: per-channel parameter {v.dtype} {tuple(v.shape)} is not "
                             f"contiguous f32 [{c}] on {x.device} (see amp_stage.kernel_params)")
    return p


def fused_amp_pair(x: torch.Tensor, pair, k: int, d: int) -> torch.Tensor:
    """One AMPBlock1 pair of x [B, T, C] with dilation d, parameters in
    kernel form. CPU tensors take the plain version; CUDA tensors (bf16,
    C % 8 == 0, C <= 384) launch K7, counted in ``fused_amp_pair.launches``."""
    if x.device.type == "cpu":
        return amp_pair_plain(x, pair, k, d)
    p = _check_cuda_args(x, pair, k, d)
    from svc_inference_pipeline_tpu_torch.ops.pallas import _build

    b, t, c = x.shape
    out = torch.empty_like(x)
    taps = (ctypes.c_float * 12)(*fir12())
    status = _build.lib().svc_amp_pair(
        x.data_ptr(), out.data_ptr(), *(v.data_ptr() for v in pair), taps, b, t, c, k, d,
        *p, torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(status, "svc_amp_pair")
    fused_amp_pair.launches += 1
    return out


fused_amp_pair.launches = 0
