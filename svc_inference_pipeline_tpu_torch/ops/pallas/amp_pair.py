"""K7: one BigVGAN AMPBlock1 pair, ``x + conv_1(act2(conv_d(act1(x))))``.

Counterpart of ``svc_inference_pipeline_tpu/ops/pallas/amp_pair.py``
(``fused_amp_pair``), the kernel ``AMPBlock1`` runs for C <= 384 on its
per-block route. On a CUDA tensor (bf16) the pair is ONE host call,
``svc_amp_pair`` (``csrc/amp_stage.cu``), which issues K2's activation and
conv for one pair: four launches with programmatic dependent launch, act1
into a zero-halo buffer [B, T + 2H, C] (H = d(k-1)/2), conv_d into an f32
buffer, act2 into the zero-halo buffer, conv_1 with the residual. On a CPU
tensor :func:`fused_amp_pair` runs :func:`amp_pair_plain`.

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

from typing import NamedTuple

import torch

from svc_inference_pipeline_tpu_torch.ops.pallas import amp_stage, snake
from svc_inference_pipeline_tpu_torch.ops.pallas.amp_stage import pair_plain

MAX_CHANNELS = 384  # AMPBlock1 takes the pair kernel up to this width, as in JAX
ACT_HALO = 5  # input rows an activation output reads on each side (csrc/snake.cuh)


def pair_halo(k: int, d: int) -> int:
    """Input rows a pair's output row depends on, on each side."""
    return 2 * ACT_HALO + (d + 1) * (k - 1) // 2


class PairScratch(NamedTuple):
    """The scratch of one ``svc_amp_pair`` call, laid out in one allocation
    by :func:`amp_stage.slab_offsets`."""

    halo: int     # H = d(k-1)/2: zero rows above and below each clip in buf
    sizes: tuple  # bytes of buf (bf16 [B, T + 2H, C]) and conv_out (f32 [B, T, C])


def scratch_layout(b: int, t_len: int, c: int, k: int, d: int) -> PairScratch:
    """The scratch of the pair on x [b, t_len, c] (pure Python)."""
    halo = amp_stage.pad_rows(k, d)
    return PairScratch(halo, (2 * b * (t_len + 2 * halo) * c, 4 * b * t_len * c))


def amp_pair_plain(x: torch.Tensor, pair, k: int, d: int) -> torch.Tensor:
    """Plain PyTorch version of the pair on x [B, T, C], with K7's rounding
    points; returns x's dtype."""
    if pair[0].shape[0] != k:
        raise ValueError(f"amp pair: weight has {pair[0].shape[0]} taps, k={k}")
    return pair_plain(x.float(), pair, d, x.dtype).to(x.dtype)


def check_args(x: torch.Tensor, pair, k: int, d: int) -> None:
    """Raise ValueError unless the kernel takes these arguments: x contiguous
    bf16 [B, T, C], 16-byte aligned, C % 8 == 0 and C <= MAX_CHANNELS, odd k,
    d >= 1, ``pair`` in kernel form on x's device (pure Python)."""
    if x.dim() != 3 or x.dtype != torch.bfloat16 or not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"amp pair: x must be contiguous bf16 [B, T, C], got {x.dtype} {tuple(x.shape)}")
    c = x.shape[2]
    if c % 8 or not 0 < c <= MAX_CHANNELS or k % 2 == 0 or k < 1 or d < 1:
        raise ValueError(f"amp pair: needs C % 8 == 0, C <= {MAX_CHANNELS}, odd k, d >= 1 "
                         f"(got C={c}, k={k}, d={d})")
    amp_stage.check_pair(pair, k, c, x.device, "amp pair")


def fused_amp_pair(x: torch.Tensor, pair, k: int, d: int) -> torch.Tensor:
    """One AMPBlock1 pair of x [B, T, C] with dilation d, parameters in
    kernel form. CPU tensors take the plain version; CUDA tensors (bf16,
    C % 8 == 0, C <= 384) run K7 in one host call, counted in
    ``fused_amp_pair.launches``."""
    if x.device.type == "cpu":
        return amp_pair_plain(x, pair, k, d)
    from svc_inference_pipeline_tpu_torch.ops.pallas import _build

    _build.refuse_autograd("fused_amp_pair", x, pair)
    check_args(x, pair, k, d)

    b, t, c = x.shape
    out = torch.empty_like(x)
    slab, (buf, conv_out) = amp_stage.scratch(scratch_layout(b, t, c, k, d).sizes, x.device)  # alive until enqueued
    status = _build.lib().svc_amp_pair(
        x.data_ptr(), out.data_ptr(), buf, conv_out, *(v.data_ptr() for v in pair), snake._taps_c(),
        b, t, c, k, d, torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(status, "svc_amp_pair")
    fused_amp_pair.launches += 1
    return out


fused_amp_pair.launches = 0
