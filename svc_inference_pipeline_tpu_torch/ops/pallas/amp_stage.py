"""K2: one BigVGAN AMP stage — the mean of the AMPBlock1 stacks that follow a
generator upsampling layer.

Counterpart of ``svc_inference_pipeline_tpu/ops/pallas/amp_stage.py``. Each
block is a chain of pairs ``a <- a + conv_1(act(conv_d(act(a))))``; the stage
output is the mean over the blocks. On CUDA the stage is ONE host call,
``svc_amp_stage`` (``csrc/amp_stage.cu``), which issues 2 launches of each of
two kernels per pair with programmatic dependent launch: the K3 activation
(``csrc/snake.cuh``), writing the conv operand into a zero-halo buffer, and
a dilated conv1d on the pipelined wgmma tile whose taps are row boxes of
that buffer and whose epilogue adds the bias, the residual and the running
block sum, and applies the mean. Every launch sees the whole sequence, so the
global edges are exact.

Precision (bf16 pipelines, as the TPU kernel): the block carry ``a`` and the
conv outputs stay f32, the conv operands (activation outputs) are rounded to
the input dtype, the stage output is rounded once.

Both versions take the stage's parameters in kernel form, made once by
:func:`kernel_params` when the model is loaded: ``block_params[i]`` is a
tuple over pairs of ``(w1 [k,C,C], b1 [C], w2 [k,C,C], b2 [C], alpha1,
inv_beta1, alpha2, inv_beta2)``, conv weights contiguous in the [k, Cin,
Cout] layout of the JAX package, everything else f32 with the snake's exp
and ``1/(beta + 1e-9)`` applied. A :class:`StageParams` (what
:func:`kernel_params` returns) keeps the stage's launch table, checked and
made on its first CUDA call; a plain tuple is checked on every call.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Sequence, Tuple

import torch
import torch.nn.functional as F

from svc_inference_pipeline_tpu_torch.ops.pallas import snake
from svc_inference_pipeline_tpu_torch.ops.pallas.snake import activation1d_plain, effective_params

TILE = 64  # rows and columns of the conv's output tile (csrc/gemm_wg.cuh)


def conv1d_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, dil: int) -> torch.Tensor:
    """"Same" zero-padded dilated conv of x [B,T,Cin] with w [k,Cin,Cout]:
    operands as given, f32 arithmetic, f32 result [B, T, Cout]."""
    k = w.shape[0]
    y = F.conv1d(
        x.float().transpose(1, 2), w.float().permute(2, 1, 0), b.float(),
        padding=dil * (k - 1) // 2, dilation=dil,
    )
    return y.transpose(1, 2)


@torch.no_grad()
def kernel_params(block_params, kind: str = "snakebeta", logscale: bool = True,
                  dtype: torch.dtype = torch.bfloat16) -> tuple:
    """Per-pair module parameters ``(w1 [k,C,C], b1, w2, b2, alpha1, beta1,
    alpha2, beta2)`` (alpha/beta as the module stores them) -> kernel form:
    contiguous conv weights in ``dtype``, f32 biases, each activation's
    effective (alpha, 1/(beta + 1e-9)). A weight already contiguous in
    ``dtype`` is used as it is, not copied."""
    def pair(w1, b1, w2, b2, al1, be1, al2, be2):
        return (w1.to(dtype).contiguous(), b1.float().contiguous(),
                w2.to(dtype).contiguous(), b2.float().contiguous(),
                *(p.contiguous() for p in effective_params(al1, be1, kind, logscale)),
                *(p.contiguous() for p in effective_params(al2, be2, kind, logscale)))

    return StageParams(tuple(pair(*p) for p in pairs) for pairs in block_params)


class StageParams(tuple):
    """A stage's parameters in kernel form (a tuple over blocks of tuples over
    pairs) that keeps its launch table for :func:`fused_amp_stage`, made on
    the first CUDA call."""


def pair_plain(a: torch.Tensor, pair, d: int, cd: torch.dtype) -> torch.Tensor:
    """One pair on the f32 carry a: a + conv_1(act2(conv_d(act1(a)))), the
    conv operands rounded to ``cd``; f32 result (K2's and K7's arithmetic)."""
    w1, b1, w2, b2, al1, ib1, al2, ib2 = pair
    t = activation1d_plain(a, al1, ib1).to(cd)
    t = conv1d_plain(t, w1.to(cd), b1, d)
    t = activation1d_plain(t, al2, ib2).to(cd)
    return a + conv1d_plain(t, w2.to(cd), b2, 1)


def amp_stage_plain(x: torch.Tensor, block_params, ks: Sequence[int],
                    dils_per_block: Sequence[Sequence[int]]) -> torch.Tensor:
    """Plain PyTorch version of the stage, with the kernel's rounding points."""
    cd = x.dtype
    acc = None
    for pairs, dils in zip(block_params, dils_per_block):
        a = x.float()
        for pair, d in zip(pairs, dils):
            a = pair_plain(a, pair, d, cd)
        acc = a if acc is None else acc + a
    return (acc * (1.0 / len(block_params))).to(cd)


def pad_rows(k: int, d: int) -> int:
    """The "same" padding d(k-1)/2 of a k-tap conv with dilation d: the zero
    rows on each side of a clip that its taps read in the conv-input buffer."""
    return d * (k - 1) // 2


def halo_rows(ks: Sequence[int], dils_per_block: Sequence[Sequence[int]]) -> int:
    """Zero rows on each side of a clip in the stage's conv-input buffer: its
    largest :func:`pad_rows`."""
    return max(pad_rows(k, d) for k, dils in zip(ks, dils_per_block) for d in dils)


class StagePlan(NamedTuple):
    """One stage call's layout, as ``svc_amp_stage`` launches it (the
    activation's thread layout is the kernel's own, ``csrc/snake.cuh``)."""

    halo: int        # H: zero rows above and below each clip in the conv-input buffer
    cp: int          # buffer channels: C rounded up to a 16-byte vector of bf16 (C itself: C % 8 == 0)
    conv_grid: tuple  # (clips x 64-row tiles, 64-column tiles) of every conv launch


def stage_plan(b: int, t_len: int, c: int, ks: Sequence[int],
               dils_per_block: Sequence[Sequence[int]]) -> StagePlan:
    """The layout of one stage call on x [b, t_len, c] (pure Python)."""
    if c % 8:
        raise ValueError(f"amp stage: channels {c} must be a multiple of 8")
    return StagePlan(halo_rows(ks, dils_per_block), c, (b * -(-t_len // TILE), -(-c // TILE)))


def check_pair(pair, k: int, c: int, device, who: str) -> None:
    """Raise ValueError unless ``pair`` is one pair in kernel form on
    ``device``: contiguous bf16 [k, c, c] weights and f32 [c] vectors, each
    16-byte aligned (the kernels' vector loads)."""
    w1, b1, w2, b2, *acts = pair
    for w in (w1, w2):
        if w.shape != (k, c, c) or w.dtype != torch.bfloat16 or not w.is_contiguous() \
                or w.device != device or w.data_ptr() % 16:
            raise ValueError(f"{who}: conv weight {w.dtype} {tuple(w.shape)} is not contiguous "
                             f"bf16 [{k}, {c}, {c}] on {device} (see amp_stage.kernel_params)")
    for v in (b1, b2, *acts):
        if v.shape != (c,) or v.dtype != torch.float32 or not v.is_contiguous() \
                or v.device != device or v.data_ptr() % 16:
            raise ValueError(f"{who}: per-channel parameter {v.dtype} {tuple(v.shape)} is not "
                             f"contiguous f32 [{c}] on {device} (see amp_stage.kernel_params)")


def _check_params(c, device, block_params, ks, dils_per_block) -> None:
    if len(block_params) != len(ks) or len(ks) != len(dils_per_block):
        raise ValueError("amp stage: block_params, ks and dils_per_block differ in length")
    for pairs, k, dils in zip(block_params, ks, dils_per_block):
        if len(pairs) != len(dils) or not dils:
            raise ValueError("amp stage: one parameter tuple per dilation expected")
        for pair in pairs:
            check_pair(pair, k, c, device, "amp stage")


def stage_table(block_params, ks, dils_per_block, c: int, device) -> tuple:
    """The host arrays ``svc_amp_stage`` reads, after checking every
    parameter once: 8 device pointers per pair, (k, d) per pair, pairs per
    block. Kept on a :class:`StageParams`."""
    key = (tuple(ks), tuple(map(tuple, dils_per_block)), c, device)
    tables = getattr(block_params, "_tables", None)
    if tables is not None and key in tables:
        return tables[key]
    _check_params(c, device, block_params, ks, dils_per_block)
    pairs = [pair for block in block_params for pair in block]
    kd = [v for k, dils in zip(ks, dils_per_block) for d in dils for v in (k, d)]
    table = ((ctypes.c_void_p * (8 * len(pairs)))(*(v.data_ptr() for pair in pairs for v in pair)),
             (ctypes.c_int * len(kd))(*kd),
             (ctypes.c_int * len(block_params))(*(len(block) for block in block_params)))
    if isinstance(block_params, StageParams):
        if tables is None:
            tables = block_params._tables = {}
        tables[key] = table
    return table


def _check_x(x) -> None:
    if x.dim() != 3 or x.dtype != torch.bfloat16 or not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"amp stage: x must be contiguous bf16 [B, T, C], got {x.dtype} {tuple(x.shape)}")
    if x.shape[2] % 8:
        raise ValueError(f"amp stage: channels {x.shape[2]} must be a multiple of 8")


def slab_offsets(sizes: Sequence[int]) -> tuple:
    """(offsets, total bytes) of buffers of ``sizes`` bytes laid out one
    after another in one allocation, each at a 256-byte boundary."""
    offsets, n = [], 0
    for size in sizes:
        offsets.append(n)
        n += -(-size // 256) * 256
    return offsets, n


def scratch(sizes: Sequence[int], device) -> tuple:
    """One allocation holding buffers of ``sizes`` bytes (:func:`slab_offsets`):
    returns it, to be kept alive until the launches are enqueued, and the
    buffers' addresses."""
    offsets, n = slab_offsets(sizes)
    slab = torch.empty(n, dtype=torch.uint8, device=device)
    return slab, [slab.data_ptr() + o for o in offsets]


def fused_amp_stage(x: torch.Tensor, block_params, ks: Tuple[int, ...],
                    dils_per_block: Tuple[Tuple[int, ...], ...]) -> torch.Tensor:
    """One AMP stage of x [B, T, C], parameters in kernel form
    (:func:`kernel_params`). CPU tensors take the plain version; CUDA tensors
    (bf16, C % 8 == 0) run the hand-written kernels in one host call, one
    count per stage in ``fused_amp_stage.launches``."""
    if x.device.type == "cpu":
        return amp_stage_plain(x, block_params, ks, dils_per_block)
    from svc_inference_pipeline_tpu_torch.ops.pallas import _build

    _build.refuse_autograd("fused_amp_stage", x, block_params)
    _check_x(x)
    b, t_len, c = x.shape
    params, kd, pairs_per_block = stage_table(block_params, ks, dils_per_block, c, x.device)
    plan = stage_plan(b, t_len, c, ks, dils_per_block)
    out = torch.empty_like(x)
    f32_bytes = 4 * b * t_len * c  # conv_out, carry and (past one block) total
    slab, ptrs = scratch([2 * b * (t_len + 2 * plan.halo) * c] + [f32_bytes] * (3 if len(block_params) > 1 else 2),
                         x.device)
    buf, conv_out, carry, total = ptrs + [None] * (4 - len(ptrs))
    status = _build.lib().svc_amp_stage(
        x.data_ptr(), out.data_ptr(), buf, conv_out, carry, total, params, kd, pairs_per_block,
        len(block_params), snake._taps_c(), b, t_len, c, plan.halo,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(status, "svc_amp_stage")
    fused_amp_stage.launches += 1
    return out


fused_amp_stage.launches = 0
