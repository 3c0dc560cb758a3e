"""K2: one BigVGAN AMP stage — the mean of the AMPBlock1 stacks that follow a
generator upsampling layer.

Counterpart of ``svc_inference_pipeline_tpu/ops/pallas/amp_stage.py``. Each
block is a chain of pairs ``a <- a + conv_1(act(conv_d(act(a))))``; the stage
output is the mean over the blocks. On CUDA the stage is a composition of
two hand-written kernels, 4 launches per pair: the K3 activation
(``csrc/snake.cuh``) and an implicit-GEMM dilated conv1d (``csrc/amp_stage.cu``)
whose epilogue adds the bias, the residual and the running block sum, and
applies the mean. Every launch sees the whole sequence, so the global edges
are exact.

Precision (bf16 pipelines, as the TPU kernel): the block carry ``a`` and the
conv outputs stay f32, the conv operands (activation outputs) are rounded to
the input dtype, the stage output is rounded once.

Both versions take the stage's parameters in kernel form, made once by
:func:`kernel_params` when the model is loaded: ``block_params[i]`` is a
tuple over pairs of ``(w1 [k,C,C], b1 [C], w2 [k,C,C], b2 [C], alpha1,
inv_beta1, alpha2, inv_beta2)``, conv weights contiguous in the [k, Cin,
Cout] layout of the JAX package, everything else f32 with the snake's exp
and ``1/(beta + 1e-9)`` applied.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from svc_inference_pipeline_tpu_torch.ops.pallas.snake import (
    activation1d_plain,
    effective_params,
    launch_activation1d,
)


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

    return tuple(tuple(pair(*p) for p in pairs) for pairs in block_params)


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


def _conv(lib, x, w, bias, dil, out, res=None, acc_in=None, scale=1.0):
    b, t, cin = x.shape
    k, _, cout = w.shape
    from svc_inference_pipeline_tpu_torch.ops.pallas import _build

    status = lib.svc_conv1d(
        x.data_ptr(), w.data_ptr(), bias.data_ptr(),
        None if res is None else res.data_ptr(), int(res is not None and res.dtype == torch.bfloat16),
        None if acc_in is None else acc_in.data_ptr(), float(scale),
        out.data_ptr(), int(out.dtype == torch.bfloat16),
        b, t, cin, cout, k, dil, torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(status, "svc_conv1d")


def _check_cuda_args(x, block_params, ks, dils_per_block) -> None:
    if x.dim() != 3 or x.dtype != torch.bfloat16 or not x.is_contiguous():
        raise ValueError(f"amp stage: x must be contiguous bf16 [B, T, C], got {x.dtype} {tuple(x.shape)}")
    c = x.shape[2]
    if c % 8:
        raise ValueError(f"amp stage: channels {c} must be a multiple of 8")
    if len(block_params) != len(ks) or len(ks) != len(dils_per_block):
        raise ValueError("amp stage: block_params, ks and dils_per_block differ in length")
    for pairs, k, dils in zip(block_params, ks, dils_per_block):
        if len(pairs) != len(dils):
            raise ValueError("amp stage: one parameter tuple per dilation expected")
        for w1, b1, w2, b2, *acts in pairs:
            for w in (w1, w2):
                if w.shape != (k, c, c) or w.dtype != torch.bfloat16 or not w.is_contiguous() \
                        or w.device != x.device:
                    raise ValueError(f"amp stage: conv weight {w.dtype} {tuple(w.shape)} is not contiguous "
                                     f"bf16 [{k}, {c}, {c}] on {x.device} (see kernel_params)")
            for v in (b1, b2, *acts):
                if v.shape != (c,) or v.dtype != torch.float32 or not v.is_contiguous() \
                        or v.device != x.device:
                    raise ValueError(f"amp stage: per-channel parameter {v.dtype} {tuple(v.shape)} is not "
                                     f"contiguous f32 [{c}] (see kernel_params)")


def fused_amp_stage(x: torch.Tensor, block_params, ks: Tuple[int, ...],
                    dils_per_block: Tuple[Tuple[int, ...], ...]) -> torch.Tensor:
    """One AMP stage of x [B, T, C], parameters in kernel form
    (:func:`kernel_params`). CPU tensors take the plain version; CUDA tensors
    (bf16) run the hand-written kernels, one count per stage in
    ``fused_amp_stage.launches``."""
    if x.device.type == "cpu":
        return amp_stage_plain(x, block_params, ks, dils_per_block)
    _check_cuda_args(x, block_params, ks, dils_per_block)
    from svc_inference_pipeline_tpu_torch.ops.pallas import _build

    lib = _build.lib()
    n_blocks = len(block_params)
    t_buf = torch.empty_like(x)                        # conv operand (bf16)
    c_buf = torch.empty(x.shape, dtype=torch.float32, device=x.device)  # conv_d output
    a = torch.empty_like(c_buf)                        # block carry
    total = torch.empty_like(c_buf) if n_blocks > 1 else None  # running block sum
    out = torch.empty_like(x)
    for bi, (pairs, dils) in enumerate(zip(block_params, dils_per_block)):
        src = x
        for j, ((w1, b1, w2, b2, al1, ib1, al2, ib2), d) in enumerate(zip(pairs, dils)):
            launch_activation1d(src, t_buf, al1, ib1)
            _conv(lib, t_buf, w1, b1, d, c_buf)
            launch_activation1d(c_buf, t_buf, al2, ib2)
            if j < len(pairs) - 1:
                _conv(lib, t_buf, w2, b2, 1, a, res=src)
            elif bi == n_blocks - 1:
                _conv(lib, t_buf, w2, b2, 1, out, res=src, acc_in=total, scale=1.0 / n_blocks)
            else:
                _conv(lib, t_buf, w2, b2, 1, total, res=src, acc_in=total if bi > 0 else None)
            src = a
    fused_amp_stage.launches += 1
    return out


fused_amp_stage.launches = 0
