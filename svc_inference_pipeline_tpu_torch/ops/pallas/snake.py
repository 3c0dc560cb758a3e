"""K3: fused anti-aliased SnakeBeta activation (BigVGAN Activation1d).

Counterpart of ``svc_inference_pipeline_tpu/ops/pallas/snake.py``; the
kernel is ``csrc/snake.cu`` (device code in ``csrc/snake.cuh``, shared with
K2). On a CPU tensor the wrapper runs :func:`activation1d_plain`, the same
polyphase arithmetic in plain PyTorch; on a CUDA tensor it launches the
kernel or raises.

Polyphase form of 2x upsample -> snake -> 2x downsample (filters from
``models.bigvgan.kaiser_sinc_filter1d(0.25, 0.3, 12)``), with both
resampling steps edge-replicating over the whole sequence:

    u[2j]   = 2 sum_{m=2..7} h[15-2m] x[clamp(j+m-5)]
    u[2j+1] = 2 sum_{m=3..8} h[16-2m] x[clamp(j+m-5)]
    s       = u + sin(alpha u)^2 / (beta + 1e-9)
    out[t]  = sum_{i=0..11} h[i] s[clamp(2t+i-5)]
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from svc_inference_pipeline_tpu_torch.models.bigvgan import kaiser_sinc_filter1d


@lru_cache(maxsize=None)
def fir12() -> tuple:
    """The 12-tap Kaiser-sinc filter of the ratio-2 resamplers."""
    return tuple(float(v) for v in kaiser_sinc_filter1d(0.25, 0.3, 12))


def effective_params(alpha, beta, kind: str = "snakebeta", logscale: bool = True):
    """(alpha, 1/(beta + 1e-9)) in f32, exp applied for log-scale parameters."""
    alpha = alpha.float()
    beta = beta.float() if kind == "snakebeta" else alpha
    if logscale:
        alpha = torch.exp(alpha)
        beta = torch.exp(beta)
    return alpha, 1.0 / (beta + 1e-9)


def activation1d_plain(x: torch.Tensor, alpha_eff: torch.Tensor,
                       inv_beta: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: x [B, T, C] -> [B, T, C] (x.dtype),
    f32 arithmetic, effective per-channel parameters."""
    h = fir12()
    t_len = x.shape[1]
    xf = x.float()
    j = torch.arange(t_len, device=x.device)

    def tap(m):
        return xf[:, (j + m - 5).clamp(0, t_len - 1)]

    even = sum(h[15 - 2 * m] * tap(m) for m in range(2, 8))
    odd = sum(h[16 - 2 * m] * tap(m) for m in range(3, 9))
    u = 2.0 * torch.stack([even, odd], dim=2).reshape(x.shape[0], 2 * t_len, x.shape[2])
    s = u + inv_beta * torch.sin(alpha_eff * u) ** 2
    n = 2 * j
    out = sum(h[i] * s[:, (n + i - 5).clamp(0, 2 * t_len - 1)] for i in range(12))
    return out.to(x.dtype)


def launch_activation1d(x, out, alpha_eff, inv_beta) -> None:
    """Kernel launch on CUDA tensors (no count; K2 shares this entry)."""
    from svc_inference_pipeline_tpu_torch.ops.pallas import _build

    b, t, c = x.shape
    taps = (ctypes.c_float * 12)(*fir12())
    status = _build.lib().svc_activation1d(
        x.data_ptr(), int(x.dtype == torch.bfloat16),
        out.data_ptr(), int(out.dtype == torch.bfloat16),
        alpha_eff.data_ptr(), inv_beta.data_ptr(), taps, b, t, c,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(status, "svc_activation1d")


def _check_cuda_args(x, alpha_eff, inv_beta) -> None:
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"activation1d: x must be a contiguous [B, T, C] tensor, got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"activation1d: unsupported dtype {x.dtype}")
    for name, p in (("alpha", alpha_eff), ("inv_beta", inv_beta)):
        if p.dtype != torch.float32 or p.shape != (x.shape[2],) or not p.is_contiguous():
            raise ValueError(f"activation1d: {name} must be contiguous f32 [{x.shape[2]}]")
        if p.device != x.device:
            raise ValueError(f"activation1d: {name} is on {p.device}, x on {x.device}")


def fused_activation1d(x: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor,
                       kind: str = "snakebeta", logscale: bool = True) -> torch.Tensor:
    """Activation1d (ratio 2/2, 12-tap filters) of x [B, T, C] -> x.dtype.

    ``alpha``/``beta`` are the module parameters (log-scale when
    ``logscale``). CPU tensors take the plain version; CUDA tensors launch
    the kernel (counted in ``fused_activation1d.launches``).
    """
    alpha_eff, inv_beta = effective_params(alpha, beta, kind, logscale)
    if x.device.type == "cpu":
        return activation1d_plain(x, alpha_eff, inv_beta)
    alpha_eff, inv_beta = alpha_eff.contiguous(), inv_beta.contiguous()
    _check_cuda_args(x, alpha_eff, inv_beta)
    out = torch.empty_like(x)
    launch_activation1d(x, out, alpha_eff, inv_beta)
    fused_activation1d.launches += 1
    return out


fused_activation1d.launches = 0
