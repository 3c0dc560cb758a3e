"""BigVGAN vocoder generator.

Counterpart of ``svc_inference_pipeline_tpu/models/bigvgan.py``, channels-last
``[B, T, C]`` at every public function. Parameters in PyTorch layouts
(``nn.Conv1d`` [Cout, Cin, k], ``nn.ConvTranspose1d`` [Cin, Cout, K]); the
bridge in ``checkpoints/from_jax.py`` converts the JAX trees.

The generator's AMP stages run through K2 (``ops/pallas/amp_stage.py``) and
its final activation through K3 (``ops/pallas/snake.py``); both take their
plain PyTorch versions on CPU tensors. ``upsample1d``/``downsample1d`` with
``snake``/``snake_beta`` are the composed anti-aliased activation, the
reference those kernels are held to.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Any, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


# ---------------------------------------------------------------------------
# Kaiser-windowed sinc filter design (numpy, f64 -> f32)
# ---------------------------------------------------------------------------


def _kaiser_window(n: int, beta: float) -> np.ndarray:
    """Symmetric Kaiser window (torch.kaiser_window(periodic=False))."""
    k = np.arange(n, dtype=np.float64)
    x = 2.0 * k / (n - 1) - 1.0
    return np.i0(beta * np.sqrt(np.maximum(0.0, 1.0 - x * x))) / np.i0(beta)


@lru_cache(maxsize=None)
def kaiser_sinc_filter1d(cutoff: float, half_width: float, kernel_size: int) -> np.ndarray:
    """Low-pass FIR [kernel_size], sum-normalised."""
    even = kernel_size % 2 == 0
    half_size = kernel_size // 2
    delta_f = 4.0 * half_width
    a = 2.285 * (half_size - 1) * math.pi * delta_f + 7.95
    if a > 50.0:
        beta = 0.1102 * (a - 8.7)
    elif a >= 21.0:
        beta = 0.5842 * (a - 21.0) ** 0.4 + 0.07886 * (a - 21.0)
    else:
        beta = 0.0
    window = _kaiser_window(kernel_size, beta)
    if even:
        time = np.arange(-half_size, half_size, dtype=np.float64) + 0.5
    else:
        time = np.arange(kernel_size, dtype=np.float64) - half_size
    if cutoff == 0:
        return np.zeros(kernel_size, dtype=np.float32)
    filt = 2.0 * cutoff * window * np.sinc(2.0 * cutoff * time)
    filt /= filt.sum()
    return filt.astype(np.float32)


# ---------------------------------------------------------------------------
# Composed anti-aliased activation (the reference of K3)
# ---------------------------------------------------------------------------


def _depthwise(x: torch.Tensor, filt: np.ndarray, stride: int = 1, transpose: bool = False):
    c = x.shape[-1]
    w = torch.as_tensor(filt, dtype=x.dtype, device=x.device).view(1, 1, -1).expand(c, 1, -1)
    xt = x.transpose(1, 2)
    if transpose:
        y = F.conv_transpose1d(xt, w, stride=stride, groups=c)
    else:
        y = F.conv1d(xt, w, stride=stride, groups=c)
    return y.transpose(1, 2)


def upsample1d(x: torch.Tensor, ratio: int = 2, kernel_size: Optional[int] = None) -> torch.Tensor:
    """Windowed-sinc xratio upsampling with edge padding: [B,T,C] -> [B,ratio*T,C]."""
    k = int(6 * ratio // 2) * 2 if kernel_size is None else kernel_size
    pad = k // ratio - 1
    pad_left = pad * ratio + (k - ratio) // 2
    pad_right = pad * ratio + (k - ratio + 1) // 2
    filt = kaiser_sinc_filter1d(0.5 / ratio, 0.6 / ratio, k)
    xp = F.pad(x.transpose(1, 2), (pad, pad), mode="replicate").transpose(1, 2)
    y = ratio * _depthwise(xp, filt, stride=ratio, transpose=True)
    return y[:, pad_left: y.shape[1] - pad_right]


def downsample1d(x: torch.Tensor, ratio: int = 2, kernel_size: Optional[int] = None) -> torch.Tensor:
    """Low-pass + decimate xratio with edge padding: [B,T,C] -> [B,T/ratio,C]."""
    k = int(6 * ratio // 2) * 2 if kernel_size is None else kernel_size
    even = k % 2 == 0
    pad_left = k // 2 - int(even)
    pad_right = k // 2
    filt = kaiser_sinc_filter1d(0.5 / ratio, 0.6 / ratio, k)
    xp = F.pad(x.transpose(1, 2), (pad_left, pad_right), mode="replicate").transpose(1, 2)
    return _depthwise(xp, filt, stride=ratio)


def snake(x: torch.Tensor, alpha: torch.Tensor, logscale: bool) -> torch.Tensor:
    """x + (1/alpha) sin^2(alpha x), alpha per channel."""
    if logscale:
        alpha = torch.exp(alpha)
    return x + (1.0 / (alpha + 1e-9)) * torch.sin(x * alpha) ** 2


def snake_beta(x: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor, logscale: bool) -> torch.Tensor:
    """x + (1/beta) sin^2(alpha x), separate frequency and magnitude."""
    if logscale:
        alpha = torch.exp(alpha)
        beta = torch.exp(beta)
    return x + (1.0 / (beta + 1e-9)) * torch.sin(x * alpha) ** 2


def activation1d_composed(x, alpha, beta, kind: str, logscale: bool) -> torch.Tensor:
    """upsample1d -> snake(beta) -> downsample1d, the unfused definition."""
    y = upsample1d(x, 2, 12)
    y = snake(y, alpha, logscale) if kind == "snake" else snake_beta(y, alpha, beta, logscale)
    return downsample1d(y, 2, 12)


class Activation1d(nn.Module):
    """Anti-aliased activation (2x up -> snake -> 2x down) with per-channel
    alpha/beta parameters; forward runs K3 (plain version on CPU)."""

    def __init__(self, channels: int, kind: str = "snakebeta", logscale: bool = True):
        super().__init__()
        self.kind = kind
        self.logscale = logscale
        init = torch.zeros if logscale else torch.ones
        self.alpha = nn.Parameter(init(channels))
        self.beta = nn.Parameter(init(channels)) if kind == "snakebeta" else None

    def params(self):
        return self.alpha, (self.beta if self.beta is not None else self.alpha)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        from svc_inference_pipeline_tpu_torch.ops.pallas.snake import fused_activation1d

        return fused_activation1d(x, *self.params(), self.kind, self.logscale)


# ---------------------------------------------------------------------------
# Conv helpers with torch semantics, channels-last
# ---------------------------------------------------------------------------


class TorchConv1d(nn.Module):
    """Conv1d with symmetric padding d(k-1)/2 (same length), channels-last,
    computed at ``dtype`` (inputs, weight and bias cast)."""

    def __init__(self, cin: int, cout: int, kernel_size: int, dilation: int = 1,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dilation = dilation
        self.compute_dtype = dtype
        self.conv = nn.Conv1d(cin, cout, kernel_size, dilation=dilation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k, d = self.conv.kernel_size[0], self.dilation
        pad = d * (k - 1) // 2
        dtype = self.compute_dtype or x.dtype
        xp = F.pad(x.to(dtype).transpose(1, 2), (pad, pad + max(0, d * (k - 1) - 2 * pad)))
        y = F.conv1d(xp, self.conv.weight.to(dtype), self.conv.bias.to(dtype), dilation=d)
        return y.transpose(1, 2)

    def kernel_kio(self) -> torch.Tensor:
        """Weight in the JAX [k, Cin, Cout] layout (K2's operand)."""
        return self.conv.weight.permute(2, 1, 0)


class TorchConvTranspose1d(nn.ConvTranspose1d):
    """ConvTranspose1d(k, stride u, padding (k-u)//2), channels-last, as u
    polyphase matmul sums: y_r[t] = sum_j x[t-j] @ W[:, :, u*j + r + p].
    Emits exactly T*u samples, which equals torch's (T-1)u - 2p + k only
    when k - 2p == u; other shapes are refused."""

    def __init__(self, cin: int, cout: int, kernel_size: int, stride: int,
                 dtype: Optional[torch.dtype] = None):
        p = (kernel_size - stride) // 2
        if kernel_size - 2 * p != stride:
            raise ValueError(
                f"TorchConvTranspose1d: kernel={kernel_size}, stride={stride}, padding={p} "
                f"gives torch output length (T-1)*{stride} - {2 * p} + {kernel_size} != "
                f"T*{stride}; the polyphase path only supports k - 2*(k-u)//2 == u"
            )
        super().__init__(cin, cout, kernel_size, stride=stride, padding=p)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k, u, p = self.kernel_size[0], self.stride[0], self.padding[0]
        dtype = self.compute_dtype or x.dtype
        b, t_len, _ = x.shape
        max_j = (k - 1) // u + 1
        xp = F.pad(x.to(dtype), (0, 0, max_j, max_j))
        w = self.weight.to(dtype)
        phases = []
        for r in range(u):
            acc = None
            for j in range(-max_j, max_j + 1):
                m = u * j + r + p
                if not 0 <= m < k:
                    continue
                seg = xp[:, max_j - j: max_j - j + t_len] @ w[:, :, m]
                acc = seg if acc is None else acc + seg
            phases.append(acc)
        y = torch.stack(phases, dim=2).reshape(b, t_len * u, -1)
        return y + self.bias.to(y.dtype)


# ---------------------------------------------------------------------------
# AMP blocks + generator
# ---------------------------------------------------------------------------


class AMPBlock1(nn.Module):
    """Parameters of one AMP block: per dilation d_j an activation, a k-tap
    conv with dilation d_j, an activation and a k-tap conv, applied as
    x <- x + conv2_j(act2_j(conv1_j(act1_j(x)))). The generator runs whole
    stages of these blocks through K2 (:meth:`pair_params`)."""

    def __init__(self, cfg: Any, channels: int, kernel_size: int = 3,
                 dilations: Sequence[int] = (1, 3, 5)):
        super().__init__()
        self.dilations = tuple(dilations)
        for j, d in enumerate(self.dilations):
            self.add_module(f"act1_{j}", Activation1d(channels, cfg.activation, cfg.snake_logscale))
            self.add_module(f"act2_{j}", Activation1d(channels, cfg.activation, cfg.snake_logscale))
            self.add_module(f"conv1_{j}", TorchConv1d(channels, channels, kernel_size, d))
            self.add_module(f"conv2_{j}", TorchConv1d(channels, channels, kernel_size, 1))

    def pair_params(self) -> tuple:
        """Per pair (w1 [k,C,C], b1, w2, b2, alpha1, beta1, alpha2, beta2), conv
        weights in the JAX [k, Cin, Cout] layout."""
        out = []
        for j in range(len(self.dilations)):
            c1, c2 = getattr(self, f"conv1_{j}"), getattr(self, f"conv2_{j}")
            a1, b1 = getattr(self, f"act1_{j}").params()
            a2, b2 = getattr(self, f"act2_{j}").params()
            out.append((c1.kernel_kio(), c1.conv.bias, c2.kernel_kio(), c2.conv.bias, a1, b1, a2, b2))
        return tuple(out)


class BigVGANGenerator(nn.Module):
    """mel [B, T, n_mels] -> waveform [B, T * prod(upsample_rates)] (f32)."""

    def __init__(self, cfg: Any, compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        if cfg.resblock != "1":
            raise NotImplementedError("resblock '2' (AMPBlock2) is not ported yet")
        self.cfg = cfg
        self.compute_dtype = compute_dtype
        ch0 = cfg.upsample_initial_channel
        self.conv_pre = TorchConv1d(cfg.input_dim, ch0, 7, dtype=compute_dtype)
        ch = ch0
        for i, (u, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
            cin, ch = ch, ch0 // (2 ** (i + 1))
            self.add_module(f"up_{i}", TorchConvTranspose1d(cin, ch, k, u, dtype=compute_dtype))
            for j, (rk, rd) in enumerate(zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes)):
                self.add_module(f"resblock_{i}_{j}", AMPBlock1(cfg, ch, rk, tuple(rd)))
        self.activation_post = Activation1d(ch, cfg.activation, cfg.snake_logscale)
        self.conv_post = TorchConv1d(ch, 1, 7, dtype=compute_dtype)
        self.kernel_stages: Optional[tuple] = None

    def stage_params(self, i: int) -> tuple:
        """Module parameters of stage i: one tuple of pair tuples per AMP block."""
        n = len(self.cfg.resblock_kernel_sizes)
        return tuple(getattr(self, f"resblock_{i}_{j}").pair_params() for j in range(n))

    @torch.no_grad()
    def prepare_kernel_params(self) -> None:
        """Put K2's parameters in kernel form once (``kernel_stages[i]``):
        each AMP conv weight is stored contiguous as [k, Cin, Cout] and the
        module's [Cout, Cin, k] weight becomes a view of it, so nothing is
        duplicated and no launch copies a weight. Call when the weights are
        final and on their device."""
        from svc_inference_pipeline_tpu_torch.ops.pallas.amp_stage import kernel_params

        for m in self.modules():
            if isinstance(m, AMPBlock1):
                for j in range(len(m.dilations)):
                    for name in (f"conv1_{j}", f"conv2_{j}"):
                        w = getattr(m, name).conv.weight
                        w.data = w.data.permute(2, 1, 0).contiguous().permute(2, 1, 0)
        cfg = self.cfg
        self.kernel_stages = tuple(
            kernel_params(self.stage_params(i), cfg.activation, cfg.snake_logscale,
                          self.compute_dtype or self.conv_pre.conv.weight.dtype)
            for i in range(len(cfg.upsample_rates)))

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        from svc_inference_pipeline_tpu_torch.ops.pallas.amp_stage import fused_amp_stage

        cfg = self.cfg
        dtype = self.compute_dtype or mel.dtype
        if self.kernel_stages is None:
            self.prepare_kernel_params()
        x = self.conv_pre(mel.to(dtype))
        ks = tuple(cfg.resblock_kernel_sizes)
        dils = tuple(tuple(d) for d in cfg.resblock_dilation_sizes)
        for i in range(len(cfg.upsample_rates)):
            x = getattr(self, f"up_{i}")(x)
            x = fused_amp_stage(x.contiguous(), self.kernel_stages[i], ks, dils)
        x = self.activation_post(x)
        x = self.conv_post(x)
        return torch.tanh(x.float())[..., 0]


def vocoder_output_finalize(wave: torch.Tensor, n_true: torch.Tensor, hop_length: int,
                            pcm16: bool = False, volume_peak: float = 0.9) -> torch.Tensor:
    """20-frame linear fade-out ending at the TRUE length, zero past it, and
    optionally peak-normalise to ``volume_peak`` + PCM16. wave [B, L]."""
    fade_len = 20 * hop_length
    idx = torch.arange(wave.shape[-1], device=wave.device)[None, :]
    n_end = (n_true.to(torch.int64) * hop_length)[:, None].to(wave.device)
    j = (idx - (n_end - fade_len)).float()
    factor = torch.clamp(1.0 - j / (fade_len - 1), 0.0, 1.0)
    factor = torch.where(idx >= n_end, torch.zeros_like(factor), factor)
    wave = wave * factor
    if not pcm16:
        return wave
    peak = wave.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(peak > 0, volume_peak / torch.clamp(peak, min=1e-30), torch.ones_like(peak))
    return torch.clamp(torch.round(wave * scale * 32767.0), -32768, 32767).to(torch.int16)
