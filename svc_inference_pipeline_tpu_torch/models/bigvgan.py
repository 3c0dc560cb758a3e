"""BigVGAN vocoder generator.

Counterpart of ``svc_inference_pipeline_tpu/models/bigvgan.py``, channels-last
``[B, T, C]`` at every public function. Parameters in PyTorch layouts
(``nn.Conv1d`` [Cout, Cin, k], ``nn.ConvTranspose1d`` [Cin, Cout, K]); the
bridge in ``checkpoints/from_jax.py`` converts the JAX trees.

The generator's AMP stages run through K2 (``ops/pallas/amp_stage.py``) and
its final activation through K3 (``ops/pallas/snake.py``). Its per-block
route (resblock "2", and resblock "1" through ``forward_per_block``) applies
the blocks one by one: an AMPBlock1 pair is one K7 call
(``ops/pallas/amp_pair.py``: K2's activation and conv, four dependent
launches) up to 384 channels, K3 and a conv otherwise.
Every kernel wrapper takes its plain PyTorch version on CPU tensors.
``upsample1d``/``downsample1d`` with
``snake``/``snake_beta`` are the composed anti-aliased activation, the
reference those kernels are held to.

Two routes, chosen when the generator is built, as the JAX generator's
``use_pallas`` chooses them: ``use_kernels=True`` (serving, the default)
runs the kernels above on kernel-form copies of the weights, made once by
``prepare_kernel_params``; the kernels write through ctypes and their
outputs carry no gradient. ``use_kernels=False`` (training) runs every
activation composed on its own alpha/beta and every AMP block through its
own act/conv modules, on any device, and makes or reads no kernel-form
copy, so autograd reaches every parameter. Nothing switches routes on its
own.

The training route also runs channel-sharded (``tp_group``, the model-axis
group of a generator sharded by ``parallel/sharding.py``'s
``VOCODER_TP_RULES``, as the GAN train steps on a mesh run it). The signal
between layers is whole on every rank. ``conv_pre`` and each up-conv are
column-parallel (the rules shard their output channels and bias; JAX
stores an up-conv kernel [K, Cout, Cin]): they compute this rank's output
channels, all-gathered (:func:`gather_from`). Each resblock conv is
row-parallel (the rules shard its input channels): it takes this rank's
channels of its activation's output, and its partial sums join in one
all-reduce (:func:`reduce_from`) before the whole bias. Each activation
runs on this rank's channels (:func:`scatter_to`) with its alpha/beta.
``activation_post`` and ``conv_post`` run replicated.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Any, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from svc_inference_pipeline_tpu_torch.parallel.sharding import copy_to, gather_from, reduce_from, scatter_to


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
    alpha/beta parameters; forward runs K3 (plain version on CPU), or with
    ``use_kernels=False`` the composed activation."""

    def __init__(self, channels: int, kind: str = "snakebeta", logscale: bool = True,
                 use_kernels: bool = True):
        super().__init__()
        self.kind = kind
        self.logscale = logscale
        self.use_kernels = use_kernels
        init = torch.zeros if logscale else torch.ones
        self.alpha = nn.Parameter(init(channels))
        self.beta = nn.Parameter(init(channels)) if kind == "snakebeta" else None

    def params(self):
        return self.alpha, (self.beta if self.beta is not None else self.alpha)

    def forward(self, x: torch.Tensor, tp_group=None) -> torch.Tensor:
        """With ``tp_group``: this rank's channels of the replicated x, the
        activation on them with this rank's alpha/beta."""
        x = scatter_to(x, -1, tp_group)
        if not self.use_kernels:
            return activation1d_composed(x, *self.params(), self.kind, self.logscale)
        from svc_inference_pipeline_tpu_torch.ops.pallas.snake import fused_activation1d

        # a conv's output is a transposed view; the kernel reads [B, T, C] rows
        return fused_activation1d(x.contiguous(), *self.params(), self.kind, self.logscale)


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

    def forward(self, x: torch.Tensor, tp_group=None) -> torch.Tensor:
        """With ``tp_group`` the conv is row-parallel: x holds this rank's
        input channels, the partial sums are all-reduced, then the whole
        bias is added."""
        k, d = self.conv.kernel_size[0], self.dilation
        pad = d * (k - 1) // 2
        dtype = self.compute_dtype or x.dtype
        xp = F.pad(x.to(dtype).transpose(1, 2), (pad, pad + max(0, d * (k - 1) - 2 * pad)))
        if tp_group is None:
            y = F.conv1d(xp, self.conv.weight.to(dtype), self.conv.bias.to(dtype), dilation=d)
            return y.transpose(1, 2)
        y = reduce_from(F.conv1d(xp, self.conv.weight.to(dtype), dilation=d), tp_group)
        return (y + self.conv.bias.to(dtype)[:, None]).transpose(1, 2)

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
    """One AMP block: per dilation d_j an activation, a k-tap conv with
    dilation d_j, an activation and a k-tap conv, applied as the pair
    x <- x + conv2_j(act2_j(conv1_j(act1_j(x)))).

    ``forward`` is the per-block route (JAX ``AMPBlock1(use_pallas=True)``):
    up to 384 channels each pair is one K7 call on the card
    (``ops/pallas/amp_pair.py``, one host call that issues K2's activation
    and conv for the pair: act1, conv_d, act2, conv_1 with the residual, as
    four dependent launches), wider blocks compose the activations (K3) and
    the convs, each pair's output in x's dtype. The generator's default
    route runs whole stages of these blocks through K2 instead
    (:meth:`pair_params`, :meth:`prepare_kernel_params`). With
    ``use_kernels=False`` every pair runs its act/conv modules, the
    activations composed."""

    def __init__(self, cfg: Any, channels: int, kernel_size: int = 3,
                 dilations: Sequence[int] = (1, 3, 5), use_kernels: bool = True):
        super().__init__()
        self.channels = channels
        self.kernel_size = kernel_size
        self.dilations = tuple(dilations)
        self.use_kernels = use_kernels
        self.kind, self.logscale = cfg.activation, cfg.snake_logscale
        for j, d in enumerate(self.dilations):
            for name in (f"act1_{j}", f"act2_{j}"):
                self.add_module(name, Activation1d(channels, cfg.activation, cfg.snake_logscale, use_kernels))
            self.add_module(f"conv1_{j}", TorchConv1d(channels, channels, kernel_size, d))
            self.add_module(f"conv2_{j}", TorchConv1d(channels, channels, kernel_size, 1))
        self.kernel_pairs: Optional[tuple] = None

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

    @torch.no_grad()
    def prepare_kernel_params(self, dtype: torch.dtype) -> None:
        """Put the pairs' parameters in kernel form once (``kernel_pairs``,
        the operands of K7 and, per stage, K2): each conv weight is stored
        contiguous as [k, Cin, Cout] and the module's [Cout, Cin, k] weight
        becomes a view of it, so nothing is duplicated and no launch copies a
        weight. Call when the weights are final and on their device.

        The copies are made from the weights as they are now: ``forward``
        makes them anew on a change of dtype or device, never on a change
        of values. After changing the weights (loading, training), call this
        again before the kernel route runs."""
        from svc_inference_pipeline_tpu_torch.ops.pallas.amp_stage import kernel_params

        for j in range(len(self.dilations)):
            for name in (f"conv1_{j}", f"conv2_{j}"):
                w = getattr(self, name).conv.weight
                w.data = w.data.permute(2, 1, 0).contiguous().permute(2, 1, 0)
        self.kernel_pairs = kernel_params((self.pair_params(),), self.kind, self.logscale, dtype)[0]

    def forward(self, x: torch.Tensor, tp_group=None) -> torch.Tensor:
        from svc_inference_pipeline_tpu_torch.ops.pallas.amp_pair import MAX_CHANNELS, fused_amp_pair

        if tp_group is not None:
            _refuse_kernels_under_tp(self.use_kernels)
        if self.use_kernels and self.channels <= MAX_CHANNELS:
            w = None if self.kernel_pairs is None else self.kernel_pairs[0][0]
            if w is None or w.dtype != x.dtype or w.device != x.device:
                self.prepare_kernel_params(x.dtype)
            x = x.contiguous()
            for pair, d in zip(self.kernel_pairs, self.dilations):
                x = fused_amp_pair(x, pair, self.kernel_size, d)
            return x
        for j in range(len(self.dilations)):
            xt = getattr(self, f"act1_{j}")(x, tp_group)
            xt = getattr(self, f"conv1_{j}")(xt, tp_group)
            xt = getattr(self, f"act2_{j}")(xt, tp_group)
            x = getattr(self, f"conv2_{j}")(xt, tp_group) + x
        return x


class AMPBlock2(nn.Module):
    """The resblock "2" block: per dilation d_j an activation (K3 on the
    card) and a k-tap conv with dilation d_j, x <- conv_j(act_j(x)) + x, in
    x's dtype (JAX ``AMPBlock2``)."""

    def __init__(self, cfg: Any, channels: int, kernel_size: int = 3,
                 dilations: Sequence[int] = (1, 3), use_kernels: bool = True):
        super().__init__()
        self.dilations = tuple(dilations)
        for j, d in enumerate(self.dilations):
            self.add_module(f"act_{j}", Activation1d(channels, cfg.activation, cfg.snake_logscale, use_kernels))
            self.add_module(f"conv_{j}", TorchConv1d(channels, channels, kernel_size, d))

    def forward(self, x: torch.Tensor, tp_group=None) -> torch.Tensor:
        for j in range(len(self.dilations)):
            x = getattr(self, f"conv_{j}")(getattr(self, f"act_{j}")(x, tp_group), tp_group) + x
        return x


class BigVGANGenerator(nn.Module):
    """mel [B, T, n_mels] -> waveform [B, T * prod(upsample_rates)] (f32).

    With resblock "1" every AMP stage runs as one K2 call (the JAX
    generator's stage route, taken there for C <= 768, a VMEM budget of the
    TPU that does not apply here); :meth:`forward_per_block` runs the same
    weights block by block instead (K7 up to 384 channels). With resblock
    "2" the stages always run block by block (AMPBlock2).

    ``use_kernels=False`` is the training route (the JAX generator with
    ``use_pallas=False``): each stage runs :meth:`stage_blocks`, every block
    and activation on its own modules, with no kernel and no kernel-form
    copy, so every parameter gets its gradient."""

    def __init__(self, cfg: Any, compute_dtype: Optional[torch.dtype] = None, use_kernels: bool = True):
        super().__init__()
        if cfg.resblock not in ("1", "2"):
            raise ValueError(f"resblock must be '1' or '2', got {cfg.resblock!r}")
        self.cfg = cfg
        self.compute_dtype = compute_dtype
        self.use_kernels = use_kernels
        block_cls = AMPBlock1 if cfg.resblock == "1" else AMPBlock2
        ch0 = cfg.upsample_initial_channel
        self.conv_pre = TorchConv1d(cfg.input_dim, ch0, 7, dtype=compute_dtype)
        ch = ch0
        for i, (u, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
            cin, ch = ch, ch0 // (2 ** (i + 1))
            self.add_module(f"up_{i}", TorchConvTranspose1d(cin, ch, k, u, dtype=compute_dtype))
            for j, (rk, rd) in enumerate(zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes)):
                self.add_module(f"resblock_{i}_{j}", block_cls(cfg, ch, rk, tuple(rd), use_kernels))
        self.activation_post = Activation1d(ch, cfg.activation, cfg.snake_logscale, use_kernels)
        self.conv_post = TorchConv1d(ch, 1, 7, dtype=compute_dtype)
        self.kernel_stages: Optional[tuple] = None

    def stage_params(self, i: int) -> tuple:
        """Module parameters of stage i: one tuple of pair tuples per AMP block."""
        n = len(self.cfg.resblock_kernel_sizes)
        return tuple(getattr(self, f"resblock_{i}_{j}").pair_params() for j in range(n))

    @torch.no_grad()
    def prepare_kernel_params(self) -> None:
        """Put every AMPBlock1's parameters in kernel form once
        (:meth:`AMPBlock1.prepare_kernel_params`) and gather them per stage
        for K2 (``kernel_stages[i]``). Call when the weights are final and on
        their device; nothing to do for resblock "2". The copies hold the
        weights as they are now: after changing the weights, call this
        again before the next forward (``SVCPipeline.refresh_kernel_params``
        does it for a pipeline)."""
        if self.cfg.resblock != "1":
            return
        from svc_inference_pipeline_tpu_torch.ops.pallas.amp_stage import StageParams

        dtype = self.compute_dtype or self.conv_pre.conv.weight.dtype
        n = len(self.cfg.resblock_kernel_sizes)
        stages = []
        for i in range(len(self.cfg.upsample_rates)):
            blocks = [getattr(self, f"resblock_{i}_{j}") for j in range(n)]
            for blk in blocks:
                blk.prepare_kernel_params(dtype)
            stages.append(StageParams(blk.kernel_pairs for blk in blocks))
        self.kernel_stages = tuple(stages)

    def stage_blocks(self, i: int, x: torch.Tensor, tp_group=None) -> torch.Tensor:
        """Stage i's blocks applied one by one to x, summed at x's dtype and
        divided by their number (the JAX generator's block route)."""
        n = len(self.cfg.resblock_kernel_sizes)
        acc = None
        for j in range(n):
            y = getattr(self, f"resblock_{i}_{j}")(x, tp_group)
            acc = y if acc is None else acc + y
        return acc / n

    def _forward(self, mel: torch.Tensor, per_block: bool, tp_group=None) -> torch.Tensor:
        from svc_inference_pipeline_tpu_torch.ops.pallas.amp_stage import fused_amp_stage

        cfg = self.cfg
        dtype = self.compute_dtype or mel.dtype
        if tp_group is not None:
            _refuse_kernels_under_tp(self.use_kernels)
        if not per_block and self.kernel_stages is None:
            self.prepare_kernel_params()
        # conv_pre and the up-convs column-parallel under TP (their output channels gathered)
        x = gather_from(self.conv_pre(copy_to(mel.to(dtype), tp_group)), -1, tp_group)
        ks = tuple(cfg.resblock_kernel_sizes)
        dils = tuple(tuple(d) for d in cfg.resblock_dilation_sizes)
        for i in range(len(cfg.upsample_rates)):
            x = gather_from(getattr(self, f"up_{i}")(copy_to(x, tp_group)), -1, tp_group)
            if per_block:
                x = self.stage_blocks(i, x, tp_group)
            else:
                x = fused_amp_stage(x.contiguous(), self.kernel_stages[i], ks, dils)
        x = self.activation_post(x)
        x = self.conv_post(x)
        return torch.tanh(x.float())[..., 0]

    def forward(self, mel: torch.Tensor, tp_group=None) -> torch.Tensor:
        """The waveform; ``tp_group`` runs the training route channel-sharded
        (the module docstring), refused on the kernel route."""
        return self._forward(mel, self.cfg.resblock != "1" or not self.use_kernels, tp_group)

    def forward_per_block(self, mel: torch.Tensor) -> torch.Tensor:
        """The generator block by block (resblock "1": each AMPBlock1's own
        forward, K7 up to 384 channels), as ``perf_vocoder_stages`` runs the
        JAX generator's layers."""
        return self._forward(mel, per_block=True)


def _refuse_kernels_under_tp(use_kernels: bool) -> None:
    if use_kernels:
        raise ValueError("tp_group shards the training route (use_kernels=False); the kernel route runs "
                         "whole, and inference splits the vocoder in time (parallel/tp_vocoder.py)")


def vocoder_output_to_audio(wave: torch.Tensor, n_frames: int, hop_length: int) -> torch.Tensor:
    """Trim to n_frames * hop and apply the reference's 20-frame linear
    fade-out to the end (the JAX ``vocoder_output_to_audio``)."""
    wave = wave[..., : n_frames * hop_length]
    fade_len = 20 * hop_length
    fade = torch.linspace(1.0, 0.0, fade_len, dtype=wave.dtype, device=wave.device)
    return torch.cat([wave[..., :-fade_len], wave[..., -fade_len:] * fade], dim=-1)


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
