"""BigVGAN discriminators: multi-period (MPD) and multi-resolution (MRD).

Counterpart of ``svc_inference_pipeline_tpu/models/discriminators.py``, the
adversarial half of the vocoder's training objective (``training/gan.py``).
Waveforms are [B, T]. The conv stacks are ``nn.Conv2d`` in PyTorch's NCHW:
a period branch folds the waveform into [B, 1, T/p, p] (JAX [B, T/p, p, 1]),
a resolution branch reads its magnitude spectrogram as [B, 1, frames, bins]
(JAX [B, frames, bins, 1]). Feature maps are therefore JAX's transposed
(0, 3, 1, 2); the logits, of one channel, flatten in the same order.
Submodules carry the JAX names (``period_2/conv_0``,
``resolution_1024/conv_post``), so ``checkpoints/from_jax.py`` bridges the
trees.
"""

from __future__ import annotations

from typing import Any, List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from svc_inference_pipeline_tpu_torch.ops.mel import stft_magnitude

LRELU_SLOPE = 0.1

Outputs = Tuple[List[torch.Tensor], List[torch.Tensor], List[List[torch.Tensor]], List[List[torch.Tensor]]]


def _get_padding(kernel_size: int, dilation: int = 1) -> int:
    return (kernel_size * dilation - dilation) // 2


class PeriodDiscriminator(nn.Module):
    """One period branch: the waveform folded into [T/p, p], then (k, 1)
    convs over the folded time axis. A length that p does not divide is
    first extended by its last ``pad`` samples reversed, ``x[:, -pad:]
    [:, ::-1]``, which repeats the last sample (the JAX module's pad; torch's
    "reflect" pad would not repeat it)."""

    def __init__(self, period: int, d_mult: float = 1.0, kernel_size: int = 5, stride: int = 3):
        super().__init__()
        self.period = period
        cin = 1
        for i, ch in enumerate((32, 128, 512, 1024)):
            cout = int(ch * d_mult)
            self.add_module(f"conv_{i}", nn.Conv2d(cin, cout, (kernel_size, 1), (stride, 1),
                                                   padding=(_get_padding(5, 1), 0)))
            cin = cout
        self.conv_4 = nn.Conv2d(cin, int(1024 * d_mult), (kernel_size, 1), padding=(2, 0))
        self.conv_post = nn.Conv2d(int(1024 * d_mult), 1, (3, 1), padding=(1, 0))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        b, t = x.shape
        p = self.period
        if t % p:
            pad = p - t % p
            x = torch.cat([x, x[:, -pad:].flip(1)], dim=1)
            t += pad
        h = x.reshape(b, 1, t // p, p)
        fmap = []
        for i in range(5):
            h = F.leaky_relu(getattr(self, f"conv_{i}")(h), LRELU_SLOPE)
            fmap.append(h)
        h = self.conv_post(h)
        fmap.append(h)
        return h.reshape(b, -1), fmap


class ResolutionDiscriminator(nn.Module):
    """One resolution branch: the magnitude spectrogram of (n_fft, hop, win)
    (reflect pad (n_fft - hop)/2, no magnitude floor) through 2-D convs
    strided along frequency."""

    SPECS = (((3, 9), (1, 1)), ((3, 9), (1, 2)), ((3, 9), (1, 2)), ((3, 9), (1, 2)), ((3, 3), (1, 1)))

    def __init__(self, resolution: Sequence[int], d_mult: float = 1.0):
        super().__init__()
        self.resolution = tuple(resolution)
        ch = int(32 * d_mult)
        cin = 1
        for i, (k, s) in enumerate(self.SPECS):
            self.add_module(f"conv_{i}", nn.Conv2d(cin, ch, k, s, padding=(k[0] // 2, k[1] // 2)))
            cin = ch
        self.conv_post = nn.Conv2d(ch, 1, (3, 3), padding=(1, 1))

    def spectrogram(self, x: torch.Tensor) -> torch.Tensor:
        n_fft, hop, win = self.resolution
        pad = (n_fft - hop) // 2
        return stft_magnitude(x, n_fft, hop, win, pad=(pad, pad), pad_mode="reflect", magnitude_floor=0.0)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        h = self.spectrogram(x).transpose(1, 2)[:, None]  # [B, 1, frames, bins]
        fmap = []
        for i in range(len(self.SPECS)):
            h = F.leaky_relu(getattr(self, f"conv_{i}")(h), LRELU_SLOPE)
            fmap.append(h)
        h = self.conv_post(h)
        fmap.append(h)
        return h.reshape(h.shape[0], -1), fmap


def _both(branches, y: torch.Tensor, y_hat: torch.Tensor) -> Outputs:
    outs_r, outs_g, fmaps_r, fmaps_g = [], [], [], []
    for d in branches:
        o_r, f_r = d(y)
        o_g, f_g = d(y_hat)
        outs_r.append(o_r)
        outs_g.append(o_g)
        fmaps_r.append(f_r)
        fmaps_g.append(f_g)
    return outs_r, outs_g, fmaps_r, fmaps_g


class MultiPeriodDiscriminator(nn.Module):
    """A period branch for each of ``cfg.mpd_reshapes`` (the vocoder config):
    (y, y_hat) -> (logits of y, of y_hat, feature maps of y, of y_hat)."""

    def __init__(self, cfg: Any):
        super().__init__()
        self.periods = tuple(cfg.mpd_reshapes)
        for p in self.periods:
            self.add_module(f"period_{p}", PeriodDiscriminator(p, cfg.discriminator_channel_mult))

    def forward(self, y: torch.Tensor, y_hat: torch.Tensor) -> Outputs:
        return _both([getattr(self, f"period_{p}") for p in self.periods], y, y_hat)


class MultiResolutionDiscriminator(nn.Module):
    """A resolution branch for each (n_fft, hop, win) of ``cfg.resolutions``."""

    def __init__(self, cfg: Any):
        super().__init__()
        self.names = [f"resolution_{res[0]}" for res in cfg.resolutions]
        for name, res in zip(self.names, cfg.resolutions):
            self.add_module(name, ResolutionDiscriminator(res, cfg.discriminator_channel_mult))

    def forward(self, y: torch.Tensor, y_hat: torch.Tensor) -> Outputs:
        return _both([getattr(self, n) for n in self.names], y, y_hat)
