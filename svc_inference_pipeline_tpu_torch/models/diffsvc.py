"""DiffSVC denoiser — the DiffWave-style dilated-conv epsilon predictor.

Counterpart of ``svc_inference_pipeline_tpu/models/diffsvc.py`` plus the
hoisted form of ``models/diffsvc_fast.py`` (:meth:`DiffSVCDenoiser.precompute`).
Channels-last ``[B, T, C]`` at every public function; parameters in PyTorch
layouts (``nn.Linear`` [out, in], ``nn.Conv1d`` [Cout, Cin, k]) — the bridge
in ``checkpoints/from_jax.py`` converts the JAX trees.

Architecture (config "mapper"): mel preprocess Linear + ReLU, sinusoidal
step embedding through two SiLU projections, ``residual_layer_num`` gated
dilated-conv blocks (dilation 2^(i mod cycle)) with an f32 skip sum, skip
projection + ReLU, output projection.
"""

from __future__ import annotations

import math
from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

INV_SQRT2 = float(torch.tensor(1.0 / math.sqrt(2.0), dtype=torch.float32))


def step_embedding(t: torch.Tensor, dim: int = 128) -> torch.Tensor:
    """Sinusoidal diffusion-step embedding [..., dim] (sin || cos)."""
    half = dim // 2
    timescales = 10.0 ** (torch.arange(half, dtype=torch.float32, device=t.device) * 4.0 / (half - 1))
    args = t[..., None].float() * timescales
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


def linear(layer: nn.Linear, x: torch.Tensor, dtype=None) -> torch.Tensor:
    """Dense at ``dtype`` (inputs, weight and bias cast), flax ``Dense(dtype=)``."""
    dtype = dtype or x.dtype
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


class StepEncoder(nn.Module):
    """Two SiLU-activated projections of the sinusoidal step embedding (f32)."""

    def __init__(self, fc_size: int = 128):
        super().__init__()
        self.projection1 = nn.Linear(128, fc_size)
        self.projection2 = nn.Linear(fc_size, fc_size)

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        x = step_embedding(t, 128)
        x = F.silu(linear(self.projection1, x, torch.float32))
        return F.silu(linear(self.projection2, x, torch.float32))


class ResidualBlock(nn.Module):
    """Gated dilated-conv residual block: x [B,T,C] + step row -> k-tap
    dilated conv (C -> 2C) + conditioner (D -> 2C) -> sigmoid . tanh ->
    Linear (C -> 2C) -> ((x + residual)/sqrt2, skip)."""

    def __init__(self, channels: int, cond_dim: int, fc_size: int, dilation: int,
                 kernel_size: int = 3):
        super().__init__()
        self.dilation = dilation
        self.kernel_size = kernel_size
        self.diffusion_projection = nn.Linear(fc_size, channels)
        self.dilated_conv = nn.Conv1d(channels, 2 * channels, kernel_size, dilation=dilation)
        self.conditioner_projection = nn.Linear(cond_dim, 2 * channels)
        self.output_projection = nn.Linear(channels, 2 * channels)

    def forward(self, x, step, cond, dtype) -> Tuple[torch.Tensor, torch.Tensor]:
        y = x + linear(self.diffusion_projection, step, dtype)
        pad = self.dilation * (self.kernel_size - 1) // 2
        y = F.conv1d(
            F.pad(y.transpose(1, 2), (pad, pad)),
            self.dilated_conv.weight.to(dtype), self.dilated_conv.bias.to(dtype),
            dilation=self.dilation,
        ).transpose(1, 2)
        y = y + linear(self.conditioner_projection, cond, dtype)
        gate, filt = y.chunk(2, dim=-1)
        y = linear(self.output_projection, torch.sigmoid(gate) * torch.tanh(filt), dtype)
        residual, skip = y.chunk(2, dim=-1)
        return (x + residual) * INV_SQRT2, skip


class DiffSVCDenoiser(nn.Module):
    """eps(x_t, cond, t): noisy mel [B,T,M] -> predicted noise [B,T,M] (f32)."""

    def __init__(self, cfg: Any, compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = compute_dtype
        c = cfg.residual_channels
        self.n_layers = cfg.residual_layer_num
        self.mel_preprocess = nn.Linear(cfg.n_mel, c)
        self.diffusion_embedding = StepEncoder(cfg.diffusion_fc_size)
        for i in range(self.n_layers):
            self.add_module(f"residual_{i}", ResidualBlock(
                c, cfg.conditioner_size, cfg.diffusion_fc_size,
                2 ** (i % cfg.dilation_cycle_length), cfg.residual_kernel_size,
            ))
        self.skip_projection = nn.Linear(c, c)
        self.output_projection = nn.Linear(c, cfg.n_mel)

    def block(self, i: int) -> ResidualBlock:
        return getattr(self, f"residual_{i}")

    def forward(self, mel_spec: torch.Tensor, conditioner: torch.Tensor,
                diffusion_step: torch.Tensor) -> torch.Tensor:
        dtype = self.compute_dtype or mel_spec.dtype
        x = torch.relu(linear(self.mel_preprocess, mel_spec, dtype))
        step = self.diffusion_embedding(diffusion_step.reshape(mel_spec.shape[0], -1)).to(dtype)
        cond = conditioner.to(dtype)
        skip_sum = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        for i in range(self.n_layers):
            x, skip = self.block(i)(x, step, cond, dtype)
            skip_sum = skip_sum + skip.float()
        x = skip_sum * float(torch.tensor(1.0 / math.sqrt(self.n_layers), dtype=torch.float32))
        x = torch.relu(linear(self.skip_projection, x, dtype))
        return linear(self.output_projection, x, dtype).float()

    def precompute(self, cond: torch.Tensor, num_steps: int,
                   dtype=torch.bfloat16) -> Tuple[torch.Tensor, torch.Tensor]:
        """Hoist all (cond, t)-only work out of the sampling loop
        (``diffsvc_fast.precompute``): (cond_projs [L, B, T, 2C], step_rows
        [S, L, C]), both in ``dtype``."""
        cond = cond.to(dtype)
        cond_projs = torch.stack(
            [linear(self.block(i).conditioner_projection, cond) for i in range(self.n_layers)]
        )
        ts = torch.arange(num_steps, dtype=torch.float32, device=cond.device)
        h = self.diffusion_embedding(ts).to(dtype)
        step_rows = torch.stack(
            [linear(self.block(i).diffusion_projection, h) for i in range(self.n_layers)], dim=1
        )
        return cond_projs, step_rows
