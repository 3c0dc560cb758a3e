"""DiffSVC denoiser — the DiffWave-style dilated-conv epsilon predictor.

Counterpart of ``svc_inference_pipeline_tpu/models/diffsvc.py`` plus the
hoisted form of ``models/diffsvc_fast.py`` (:meth:`DiffSVCDenoiser.precompute`).
Channels-last ``[B, T, C]`` at every public function; parameters in PyTorch
layouts (``nn.Linear`` [out, in], ``nn.Conv1d`` [Cout, Cin, k]) — the bridge
in ``checkpoints/from_jax.py`` converts the JAX trees.

Architecture (config "mapper"): mel preprocess Linear + ReLU, sinusoidal
step embedding through two SiLU projections, ``residual_layer_num`` gated
dilated-conv blocks (dilation 2^(i mod cycle)) with an f32 skip sum, skip
projection + ReLU, output projection. Its forward sows JAX's
intermediates (``utils/observability.py::capture_intermediates``).
"""

from __future__ import annotations

import math
from typing import Any, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from svc_inference_pipeline_tpu_torch.parallel.sharding import copy_to, gather_from, row_parallel
from svc_inference_pipeline_tpu_torch.utils.observability import sow

INV_SQRT2 = float(torch.tensor(1.0 / math.sqrt(2.0), dtype=torch.float32))


def step_timescales(half: int) -> np.ndarray:
    """The embedding's timescales 10^(4i/(half-1)), f32, computed on the host
    as JAX's CPU computes them (the f32 exponent, the power in float64, then
    rounded to f32). A device's own f32 pow can differ by an ulp, and t times
    the largest timescale reaches 1e7, where one ulp moves the sine by most
    of a radian; so every device takes this table."""
    return (10.0 ** (np.arange(half, dtype=np.float32) * 4.0 / (half - 1)).astype(np.float64)).astype(np.float32)


def step_embedding(t: torch.Tensor, dim: int = 128) -> torch.Tensor:
    """Sinusoidal diffusion-step embedding [..., dim] (sin || cos)."""
    timescales = torch.tensor(step_timescales(dim // 2), device=t.device)
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
        sow(self, "step_embedding", x)
        x = F.silu(linear(self.projection1, x, torch.float32))
        x = F.silu(linear(self.projection2, x, torch.float32))
        sow(self, "step_encoder_output", x)
        return x


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

    def forward(self, x, step_row, cond_proj, dtype, tp_group=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """The block given its projected step row (whole C) and conditioner
        (2C, or with ``tp_group`` this rank's gate and filter channels of a
        block sharded by ``MAPPER_TP_RULES``: the conv then computes those
        channels, the output projection its share of the sum, all-reduced)."""
        y = copy_to(x + step_row, tp_group)
        pad = self.dilation * (self.kernel_size - 1) // 2
        y = F.conv1d(
            F.pad(y.transpose(1, 2), (pad, pad)),
            self.dilated_conv.weight.to(dtype), self.dilated_conv.bias.to(dtype),
            dilation=self.dilation,
        ).transpose(1, 2)
        y = y + cond_proj
        sow(self, "noise_step_condition", y)
        gate, filt = y.chunk(2, dim=-1)
        g = torch.sigmoid(gate) * torch.tanh(filt)
        if tp_group is None:
            y = linear(self.output_projection, g, dtype)
        else:
            y = row_parallel(g, self.output_projection, tp_group, dtype)
        residual, skip = y.chunk(2, dim=-1)
        return (x + residual) * INV_SQRT2, skip


class DiffSVCDenoiser(nn.Module):
    """eps(x_t, cond, t): noisy mel [B,T,M] -> predicted noise [B,T,M] (f32).

    Every entry point takes ``tp_group``: the model-axis group of a denoiser
    sharded by ``MAPPER_TP_RULES`` (``parallel/sharding.py``), the Megatron
    pattern of JAX's GSPMD placement: the blocks' step projections are
    column shards, all-gathered once a forward; each block's conv and
    conditioner projection are column shards and its output projection a
    row shard, joined by one all-reduce."""

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
                diffusion_step: torch.Tensor, tp_group=None) -> torch.Tensor:
        dtype = self.compute_dtype or mel_spec.dtype
        t = diffusion_step.reshape(mel_spec.shape[0], -1).to(mel_spec.device)
        step = self.diffusion_embedding(t).to(dtype)
        cond = copy_to(conditioner.to(dtype), tp_group)
        cond_projs = [linear(self.block(i).conditioner_projection, cond) for i in range(self.n_layers)]
        return self.layers(mel_spec, self.step_rows(step, tp_group), cond_projs, dtype, tp_group)

    def step_rows(self, h: torch.Tensor, tp_group=None) -> torch.Tensor:
        """The blocks' step projections of the step encoder's output h
        [..., fc] -> [L, ..., C] (gathered whole under TP)."""
        h = copy_to(h, tp_group)
        rows = torch.stack([linear(self.block(i).diffusion_projection, h) for i in range(self.n_layers)])
        return gather_from(rows, -1, tp_group)

    def layers(self, mel_spec: torch.Tensor, step_rows, cond_projs, dtype, tp_group=None) -> torch.Tensor:
        """The x-dependent part: mel preprocess, the blocks over their step
        rows and conditioner projections, skip and output projections."""
        x = torch.relu(linear(self.mel_preprocess, mel_spec, dtype))
        skip_sum = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        for i in range(self.n_layers):
            x, skip = self.block(i)(x, step_rows[i], cond_projs[i], dtype, tp_group)
            skip_sum = skip_sum + skip.float()
        x = skip_sum * float(torch.tensor(1.0 / math.sqrt(self.n_layers), dtype=torch.float32))
        x = torch.relu(linear(self.skip_projection, x, dtype))
        return linear(self.output_projection, x, dtype).float()

    def precompute(self, cond: torch.Tensor, num_steps: int,
                   dtype=torch.bfloat16, tp_group=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Hoist all (cond, t)-only work out of the sampling loop
        (``diffsvc_fast.precompute``): (cond_projs [L, B, T, 2C], step_rows
        [S, L, C]), both in ``dtype`` (cond_projs on this rank's channels
        under TP)."""
        cond = cond.to(dtype)
        cond_projs = torch.stack(
            [linear(self.block(i).conditioner_projection, cond) for i in range(self.n_layers)]
        )
        ts = torch.arange(num_steps, dtype=torch.float32, device=cond.device)
        h = self.diffusion_embedding(ts).to(dtype)
        return cond_projs, self.step_rows(h, tp_group).transpose(0, 1).contiguous()


def make_composed_denoise_fn(den: DiffSVCDenoiser, cond: torch.Tensor, num_steps: int,
                             dtype=torch.bfloat16, tp_group=None):
    """Sampler-compatible ``fn(x, cond, t) -> eps`` of the denoiser's own
    layers over hoisted conditioning (``diffsvc_fast.make_fast_denoise_fn``):
    no kernel, the route of a TP denoiser and of a data-parallel batch that
    does not divide by the data axis. Reads ``t[0, 0]`` (one shared step)."""
    cond_projs, step_rows = den.precompute(cond, num_steps, dtype, tp_group)

    def fn(x, _cond_unused, t):
        return den.layers(x, step_rows[int(t[0, 0])], cond_projs, dtype, tp_group)

    return fn
