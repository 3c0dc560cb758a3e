"""Ancestral DDPM sampling over an eager denoiser.

Counterpart of ``svc_inference_pipeline_tpu/sampling/ddpm.py``. A Python
loop over the steps (the JAX package's ``lax.scan``); the main path uses the
fused per-step kernel instead (``ops/pallas/denoiser_step.py``), and this
sampler is the module-level reference it is held to.

Numeric contract: x_T ~ N(0, (1/1.2)^2), x0 clamped to [-1, 1], posterior
mean c2 x0 + c3 x_t, noise scaled by exp(log sigma^2 / 2), no noise at t = 0.
Step i runs t = steps-1-i with noise z[i].
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple

import torch

from svc_inference_pipeline_tpu_torch.sampling.schedule import DiffusionSchedule

INIT_NOISE_STD = 1.0 / 1.2

DenoiseFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


def p_sample_step(denoise_fn: DenoiseFn, schedule: DiffusionSchedule, x: torch.Tensor,
                  t: int, cond: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """One reverse step x_t -> x_{t-1} with the given standard-normal z."""
    t_b = torch.full((x.shape[0], 1), t, dtype=torch.int64, device=x.device)
    eps = denoise_fn(x, cond, t_b)
    x0 = float(schedule.sqrt_recip_alphas_cumprod[t]) * x - float(schedule.sqrt_recipm1_alphas_cumprod[t]) * eps
    x0 = torch.clamp(x0, -1.0, 1.0)
    mean = float(schedule.posterior_mean_coef1[t]) * x0 + float(schedule.posterior_mean_coef2[t]) * x
    if t == 0:
        return mean
    return mean + math.exp(0.5 * float(schedule.posterior_log_variance_clipped[t])) * z


def ddpm_sample(denoise_fn: DenoiseFn, cond: torch.Tensor, shape: Sequence[int],
                schedule: DiffusionSchedule, generator: Optional[torch.Generator] = None,
                noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
    """Full reverse process -> x_0 of ``shape`` [B, T, M].

    ``noise = (x_T, z [steps, B, T, M])`` injects the draws (x_T already
    scaled by INIT_NOISE_STD); otherwise they come from ``generator`` on the
    device of ``cond``.
    """
    device = cond.device
    if noise is None:
        x = INIT_NOISE_STD * torch.randn(tuple(shape), generator=generator, device=device)
    else:
        x = noise[0].to(device=device, dtype=torch.float32)
    num_steps = schedule.num_steps
    for i in range(num_steps):
        if noise is None:
            z = torch.randn(tuple(shape), generator=generator, device=device)
        else:
            z = noise[1][i].to(device=device, dtype=torch.float32)
        x = p_sample_step(denoise_fn, schedule, x, num_steps - 1 - i, cond, z)
    return x
