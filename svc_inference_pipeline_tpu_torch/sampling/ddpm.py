"""Ancestral DDPM sampling over an eager denoiser.

Counterpart of ``svc_inference_pipeline_tpu/sampling/ddpm.py``. A Python
loop over the steps (the JAX package's ``lax.scan``); the main path uses the
fused per-step kernel instead (``ops/pallas/denoiser_step.py``), and this
sampler is the module-level reference it is held to.

Numeric contract: x_T ~ N(0, (1/1.2)^2), x0 clamped to [-1, 1], posterior
mean c2 x0 + c3 x_t, noise scaled by exp(log sigma^2 / 2), no noise at t = 0.
Step i runs t = steps-1-i with noise z[i].

:func:`ddpm_training_loss` is the training objective: the eps-prediction MSE
at a step drawn uniformly for each clip.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple

import torch

from svc_inference_pipeline_tpu_torch.sampling.schedule import DiffusionSchedule

INIT_NOISE_STD = 1.0 / 1.2

DenoiseFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


def step_index(t: int, batch: int) -> torch.Tensor:
    """The fast samplers' step argument: int64 [B, 1] on the CPU, so a
    kernel-backed ``denoise_fn`` reads it without a device synchronisation."""
    return torch.full((batch, 1), int(t), dtype=torch.int64)


def initial_noise(shape: Sequence[int], device, generator: Optional[torch.Generator],
                  noise: Optional[torch.Tensor]) -> torch.Tensor:
    """x_T: ``noise`` (already scaled by INIT_NOISE_STD) or a fresh draw."""
    if noise is None:
        return INIT_NOISE_STD * torch.randn(tuple(shape), generator=generator, device=device)
    return noise.to(device=device, dtype=torch.float32)


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
    x = initial_noise(shape, device, generator, None if noise is None else noise[0])
    num_steps = schedule.num_steps
    for i in range(num_steps):
        if noise is None:
            z = torch.randn(tuple(shape), generator=generator, device=device)
        else:
            z = noise[1][i].to(device=device, dtype=torch.float32)
        x = p_sample_step(denoise_fn, schedule, x, num_steps - 1 - i, cond, z)
    return x


def ddpm_training_loss(denoise_fn: DenoiseFn, x0: torch.Tensor, cond: torch.Tensor,
                       schedule: DiffusionSchedule, generator: Optional[torch.Generator] = None,
                       t: Optional[torch.Tensor] = None,
                       noise: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(eps-prediction MSE, t [B]) at steps ``t`` with the standard-normal
    ``noise`` of x0's shape; either one not given is drawn from ``generator``
    (required then) on x0's device (t uniform in [0, steps)). The JAX objective draws both
    from one key (``t_key, n_key = split(key)``); passing its ``t`` and
    ``noise`` reproduces it."""
    b = x0.shape[0]
    if generator is None and (t is None or noise is None):
        raise ValueError("ddpm_training_loss: draws come from an explicit generator (or pass t and noise)")
    if t is None:
        t = torch.randint(0, schedule.num_steps, (b,), generator=generator, device=x0.device)
    if noise is None:
        noise = torch.randn(x0.shape, generator=generator, device=x0.device, dtype=x0.dtype)
    t = t.to(x0.device)
    noise = noise.to(device=x0.device, dtype=x0.dtype)
    x_t = schedule.q_sample(x0, t, noise)
    eps = denoise_fn(x_t, cond, t[:, None])
    return torch.mean(torch.square(eps - noise)), t
