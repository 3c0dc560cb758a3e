"""DPM-Solver++(2M) sampling (Lu et al. 2022).

Counterpart of ``svc_inference_pipeline_tpu/sampling/dpmpp.py``, a Python
loop over the denoise contract of ``sampling/ddpm.py``. With
alpha_t = sqrt(a_t), sigma_t = sqrt(1 - a_t), lambda_t = log(alpha_t / sigma_t):

    x0  = (x - sigma_t eps) / alpha_t, clamped to [-1, 1]
    h   = lambda_{t_next} - lambda_t
    D   = (1 + c) x0 - c x0_prev,  c = 1 / (2 max(r, 1e-20)),  r = h_prev / h
          (h == 0 divides by 1; the first step has c = 0: D = x0)
    x'  = (sigma_{t_next} / sigma_t) x - alpha_{t_next} expm1(-h) D

and the step at t = 0 returns x0. Grid: endpoint-inclusive
linspace(steps - 1, 0, n), one eps evaluation per entry (101 at s = 10).
The schedule arrays alpha, sigma, lambda and every coefficient are float32,
as in the JAX scan.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from svc_inference_pipeline_tpu_torch.sampling.ddpm import DenoiseFn, initial_noise, step_index
from svc_inference_pipeline_tpu_torch.sampling.schedule import DiffusionSchedule


def dpmpp_timesteps(num_steps: int, speedup: int) -> np.ndarray:
    """Endpoint-inclusive descending grid: about num_steps/speedup solver
    steps from num_steps - 1 down to 0."""
    n = max(2, int(round(num_steps / max(speedup, 1))) + 1)
    ts = np.round(np.linspace(num_steps - 1, 0, n)).astype(np.int64)
    return np.unique(ts)[::-1].copy()


def dpmpp_sample(denoise_fn: DenoiseFn, cond: torch.Tensor, shape: Sequence[int],
                 schedule: DiffusionSchedule, speedup: int = 10, order: int = 2,
                 clip_denoised: bool = True, timesteps: Optional[Sequence[int]] = None,
                 generator: Optional[torch.Generator] = None,
                 noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """DPM-Solver++ reverse process -> x_0 [B, T, M]. ``order`` 2 is the
    2M multistep solver, 1 the first-order update; ``timesteps`` overrides
    the grid (descending, last entry 0); ``noise`` injects x_T."""
    if order not in (1, 2):
        raise ValueError(f"order must be 1 or 2, got {order}")
    if timesteps is None:
        ts = dpmpp_timesteps(schedule.num_steps, speedup)
    else:
        ts = np.asarray(timesteps, dtype=np.int64)
        if not ((np.diff(ts) < 0).all() and ts[-1] == 0):
            raise ValueError("timesteps must descend and end at 0")
    t_next = np.append(ts[1:], 0)
    x = initial_noise(shape, cond.device, generator, noise)
    a_cum = schedule.alphas_cumprod
    alphas = np.sqrt(a_cum)
    sigmas = np.sqrt(np.float32(1.0) - a_cum)
    lambdas = np.log(alphas / sigmas)
    x0_prev = torch.zeros_like(x)
    h_prev = np.float32(0.0)
    for i, (t, tn) in enumerate(zip(ts.tolist(), t_next.tolist())):
        eps = denoise_fn(x, cond, step_index(t, shape[0]))
        x0 = (x - float(sigmas[t]) * eps) / float(alphas[t])
        if clip_denoised:
            x0 = torch.clamp(x0, -1.0, 1.0)
        h = lambdas[tn] - lambdas[t]
        if order == 2:
            r = h_prev / (np.float32(1.0) if h == 0.0 else h)
            c = np.float32(0.0) if i == 0 else np.float32(1.0) / (np.float32(2.0) * np.maximum(r, np.float32(1e-20)))
            d = float(np.float32(1.0) + c) * x0 - float(c) * x0_prev
        else:
            d = x0
        if t == 0:
            x = x0
        else:
            x = float(sigmas[tn] / sigmas[t]) * x - float(alphas[tn] * np.expm1(-h)) * d
        x0_prev, h_prev = x0, h
    return x
