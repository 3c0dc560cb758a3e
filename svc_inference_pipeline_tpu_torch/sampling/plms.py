"""PLMS fast sampling (pseudo linear multi-step, Liu et al. 2022).

Counterpart of ``svc_inference_pipeline_tpu/sampling/plms.py`` (a
``lax.scan`` there, a Python loop here) over the denoise contract of
``sampling/ddpm.py``: ``denoise_fn(x, cond, t_b)`` with ``t_b`` an int64
CPU tensor [B, 1], so a kernel-backed ``denoise_fn`` reads its step without
a device synchronisation.

Step grid reversed(range(0, steps, s)); t_prev = max(t - s, 0). The first
step is the warm-up: predict to t_prev, evaluate eps there too, average
(two evaluations, so 101 at s = 10). Then Adams-Bashforth of order
min(count, 3) + 1 over the eps history, most recent first. Transfer:

    x_{t-s} = x + (a_{t-s} - a_t) [ x / (sqrt(a_t) (sqrt(a_t) + sqrt(a_{t-s})))
              - eps' / (sqrt(a_t) (sqrt((1-a_{t-s}) a_t) + sqrt((1-a_t) a_{t-s}))) ]

The per-step coefficients are computed in float32 from the float32
schedule arrays, as the JAX scan does.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from svc_inference_pipeline_tpu_torch.sampling.ddpm import DenoiseFn, initial_noise, step_index
from svc_inference_pipeline_tpu_torch.sampling.schedule import DiffusionSchedule


def _transfer(schedule: DiffusionSchedule, x: torch.Tensor, eps: torch.Tensor, t: int,
              t_prev: int) -> torch.Tensor:
    a_t = schedule.alphas_cumprod[t]
    a_prev = schedule.alphas_cumprod[t_prev]
    sq_t, sq_prev = np.sqrt(a_t), np.sqrt(a_prev)
    d_x = sq_t * (sq_t + sq_prev)
    d_eps = sq_t * (np.sqrt((np.float32(1.0) - a_prev) * a_t) + np.sqrt((np.float32(1.0) - a_t) * a_prev))
    return x + float(a_prev - a_t) * (x / float(d_x) - eps / float(d_eps))


def plms_sample(denoise_fn: DenoiseFn, cond: torch.Tensor, shape: Sequence[int],
                schedule: DiffusionSchedule, speedup: int = 10,
                generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """PLMS reverse process with stride ``speedup`` -> x_0 [B, T, M].

    ``noise`` injects x_T (already scaled by INIT_NOISE_STD); otherwise it
    is drawn from ``generator`` on the device of ``cond``.
    """
    ts = np.arange(0, schedule.num_steps, speedup)[::-1]
    b = shape[0]
    x = initial_noise(shape, cond.device, generator, noise)
    history = []  # eps of the earlier steps, most recent first
    for t in ts:
        t = int(t)
        t_prev = max(t - speedup, 0)
        eps = denoise_fn(x, cond, step_index(t, b))
        if not history:
            x_pred = _transfer(schedule, x, eps, t, t_prev)
            eps_prime = (eps + denoise_fn(x_pred, cond, step_index(t_prev, b))) / 2.0
        elif len(history) == 1:
            eps_prime = (3.0 * eps - history[0]) / 2.0
        elif len(history) == 2:
            eps_prime = (23.0 * eps - 16.0 * history[0] + 5.0 * history[1]) / 12.0
        else:
            eps_prime = (55.0 * eps - 59.0 * history[0] + 37.0 * history[1] - 9.0 * history[2]) / 24.0
        x = _transfer(schedule, x, eps_prime, t, t_prev)
        history = [eps] + history[:2]
    return x
