"""DDIM sampling (Song et al. 2021), deterministic at eta = 0.

Counterpart of ``svc_inference_pipeline_tpu/sampling/ddim.py``, a Python loop
over the denoise contract of ``sampling/ddpm.py``. Step grid
reversed(range(0, steps, s)); one eps evaluation per step (100 at s = 10):

    x_{t-s} = sqrt(a_{t-s}) x0 + sqrt(max(1 - a_{t-s} - sigma^2, 0)) eps + sigma z (t > 0)
    sigma   = eta sqrt((1 - a_{t-s}) / (1 - a_t)) sqrt(1 - a_t / a_{t-s})

with x0 = (x - sqrt(1 - a_t) eps) / sqrt(a_t) clamped to [-1, 1] and
a_{t-s} = 1 at t = 0. As in the JAX scan, a z is drawn for every step, also
at eta = 0. Coefficients in float32 from the float32 schedule arrays.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from svc_inference_pipeline_tpu_torch.sampling.ddpm import DenoiseFn, initial_noise, step_index
from svc_inference_pipeline_tpu_torch.sampling.schedule import DiffusionSchedule


def ddim_sample(denoise_fn: DenoiseFn, cond: torch.Tensor, shape: Sequence[int],
                schedule: DiffusionSchedule, speedup: int = 10, eta: float = 0.0,
                clip_denoised: bool = True, generator: Optional[torch.Generator] = None,
                noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
    """DDIM reverse process with stride ``speedup`` -> x_0 [B, T, M].

    ``noise = (x_T, z [n_steps, B, T, M])`` injects the draws (x_T already
    scaled by INIT_NOISE_STD); otherwise they come from ``generator``.
    """
    ts = np.arange(0, schedule.num_steps, speedup)[::-1]
    device = cond.device
    x = initial_noise(shape, device, generator, None if noise is None else noise[0])
    a_cum = schedule.alphas_cumprod
    one = np.float32(1.0)
    for i, t in enumerate(ts):
        t = int(t)
        t_prev = max(t - speedup, 0)
        eps = denoise_fn(x, cond, step_index(t, shape[0]))
        a_t = a_cum[t]
        a_prev = a_cum[0] if t_prev == t else a_cum[t_prev]
        a_prev = one if t == 0 else a_prev
        x0 = (x - float(np.sqrt(one - a_t)) * eps) / float(np.sqrt(a_t))
        if clip_denoised:
            x0 = torch.clamp(x0, -1.0, 1.0)
        sigma = np.float32(eta) * np.sqrt((one - a_prev) / (one - a_t)) * np.sqrt(one - a_t / a_prev)
        dir_xt = float(np.sqrt(np.maximum(one - a_prev - sigma ** 2, np.float32(0.0)))) * eps
        if noise is None:
            z = torch.randn(tuple(shape), generator=generator, device=device)
        else:
            z = noise[1][i].to(device=device, dtype=torch.float32)
        x = float(np.sqrt(a_prev)) * x0 + dir_xt + float(sigma) * z * float(t > 0)
    return x
