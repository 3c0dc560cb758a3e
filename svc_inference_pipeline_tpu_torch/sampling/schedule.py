"""Diffusion noise schedule and derived constants.

Counterpart of ``svc_inference_pipeline_tpu/sampling/schedule.py``: computed
once in float64 and stored as float32 numpy arrays (host side; the samplers
read per-step scalars from them). The training functions :meth:`q_sample`
and :meth:`predict_start_from_noise` gather their rows by ``t`` on the
tensor's device, in f32.

    betas = linspace(start, end, steps); alphas = 1 - betas
    a_cum = cumprod(alphas); a_prev = [1, a_cum[:-1]]
    c0 = sqrt(1/a_cum), c1 = sqrt(1/a_cum - 1)                 (x0 prediction)
    c2 = beta sqrt(a_prev)/(1-a_cum), c3 = (1-a_prev) sqrt(alpha)/(1-a_cum)
    log sigma^2 = log(max(beta (1-a_prev)/(1-a_cum), 1e-20))
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch


class DiffusionSchedule:
    """Precomputed DDPM constants, each a float32 array of shape [steps]."""

    def __init__(self, **arrays: np.ndarray):
        self.__dict__.update(arrays)

    @classmethod
    def from_betas(cls, betas) -> "DiffusionSchedule":
        betas = np.asarray(betas, dtype=np.float64)
        alphas = 1.0 - betas
        a_cum = np.cumprod(alphas)
        a_prev = np.append(1.0, a_cum[:-1])
        post_var = betas * (1.0 - a_prev) / (1.0 - a_cum)
        arrays = dict(
            betas=betas,
            alphas_cumprod=a_cum,
            alphas_cumprod_prev=a_prev,
            sqrt_alphas_cumprod=np.sqrt(a_cum),
            sqrt_one_minus_alphas_cumprod=np.sqrt(1.0 - a_cum),
            sqrt_recip_alphas_cumprod=np.sqrt(1.0 / a_cum),
            sqrt_recipm1_alphas_cumprod=np.sqrt(1.0 / a_cum - 1.0),
            posterior_mean_coef1=betas * np.sqrt(a_prev) / (1.0 - a_cum),
            posterior_mean_coef2=(1.0 - a_prev) * np.sqrt(alphas) / (1.0 - a_cum),
            posterior_log_variance_clipped=np.log(np.maximum(post_var, 1e-20)),
        )
        return cls(**{k: v.astype(np.float32) for k, v in arrays.items()})

    @classmethod
    def from_factors(cls, factors) -> "DiffusionSchedule":
        """Linear schedule from [start, end, steps] (``noise_schedule_factors``)."""
        start, end, steps = factors
        return cls.from_betas(np.linspace(start, end, int(steps)))

    @classmethod
    def from_config(cls, mapper_cfg: Any) -> "DiffusionSchedule":
        if "noise_schedule" in mapper_cfg and mapper_cfg.get("noise_schedule"):
            return cls.from_betas(np.asarray(mapper_cfg.noise_schedule))
        return cls.from_factors(mapper_cfg.noise_schedule_factors)

    @property
    def num_steps(self) -> int:
        return int(self.betas.shape[0])

    def _rows(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """f32 entries ``t`` of the array ``name``, on ``t``'s device."""
        return torch.as_tensor(getattr(self, name), device=t.device)[t.long()]

    def q_sample(self, x0: torch.Tensor, t: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        """Forward process x_t = sqrt(a_cum_t) x0 + sqrt(1 - a_cum_t) eps;
        ``t`` is [B], x0 and noise [B, T, M]."""
        a = self._rows("sqrt_alphas_cumprod", t)[:, None, None]
        b = self._rows("sqrt_one_minus_alphas_cumprod", t)[:, None, None]
        return a * x0 + b * noise

    def predict_start_from_noise(self, x_t: torch.Tensor, t: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        """x0 = sqrt(1/a_cum_t) x_t - sqrt(1/a_cum_t - 1) eps, the rows of
        ``t`` broadcast against x_t as they come (a scalar ``t`` for one step)."""
        t = torch.as_tensor(t, device=x_t.device)
        return (self._rows("sqrt_recip_alphas_cumprod", t) * x_t
                - self._rows("sqrt_recipm1_alphas_cumprod", t) * noise)
