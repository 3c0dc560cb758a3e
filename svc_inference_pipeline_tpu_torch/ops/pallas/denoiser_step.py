"""K1: one whole ancestral DDPM reverse step of the DiffSVC denoiser.

Counterpart of ``svc_inference_pipeline_tpu/ops/pallas/denoiser_step.py``
(``_ddpm_step_pallas`` driven by ``_ddpm_sample_fused``); the kernel is
``csrc/denoiser_step.cu`` (2 + 2L GEMM launches per step with fused
epilogues). One step: mel preprocess, L gated dilated-conv layers over the
precomputed conditioner and step rows, skip and output projections, then
x0 = clamp(c0 x - c1 eps, +-1) and x' = c2 x0 + c3 x + sigma z.

Numerics follow the TPU kernel: operands rounded to the compute dtype, f32
accumulation, f32 gates and skip sum, h stored at the compute dtype, the
carry x in f32 with the mel padded to ``LANE`` channels (pad lanes stay 0).

CPU tensors take :func:`ddpm_step_plain`; CUDA tensors launch the kernel
(bf16 only) or raise.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from svc_inference_pipeline_tpu_torch.models.diffsvc import INV_SQRT2, DiffSVCDenoiser
from svc_inference_pipeline_tpu_torch.sampling.ddpm import INIT_NOISE_STD
from svc_inference_pipeline_tpu_torch.sampling.schedule import DiffusionSchedule

LANE = 128  # mel channels padded to this width in the carry


class StackedDenoiser(NamedTuple):
    """Per-layer weights stacked for the kernel, all in the compute dtype."""

    w1: torch.Tensor     # [L, 3C, 2C]  tap-major rows: [left; mid; right]
    wout: torch.Tensor   # [L, C, 2C]
    bout: torch.Tensor   # [L, 2C]
    wmel: torch.Tensor   # [M_pad, C]
    bmel: torch.Tensor   # [C]
    wskip: torch.Tensor  # [C, C]
    bskip: torch.Tensor  # [C]
    wo: torch.Tensor     # [C, M_pad]
    bo: torch.Tensor     # [M_pad]
    cycle: int           # dilation 2^(layer mod cycle)


def stack_denoiser_params(den: DiffSVCDenoiser, dtype=torch.bfloat16) -> StackedDenoiser:
    cfg = den.cfg
    n_mel = cfg.n_mel
    m_pad = -(-n_mel // LANE) * LANE
    blocks = [den.block(i) for i in range(den.n_layers)]
    c = cfg.residual_channels

    def cast(x):
        return x.detach().to(dtype).contiguous()

    w1 = torch.stack([b.dilated_conv.weight.permute(2, 1, 0).reshape(-1, 2 * c) for b in blocks])
    wout = torch.stack([b.output_projection.weight.t() for b in blocks])
    bout = torch.stack([b.output_projection.bias for b in blocks])
    wmel = F.pad(den.mel_preprocess.weight.t(), (0, 0, 0, m_pad - n_mel))
    wo = F.pad(den.output_projection.weight.t(), (0, m_pad - n_mel))
    bo = F.pad(den.output_projection.bias, (0, m_pad - n_mel))
    return StackedDenoiser(
        cast(w1), cast(wout), cast(bout), cast(wmel), cast(den.mel_preprocess.bias),
        cast(den.skip_projection.weight.t()), cast(den.skip_projection.bias),
        cast(wo), cast(bo), cfg.dilation_cycle_length,
    )


def fold_conditioner(den: DiffSVCDenoiser, cond_projs: torch.Tensor,
                     dtype=torch.bfloat16) -> torch.Tensor:
    """cond_projs [L,B,T,2C] + the dilated-conv bias (f32) -> [L, B, T, 2C]
    in ``dtype``: one add per layer instead of two."""
    b1 = torch.stack([den.block(i).dilated_conv.bias.detach().float() for i in range(den.n_layers)])
    return (cond_projs.float() + b1[:, None, None, :]).to(dtype).contiguous()


def schedule_rows(schedule: DiffusionSchedule) -> np.ndarray:
    """[steps, 5] f32 rows (c0, c1, c2, c3, sigma) in sampling order
    (t = steps-1 ... 0); sigma = 0 at t = 0."""
    ts = np.arange(schedule.num_steps - 1, -1, -1)
    sigma = np.where(ts > 0, np.exp(0.5 * schedule.posterior_log_variance_clipped[ts]), 0.0)
    return np.stack([
        schedule.sqrt_recip_alphas_cumprod[ts],
        schedule.sqrt_recipm1_alphas_cumprod[ts],
        schedule.posterior_mean_coef1[ts],
        schedule.posterior_mean_coef2[ts],
        sigma,
    ], axis=1).astype(np.float32)


def ddpm_step_plain(st: StackedDenoiser, condb: torch.Tensor, step_rows_t: torch.Tensor,
                    x: torch.Tensor, z: torch.Tensor, srow: Sequence[float]) -> torch.Tensor:
    """Plain PyTorch version: x, z [B, T, M_pad] f32 -> x' [B, T, M_pad] f32."""
    cd = st.wmel.dtype

    def r(a):  # round to the compute dtype, keep computing in f32
        return a.to(cd).float()

    n_layers = st.w1.shape[0]
    c = st.wskip.shape[0]
    t_len = x.shape[1]
    h = r(torch.relu(r(x) @ st.wmel.float() + st.bmel.float()))
    skip = torch.zeros(x.shape[:-1] + (c,), dtype=torch.float32, device=x.device)
    for i in range(n_layers):
        d = 2 ** (i % st.cycle)
        y = F.pad(r(h + step_rows_t[i].float()), (0, 0, d, d))
        y3 = torch.cat([y[:, :t_len], y[:, d:d + t_len], y[:, 2 * d:2 * d + t_len]], dim=-1)
        acc = y3 @ st.w1[i].float() + condb[i].float()
        g = torch.sigmoid(acc[..., :c]) * torch.tanh(acc[..., c:])
        yo = r(g) @ st.wout[i].float() + st.bout[i].float()
        h = r((h + yo[..., :c]) * INV_SQRT2)
        skip = skip + yo[..., c:]
    inv_sqrt_l = float(np.float32(1.0 / math.sqrt(n_layers)))
    s1 = torch.relu(r(skip * inv_sqrt_l) @ st.wskip.float() + st.bskip.float())
    eps = r(s1) @ st.wo.float() + st.bo.float()
    s0, s1c, s2, s3, s4 = (float(v) for v in srow)
    x0 = torch.clamp(s0 * x - s1c * eps, -1.0, 1.0)
    return s2 * x0 + s3 * x + s4 * z


def _check_cuda_args(st, condb, step_rows_t, x, z) -> None:
    b, t_len, m_pad = x.shape
    n_layers, k3, c2 = st.w1.shape
    c = c2 // 2
    if k3 != 3 * c or c % 64 or m_pad % 64:
        raise ValueError(f"ddpm_step: kernel needs k=3 and C, M_pad multiples of 64 (C={c}, M_pad={m_pad})")
    want = {
        "w1": (n_layers, 3 * c, 2 * c), "wout": (n_layers, c, 2 * c), "bout": (n_layers, 2 * c),
        "wmel": (m_pad, c), "bmel": (c,), "wskip": (c, c), "bskip": (c,), "wo": (c, m_pad),
        "bo": (m_pad,),
    }
    tensors = dict(st._asdict(), condb=condb, step_rows_t=step_rows_t)
    want.update(condb=(n_layers, b, t_len, 2 * c), step_rows_t=(n_layers, c))
    for name, shape in want.items():
        v = tensors[name]
        if v.dtype != torch.bfloat16 or tuple(v.shape) != shape or not v.is_contiguous():
            raise ValueError(f"ddpm_step: {name} must be contiguous bf16 {shape}, got {v.dtype} {tuple(v.shape)}")
        if v.device != x.device:
            raise ValueError(f"ddpm_step: {name} is on {v.device}, x on {x.device}")
    for name, v in (("x", x), ("z", z)):
        if v.dtype != torch.float32 or v.shape != x.shape or not v.is_contiguous():
            raise ValueError(f"ddpm_step: {name} must be contiguous f32 {tuple(x.shape)}")


def ddpm_step(st: StackedDenoiser, condb: torch.Tensor, step_rows_t: torch.Tensor,
              x: torch.Tensor, z: torch.Tensor, srow: Sequence[float]) -> torch.Tensor:
    """One reverse step x_t -> x_{t-1}.

    st: stacked weights; condb [L, B, T, 2C] (conditioner + conv bias);
    step_rows_t [L, C] (this step's rows); x, z [B, T, M_pad] f32; srow the
    five schedule scalars of this step. CUDA launches are counted in
    ``ddpm_step.launches`` (one per step).
    """
    if x.device.type == "cpu":
        return ddpm_step_plain(st, condb, step_rows_t, x, z, srow)
    _check_cuda_args(st, condb, step_rows_t, x, z)
    from svc_inference_pipeline_tpu_torch.ops.pallas import _build

    b, t_len, m_pad = x.shape
    n_layers, _, c2 = st.w1.shape
    c = c2 // 2
    out = torch.empty_like(x)
    h = torch.empty((b * t_len, c), dtype=torch.bfloat16, device=x.device)
    g = torch.empty_like(h)
    s1 = torch.empty_like(h)
    skip = torch.empty((b * t_len, c), dtype=torch.float32, device=x.device)
    status = _build.lib().svc_ddpm_step(
        x.data_ptr(), z.data_ptr(), out.data_ptr(), h.data_ptr(), skip.data_ptr(),
        g.data_ptr(), s1.data_ptr(), step_rows_t.data_ptr(),
        st.w1.data_ptr(), condb.data_ptr(), st.wout.data_ptr(), st.bout.data_ptr(),
        st.wmel.data_ptr(), st.bmel.data_ptr(), st.wskip.data_ptr(), st.bskip.data_ptr(),
        st.wo.data_ptr(), st.bo.data_ptr(),
        b, t_len, c, n_layers, st.cycle, m_pad, *(float(v) for v in srow),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(status, "svc_ddpm_step")
    ddpm_step.launches += 1
    return out


ddpm_step.launches = 0


def ddpm_sample_fused(st: StackedDenoiser, condb: torch.Tensor, step_rows: torch.Tensor,
                      schedule: DiffusionSchedule, shape: Tuple[int, int, int],
                      generator: Optional[torch.Generator] = None,
                      noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
    """Full ancestral DDPM reverse process with the update inside each step.

    shape (B, T, M). Step i runs t = steps-1-i with noise z[i]. Noise comes
    from ``generator`` on the carry's device, or from ``noise = (x_T [B,T,M],
    z [steps, B, T, M])`` (x_T already scaled by INIT_NOISE_STD), which tests
    use to feed both frameworks the same draws. Returns x_0 [B, T, M] f32.
    """
    b, t_len, n_mel = shape
    m_pad = st.wmel.shape[0]
    device = condb.device
    num_steps = schedule.num_steps
    pad = (0, m_pad - n_mel)
    if noise is None:
        x_t = INIT_NOISE_STD * torch.randn(shape, generator=generator, device=device)
    else:
        x_t = noise[0].to(device=device, dtype=torch.float32)
    x = F.pad(x_t, pad).contiguous()
    z = torch.zeros_like(x)
    rows = schedule_rows(schedule)
    for i in range(num_steps):
        if noise is None:
            z[..., :n_mel].normal_(generator=generator)
        else:
            z[..., :n_mel] = noise[1][i].to(device=device, dtype=torch.float32)
        x = ddpm_step(st, condb, step_rows[num_steps - 1 - i], x, z, rows[i])
    return x[..., :n_mel]


def make_fused_sampler(den: DiffSVCDenoiser, cond: torch.Tensor, num_steps: int,
                       dtype=torch.bfloat16):
    """Sampler closure over the hoisted conditioning and stacked weights:
    ``sample(schedule, shape, generator=None, noise=None) -> x_0``."""
    cond_projs, step_rows = den.precompute(cond, num_steps, dtype)
    st = stack_denoiser_params(den, dtype)
    condb = fold_conditioner(den, cond_projs, dtype)
    step_rows = step_rows.contiguous()

    def sample(schedule, shape, generator=None, noise=None):
        return ddpm_sample_fused(st, condb, step_rows, schedule, shape, generator, noise)

    return sample
