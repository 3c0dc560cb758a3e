"""K8: the DiffSVC denoiser's eps forward in one launch per evaluation.

Counterpart of ``perf_kernel3.py::build_v2_fn`` (kernel body
``make_kernel_v2``): the concat-tap TPU kernel whose grid walks the layers
with h, the skip sum and the conv input y3 = [y(t-d) | y(t) | y(t+d)]
resident. On a CUDA tensor :func:`denoise_v2` launches ``csrc/denoiser_v2.cu``
once (a persistent cooperative kernel, grid-wide barriers between its
phases); on a CPU tensor it runs ``denoiser_step.denoise_plain``, whose stacks
(``stack_denoiser_params``, ``fold_conditioner``) already have K8's rounding
points: conditioner + conv bias folded to bf16, bf16 biases, y = bf16(h +
step_row), one K = 3C product over the zero-padded taps, f32 gates and skip.

K8 computes what K5 (``denoiser_step.denoise``, 2 + 2L launches) computes,
for one clip (batch 1, as the TPU harness) on a bf16 stack.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from svc_inference_pipeline_tpu_torch.models.diffsvc import DiffSVCDenoiser
from svc_inference_pipeline_tpu_torch.ops.pallas.denoiser_step import (
    StackedDenoiser,
    _check_cuda_args,
    _check_f32,
    denoise_plain,
    fold_conditioner,
    stack_denoiser_params,
)


def denoise_v2(st: StackedDenoiser, condb: torch.Tensor, step_rows_t: torch.Tensor,
               x: torch.Tensor) -> torch.Tensor:
    """eps [1, T, n_mel] f32 of x [1, T, n_mel] f32 (rounded to bf16), the
    stack ``st``, condb [L, 1, T, 2C] and this step's rows [L, C]. CUDA
    launches are counted in ``denoise_v2.launches`` (the grid of the last one
    in ``denoise_v2.grid``)."""
    if x.dim() != 3 or x.shape[0] != 1:
        raise ValueError(f"denoise_v2: one clip only (x [1, T, n_mel]), got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return denoise_plain(st, condb, step_rows_t, x)
    from svc_inference_pipeline_tpu_torch.ops.pallas import _build

    _build.refuse_autograd("denoise_v2", st, condb, step_rows_t, x)
    _check_cuda_args("denoise_v2", st, condb, step_rows_t, x)
    if st.w1s is not None or st.wouts is not None:
        raise ValueError(f"denoise_v2: bf16 stacks only, got an {st.mode} stack")
    _, t_len, n_mel = x.shape
    n_layers, _, c2 = st.w1.shape
    c, m_pad = c2 // 2, st.wmel.shape[0]
    if n_mel > m_pad:
        raise ValueError(f"denoise_v2: x has {n_mel} mel channels, the stack {m_pad}")
    _check_f32("denoise_v2", "x", x, (1, t_len, n_mel))
    xp = F.pad(x, (0, m_pad - n_mel))
    eps = torch.empty_like(x)
    h, g, s1 = (torch.empty((t_len, c), dtype=torch.bfloat16, device=x.device) for _ in range(3))
    y3 = torch.empty((t_len, 3 * c), dtype=torch.bfloat16, device=x.device)
    skip = torch.empty((t_len, c), dtype=torch.float32, device=x.device)
    grid = ctypes.c_int(0)
    status = _build.lib().svc_denoise_v2(
        xp.data_ptr(), eps.data_ptr(), h.data_ptr(), skip.data_ptr(), y3.data_ptr(), g.data_ptr(),
        s1.data_ptr(), step_rows_t.data_ptr(), st.w1.data_ptr(), condb.data_ptr(), st.wout.data_ptr(),
        st.bout.data_ptr(), st.wmel.data_ptr(), st.bmel.data_ptr(), st.wskip.data_ptr(),
        st.bskip.data_ptr(), st.wo.data_ptr(), st.bo.data_ptr(),
        t_len, c, n_layers, st.cycle, m_pad, n_mel, ctypes.byref(grid),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(status, "svc_denoise_v2")
    denoise_v2.launches += 1
    denoise_v2.grid = grid.value
    return eps


denoise_v2.launches = 0
denoise_v2.grid = 0


def build_v2_fn(den: DiffSVCDenoiser, cond: torch.Tensor, num_steps: int, dtype=torch.bfloat16):
    """Sampler-compatible ``fn(x, cond, t) -> eps`` through K8 over the
    hoisted conditioning of one clip (cond [1, T, D]) and the bf16 stack;
    ``t[0, 0]`` selects the step rows."""
    if cond.shape[0] != 1:
        raise ValueError(f"build_v2_fn: one clip only (cond [1, T, D]), got {tuple(cond.shape)}")
    cond_projs, step_rows = den.precompute(cond, num_steps, dtype)
    st = stack_denoiser_params(den, dtype)
    condb = fold_conditioner(den, cond_projs, dtype)
    step_rows = step_rows.contiguous()

    def fn(x, _cond_unused, t):
        return denoise_v2(st, condb, step_rows[int(t[0, 0])], x)

    return fn
