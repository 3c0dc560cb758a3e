"""Pipeline parallelism (GPipe) for the DiffSVC denoiser, forward only.

Counterpart of ``svc_inference_pipeline_tpu/parallel/pp.py``: the residual
layers are split into S contiguous stages over the ``pipe`` axis of the
mesh, one stage a rank, and microbatches flow through the stages: at
global step t a stage computes microbatch t - stage (bubble (S-1) /
(n_micro + S - 1)). Stage 0 applies the mel preprocess, the last stage the
output head and keeps the finished microbatches; after each step every
stage sends its (h, skip) carry to stage (stage + 1) % S and receives its
predecessor's (``dist.batch_isend_irecv`` over the pipe group: JAX's
``ppermute`` ring). The last stage's outputs are then broadcast to the
group. Everything runs in f32, as JAX's stages do.

The dilated conv's dilation 2^(i mod cycle) comes from the absolute layer
index, a plain Python index here (JAX switches over four static branches
because the index is traced). The backward of the ring is not ported.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from svc_inference_pipeline_tpu_torch.models.diffsvc import DiffSVCDenoiser
from svc_inference_pipeline_tpu_torch.parallel.mesh import PIPE_AXIS, axis_rank, axis_size

Params = Dict[str, torch.Tensor]


def stack_layer_params(den: DiffSVCDenoiser, n_layers: int, n_stages: int) -> Tuple[Params, Params]:
    """(stacked, shared): every ``residual_i`` parameter stacked to [S, per,
    ...] (f32, PyTorch layouts), and the rest (mel preprocess, skip and
    output projections) by name."""
    assert n_layers % n_stages == 0, (n_layers, n_stages)
    per = n_layers // n_stages
    names = [n for n, _ in den.block(0).named_parameters()]
    stacked = {n: torch.stack([den.block(i).get_parameter(n).detach().float() for i in range(n_layers)])
               .reshape(n_stages, per, *den.block(0).get_parameter(n).shape) for n in names}
    shared = {n: p.detach().float() for n, p in den.named_parameters() if not n.startswith("residual_")}
    return stacked, shared


def _dense(p: Params, prefix: str, x: torch.Tensor) -> torch.Tensor:
    return F.linear(x, p[f"{prefix}.weight"], p.get(f"{prefix}.bias"))


def _dilated_conv(y: torch.Tensor, w: torch.Tensor, b: torch.Tensor, d: int) -> torch.Tensor:
    """k = 3 dilated conv as three shifted matmuls (JAX's
    ``_dilated_conv_static``); w is the [2C, C, 3] conv weight."""
    t_len = y.shape[1]
    yp = F.pad(y, (0, 0, d, d))
    return (yp[:, :t_len] @ w[..., 0].T + yp[:, d:d + t_len] @ w[..., 1].T
            + yp[:, 2 * d:2 * d + t_len] @ w[..., 2].T) + b


def _layer(p: Params, cond_proj: torch.Tensor, step_row: torch.Tensor, h: torch.Tensor,
           skip: torch.Tensor, abs_idx: int, cycle: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One residual layer (f32); ``abs_idx`` picks the dilation."""
    y = _dilated_conv(h + step_row, p["dilated_conv.weight"], p["dilated_conv.bias"], 2 ** (abs_idx % cycle))
    gate, filt = (y + cond_proj).chunk(2, dim=-1)
    y = _dense(p, "output_projection", torch.sigmoid(gate) * torch.tanh(filt))
    residual, skip_out = y.chunk(2, dim=-1)
    return (h + residual) * np.float32(1.0 / math.sqrt(2.0)), skip + skip_out


def _ring_shift(tensors, group, stage: int, n_stages: int):
    """Send each tensor to stage + 1 and receive stage - 1's (mod S)."""
    if n_stages == 1:
        return tensors
    nxt = dist.get_global_rank(group, (stage + 1) % n_stages)
    prv = dist.get_global_rank(group, (stage - 1) % n_stages)
    out = [torch.empty_like(t) for t in tensors]
    ops = [dist.P2POp(dist.isend, t.contiguous(), nxt, group) for t in tensors]
    ops += [dist.P2POp(dist.irecv, o, prv, group) for o in out]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return out


@torch.no_grad()
def pipeline_denoise(stacked: Params, shared: Params, cond_projs: torch.Tensor, step_rows: torch.Tensor,
                     x_mb: torch.Tensor, mesh, cfg, axis: str = PIPE_AXIS) -> torch.Tensor:
    """eps of every microbatch through the S-stage pipeline: cond_projs
    [L, n_micro, Bm, T, 2C] and step_rows [L, n_micro, C] (layer-major),
    x_mb [n_micro, Bm, T, M] -> [n_micro, Bm, T, M] f32 on every stage."""
    n_stages, stage = axis_size(mesh, axis), axis_rank(mesh, axis)
    group = mesh.get_group(axis) if mesh is not None and axis in (mesh.mesh_dim_names or ()) else None
    n_layers, cycle = cfg.residual_layer_num, cfg.dilation_cycle_length
    per = n_layers // n_stages
    n_micro, bm, t_len = x_mb.shape[:3]
    c = cfg.residual_channels
    mine = {n: v[stage] for n, v in stacked.items()}
    cp = cond_projs.reshape(n_stages, per, *cond_projs.shape[1:])[stage].float()
    sr = step_rows.reshape(n_stages, per, *step_rows.shape[1:])[stage].float()
    dev = x_mb.device
    h_c = torch.zeros((bm, t_len, c), device=dev)
    skip_c = torch.zeros_like(h_c)
    out_buf = torch.zeros((n_micro, bm, t_len, cfg.n_mel), device=dev)
    for t in range(n_micro + n_stages - 1):
        mb = t - stage  # the microbatch this stage works on now
        h, skip = h_c, skip_c
        if 0 <= mb < n_micro:
            if stage == 0:
                h = torch.relu(_dense(shared, "mel_preprocess", x_mb[mb].float()))
                skip = torch.zeros_like(h)
            for j in range(per):
                p_j = {n: v[j] for n, v in mine.items()}
                h, skip = _layer(p_j, cp[j, mb], sr[j, mb], h, skip, stage * per + j, cycle)
            if stage == n_stages - 1:
                out = torch.relu(_dense(shared, "skip_projection", skip * np.float32(1.0 / math.sqrt(n_layers))))
                out_buf[mb] = _dense(shared, "output_projection", out)
        h_c, skip_c = _ring_shift((h, skip), group, stage, n_stages)
    if group is not None:
        dist.broadcast(out_buf, dist.get_global_rank(group, n_stages - 1), group=group)
    return out_buf


def make_pp_denoise_fn(den: DiffSVCDenoiser, cond: torch.Tensor, num_steps: int, cfg, mesh,
                       axis: str = PIPE_AXIS, n_micro: Optional[int] = None):
    """Sampler-compatible ``fn(x, cond, t)`` whose every eps runs through the
    S-stage pipeline (``make_composed_denoise_fn``'s contract: one shared
    step per batch, ``t[0, 0]``; conditioning hoisted once, in f32).
    ``n_micro`` (default B) must divide B."""
    n_stages = axis_size(mesh, axis)
    n_layers = cfg.residual_layer_num
    b = cond.shape[0]
    n_micro = n_micro or b
    assert b % n_micro == 0, (b, n_micro)
    bm = b // n_micro
    cond_projs, step_rows = den.precompute(cond, num_steps, torch.float32)
    cond_projs = cond_projs.reshape(n_layers, n_micro, bm, cond.shape[1], -1)
    stacked, shared = stack_layer_params(den, n_layers, n_stages)

    def fn(x, _cond_unused, t):
        rows = step_rows[int(t[0, 0])][:, None, :].expand(n_layers, n_micro, -1)  # [L, n_micro, C]
        x_mb = x.float().reshape(n_micro, bm, x.shape[1], x.shape[2])
        out = pipeline_denoise(stacked, shared, cond_projs, rows, x_mb, mesh, cfg, axis)
        return out.reshape(b, x.shape[1], x.shape[2])

    return fn


def pp_denoise_fn(den: DiffSVCDenoiser, cond: torch.Tensor, t_steps: torch.Tensor, x: torch.Tensor, mesh, cfg,
                  num_steps: int, n_micro: Optional[int] = None) -> torch.Tensor:
    """Full-batch eps through the pipeline: x [B, T, M], ``t_steps`` [B]
    (one shared step per microbatch, the first of each is read)."""
    n_stages = axis_size(mesh, PIPE_AXIS)
    b = x.shape[0]
    n_micro = n_micro or b
    assert b % n_micro == 0
    bm = b // n_micro
    n_layers = cfg.residual_layer_num
    cond_projs, step_rows = den.precompute(cond, num_steps, torch.float32)
    cond_projs = cond_projs.reshape(n_layers, n_micro, bm, cond.shape[1], -1)
    t_idx = torch.as_tensor(t_steps).reshape(n_micro, bm)[:, 0].long().cpu()
    rows = step_rows[t_idx].transpose(0, 1)  # [L, n_micro, C]
    stacked, shared = stack_layer_params(den, n_layers, n_stages)
    out = pipeline_denoise(stacked, shared, cond_projs, rows, x.reshape(n_micro, bm, x.shape[1], x.shape[2]),
                           mesh, cfg)
    return out.reshape(b, x.shape[1], x.shape[2])
