"""Pipeline parallelism (GPipe) for the DiffSVC denoiser, differentiable.

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

The backward (``jax.grad`` through ``ppermute``'s transpose in JAX) is one
autograd Function around the whole schedule (:class:`_Pipeline`): every
rank runs the reverse schedule, n_micro + S - 1 steps, recomputing each
of its active steps from the carry it received (GPipe's
re-materialisation), and ring-shifts the carries' gradients the other way,
zeros where a carry was dropped, so every rank makes the same sends and
receives. A rank's gradients cover its own stage (its layers, the shared
parameters its stage reads, its slices of the conditioning): the model's
gradient is their sum over the pipe group. Every rank computes the same
loss from the broadcast outputs, so the broadcast's backward takes the
last stage's own gradient and sums nothing.

The ring's transport follows the group's backend: NCCL sends CUDA
tensors; gloo, which takes CUDA tensors in its collectives but not in
point-to-point sends, sends host copies, as its collectives stage them.

The dilated conv's dilation 2^(i mod cycle) comes from the absolute layer
index, a plain Python index here (JAX switches over four static branches
because the index is traced).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

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
    output projections) by name; differentiable (the stack and the cast
    carry gradients back to the parameters)."""
    assert n_layers % n_stages == 0, (n_layers, n_stages)
    per = n_layers // n_stages
    names = [n for n, _ in den.block(0).named_parameters()]
    stacked = {n: torch.stack([den.block(i).get_parameter(n).float() for i in range(n_layers)])
               .reshape(n_stages, per, *den.block(0).get_parameter(n).shape) for n in names}
    shared = {n: p.float() for n, p in den.named_parameters() if not n.startswith("residual_")}
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


def _ring_shift(tensors, group, stage: int, n_stages: int, step: int = 1):
    """Send each tensor to stage + step and receive stage - step's (mod S):
    step 1 is the forward ring, -1 the backward's. gloo sends host copies
    of CUDA tensors (it refuses them in point-to-point ops)."""
    if n_stages == 1:
        return tensors
    nxt = dist.get_global_rank(group, (stage + step) % n_stages)
    prv = dist.get_global_rank(group, (stage - step) % n_stages)
    staged = dist.get_backend(group) == "gloo" and tensors[0].is_cuda
    send = [t.detach().cpu() if staged else t.detach().contiguous() for t in tensors]
    out = [torch.empty_like(t) for t in send]
    ops = [dist.P2POp(dist.isend, t, nxt, group) for t in send]
    ops += [dist.P2POp(dist.irecv, o, prv, group) for o in out]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return [o.to(t.device) for o, t in zip(out, tensors)] if staged else out


class _Schedule:
    """One stage's static part of the pipeline: sizes, the pipe group, and
    its step on a microbatch."""

    def __init__(self, cfg, mesh, axis: str, x_mb: torch.Tensor, names: List[str], shared_names: List[str]):
        self.n_stages, self.stage = axis_size(mesh, axis), axis_rank(mesh, axis)
        self.group = mesh.get_group(axis) if mesh is not None and axis in (mesh.mesh_dim_names or ()) else None
        self.n_layers, self.cycle = cfg.residual_layer_num, cfg.dilation_cycle_length
        self.per = self.n_layers // self.n_stages
        self.n_micro, self.bm, self.t_len = x_mb.shape[:3]
        self.c, self.n_mel = cfg.residual_channels, cfg.n_mel
        self.names, self.shared_names = names, shared_names
        self.n_steps = self.n_micro + self.n_stages - 1

    def active(self, t: int) -> bool:
        return 0 <= t - self.stage < self.n_micro

    def split(self, tensors):
        """(mine, shared, cp, sr, x_mb) from the flat tensor list."""
        k, m = len(self.names), len(self.shared_names)
        mine = dict(zip(self.names, tensors[:k]))
        shared = dict(zip(self.shared_names, tensors[k:k + m]))
        return (mine, shared, *tensors[k + m:])

    def step(self, tensors, mb: int, h: torch.Tensor, skip: torch.Tensor):
        """This stage on microbatch ``mb`` from the received carry: (h, skip,
        the finished eps on the last stage or None)."""
        mine, shared, cp, sr, x_mb = self.split(tensors)
        if self.stage == 0:  # a fresh microbatch in place of the ring's carry
            h = torch.relu(_dense(shared, "mel_preprocess", x_mb[mb].float()))
            skip = torch.zeros_like(h)
        for j in range(self.per):
            p_j = {n: v[j] for n, v in mine.items()}
            h, skip = _layer(p_j, cp[j, mb], sr[j, mb], h, skip, self.stage * self.per + j, self.cycle)
        out = None
        if self.stage == self.n_stages - 1:
            out = _dense(shared, "output_projection", torch.relu(
                _dense(shared, "skip_projection", skip * np.float32(1.0 / math.sqrt(self.n_layers)))))
        return h, skip, out

    def zeros(self, like: torch.Tensor) -> torch.Tensor:
        return torch.zeros((self.bm, self.t_len, self.c), device=like.device)

    def forward(self, tensors, carries: Optional[list] = None) -> torch.Tensor:
        """The schedule; the outputs broadcast from the last stage. With
        ``carries``, the carry each active step received is appended."""
        x_mb = tensors[-1]
        h_c = skip_c = self.zeros(x_mb)
        out_buf = torch.zeros((self.n_micro, self.bm, self.t_len, self.n_mel), device=x_mb.device)
        for t in range(self.n_steps):
            h, skip = h_c, skip_c
            if self.active(t):
                if carries is not None:
                    carries.append((h_c, skip_c))
                h, skip, out = self.step(tensors, t - self.stage, h_c, skip_c)
                if out is not None:
                    out_buf[t - self.stage] = out
            h_c, skip_c = _ring_shift((h, skip), self.group, self.stage, self.n_stages)
        if self.group is not None:
            dist.broadcast(out_buf, dist.get_global_rank(self.group, self.n_stages - 1), group=self.group)
        return out_buf


class _Pipeline(torch.autograd.Function):
    """The schedule under autograd: forward as :meth:`_Schedule.forward`,
    backward as its reverse (the module docstring)."""

    @staticmethod
    def forward(ctx, sched: _Schedule, *tensors):
        ctx.sched, ctx.carries = sched, []
        ctx.save_for_backward(*tensors)
        return sched.forward(tensors, ctx.carries)

    @staticmethod
    def backward(ctx, g_buf):
        sched = ctx.sched
        inputs = ctx.saved_tensors
        needs = ctx.needs_input_grad[1:]
        leaves = [t.detach().requires_grad_(n) for t, n in zip(inputs, needs)]
        wrt = [v for v, n in zip(leaves, needs) if n]
        grads = [torch.zeros_like(v) for v in wrt]
        g_h = g_skip = sched.zeros(g_buf)  # the last step's carry reaches no one
        for t in reversed(range(sched.n_steps)):
            if sched.active(t):  # else the carry passed through: so does its gradient
                mb = t - sched.stage
                h_in, skip_in = (v.detach().requires_grad_(sched.stage > 0) for v in ctx.carries.pop())
                with torch.enable_grad():
                    h, skip, out = sched.step(leaves, mb, h_in, skip_in)
                    outs, g_outs = [h, skip], [g_h, g_skip]
                    if out is not None:
                        outs.append(out)
                        g_outs.append(g_buf[mb])
                    carry = [h_in, skip_in] if sched.stage > 0 else []
                    got = torch.autograd.grad(outs, wrt + carry, g_outs, allow_unused=True)
                for acc, g in zip(grads, got):
                    if g is not None:
                        acc += g
                if carry:
                    g_h, g_skip = (g if g is not None else torch.zeros_like(c) for g, c in zip(got[len(wrt):], carry))
                else:  # stage 0 dropped the carry it received
                    g_h, g_skip = sched.zeros(g_buf), sched.zeros(g_buf)
            g_h, g_skip = _ring_shift((g_h, g_skip), sched.group, sched.stage, sched.n_stages, step=-1)
        it = iter(grads)
        return (None, *(next(it) if n else None for n in needs))


def pipeline_denoise(stacked: Params, shared: Params, cond_projs: torch.Tensor, step_rows: torch.Tensor,
                     x_mb: torch.Tensor, mesh, cfg, axis: str = PIPE_AXIS) -> torch.Tensor:
    """eps of every microbatch through the S-stage pipeline: cond_projs
    [L, n_micro, Bm, T, 2C] and step_rows [L, n_micro, C] (layer-major),
    x_mb [n_micro, Bm, T, M] -> [n_micro, Bm, T, M] f32 on every stage.
    Differentiable when grad mode is on and an input requires grad (every
    rank must then run the backward); otherwise no graph is built."""
    names, shared_names = list(stacked), list(shared)
    sched = _Schedule(cfg, mesh, axis, x_mb, names, shared_names)
    per, stage = sched.per, sched.stage
    tensors = [stacked[n][stage] for n in names] + [shared[n] for n in shared_names] + [
        cond_projs.reshape(sched.n_stages, per, *cond_projs.shape[1:])[stage].float(),
        step_rows.reshape(sched.n_stages, per, *step_rows.shape[1:])[stage].float(), x_mb]
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return _Pipeline.apply(sched, *tensors)
    with torch.no_grad():
        return sched.forward(tensors)


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
    with torch.no_grad():  # the sampler's route builds no graph
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
    (one shared step per microbatch, the first of each is read).
    Differentiable under autograd, ``precompute`` included: a rank's
    gradients are its stage's share (the module docstring)."""
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
