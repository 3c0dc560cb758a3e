"""Diffusion (mapper) training: the condition encoder and the DiffSVC denoiser.

Counterpart of ``svc_inference_pipeline_tpu/training/diffusion.py``, with
its ``mesh=`` branch (data and tensor parallelism, one rank a device).
The objective is the eps-prediction MSE of ``sampling/ddpm.py::
ddpm_training_loss`` through the plain ``DiffSVCDenoiser.forward``, which is
differentiable; the kernel stacks of sampling (K1, K5) are not used, as the
JAX step uses no Pallas kernel. ``torch.optim.AdamW`` takes the place of
``optax.adamw``, and the EMA of the parameters is kept beside them.

Batch: ``{"mel": [B, T, M] normalised to [-1, 1], "content_whisper",
"melody", "loudness", "singer"}``, the feature dict of the conversion
pipeline plus the target mel.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from svc_inference_pipeline_tpu_torch.checkpoints.from_jax import random_init_
from svc_inference_pipeline_tpu_torch.models.diffsvc import DiffSVCDenoiser
from svc_inference_pipeline_tpu_torch.models.encoder import ConditionEncoder
from svc_inference_pipeline_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, axis_group, axis_rank, axis_size
from svc_inference_pipeline_tpu_torch.parallel.sharding import (
    MAPPER_TP_RULES, batch_shard, is_gated, param_specs, shard_slice, unshard)
from svc_inference_pipeline_tpu_torch.sampling.ddpm import ddpm_training_loss
from svc_inference_pipeline_tpu_torch.sampling.schedule import DiffusionSchedule
from svc_inference_pipeline_tpu_torch.utils.devices import resolve_device

LR = 1e-4
WEIGHT_DECAY = 1e-6

Ema = Dict[str, Dict[str, torch.Tensor]]


@dataclass
class DiffusionTrainState:
    """``step`` counts applied updates; ``ema`` holds the shadow weights,
    ``{"enc": {name: tensor}, "den": {name: tensor}}`` over the modules'
    parameters (the usual eval and inference weights)."""

    step: int
    encoder: ConditionEncoder
    denoiser: DiffSVCDenoiser
    optimizer: torch.optim.Optimizer
    ema: Ema

    def modules(self) -> Dict[str, torch.nn.Module]:
        return {"enc": self.encoder, "den": self.denoiser}


def make_optimizer(params, lr: float = LR, weight_decay: float = WEIGHT_DECAY) -> torch.optim.AdamW:
    """``optax.adamw(lr, weight_decay=...)``: b1 0.9, b2 0.999, eps 1e-8, one
    parameter group, so biases decay too, as optax without a mask does."""
    return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay)


def ema_of(modules: Dict[str, torch.nn.Module]) -> Ema:
    """A copy of the modules' parameters, the EMA's starting point."""
    return {k: {n: p.detach().clone() for n, p in m.named_parameters()} for k, m in modules.items()}


def init_diffusion_train_state(cfg, generator: torch.Generator,
                               optimizer: Optional[Callable] = None,
                               device=None) -> Tuple[DiffusionTrainState, torch.optim.Optimizer]:
    """(state, optimizer) at step 0 on ``device`` (None: the GPU, see
    ``resolve_device``): f32 modules of ``cfg.mapper`` drawn from
    ``generator`` (``random_init_``), AdamW at lr 1e-4 and weight decay 1e-6
    unless ``optimizer`` (a function of the parameter list) makes another,
    and the EMA equal to the parameters."""
    device = resolve_device(device)
    with torch.device(device):
        encoder, denoiser = ConditionEncoder(cfg.mapper), DiffSVCDenoiser(cfg.mapper)
    random_init_(encoder, generator)
    random_init_(denoiser, generator)
    params = list(encoder.parameters()) + list(denoiser.parameters())
    opt = (optimizer or make_optimizer)(params)
    modules = {"enc": encoder, "den": denoiser}
    return DiffusionTrainState(0, encoder, denoiser, opt, ema_of(modules)), opt


def ema_decay_at(step: int, decay: float) -> float:
    """min(decay, (1 + step)/(10 + step)) in f32, as the JAX step takes it
    from the state's step before the increment."""
    s = np.float32(step)
    return float(np.minimum(np.float32(decay), (np.float32(1.0) + s) / (np.float32(10.0) + s)))


@torch.no_grad()
def update_ema(ema: Ema, modules: Dict[str, torch.nn.Module], d: float) -> None:
    """ema <- ema d + params (1 - d), in place."""
    keep = float(np.float32(1.0) - np.float32(d))
    for key, module in modules.items():
        names, params = zip(*module.named_parameters())
        shadow = [ema[key][n] for n in names]
        torch._foreach_mul_(shadow, d)
        torch._foreach_add_(shadow, torch._foreach_mul([p.detach() for p in params], keep))


def make_diffusion_train_step(cfg, optimizer: torch.optim.Optimizer, mesh=None,
                              ema_decay: float = 0.999) -> Callable:
    """The train step ``step(state, batch, generator=None, t=None, noise=None)
    -> (state, loss)``: loss and gradients under autograd (whatever the
    caller's grad mode), one ``optimizer`` step, the EMA update with the
    warm-up decay of :func:`ema_decay_at`, ``state.step + 1``. Batch tensors
    are moved to the modules' device. ``t`` [B] and ``noise`` [B, T, M] pass
    given draws (the JAX step's, in the tests); otherwise they come from
    ``generator``, which is then required.

    A step whose loss is not finite changes nothing: no update, no EMA,
    neither ``state.step`` nor AdamW's step advances. The JAX loop drops
    such a step's new state; ``torch.optim`` updates in place, so the step
    tests the loss before it updates.

    With ``mesh`` (JAX's mesh branch, data and tensor parallelism): every
    rank takes the global batch and the global draws (the same generator on
    every rank), and keeps its data rank's slice of them; the modules,
    sharded by ``MAPPER_TP_RULES`` over the model axis (``step.shard_state``),
    run their TP forwards; the loss and the gradients are averaged over the
    data group. AdamW and the EMA are elementwise, so they run on each
    rank's shards as they are. ``step.batch_shard`` slices a batch by data
    rank. A DP x TP step equals the single-device step up to the order of
    f32 sums."""
    schedule = DiffusionSchedule.from_config(cfg.mapper)
    data_group = axis_group(mesh, DATA_AXIS)
    tp_group = axis_group(mesh, MODEL_AXIS)
    n_data = axis_size(mesh, DATA_AXIS)

    def shard(x):
        return x if x is None or mesh is None else batch_shard(x, mesh, DATA_AXIS)

    def train_step(state: DiffusionTrainState, batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator] = None, t: Optional[torch.Tensor] = None,
                   noise: Optional[torch.Tensor] = None) -> Tuple[DiffusionTrainState, torch.Tensor]:
        if state.optimizer is not optimizer:
            raise ValueError("the state's optimizer is not the one this step was made for")
        device = next(state.denoiser.parameters()).device
        batch = {k: torch.as_tensor(v).to(device) for k, v in batch.items() if k != "wave"}
        if mesh is not None:
            # the global draws on every rank, in the single-device order, then this rank's slice
            x0 = batch["mel"]
            if t is None:
                t = torch.randint(0, schedule.num_steps, (x0.shape[0],), generator=generator, device=device)
            if noise is None:
                noise = torch.randn(x0.shape, generator=generator, device=device, dtype=torch.float32)
            batch = {k: shard(v) for k, v in batch.items()}
            t, noise = shard(t), shard(noise)
        optimizer.zero_grad(set_to_none=True)
        with torch.enable_grad():
            cond = state.encoder(batch, tp_group)
            loss, _ = ddpm_training_loss(lambda x, c, s: state.denoiser(x, c, s, tp_group), batch["mel"].float(),
                                         cond, schedule, generator, t, noise)
            loss.backward()
        if data_group is not None:
            loss = loss.detach().clone()
            dist.all_reduce(loss, group=data_group)
            loss /= n_data
            grads = [p.grad for m in state.modules().values() for p in m.parameters() if p.grad is not None]
            for g in grads:
                dist.all_reduce(g, group=data_group)
            torch._foreach_div_(grads, float(n_data))
        if not torch.isfinite(loss):
            optimizer.zero_grad(set_to_none=True)
            return state, loss.detach()
        optimizer.step()
        update_ema(state.ema, state.modules(), ema_decay_at(state.step, ema_decay))
        state.step += 1
        return state, loss.detach()

    if mesh is not None:
        train_step.shard_state = lambda state: shard_state(state, mesh)
        train_step.batch_shard = lambda batch: {k: shard(torch.as_tensor(v)) for k, v in batch.items()}
    return train_step


def _module_specs(state: DiffusionTrainState) -> Dict[str, Dict[str, Tuple[Optional[int], bool]]]:
    """{module key: {parameter name: (the dim MAPPER_TP_RULES shards, gated)}}."""
    return {k: {n: (dim, is_gated(m, n)) for n, dim in param_specs(m, MAPPER_TP_RULES).items()}
            for k, m in state.modules().items()}


def _named_state(state: DiffusionTrainState):
    """(module key, parameter name, parameter) in the optimizer's order."""
    return [(k, n, p) for k, m in state.modules().items() for n, p in m.named_parameters()]


@torch.no_grad()
def shard_state(state: DiffusionTrainState, mesh) -> DiffusionTrainState:
    """Keep this rank's model-axis slice of the parameters, the EMA and
    AdamW's moments (a state from ``init_diffusion_train_state`` or a
    checkpoint, whole on every rank), in place."""
    size, rank = axis_size(mesh, MODEL_AXIS), axis_rank(mesh, MODEL_AXIS)
    if size == 1:
        return state
    specs = _module_specs(state)
    for key, name, p in _named_state(state):
        dim, gated = specs[key][name]
        if dim is None:
            continue
        p.data = shard_slice(p.data, dim, rank, size, gated)
        state.ema[key][name] = shard_slice(state.ema[key][name], dim, rank, size, gated)
        for k, v in state.optimizer.state.get(p, {}).items():
            if torch.is_tensor(v) and v.dim() > 0:
                state.optimizer.state[p][k] = shard_slice(v, dim, rank, size, gated)
    return state


@torch.no_grad()
def gathered_state_dict(state: DiffusionTrainState, mesh) -> dict:
    """The checkpoint dict of a sharded state in the single-device layout
    (``loop.state_dict_of``'s), the shards all-gathered over the model
    axis: every rank of the group must call it."""
    group = axis_group(mesh, MODEL_AXIS)
    specs = _module_specs(state)

    def whole(key, name, v):
        dim, gated = specs[key][name]
        return v if dim is None or group is None else unshard(v, dim, group, gated)

    out = {"step": state.step,
           "enc": {n: whole("enc", n, v) for n, v in state.encoder.state_dict().items()},
           "den": {n: whole("den", n, v) for n, v in state.denoiser.state_dict().items()},
           "ema": {k: {n: whole(k, n, v) for n, v in tree.items()} for k, tree in state.ema.items()}}
    opt = state.optimizer.state_dict()
    for i, (key, name, _) in enumerate(_named_state(state)):
        if i in opt["state"]:
            opt["state"][i] = {k: whole(key, name, v) if torch.is_tensor(v) and v.dim() > 0 else v
                               for k, v in opt["state"][i].items()}
    out["optimizer"] = opt
    return out
