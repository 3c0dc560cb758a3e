"""Sharding rules: parameter tensor parallelism and batch data parallelism.

Counterpart of ``svc_inference_pipeline_tpu/parallel/sharding.py``. The
rule tables are JAX's, word for word: (regex over a JAX parameter path,
PartitionSpec over the JAX layout). They are read through the weights
bridge (``checkpoints/from_jax.py``), which names each PyTorch parameter's
JAX path and axis permutation, so the rules cannot drift from the weights:
a Dense kernel ``P(None, M)`` (output columns) shards dim 0 of the
``nn.Linear`` weight, a conv kernel ``P(None, None, M)`` dim 0 of the conv
weight. :func:`param_specs` maps each parameter name to the dim it shards
(or None), and :func:`shard_params` keeps this rank's slice of it in place.

The layout (the Megatron pattern):

* DiffSVC residual blocks: the dilated conv C -> 2C and the conditioner /
  step projections shard their output channels; the 1x1 output projection
  shards its input channels: column-parallel, then row-parallel, with one
  all-reduce per block at the residual join. The gated outputs are
  gate || filter; a rank keeps the matching chunk of each half
  (:data:`GATED`), so its gates meet their filters locally (GSPMD reshards
  JAX's contiguous split there; the function is the same).
* The condition encoder: embedding tables shard their vocabulary (a lookup
  masks the ids of other shards and is all-reduced), the content projection
  its output columns (all-gathered).
* Whisper: q/k/v shard heads, the out projection and ``mlp_2`` their input,
  ``mlp_0`` its output: one all-reduce per sub-block.
* BigVGAN: channel sharding of every conv, the GAN train steps' TP
  (``training/gan.py``): ``conv_pre`` column-parallel, each up-conv and
  resblock conv row-parallel on this rank's input channels, the
  activations on those channels. Inference runs the vocoder time-chunked
  instead (``parallel/tp_vocoder.py``).

JAX's GSPMD writes the collectives; here the TP forwards call the
autograd-aware ones below: :func:`reduce_from` (all-reduce forward,
identity backward, where a row-parallel product's partial sums join),
:func:`copy_to` (identity forward, all-reduce backward, where a replicated
tensor enters column-parallel products), :func:`gather_from` (all-gather
forward, this rank's slice backward) and :func:`scatter_to` (this rank's
slice forward, all-gather backward, where a replicated tensor enters
row-parallel products).
"""

from __future__ import annotations

import re
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from svc_inference_pipeline_tpu_torch.checkpoints.from_jax import jax_path_of
from svc_inference_pipeline_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, axis_rank, axis_size

Spec = Tuple[Optional[str], ...]  # a PartitionSpec: one axis name or None per JAX array axis
Rules = Sequence[Tuple[str, Spec]]

M = MODEL_AXIS
D = DATA_AXIS

MAPPER_TP_RULES: Rules = (
    # residual blocks: column-parallel in, row-parallel out
    (r".*residual_\d+/dilated_conv/kernel", (None, None, M)),
    (r".*residual_\d+/dilated_conv/bias", (M,)),
    (r".*residual_\d+/conditioner_projection/kernel", (None, M)),
    (r".*residual_\d+/conditioner_projection/bias", (M,)),
    (r".*residual_\d+/diffusion_projection/kernel", (None, M)),
    (r".*residual_\d+/diffusion_projection/bias", (M,)),
    (r".*residual_\d+/output_projection/kernel", (M, None)),
    # condition encoder: embedding tables shard over the vocab axis
    (r".*(melody|loudness|singer)/embedding", (M, None)),
    (r".*content_\w+/kernel", (None, M)),
)

VOCODER_TP_RULES: Rules = (
    (r".*conv_pre/conv/kernel", (None, None, M)),
    (r".*conv_pre/conv/bias", (M,)),
    (r".*up_\d+/kernel", (None, M, None)),
    (r".*up_\d+/bias", (M,)),
    (r".*resblock_\d+_\d+/conv\d?_\d+/conv/kernel", (None, M, None)),
    (r".*resblock_\d+_\d+/act\d?_\d+/(alpha|beta)", (M,)),
)

WHISPER_TP_RULES: Rules = (
    (r".*block_\d+/attn/(query|key|value)/kernel", (None, M)),
    (r".*block_\d+/attn/(query|value)/bias", (M,)),
    (r".*block_\d+/attn/out/kernel", (M, None)),
    (r".*block_\d+/mlp_0/kernel", (None, M)),
    (r".*block_\d+/mlp_0/bias", (M,)),
    (r".*block_\d+/mlp_2/kernel", (M, None)),
    # scanned layout (scan_layers=True): leading layer axis stays unsharded
    (r".*blocks/block/attn/(query|key|value)/kernel", (None, None, M)),
    (r".*blocks/block/attn/(query|value)/bias", (None, M)),
    (r".*blocks/block/attn/out/kernel", (None, M, None)),
    (r".*blocks/block/mlp_0/kernel", (None, None, M)),
    (r".*blocks/block/mlp_0/bias", (None, M)),
    (r".*blocks/block/mlp_2/kernel", (None, M, None)),
)

# JAX paths whose sharded dim is gate || filter: a rank keeps chunk r of each half
GATED = (r".*residual_\d+/(dilated_conv|conditioner_projection)/(kernel|bias)",)


def _spec_for(path: str, rules: Rules) -> Spec:
    for pattern, spec in rules:
        if re.fullmatch(pattern, path):
            return spec
    return ()  # replicate


def param_specs(module: nn.Module, rules: Rules, axis: str = M) -> Dict[str, Optional[int]]:
    """{parameter name: the PyTorch dim sharded over ``axis``, or None}."""
    out = {}
    for name, _ in module.named_parameters():
        path, perm = jax_path_of(module, name)
        spec = _spec_for(path, rules)
        jax_dim = spec.index(axis) if axis in spec else None
        out[name] = None if jax_dim is None else (perm.index(jax_dim) if perm else jax_dim)
    return out


def shard_slice(t: torch.Tensor, dim: int, rank: int, size: int, gated: bool = False) -> torch.Tensor:
    """Rank ``rank`` of ``size``'s slice of ``t`` along ``dim``; with
    ``gated`` the dim is two halves and the slice is chunk ``rank`` of each."""
    if gated:
        halves = t.chunk(2, dim=dim)
        return torch.cat([h.chunk(size, dim=dim)[rank] for h in halves], dim=dim).contiguous()
    if t.shape[dim] % size:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not divide by {size}")
    return t.chunk(size, dim=dim)[rank].contiguous()


def unshard(t: torch.Tensor, dim: int, group, gated: bool = False) -> torch.Tensor:
    """The whole tensor from the ranks' :func:`shard_slice` slices (all-gather)."""
    parts = all_gather_dim(t, dim, group).chunk(dist.get_world_size(group), dim=dim)
    if gated:
        halves = [p.chunk(2, dim=dim) for p in parts]
        return torch.cat([h[0] for h in halves] + [h[1] for h in halves], dim=dim)
    return torch.cat(parts, dim=dim)


def is_gated(module: nn.Module, name: str) -> bool:
    """Whether parameter ``name``'s sharded dim is gate || filter."""
    return any(re.fullmatch(p, jax_path_of(module, name)[0]) for p in GATED)


@torch.no_grad()
def shard_params(module: nn.Module, mesh, rules: Rules, axis: str = M) -> nn.Module:
    """Keep this rank's slice (along ``axis`` of ``mesh``) of every
    parameter the rules shard, in place; the rest stay whole."""
    size, rank = axis_size(mesh, axis), axis_rank(mesh, axis)
    if size == 1:
        return module
    own = dict(module.named_parameters())
    for name, dim in param_specs(module, rules, axis).items():
        if dim is None:
            continue
        own[name].data = shard_slice(own[name].data, dim, rank, size, is_gated(module, name))
    return module


def batch_shard(x, mesh, axis: str = D):
    """This data rank's slice of dim 0 (``batch_sharding``'s counterpart)."""
    size = axis_size(mesh, axis)
    if size == 1:
        return x
    if isinstance(x, np.ndarray):
        return np.array_split(x, size)[axis_rank(mesh, axis)]
    return x.chunk(size, dim=0)[axis_rank(mesh, axis)]


def fold_generator(generator: Optional[torch.Generator], index: int, device) -> torch.Generator:
    """A generator for shard ``index`` of a batch, seeded from (the caller's
    generator's seed, or 0, and ``index``): JAX's ``fold_in(key, index)``."""
    seed = generator.initial_seed() if generator is not None else 0
    s = int(np.random.SeedSequence((seed, index)).generate_state(1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(s)


def replicate(x, mesh=None):
    """Every rank keeps the whole of ``x`` (``replicate``'s counterpart)."""
    return x


# ---------------------------------------------------------------------------
# collectives of the TP forwards
# ---------------------------------------------------------------------------


def all_gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim``, in rank order (no
    autograd; ``x`` itself for no group)."""
    if group is None:
        return x
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather_dim(x, dim, group)

    @staticmethod
    def backward(ctx, grad):
        size, rank = dist.get_world_size(ctx.group), dist.get_rank(ctx.group)
        return grad.chunk(size, dim=ctx.dim)[rank].contiguous(), None, None


class _ScatterTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        size, rank = dist.get_world_size(group), dist.get_rank(group)
        return x.chunk(size, dim=dim)[rank].contiguous()

    @staticmethod
    def backward(ctx, grad):
        return all_gather_dim(grad, ctx.dim, ctx.group), None, None


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    """Sum of the ranks' partials (all-reduce); the gradient passes through."""
    return x if group is None else _ReduceFrom.apply(x, group)


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """A replicated tensor entering column-parallel products: the gradient
    is the sum of the ranks' gradients."""
    return x if group is None else _CopyTo.apply(x, group)


def gather_from(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The ranks' column shards joined along ``dim``; the gradient is this
    rank's slice."""
    return x if group is None else _GatherFrom.apply(x, dim, group)


def scatter_to(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's equal slice of a replicated ``x`` along ``dim``; the
    gradient is the ranks' slices' gradients joined (each rank's slice
    gradient is whole for its slice, so nothing is summed or scaled)."""
    if group is None:
        return x
    if x.shape[dim] % dist.get_world_size(group):
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not divide by {dist.get_world_size(group)}")
    return _ScatterTo.apply(x, dim, group)


def row_parallel(x: torch.Tensor, layer: nn.Linear, group, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``layer`` (weight sharded over its input) on this rank's input
    columns: the f32 partial products all-reduced, then the whole bias, at
    ``dtype`` (default x's)."""
    dtype = dtype or x.dtype
    partial = torch.nn.functional.linear(x.to(dtype).float(), layer.weight.to(dtype).float())
    y = reduce_from(partial, group)
    return (y + layer.bias.to(dtype).float()).to(dtype)


def group_rank(group) -> Tuple[int, int]:
    """(rank, size) of this process in ``group`` ((0, 1) for None)."""
    if group is None:
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)
