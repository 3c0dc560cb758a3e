"""Tensor-parallel vocoder by overlap-save time chunking.

Counterpart of ``svc_inference_pipeline_tpu/parallel/tp_vocoder.py``. Every
op of BigVGAN is local in time, so the generator runs on time chunks of the
mel, each widened by a ``halo`` of at least its receptive radius on both
sides, and each chunk keeps the output frames it owns:

* the mel [B, T, M] is cut into ``n_chunks`` chunks of T/n frames plus the
  halo (clamped to the array, so the first and last chunks see the true
  edges and their padding is the whole generator's own);
* without a mesh the chunks are folded into the batch on one device (one
  generator call on [n B, T/n + 2 halo, M]), as JAX does with ``mesh=None``;
* with a mesh each rank of the model axis runs its n/model chunks through
  the whole generator (K2 and K3 on that rank), and an all-gather over the
  model group reassembles the kept frames.

A kept frame sits >= ``halo`` frames from every interior cut, so the result
is the unchunked generator's up to float rounding. Where the shape cannot be
chunked exactly (T not divisible by ``n_chunks``, chunks shorter than their
halos, a cut too close to a kept frame) the generator runs unchunked: that
is JAX's semantics, and the unchunked call runs the same kernels.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional

import torch

from svc_inference_pipeline_tpu_torch.parallel.mesh import MODEL_AXIS, axis_group, axis_rank, axis_size
from svc_inference_pipeline_tpu_torch.parallel.sharding import all_gather_dim

__all__ = ["vocoder_receptive_radius", "chunk_starts", "chunked_vocoder_apply"]


def vocoder_receptive_radius(vcfg) -> int:
    """Conservative receptive radius of BigVGAN in mel frames (JAX's bound:
    each op's half-width in input mel frames, every anti-aliased activation
    counted as 10 of its own rate's samples, plus 25% and 4 frames)."""
    sandwich = 10.0  # anti-aliased activation half-width, own-rate units
    r = (7 - 1) / 2.0  # conv_pre
    up = 1
    for u, k in zip(vcfg.upsample_rates, vcfg.upsample_kernel_sizes):
        r += (math.ceil(k / u) + 1) / up  # ConvTranspose, input-rate units
        up *= u
        branch = 0.0
        for rk, rd in zip(vcfg.resblock_kernel_sizes, vcfg.resblock_dilation_sizes):
            chain = sum((rk - 1) / 2.0 * d for d in rd)  # convs1
            if str(vcfg.resblock) == "1":
                chain += len(rd) * (rk - 1) / 2.0  # convs2
                chain += 2 * len(rd) * sandwich  # act1+act2 per pair
            else:
                chain += len(rd) * sandwich
            branch = max(branch, chain)
        r += branch / up
    r += (sandwich + 3.0) / up  # activation_post + conv_post
    return int(math.ceil(r * 1.25)) + 4


def chunk_starts(t: int, n_chunks: int, halo: int) -> Optional[List[int]]:
    """The chunks' first input frames, or None where the overlap-save split
    is not exact (JAX's checks, in JAX's order)."""
    if n_chunks <= 1 or t % n_chunks != 0 or t // n_chunks + 2 * halo > t:
        return None
    tl = t // n_chunks
    c = tl + 2 * halo
    starts = [min(max(i * tl - halo, 0), t - c) for i in range(n_chunks)]
    for i, s in enumerate(starts):
        off = i * tl - s
        if not (0 <= off <= c - tl):
            return None
        if (off < halo and s != 0) or (c - (off + tl) < halo and s + c != t):
            return None
    return starts


def chunked_vocoder_apply(apply_fn: Callable[[torch.Tensor], torch.Tensor], mel: torch.Tensor, n_chunks: int,
                          halo: int, hop: int, mesh=None, axis: Optional[str] = None) -> torch.Tensor:
    """``apply_fn`` (mel [B', T', M] -> wave [B', T' hop]) overlap-save
    chunked: [B, T, M] -> [B, T hop]. With ``mesh`` and ``axis`` (default
    the model axis) this rank runs chunks rank, rank + 1, ... of its
    n_chunks / size share, and every rank returns the whole wave."""
    b, t, m = mel.shape
    starts = chunk_starts(t, n_chunks, halo)
    if starts is None:
        return apply_fn(mel)
    tl = t // n_chunks
    c = tl + 2 * halo
    axis = axis or MODEL_AXIS
    size = axis_size(mesh, axis)
    if n_chunks % size:
        raise ValueError(f"n_chunks={n_chunks} does not divide over the {size}-way '{axis}' axis")
    per = n_chunks // size
    mine = range(axis_rank(mesh, axis) * per, (axis_rank(mesh, axis) + 1) * per)
    chunks = torch.cat([mel[:, starts[i]:starts[i] + c] for i in mine], dim=0)  # [per B, C, M], chunk-major
    waves = apply_fn(chunks)  # [per B, C hop]
    kept = torch.stack([waves[j * b:(j + 1) * b, (i * tl - starts[i]) * hop:(i * tl - starts[i] + tl) * hop]
                        for j, i in enumerate(mine)])  # [per, B, tl hop]
    group = axis_group(mesh, axis)
    if group is not None:
        kept = all_gather_dim(kept, 0, group)  # [n, B, tl hop], chunk order
    return torch.cat(list(kept), dim=1)
