"""Hop-rate feature remapping: content frames (hop 480) -> mel frames (hop 256).

Counterpart of ``svc_inference_pipeline_tpu/ops/remap.py``: gcd-reduce
480/256 to 15/8, repeat each source frame 15 times, mean-pool groups of 8.
:func:`remap_features_device` runs on a tensor's device, and its leading
axes are batch axes (the JAX batched front-end vmaps the same function over
clips). :func:`remap_features` (the Whisper contract: the target capped at
``max_source_len`` source frames) and :func:`remap_features_tolerant` (the
ContentVec contract: a +-3-frame length check, the last frame repeated when
short) are numpy on the host, as are :func:`repeat_expand_2d`'s
nearest-neighbour expansion.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

WHISPER_MAX_SOURCE_LEN = 1500  # 30 s of 20 ms frames


def remap_features_device(raw_feats: torch.Tensor, target_len: int,
                          source_hop: int = 480, target_hop: int = 256) -> torch.Tensor:
    """[..., S, D] -> [..., target_len, D]; ``target_len`` is already capped
    by the caller."""
    g = math.gcd(source_hop, target_hop)
    src, tgt = source_hop // g, target_hop // g
    lead, width = raw_feats.shape[:-2], raw_feats.shape[-1]
    source_len = target_len * tgt // src + 1
    up = torch.repeat_interleave(raw_feats[..., :source_len, :], src, dim=-2)
    const = source_len * src // tgt * tgt
    return up[..., :const, :].reshape(*lead, -1, tgt, width).mean(dim=-2)[..., :target_len, :]


def remap_features(raw_feats: np.ndarray, target_len: int, source_hop: int = 480, target_hop: int = 256,
                   fast_mapping: bool = True,
                   max_source_len: Optional[int] = WHISPER_MAX_SOURCE_LEN) -> np.ndarray:
    """[S, D] content frames -> [target_len', D] mel-rate frames. The target
    is capped at ``max_source_len * source_hop / target_hop`` frames (2812 for
    the defaults); ``fast_mapping`` cuts the source to the frames needed."""
    g = math.gcd(source_hop, target_hop)
    src, tgt = source_hop // g, target_hop // g

    if max_source_len is not None:
        target_len = min(target_len, max_source_len * src // tgt)

    width = raw_feats.shape[-1]
    if fast_mapping:
        source_len = target_len * tgt // src + 1
        raw_feats = raw_feats[:source_len]
    else:
        source_len = raw_feats.shape[0]

    const = source_len * src // tgt * tgt
    up = np.repeat(raw_feats, src, axis=0)
    down = up[:const].reshape(-1, tgt, width).mean(axis=1)
    if len(down) < target_len:
        raise ValueError(f"{len(down)} remapped frames for a target of {target_len}")
    return down[:target_len].astype(raw_feats.dtype)


def remap_features_tolerant(raw_feats: np.ndarray, target_len: int, source_hop: int = 480,
                            target_hop: int = 256, tolerance: int = 3) -> np.ndarray:
    """ContentVec's variant: no source cap, a +-``tolerance``-frame length
    check (beyond it: ValueError), the last frame repeated when short."""
    g = math.gcd(source_hop, target_hop)
    src, tgt = source_hop // g, target_hop // g

    source_len, width = raw_feats.shape
    const = source_len * src // tgt * tgt
    up = np.repeat(raw_feats, src, axis=0)
    down = up[:const].reshape(-1, tgt, width).mean(axis=1)

    if abs(target_len - len(down)) > tolerance:
        raise ValueError(
            f"feature/mel length mismatch beyond tolerance: {len(down)} vs {target_len} "
            f"(source {source_len} frames)"
        )
    if len(down) < target_len:
        down = np.concatenate([down, np.repeat(down[-1:], target_len - len(down), axis=0)], axis=0)
    return down[:target_len].astype(raw_feats.dtype)


def repeat_expand_2d(content: np.ndarray, target_len: int) -> np.ndarray:
    """Nearest-neighbour length expansion [D, S] -> [D, target_len]: frame i
    takes source position floor(i * S / target_len)."""
    src_len = content.shape[-1]
    pos = (np.arange(target_len, dtype=np.float64) * src_len) // target_len
    return content[:, np.minimum(pos.astype(np.int64), src_len - 1)]
