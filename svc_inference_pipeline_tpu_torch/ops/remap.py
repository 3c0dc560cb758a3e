"""Hop-rate feature remapping: content frames (hop 480) -> mel frames (hop 256).

Counterpart of ``remap_features_device`` in
``svc_inference_pipeline_tpu/ops/remap.py``: gcd-reduce 480/256 to 15/8,
repeat each source frame 15 times, mean-pool groups of 8.
"""

from __future__ import annotations

import math

import torch

WHISPER_MAX_SOURCE_LEN = 1500  # 30 s of 20 ms frames


def remap_features_device(raw_feats: torch.Tensor, target_len: int,
                          source_hop: int = 480, target_hop: int = 256) -> torch.Tensor:
    """[S, D] -> [target_len, D]; ``target_len`` is already capped by the caller."""
    g = math.gcd(source_hop, target_hop)
    src, tgt = source_hop // g, target_hop // g
    width = raw_feats.shape[-1]
    source_len = target_len * tgt // src + 1
    up = torch.repeat_interleave(raw_feats[:source_len], src, dim=0)
    const = source_len * src // tgt * tgt
    return up[:const].reshape(-1, tgt, width).mean(dim=1)[:target_len]
