"""Condition encoder: content + melody + loudness + singer -> conditioner.

Counterpart of ``svc_inference_pipeline_tpu/models/encoder.py`` (f32):

* content: Linear(input_content_dim -> encoder_content_dim) per content type,
* melody: F0 bucketised over n_bins-1 log-spaced boundaries spanning
  (C1 - 0.1 Hz, C7] -> embedding,
* loudness: energy bucketised over n_bins-1 log-spaced boundaries in
  [1e-30, 1.5] -> embedding,
* singer: embedding table broadcast over time,
* merged by sum ("add") or concatenation ("concat").

``torch.bucketize(x, bins, right=False)`` is ``searchsorted(bins, x,
side='left')``, the JAX module's bucketing.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from svc_inference_pipeline_tpu_torch.parallel.sharding import gather_from, group_rank, reduce_from

_C1_HZ = 440.0 * 2.0 ** ((24 - 69) / 12.0)
_C7_HZ = 440.0 * 2.0 ** ((96 - 69) / 12.0)
_LOUDNESS_MIN = 1e-30
_LOUDNESS_MAX = 1.5


def melody_bins(n_bins: int) -> np.ndarray:
    return np.exp(np.linspace(np.log(_C1_HZ - 0.1), np.log(_C7_HZ), n_bins - 1)).astype(np.float32)


def loudness_bins(n_bins: int) -> np.ndarray:
    return np.exp(np.linspace(np.log(_LOUDNESS_MIN), np.log(_LOUDNESS_MAX), n_bins - 1)).astype(np.float32)


def _lookup(table: nn.Embedding, ids: torch.Tensor, tp_group=None) -> torch.Tensor:
    """Embedding lookup; with ``tp_group`` the table holds rows [r n, (r+1) n)
    of the vocabulary, other ids look up zeros, and the ranks' rows are
    summed (all-reduce)."""
    if tp_group is None:
        return table(ids)
    rank, _ = group_rank(tp_group)
    n = table.weight.shape[0]
    local = ids - rank * n
    mine = (local >= 0) & (local < n)
    rows = F.embedding(torch.where(mine, local, 0), table.weight) * mine[..., None]
    return reduce_from(rows, tp_group)


class ConditionEncoder(nn.Module):
    """batch {content_<type> [B,T,Din], melody [B,T], loudness [B,T],
    singer [B,1] int} -> cond [B, T, D]. Only encoders with a nonzero input
    dimension exist, as in the JAX module."""

    def __init__(self, cfg: Any):
        super().__init__()
        self.cfg = cfg
        self.content_types = [
            t for t in cfg.content_feature if cfg.input_content_dim[t] != 0
        ]
        for t in self.content_types:
            self.add_module(f"content_{t}", nn.Linear(cfg.input_content_dim[t], cfg.encoder_content_dim))
        if cfg.input_melody_dim != 0:
            self.melody = (nn.Linear(1, cfg.encoder_melody_dim) if cfg.n_bins_melody == 0
                           else nn.Embedding(cfg.n_bins_melody, cfg.encoder_melody_dim))
            self.register_buffer("melody_boundaries", torch.tensor(melody_bins(cfg.n_bins_melody)),
                                 persistent=False)
        if cfg.input_loudness_dim != 0:
            self.loudness = (nn.Linear(1, cfg.encoder_loudness_dim) if cfg.n_bins_loudness == 0
                             else nn.Embedding(cfg.n_bins_loudness, cfg.encoder_loudness_dim))
            self.register_buffer("loudness_boundaries", torch.tensor(loudness_bins(cfg.n_bins_loudness)),
                                 persistent=False)
        self.singer = nn.Embedding(cfg.singer_table_size, cfg.encoder_singer_dim)

    def _binned(self, layer, values, boundaries, n_bins, tp_group=None):
        if n_bins == 0:
            return layer(values.float()[..., None])
        return _lookup(layer, torch.bucketize(values.float(), boundaries, right=False), tp_group)

    def _content(self, t: str, x: torch.Tensor, tp_group) -> torch.Tensor:
        layer = getattr(self, f"content_{t}")
        if tp_group is None:
            return layer(x)
        # column-parallel: this rank's output columns, all-gathered, then the
        # whole (replicated) bias
        return gather_from(F.linear(x, layer.weight), -1, tp_group) + layer.bias

    def forward(self, batch: Dict[str, torch.Tensor], tp_group=None) -> torch.Tensor:
        """``tp_group``: the model-axis group of a module sharded by
        ``MAPPER_TP_RULES`` (``parallel/sharding.py``): the tables hold a
        slice of their vocabulary and the content projections a slice of
        their output columns."""
        cfg = self.cfg
        outputs = [self._content(t, batch[f"content_{t}"].float(), tp_group) for t in self.content_types]
        if cfg.input_melody_dim != 0:
            outputs.append(self._binned(self.melody, batch["melody"], self.melody_boundaries,
                                        cfg.n_bins_melody, tp_group))
        if cfg.input_loudness_dim != 0:
            outputs.append(self._binned(self.loudness, batch["loudness"], self.loudness_boundaries,
                                        cfg.n_bins_loudness, tp_group))
        seq_len = outputs[0].shape[1]
        singer = _lookup(self.singer, batch["singer"].long(), tp_group)  # [B, 1, D]
        outputs.append(singer.expand(singer.shape[0], seq_len, singer.shape[-1]))
        if cfg.merge_mode == "concat":
            return torch.cat(outputs, dim=-1)
        if cfg.merge_mode != "add":
            raise ValueError(f"unknown merge_mode {cfg.merge_mode!r}")
        out = outputs[0]
        for o in outputs[1:]:
            out = out + o
        return out
