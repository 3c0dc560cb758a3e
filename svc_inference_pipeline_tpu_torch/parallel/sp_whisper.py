"""Sequence-parallel Whisper encoding over the model axis.

Counterpart of ``svc_inference_pipeline_tpu/parallel/sp_whisper.py``: one
30 s window's encoder pass sharded over ranks along TIME:

* the conv stem and the positional embedding are replicated (~0.5% of the
  FLOPs), and each rank keeps its ``n_audio_ctx / model`` frames;
* in each block q stays local and K/V are all-gathered over the model
  group; the attention is the einsum form (q and k each scaled by
  hd^-0.25, the softmax in f32), with no kernel, as in JAX;
* LayerNorm and the MLP are pointwise in time, so local.

It reads the per-block weights of ``models/whisper.py``'s encoder (the
port never stacks them) and returns the whole [B, n_audio_ctx, D] on every
rank (the time shards all-gathered), f32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from svc_inference_pipeline_tpu_torch.models.whisper import WhisperAudioEncoder, layer_norm_f32, text_attention
from svc_inference_pipeline_tpu_torch.parallel.mesh import MODEL_AXIS, axis_group, axis_rank, axis_size
from svc_inference_pipeline_tpu_torch.parallel.sharding import all_gather_dim


def _dense(layer, x: torch.Tensor) -> torch.Tensor:
    bias = None if layer.bias is None else layer.bias.to(x.dtype)
    return F.linear(x, layer.weight.to(x.dtype), bias)


def _stem(enc: WhisperAudioEncoder, mel: torch.Tensor) -> torch.Tensor:
    """conv1/conv2 + positional embedding (replicated)."""
    dt = mel.dtype
    x = F.gelu(F.conv1d(mel, enc.conv1.weight.to(dt), enc.conv1.bias.to(dt), padding=1))
    x = F.gelu(F.conv1d(x, enc.conv2.weight.to(dt), enc.conv2.bias.to(dt), stride=2, padding=1))
    return x.transpose(1, 2) + enc.positional_embedding.to(dt)


def _block_sp(blk, x: torch.Tensor, n_head: int, group) -> torch.Tensor:
    """One encoder block on time-sharded x: local q, all-gathered K/V."""
    h = layer_norm_f32(blk.attn_ln, x)
    q = _dense(blk.attn.query, h)
    k = all_gather_dim(_dense(blk.attn.key, h), 1, group)  # [B, T, D]
    v = all_gather_dim(_dense(blk.attn.value, h), 1, group)
    x = x + _dense(blk.attn.out, text_attention(q, k, v, n_head))
    h = layer_norm_f32(blk.mlp_ln, x)
    return x + _dense(blk.mlp_2, F.gelu(_dense(blk.mlp_0, h)))


@torch.no_grad()
def encode_sequence_parallel(encoder: WhisperAudioEncoder, mel: torch.Tensor, mesh,
                             seq_axis: str = MODEL_AXIS, compute_dtype=torch.float32) -> torch.Tensor:
    """Sequence-parallel ``embed_audio``: mel [B, n_mels, 3000] -> [B,
    n_audio_ctx, D] f32. ``n_audio_ctx`` must divide by the size of
    ``seq_axis``."""
    dims = encoder.dims
    n_shards = axis_size(mesh, seq_axis)
    assert dims.n_audio_ctx % n_shards == 0, (dims.n_audio_ctx, n_shards)
    group = axis_group(mesh, seq_axis)
    x = _stem(encoder, mel.to(compute_dtype))
    if x.shape[1:] != (dims.n_audio_ctx, dims.n_audio_state):
        raise ValueError(f"whisper encoder: unexpected stem output {tuple(x.shape)}")
    x = x.chunk(n_shards, dim=1)[axis_rank(mesh, seq_axis)]
    for i in range(dims.n_audio_layer):
        x = _block_sp(getattr(encoder, f"block_{i}"), x, dims.n_audio_head, group)
    x = layer_norm_f32(encoder.ln_post, x).float()
    return x if group is None else all_gather_dim(x.contiguous(), 1, group)
