"""Whisper audio encoder and text decoder.

Counterpart of ``svc_inference_pipeline_tpu/models/whisper.py``: conv stem
with exact GELU, sinusoidal positions, pre-LN residual attention blocks with
LayerNorm computed in f32, ``ln_post``. The encoder's matmuls run at its
weights' dtype, and its attention is K4 (``ops/pallas/attention.py``), which
takes its plain version on CPU tensors.

The text decoder (``WhisperTextDecoder``, used by
``models/whisper_decoding.py``) runs at f32: causal self-attention over a
fixed-size KV buffer per layer, cross-attention over the audio features
with their (k, v) computed once, and logits ``x @ token_embedding.T``. Its
attention is not a kernel in the JAX package either (``_attention``'s einsum
branch): here it is ``torch.matmul`` with the same split scale.

Encoder: [B, n_mels, 3000] log-mel -> [B, 1500, n_state] f32.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from svc_inference_pipeline_tpu_torch.parallel.sharding import copy_to, group_rank, row_parallel


@dataclasses.dataclass(frozen=True)
class WhisperDims:
    n_mels: int = 80
    n_audio_ctx: int = 1500
    n_audio_state: int = 1024
    n_audio_head: int = 16
    n_audio_layer: int = 24
    n_vocab: int = 51865
    n_text_ctx: int = 448
    n_text_state: int = 1024
    n_text_head: int = 16
    n_text_layer: int = 24


WHISPER_SIZES: Dict[str, WhisperDims] = {
    "tiny": WhisperDims(80, 1500, 384, 6, 4, 51865, 448, 384, 6, 4),
    "base": WhisperDims(80, 1500, 512, 8, 6, 51865, 448, 512, 8, 6),
    "small": WhisperDims(80, 1500, 768, 12, 12, 51865, 448, 768, 12, 12),
    "medium": WhisperDims(80, 1500, 1024, 16, 24, 51865, 448, 1024, 16, 24),
    "large-v1": WhisperDims(80, 1500, 1280, 20, 32, 51865, 448, 1280, 20, 32),
    "large-v2": WhisperDims(80, 1500, 1280, 20, 32, 51865, 448, 1280, 20, 32),
    "large": WhisperDims(80, 1500, 1280, 20, 32, 51865, 448, 1280, 20, 32),
}


def sinusoids(length: int, channels: int, max_timescale: float = 10000.0) -> np.ndarray:
    """Sinusoidal positional embedding [length, channels] (f32)."""
    assert channels % 2 == 0
    log_inc = np.log(max_timescale) / (channels // 2 - 1)
    inv = np.exp(-log_inc * np.arange(channels // 2))
    t = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(t), np.cos(t)], axis=1).astype(np.float32)


def layer_norm_f32(ln: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """LayerNorm in f32 whatever the input dtype; result in the input dtype."""
    y = F.layer_norm(x.float(), ln.normalized_shape, ln.weight.float(), ln.bias.float(), 1e-5)
    return y.to(x.dtype)


def text_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, n_head: int,
                   mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The decoder's attention, q [B, Tq, D] over k, v [B, Tk, D]: q and k
    each scaled by hd^-0.25, ``mask`` [Tq, Tk] added to the scores, softmax
    in f32."""
    b, tq, d = q.shape
    tk = k.shape[1]
    hd = d // n_head
    scale = hd ** -0.25
    q = q.reshape(b, tq, n_head, hd).transpose(1, 2) * scale
    k = k.reshape(b, tk, n_head, hd).permute(0, 2, 3, 1) * scale
    v = v.reshape(b, tk, n_head, hd).transpose(1, 2)
    qk = q @ k
    if mask is not None:
        qk = qk + mask
    w = torch.softmax(qk.float(), dim=-1).to(q.dtype)
    return (w @ v).transpose(1, 2).reshape(b, tq, d)


class MultiHeadAttention(nn.Module):
    def __init__(self, n_state: int, n_head: int):
        super().__init__()
        self.n_head = n_head
        self.query = nn.Linear(n_state, n_state)
        self.key = nn.Linear(n_state, n_state, bias=False)
        self.value = nn.Linear(n_state, n_state)
        self.out = nn.Linear(n_state, n_state)

    def forward(self, x: torch.Tensor, tp_group=None) -> torch.Tensor:
        """The encoder's self-attention, through K4. With ``tp_group`` (a
        block sharded by ``WHISPER_TP_RULES``) q/k/v are this rank's heads,
        K4 runs on those ``n_head / model`` heads, and the out projection's
        share of the sum is all-reduced."""
        from svc_inference_pipeline_tpu_torch.ops.pallas.attention import encoder_attention

        x = copy_to(x, tp_group)
        q, k, v = self.query(x), self.key(x), self.value(x)
        heads = self.n_head // group_rank(tp_group)[1]
        o = encoder_attention(q.contiguous(), k.contiguous(), v.contiguous(), heads)
        return self.out(o) if tp_group is None else row_parallel(o, self.out, tp_group)

    def attend(self, x: torch.Tensor, xa: Optional[torch.Tensor] = None,
               mask: Optional[torch.Tensor] = None, kv: Optional[Tuple] = None,
               kv_buffer: Optional[Tuple] = None, offset: int = 0):
        """The decoder's self-attention (``xa`` None) or cross-attention over
        ``xa``. ``kv`` is a precomputed (k, v). ``kv_buffer`` is a pair of
        [B, T_max, D] buffers: the new k/v rows are written at ``offset``
        and attention reads the rows written so far. Returns (out, (k, v))."""
        q = self.query(x)
        if kv is not None:
            k, v = kv
        else:
            src = x if xa is None else xa
            k, v = self.key(src), self.value(src)
        if kv_buffer is not None:
            kb, vb = kv_buffer
            end = offset + x.shape[1]
            kb[:, offset:end] = k
            vb[:, offset:end] = v
            k, v = kb[:, :end], vb[:, :end]
        return self.out(text_attention(q, k, v, self.n_head, mask)), (k, v)


class ResidualAttentionBlock(nn.Module):
    def __init__(self, n_state: int, n_head: int):
        super().__init__()
        self.attn_ln = nn.LayerNorm(n_state)
        self.attn = MultiHeadAttention(n_state, n_head)
        self.mlp_ln = nn.LayerNorm(n_state)
        self.mlp_0 = nn.Linear(n_state, 4 * n_state)
        self.mlp_2 = nn.Linear(4 * n_state, n_state)

    def mlp(self, x: torch.Tensor, tp_group=None) -> torch.Tensor:
        h = F.gelu(self.mlp_0(copy_to(layer_norm_f32(self.mlp_ln, x), tp_group)))
        return self.mlp_2(h) if tp_group is None else row_parallel(h, self.mlp_2, tp_group)

    def forward(self, x: torch.Tensor, tp_group=None) -> torch.Tensor:
        x = x + self.attn(layer_norm_f32(self.attn_ln, x), tp_group)
        return x + self.mlp(x, tp_group)


class TextResidualAttentionBlock(ResidualAttentionBlock):
    """A decoder layer: causal self-attention, cross-attention over the audio
    features, MLP."""

    def __init__(self, n_state: int, n_head: int):
        super().__init__(n_state, n_head)
        self.cross_attn_ln = nn.LayerNorm(n_state)
        self.cross_attn = MultiHeadAttention(n_state, n_head)

    def forward(self, x: torch.Tensor, xa: torch.Tensor, mask: Optional[torch.Tensor] = None,
                cross_kv: Optional[Tuple] = None, self_buffer: Optional[Tuple] = None,
                offset: int = 0):
        h, self_kv = self.attn.attend(layer_norm_f32(self.attn_ln, x), mask=mask,
                                      kv_buffer=self_buffer, offset=offset)
        x = x + h
        h, cross_kv = self.cross_attn.attend(layer_norm_f32(self.cross_attn_ln, x), xa=xa, kv=cross_kv)
        x = x + h
        return x + self.mlp(x), (self_kv, cross_kv)


class WhisperAudioEncoder(nn.Module):
    """[B, n_mels, 3000] -> [B, n_audio_ctx, n_state] f32. The module's
    matmul weights set the compute dtype (``.to(bf16)`` them, keeping the
    LayerNorms f32)."""

    def __init__(self, dims: WhisperDims):
        super().__init__()
        self.dims = dims
        d = dims.n_audio_state
        self.conv1 = nn.Conv1d(dims.n_mels, d, 3, padding=1)
        self.conv2 = nn.Conv1d(d, d, 3, stride=2, padding=1)
        self.register_buffer("positional_embedding",
                             torch.tensor(sinusoids(dims.n_audio_ctx, d)), persistent=False)
        for i in range(dims.n_audio_layer):
            self.add_module(f"block_{i}", ResidualAttentionBlock(d, dims.n_audio_head))
        self.ln_post = nn.LayerNorm(d)

    def forward(self, mel: torch.Tensor, tp_group=None) -> torch.Tensor:
        """``tp_group``: the model-axis group of an encoder sharded by
        ``WHISPER_TP_RULES`` (the stem and the LayerNorms stay whole)."""
        dtype = self.conv1.weight.dtype
        x = F.gelu(self.conv1(mel.to(dtype)))
        x = F.gelu(self.conv2(x)).transpose(1, 2)  # [B, 1500, D]
        if x.shape[1:] != (self.dims.n_audio_ctx, self.dims.n_audio_state):
            raise ValueError(f"whisper encoder: unexpected stem output {tuple(x.shape)}")
        x = x + self.positional_embedding.to(x.dtype)
        for i in range(self.dims.n_audio_layer):
            x = getattr(self, f"block_{i}")(x, tp_group)
        return layer_norm_f32(self.ln_post, x).float()


class WhisperTextDecoder(nn.Module):
    """Tokens [B, T] and audio features [B, n_audio_ctx, D] -> logits
    [B, T, n_vocab] f32, with a KV cache.

    ``cache`` holds ``cross_i`` (the cross-attention (k, v), computed from
    the audio features when absent) and, for incremental decoding,
    ``self_i``: a pair of [B, n_text_ctx, D] buffers that the new tokens'
    k/v rows are written into at ``offset``. Returns (logits, cache).

    ``embedding_dtypes`` are the storage dtypes of the token and positional
    embeddings in the weights' source: their sum is taken at those dtypes
    (fp16 for OpenAI's files), as the JAX decoder's ``nn.Embed`` does, and
    everything after it at f32."""

    def __init__(self, dims: WhisperDims):
        super().__init__()
        self.dims = dims
        self.embedding_dtypes = (torch.float32, torch.float32)
        d = dims.n_text_state
        self.positional_embedding = nn.Parameter(torch.empty(dims.n_text_ctx, d))
        self.token_embedding = nn.Embedding(dims.n_vocab, d)
        for i in range(dims.n_text_layer):
            self.add_module(f"block_{i}", TextResidualAttentionBlock(d, dims.n_text_head))
        self.ln = nn.LayerNorm(d)

    def forward(self, tokens: torch.Tensor, audio_features: torch.Tensor,
                cache: Optional[Dict[str, Tuple]] = None, offset: int = 0):
        tq = tokens.shape[-1]
        tok_dtype, pos_dtype = self.embedding_dtypes
        x = (self.token_embedding(tokens).to(tok_dtype)
             + self.positional_embedding[offset: offset + tq].to(pos_dtype)).float()
        xa = audio_features.float()
        # row i (position offset + i) sees the columns up to its own position;
        # a single new token sees every row written so far and needs no mask
        mask = None
        if tq > 1:
            rows = offset + torch.arange(tq, device=x.device)[:, None]
            cols = torch.arange(offset + tq, device=x.device)[None, :]
            mask = torch.zeros((), device=x.device).masked_fill(cols > rows, float("-inf"))
        incremental = cache is not None and "self_0" in cache
        new_cache: Dict[str, Tuple] = {}
        for i in range(self.dims.n_text_layer):
            x, (self_kv, cross_kv) = getattr(self, f"block_{i}")(
                x, xa, mask=mask, cross_kv=cache.get(f"cross_{i}") if cache else None,
                self_buffer=cache[f"self_{i}"] if incremental else None, offset=offset)
            new_cache[f"cross_{i}"] = cross_kv
            new_cache[f"self_{i}"] = cache[f"self_{i}"] if incremental else self_kv
        x = layer_norm_f32(self.ln, x)
        return x.float() @ self.token_embedding.weight.float().T, new_cache


def is_multilingual(dims: WhisperDims) -> bool:
    return dims.n_vocab == 51865
