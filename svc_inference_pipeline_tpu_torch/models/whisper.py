"""Whisper audio encoder.

Counterpart of ``WhisperAudioEncoder`` in
``svc_inference_pipeline_tpu/models/whisper.py`` (the decoder is not ported):
conv stem with exact GELU, sinusoidal positions, pre-LN residual attention
blocks with LayerNorm computed in f32, ``ln_post``. Matmuls run at the
compute dtype; the attention is K4 (``ops/pallas/attention.py``), which
takes its plain version on CPU tensors.

[B, n_mels, 3000] log-mel -> [B, 1500, n_state] f32.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class WhisperDims:
    n_mels: int = 80
    n_audio_ctx: int = 1500
    n_audio_state: int = 1024
    n_audio_head: int = 16
    n_audio_layer: int = 24
    # the text decoder's dims: carried by every Whisper checkpoint and read
    # by no module of the port (the decoder is not ported)
    n_vocab: int = 51865
    n_text_ctx: int = 448
    n_text_state: int = 1024
    n_text_head: int = 16
    n_text_layer: int = 24


WHISPER_SIZES: Dict[str, WhisperDims] = {
    "tiny": WhisperDims(80, 1500, 384, 6, 4),
    "base": WhisperDims(80, 1500, 512, 8, 6),
    "small": WhisperDims(80, 1500, 768, 12, 12),
    "medium": WhisperDims(80, 1500, 1024, 16, 24),
    "large-v1": WhisperDims(80, 1500, 1280, 20, 32),
    "large-v2": WhisperDims(80, 1500, 1280, 20, 32),
    "large": WhisperDims(80, 1500, 1280, 20, 32),
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


class MultiHeadAttention(nn.Module):
    def __init__(self, n_state: int, n_head: int):
        super().__init__()
        self.n_head = n_head
        self.query = nn.Linear(n_state, n_state)
        self.key = nn.Linear(n_state, n_state, bias=False)
        self.value = nn.Linear(n_state, n_state)
        self.out = nn.Linear(n_state, n_state)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        from svc_inference_pipeline_tpu_torch.ops.pallas.attention import encoder_attention

        q, k, v = self.query(x), self.key(x), self.value(x)
        return self.out(encoder_attention(q.contiguous(), k.contiguous(), v.contiguous(), self.n_head))


class ResidualAttentionBlock(nn.Module):
    def __init__(self, n_state: int, n_head: int):
        super().__init__()
        self.attn_ln = nn.LayerNorm(n_state)
        self.attn = MultiHeadAttention(n_state, n_head)
        self.mlp_ln = nn.LayerNorm(n_state)
        self.mlp_0 = nn.Linear(n_state, 4 * n_state)
        self.mlp_2 = nn.Linear(4 * n_state, n_state)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(layer_norm_f32(self.attn_ln, x))
        y = F.gelu(self.mlp_0(layer_norm_f32(self.mlp_ln, x)))
        return x + self.mlp_2(y)


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

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        dtype = self.conv1.weight.dtype
        x = F.gelu(self.conv1(mel.to(dtype)))
        x = F.gelu(self.conv2(x)).transpose(1, 2)  # [B, 1500, D]
        if x.shape[1:] != (self.dims.n_audio_ctx, self.dims.n_audio_state):
            raise ValueError(f"whisper encoder: unexpected stem output {tuple(x.shape)}")
        x = x + self.positional_embedding.to(x.dtype)
        for i in range(self.dims.n_audio_layer):
            x = getattr(self, f"block_{i}")(x)
        return layer_norm_f32(self.ln_post, x).float()
