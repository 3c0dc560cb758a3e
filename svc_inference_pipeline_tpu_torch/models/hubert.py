"""HuBERT / ContentVec content encoder.

Counterpart of ``svc_inference_pipeline_tpu/models/hubert.py``
(``HubertConfig``, ``HubertModel``), with the JAX module names as submodule
names, so the weights bridge (``checkpoints/from_jax.py``) loads JAX's trees
and ``checkpoints/hubert_convert.py``'s. HuBERT-base: a 7-layer conv feature
extractor at 320x decimation (bias-free convs, exact GELU,
``GroupNorm(512, 512)`` after the first conv only), LayerNorm and a
projection to 768, a grouped positional conv (kernel 128, 16 groups,
padding 64, its last frame cut since the kernel is even), then post-LN
transformer layers. ContentVec's features are layer 9's output through
``final_proj`` (256).

The attention is plain ``torch.matmul`` with q scaled by hd^-0.5 after its
projection and an f32 softmax, as JAX's einsum is; it is not a kernel in
either package.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class HubertConfig:
    conv_layers: Tuple[Tuple[int, int, int], ...] = (
        (512, 10, 5),
        (512, 3, 2),
        (512, 3, 2),
        (512, 3, 2),
        (512, 3, 2),
        (512, 2, 2),
        (512, 2, 2),
    )
    encoder_dim: int = 768
    encoder_layers: int = 12
    encoder_heads: int = 12
    encoder_ffn_dim: int = 3072
    pos_conv_kernel: int = 128
    pos_conv_groups: int = 16
    final_dim: int = 256  # final_proj output (ContentVec features)


class ConvFeatureExtractor(nn.Module):
    """Waveform [B, L] -> features [B, S, C] (channels last)."""

    def __init__(self, cfg: HubertConfig):
        super().__init__()
        c_in = 1
        for i, (dim, k, stride) in enumerate(cfg.conv_layers):
            setattr(self, f"conv_{i}", nn.Conv1d(c_in, dim, k, stride=stride, bias=False))
            c_in = dim
        self.n_layers = len(cfg.conv_layers)
        dim0 = cfg.conv_layers[0][0]
        self.group_norm = nn.GroupNorm(dim0, dim0, eps=1e-5)

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        x = wav[:, None, :]
        for i in range(self.n_layers):
            x = getattr(self, f"conv_{i}")(x)
            if i == 0:
                x = self.group_norm(x)
            x = F.gelu(x)
        return x.transpose(1, 2)


class SelfAttention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_proj, self.k_proj, self.v_proj, self.out_proj = (nn.Linear(dim, dim) for _ in range(4))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, d = x.shape
        h = self.heads
        hd = d // h
        q = (self.q_proj(x) * hd ** -0.5).view(b, t, h, hd).transpose(1, 2)
        k = self.k_proj(x).view(b, t, h, hd).permute(0, 2, 3, 1)
        v = self.v_proj(x).view(b, t, h, hd).transpose(1, 2)
        w = torch.softmax(torch.matmul(q, k).float(), dim=-1)
        out = torch.matmul(w.to(v.dtype), v).transpose(1, 2).reshape(b, t, d)
        return self.out_proj(out)


class EncoderLayer(nn.Module):
    """Post-LN transformer layer (fairseq's layer_norm_first=False)."""

    def __init__(self, cfg: HubertConfig):
        super().__init__()
        d = cfg.encoder_dim
        self.self_attn = SelfAttention(d, cfg.encoder_heads)
        self.self_attn_layer_norm = nn.LayerNorm(d, eps=1e-5)
        self.fc1 = nn.Linear(d, cfg.encoder_ffn_dim)
        self.fc2 = nn.Linear(cfg.encoder_ffn_dim, d)
        self.final_layer_norm = nn.LayerNorm(d, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.self_attn_layer_norm(x + self.self_attn(x))
        return self.final_layer_norm(x + self.fc2(F.gelu(self.fc1(x))))


class HubertModel(nn.Module):
    """``forward(wav [B, L], output_layer=9, final_proj=True)`` -> [B, S, 256]:
    layer ``output_layer``'s output through ``final_proj`` (without it
    [B, S, 768])."""

    def __init__(self, cfg: HubertConfig = HubertConfig()):
        super().__init__()
        self.cfg = cfg
        c_feat, d = cfg.conv_layers[-1][0], cfg.encoder_dim
        self.feature_extractor = ConvFeatureExtractor(cfg)
        self.layer_norm = nn.LayerNorm(c_feat, eps=1e-5)
        self.post_extract_proj = nn.Linear(c_feat, d)
        self.pos_conv = nn.Conv1d(d, d, cfg.pos_conv_kernel, padding=cfg.pos_conv_kernel // 2,
                                  groups=cfg.pos_conv_groups)
        self.encoder_layer_norm = nn.LayerNorm(d, eps=1e-5)
        for i in range(cfg.encoder_layers):
            setattr(self, f"layer_{i}", EncoderLayer(cfg))
        self.final_proj = nn.Linear(d, cfg.final_dim)

    def forward(self, wav: torch.Tensor, output_layer: int = 9, final_proj: bool = True) -> torch.Tensor:
        if not 1 <= output_layer <= self.cfg.encoder_layers:
            raise ValueError(f"output_layer {output_layer} outside 1..{self.cfg.encoder_layers}")
        x = self.post_extract_proj(self.layer_norm(self.feature_extractor(wav)))
        pos = self.pos_conv(x.transpose(1, 2))
        if self.cfg.pos_conv_kernel % 2 == 0:
            pos = pos[..., :-1]
        x = self.encoder_layer_norm(x + F.gelu(pos).transpose(1, 2))
        for i in range(output_layer):
            x = getattr(self, f"layer_{i}")(x)
        return self.final_proj(x) if final_proj else x
