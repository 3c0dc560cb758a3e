"""Content features: the Whisper encoder holder.

Counterpart of ``WhisperPPGExtractor`` in
``svc_inference_pipeline_tpu/pipeline/content.py``: holds the encoder with its
weights resident on the device. In bf16 mode the matmul weights (linear and
conv layers, biases included) are stored bf16 and the LayerNorms stay f32.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Union

import torch
from torch import nn

from svc_inference_pipeline_tpu_torch.checkpoints.from_jax import (
    load_jax_params,
    random_init_,
    unstack_blocks,
)
from svc_inference_pipeline_tpu_torch.models.whisper import (
    WHISPER_SIZES,
    WhisperAudioEncoder,
    WhisperDims,
)


def cast_matmul_weights_(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Store every parameter of ``module`` at ``dtype`` except LayerNorms."""
    for sub in module.modules():
        if isinstance(sub, nn.LayerNorm):
            continue
        for p in sub.parameters(recurse=False):
            p.data = p.data.to(dtype)
    return module


class WhisperPPGExtractor:
    """[W, 80, 3000] log-mel windows -> [W, 1500, D] features (f32)."""

    def __init__(self, encoder: WhisperAudioEncoder, fs: int = 24000):
        self.encoder = encoder
        self.dims = encoder.dims
        self.fs = fs

    @classmethod
    def random_init(cls, size_or_dims: Union[str, WhisperDims] = "tiny",
                    generator: Optional[torch.Generator] = None, device="cpu",
                    compute_dtype=torch.bfloat16, fs: int = 24000) -> "WhisperPPGExtractor":
        dims = WHISPER_SIZES[size_or_dims] if isinstance(size_or_dims, str) else size_or_dims
        with torch.device(device):
            enc = WhisperAudioEncoder(dims)
        generator = generator or torch.Generator(device=device).manual_seed(0)
        random_init_(enc, generator)
        return cls(cast_matmul_weights_(enc.to(device).eval(), compute_dtype), fs)

    @classmethod
    def from_jax_params(cls, dims: WhisperDims, params: Dict[str, Any], device="cpu",
                        compute_dtype=torch.bfloat16, fs: int = 24000) -> "WhisperPPGExtractor":
        enc = WhisperAudioEncoder(dims)
        load_jax_params(enc, unstack_blocks(params, dims.n_audio_layer))
        return cls(cast_matmul_weights_(enc.to(device).eval(), compute_dtype), fs)

    @torch.no_grad()
    def embed_audio(self, mel: torch.Tensor) -> torch.Tensor:
        return self.encoder(mel)
