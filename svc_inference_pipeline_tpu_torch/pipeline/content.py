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
from svc_inference_pipeline_tpu_torch.utils.devices import resolve_device


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
                    generator: Optional[torch.Generator] = None, device=None,
                    compute_dtype=torch.bfloat16, fs: int = 24000) -> "WhisperPPGExtractor":
        """Random weights on ``device`` (None: the GPU, see ``resolve_device``)."""
        device = resolve_device(device)
        dims = WHISPER_SIZES[size_or_dims] if isinstance(size_or_dims, str) else size_or_dims
        with torch.device(device):
            enc = WhisperAudioEncoder(dims)
        generator = generator or torch.Generator(device=device).manual_seed(0)
        random_init_(enc, generator)
        return cls(cast_matmul_weights_(enc.to(device).eval(), compute_dtype), fs)

    @classmethod
    def from_jax_params(cls, dims: WhisperDims, params: Dict[str, Any], device=None,
                        compute_dtype=torch.bfloat16, fs: int = 24000) -> "WhisperPPGExtractor":
        """JAX weights (numpy) on ``device`` (None: the GPU)."""
        device = resolve_device(device)
        with torch.device(device):
            enc = WhisperAudioEncoder(dims)
        load_jax_params(enc, unstack_blocks(params, dims.n_audio_layer))
        return cls(cast_matmul_weights_(enc.to(device).eval(), compute_dtype), fs)

    @classmethod
    def from_torch_checkpoint(cls, path: str, device=None, compute_dtype=torch.bfloat16,
                              fs: int = 24000) -> "WhisperPPGExtractor":
        """A Whisper ``.pt`` file (``{"dims", "model_state_dict"}``, fp16 in
        OpenAI's files) on ``device`` (None: the GPU)."""
        from svc_inference_pipeline_tpu_torch.checkpoints.torch_convert import load_whisper

        dims_dict, params = load_whisper(path)
        return cls.from_jax_params(WhisperDims(**dims_dict), params["encoder"], device, compute_dtype, fs)

    @torch.no_grad()
    def embed_audio(self, mel: torch.Tensor) -> torch.Tensor:
        return self.encoder(mel)
