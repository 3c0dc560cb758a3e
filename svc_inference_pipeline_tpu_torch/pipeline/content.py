"""Content features: the Whisper encoder holder with its per-clip API, and
ContentVec.

Counterpart of ``WhisperPPGExtractor`` and ``ContentVecExtractor`` in
``svc_inference_pipeline_tpu/pipeline/content.py``. ``WhisperPPGExtractor``
holds the encoder with its weights resident on the device. In bf16 mode the
matmul weights (linear and conv layers, biases included) are stored bf16 and
the LayerNorms stay f32. Its ``extract`` is the per-clip API: resample to
16 kHz on the host, 30 s windows, log-mel and the encoder (whose attention
is K4) on the device, the 480 -> 256 hop remap on the host.
``ContentVecExtractor`` runs ``models/hubert.py`` in f32 on its device.
``shard`` keeps this rank's tensor-parallel slice of the encoder;
``ensure_unstacked`` undoes a stacking the port never does.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Union

import numpy as np
import torch
from torch import nn

from svc_inference_pipeline_tpu_torch.checkpoints.from_jax import (
    load_jax_params,
    random_init_,
    unstack_blocks,
)
from svc_inference_pipeline_tpu_torch.models.hubert import HubertConfig, HubertModel
from svc_inference_pipeline_tpu_torch.models.whisper import (
    WHISPER_SIZES,
    WhisperAudioEncoder,
    WhisperDims,
)
from svc_inference_pipeline_tpu_torch.ops.remap import remap_features, remap_features_tolerant
from svc_inference_pipeline_tpu_torch.ops.resample import resample_host
from svc_inference_pipeline_tpu_torch.ops.whisper_mel import N_SAMPLES, log_mel_spectrogram
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
        self.tp_group = None

    def shard(self, mesh, rules, axis: str = "model") -> None:
        """Keep this rank's slice of the encoder under the tensor-parallel
        ``rules`` (``parallel/sharding.py``) over ``axis`` of ``mesh``; the
        encoder then runs its TP forward. JAX turns its Pallas attention off
        here because GSPMD cannot partition a ``pallas_call``; an explicit
        head shard has no such limit, so K4 stays on, on this rank's heads."""
        from svc_inference_pipeline_tpu_torch.parallel.mesh import axis_group
        from svc_inference_pipeline_tpu_torch.parallel.sharding import shard_params

        shard_params(self.encoder, mesh, rules, axis)
        self.tp_group = axis_group(mesh, axis)

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
        return self.encoder(mel, self.tp_group)

    def extract(self, audio: np.ndarray, mel_len: int, chunked: bool = True) -> np.ndarray:
        """Waveform at ``self.fs`` -> mel-rate features [T', D] (f32, host).
        Up to 30 s: one zero-padded window, as the reference. Longer: with
        ``chunked`` every 30 s window is encoded (one batch), else the clip
        is cut to its first 30 s, as the reference does."""
        audio16 = resample_host(np.asarray(audio), self.fs, 16000)
        n_windows = max(1, -(-len(audio16) // N_SAMPLES)) if chunked else 1
        windows = np.zeros((n_windows, N_SAMPLES), dtype=np.float32)
        for w in range(n_windows):
            seg = audio16[w * N_SAMPLES: (w + 1) * N_SAMPLES]
            windows[w, : len(seg)] = seg
        device = next(self.encoder.parameters()).device
        feats = self.embed_audio(log_mel_spectrogram(torch.from_numpy(windows).to(device)))  # [W, 1500, D]
        feats = feats.float().cpu().numpy().reshape(-1, feats.shape[-1])
        return remap_features(feats, mel_len, max_source_len=feats.shape[0])


class ContentVecExtractor:
    """ContentVec/HuBERT content features at the mel hop: ``models/hubert.py``
    (f32) on the device of ``model``, layer ``output_layer`` through
    ``final_proj``."""

    def __init__(self, model: HubertModel, fs: int = 24000, output_layer: int = 9):
        self.model = model.eval()
        self.cfg = model.cfg
        self.fs = fs
        self.output_layer = output_layer

    @classmethod
    def from_jax_params(cls, params: Dict[str, Any], cfg: Optional[HubertConfig] = None, device=None,
                        fs: int = 24000, output_layer: int = 9) -> "ContentVecExtractor":
        """A JAX-layout tree (JAX's ``model.init`` or ``load_hubert``'s) on
        ``device`` (None: the GPU)."""
        with torch.device(resolve_device(device)):
            model = HubertModel(cfg or HubertConfig())
        return cls(load_jax_params(model, params), fs, output_layer)

    @classmethod
    def from_torch_checkpoint(cls, path: str, device=None, fs: int = 24000,
                              output_layer: int = 9) -> "ContentVecExtractor":
        """A fairseq ContentVec/HuBERT-base ``.pt`` file on ``device`` (None:
        the GPU)."""
        from svc_inference_pipeline_tpu_torch.checkpoints.hubert_convert import load_hubert

        cfg, params = load_hubert(path)
        return cls.from_jax_params(params, cfg, device, fs, output_layer)

    @classmethod
    def random_init(cls, cfg: Optional[HubertConfig] = None, generator: Optional[torch.Generator] = None,
                    device=None, fs: int = 24000, output_layer: int = 9) -> "ContentVecExtractor":
        """Random weights (``random_init_``) drawn on ``device`` (None: the
        GPU) from ``generator`` (default seeded 0)."""
        device = resolve_device(device)
        with torch.device(device):
            model = HubertModel(cfg or HubertConfig())
        random_init_(model, generator or torch.Generator(device=device).manual_seed(0))
        return cls(model, fs, output_layer)

    @torch.no_grad()
    def extract(self, audio: np.ndarray, mel_len: int) -> np.ndarray:
        """Waveform at ``self.fs`` -> [mel_len, final_dim] (f32, host)."""
        audio16 = resample_host(np.asarray(audio), self.fs, 16000)
        device = self.model.final_proj.weight.device
        feats = self.model(torch.from_numpy(audio16[None]).to(device), output_layer=self.output_layer)[0]
        return remap_features_tolerant(feats.float().cpu().numpy(), mel_len)
