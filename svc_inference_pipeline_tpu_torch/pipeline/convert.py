"""End-to-end singing voice conversion: wav in -> converted wav out.

Counterpart of ``svc_inference_pipeline_tpu/pipeline/convert.py`` for the
single-clip DDPM path:

    pipe = SVCPipeline.from_config(cfg, random_weights=True, device="cuda")
    wav  = pipe.convert("clip.wav", "svcc_CDF1")

Stages: load -> [host thread: Praat F0 + median shift to the target singer]
overlapping [device: mel energy, 24->16 kHz resample, Whisper log-mel and
encoder (30 s windows), 480->256 hop remap] -> condition encoder -> DDPM
(one K1 launch per reverse step) -> mel denormalisation -> BigVGAN (K2 per
stage, K3 for the last activation) -> fade-out and trim at the true length.
Frame counts are padded to a bucket multiple, as in the JAX pipeline.

``self.timings`` holds the wall seconds of the last conversion's phases,
each closed by a device synchronisation.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from svc_inference_pipeline_tpu_torch.checkpoints.from_jax import load_jax_params, random_init_
from svc_inference_pipeline_tpu_torch.config import HParams
from svc_inference_pipeline_tpu_torch.models.bigvgan import BigVGANGenerator, vocoder_output_finalize
from svc_inference_pipeline_tpu_torch.models.diffsvc import DiffSVCDenoiser
from svc_inference_pipeline_tpu_torch.models.encoder import ConditionEncoder
from svc_inference_pipeline_tpu_torch.models.whisper import WhisperDims
from svc_inference_pipeline_tpu_torch.ops.f0 import get_f0_features
from svc_inference_pipeline_tpu_torch.ops.mel import extract_mel_features
from svc_inference_pipeline_tpu_torch.ops.pallas.denoiser_step import make_fused_sampler
from svc_inference_pipeline_tpu_torch.ops.remap import remap_features_device
from svc_inference_pipeline_tpu_torch.ops.resample import _out_len, _resample_conv
from svc_inference_pipeline_tpu_torch.ops.whisper_mel import N_SAMPLES, log_mel_spectrogram
from svc_inference_pipeline_tpu_torch.pipeline.content import WhisperPPGExtractor
from svc_inference_pipeline_tpu_torch.sampling.schedule import DiffusionSchedule
from svc_inference_pipeline_tpu_torch.utils.artifacts import load_mel_min_max, pitch_shift
from svc_inference_pipeline_tpu_torch.utils.audio_io import load_audio
from svc_inference_pipeline_tpu_torch.utils.registry import get_singer_id

DEFAULT_BUCKET = 64  # frame-count padding granularity


def pad_to_bucket(n: int, bucket: int = DEFAULT_BUCKET) -> int:
    return ((n + bucket - 1) // bucket) * bucket


def mel_frame_count(cfg: HParams, n_samples: int) -> int:
    """Frame count of the mel front-end for ``n_samples`` samples, analytically."""
    padded_len = n_samples + 2 * int((cfg.n_fft - cfg.hop_length) / 2)
    return 1 + (padded_len - cfg.n_fft) // cfg.hop_length


def resolve_device(name: Optional[str]) -> torch.device:
    """Config/CLI device name -> torch device: "tpu", "cuda" and "gpu" all
    name the GPU (the JAX config's default is "tpu")."""
    name = (name or "cuda").lower()
    if name in ("tpu", "cuda", "gpu"):
        return torch.device("cuda")
    if name.startswith("cuda:") or name == "cpu":
        return torch.device(name)
    raise ValueError(f"unknown device {name!r} (use cuda, tpu or cpu)")


def compute_dtype(cfg: HParams) -> torch.dtype:
    """The config's compute dtype (``compute_dtype``, default bfloat16)."""
    return torch.bfloat16 if cfg.get("compute_dtype", "bfloat16") == "bfloat16" else torch.float32


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class SVCPipeline:
    """Holds the models on one device and runs conversions."""

    def __init__(self, cfg: HParams, cond_encoder: ConditionEncoder, denoiser: DiffSVCDenoiser,
                 vocoder: BigVGANGenerator, whisper: WhisperPPGExtractor,
                 device: Union[str, torch.device]):
        sampler = cfg.mapper.get("sampler", "ddpm")
        if sampler != "ddpm":
            raise NotImplementedError(f"sampler {sampler!r} is not ported yet (only 'ddpm')")
        self.cfg = cfg
        self.device = torch.device(device)
        self.compute_dtype = cd = compute_dtype(cfg)
        # cast policy of the JAX pipeline: the denoiser is stored entirely at
        # the compute dtype; vocoder leaves of 2+ dimensions too, its 1-D
        # leaves (biases, snake alpha/beta) stay f32; the condition encoder
        # stays f32
        self.cond_encoder = cond_encoder.to(self.device).eval()
        self.denoiser = denoiser.to(device=self.device, dtype=cd).eval()
        self.vocoder = vocoder.to(self.device).eval()
        for p in self.vocoder.parameters():
            if p.dim() >= 2:
                p.data = p.data.to(cd)
        self.vocoder.prepare_kernel_params()
        self.whisper = whisper
        self.schedule = DiffusionSchedule.from_config(cfg.mapper)
        mel_min, mel_max = load_mel_min_max(cfg.min_mel_file, cfg.max_mel_file)
        self._mel_min = torch.as_tensor(mel_min, device=self.device)
        self._mel_max = torch.as_tensor(mel_max, device=self.device)
        self.timings: Dict[str, float] = {}

    # ------------------------------------------------------------------
    # Builders
    # ------------------------------------------------------------------

    @staticmethod
    def _models(cfg: HParams, cd: torch.dtype):
        return (ConditionEncoder(cfg.mapper), DiffSVCDenoiser(cfg.mapper, compute_dtype=cd),
                BigVGANGenerator(cfg.vocoder, compute_dtype=cd))

    @staticmethod
    def _adapt_content_width(cfg: HParams, width: int) -> HParams:
        if cfg.mapper.input_content_dim["whisper"] == width:
            return cfg
        d = cfg.to_dict()
        d["mapper"]["input_content_dim"]["whisper"] = width
        return HParams(**d)

    @classmethod
    def from_config(cls, cfg: HParams, random_weights: bool = False, whisper_size: str = "tiny",
                    seed: int = 0, device: Optional[str] = None) -> "SVCPipeline":
        """Build with random weights drawn from one ``torch.Generator``
        seeded with ``seed`` (checkpoint loading is not ported yet)."""
        if not random_weights:
            raise NotImplementedError("checkpoint loading is not ported yet; use random_weights=True")
        dev = resolve_device(device or cfg.get("device"))
        cd = compute_dtype(cfg)
        g = torch.Generator(device=dev).manual_seed(seed)
        whisper = WhisperPPGExtractor.random_init(whisper_size, g, dev, cd, fs=cfg.fs)
        # a non-medium random whisper emits another feature width: adapt the
        # content-encoder input to it
        cfg = cls._adapt_content_width(cfg, whisper.dims.n_audio_state)
        with torch.device(dev):
            models = cls._models(cfg, cd)
        for m in models:
            random_init_(m, g)
        return cls(cfg, *models, whisper, dev)

    @classmethod
    def from_jax_params(cls, cfg: HParams, cond_params, den_params, voc_params,
                        whisper_dims: WhisperDims, whisper_params, device="cpu") -> "SVCPipeline":
        """Build from JAX parameter trees (numpy), through the weights bridge."""
        cd = compute_dtype(cfg)
        whisper = WhisperPPGExtractor.from_jax_params(whisper_dims, whisper_params, device, cd, cfg.fs)
        cfg = cls._adapt_content_width(cfg, whisper_dims.n_audio_state)
        cond, den, voc = cls._models(cfg, cd)
        for m, p in ((cond, cond_params), (den, den_params), (voc, voc_params)):
            load_jax_params(m, p)
        return cls(cfg, cond, den, voc, whisper, device)

    # ------------------------------------------------------------------
    # Front-end
    # ------------------------------------------------------------------

    @torch.no_grad()
    def _frontend_device(self, audio24: torch.Tensor, n_windows: int, n_frames: int,
                         padded: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Mel energy + resample + Whisper log-mel + encoder (30 s windows)
        + hop remap + bucket padding, on the device."""
        _, energy = extract_mel_features(audio24, self.cfg)
        audio16 = _resample_conv(audio24, self.cfg.fs, 16000, "kaiser_best")
        audio16 = F.pad(audio16, (0, n_windows * N_SAMPLES - audio16.shape[-1]))
        wmel = log_mel_spectrogram(audio16.reshape(n_windows, N_SAMPLES))
        feats = self.whisper.embed_audio(wmel)
        feats = feats.reshape(-1, feats.shape[-1])
        content = remap_features_device(feats.float(), n_frames)
        energy = F.pad(energy[:n_frames], (0, padded - n_frames))
        content = F.pad(content, (0, 0, 0, padded - n_frames))
        return energy[None], content[None]

    def extract_features(self, wav: Union[str, np.ndarray], singer_name: str):
        """(batch dict padded to the bucket, true frame count). F0 runs on a
        host thread while the device computes the Whisper chain."""
        cfg = self.cfg
        audio = load_audio(wav, cfg.fs)[0] if isinstance(wav, str) else np.asarray(wav, np.float32)
        len16 = _out_len(len(audio), 2, 3)  # 24 kHz -> 16 kHz length
        n_windows = max(1, -(-len16 // N_SAMPLES))
        n_frames = min(mel_frame_count(cfg, len(audio)), n_windows * 1500 * 15 // 8)
        padded = pad_to_bucket(n_frames)

        def f0_job():
            f0, _ = get_f0_features(audio, n_frames, cfg)
            return np.pad(pitch_shift(f0, cfg)[:n_frames], (0, padded - n_frames)).astype(np.float32)

        with ThreadPoolExecutor(max_workers=1) as pool:
            f0_future = pool.submit(f0_job)
            audio_dev = torch.as_tensor(audio, device=self.device)
            energy, content = self._frontend_device(audio_dev, n_windows, n_frames, padded)
            f0 = f0_future.result()
        singer = get_singer_id(cfg, singer_name)
        batch = {
            "content_whisper": content,
            "melody": torch.as_tensor(f0, device=self.device)[None],
            "loudness": energy,
            "singer": torch.as_tensor(singer[None].astype(np.int64), device=self.device),
        }
        return batch, n_frames

    # ------------------------------------------------------------------
    # Core: cond encode -> DDPM -> denorm -> vocode -> finalize
    # ------------------------------------------------------------------

    @torch.no_grad()
    def _convert_core(self, batch: Dict[str, torch.Tensor], n_true: torch.Tensor, n_frames: int,
                      generator: Optional[torch.Generator] = None,
                      noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
        """Waveform [B, n_frames * hop] (f32) of a padded feature batch.
        ``noise = (x_T, z [steps, B, T, M])`` injects the sampler's draws."""
        t0 = time.perf_counter()
        cond = self.cond_encoder(batch)
        shape = (cond.shape[0], n_frames, self.cfg.mapper.n_mel)
        sample = make_fused_sampler(self.denoiser, cond, self.schedule.num_steps, self.compute_dtype)
        mel_norm = sample(self.schedule, shape, generator, noise)
        _sync(self.device)
        t1 = time.perf_counter()
        lo, hi = self._mel_min, self._mel_max
        mel = (mel_norm + 1.0) / 2.0 * (hi - lo + 1e-12) + lo
        wave = self.vocoder(mel)
        hop = self.cfg.hop_length
        wave = vocoder_output_finalize(wave[..., : n_frames * hop], n_true, hop)
        _sync(self.device)
        self.timings.update(ddpm_s=t1 - t0, vocoder_s=time.perf_counter() - t1)
        return wave

    def convert(self, wav: Union[str, np.ndarray], singer_name: str,
                generator: Optional[torch.Generator] = None) -> np.ndarray:
        """Convert one utterance to the target singer -> waveform at cfg.fs."""
        t0 = time.perf_counter()
        batch, n_frames = self.extract_features(wav, singer_name)
        _sync(self.device)
        self.timings = {"frontend_s": time.perf_counter() - t0}
        padded = batch["melody"].shape[1]
        n_true = torch.tensor([n_frames], device=self.device)
        wave = self._convert_core(batch, n_true, padded, generator)
        audio = wave[0, : n_frames * self.cfg.hop_length].cpu().numpy().copy()
        self.timings["total_s"] = time.perf_counter() - t0
        return audio
