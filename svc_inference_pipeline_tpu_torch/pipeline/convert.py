"""End-to-end singing voice conversion: wav in -> converted wav out.

Counterpart of ``svc_inference_pipeline_tpu/pipeline/convert.py``:

    pipe = SVCPipeline.from_config(cfg)        # checkpoint files of cfg, on the GPU
    pipe = SVCPipeline.from_config(cfg, random_weights=True)   # seeded random weights
    wav  = pipe.convert("clip.wav", "svcc_CDF1")
    wav  = pipe.convert("clip.wav", "svcc_CDF1", sampler="plms", speedup=10)
    wavs = pipe.convert_batch(["a.wav", "b.wav"], ["svcc_CDF1", "svcc_CDM1"])
    wavs = pipe.convert_multi_singer("clip.wav", ["svcc_CDF1", "svcc_CDM1"])
    for chunk in pipe.convert_streaming("long.wav", "svcc_CDF1"): ...

Stages: load -> Praat F0 + median shift to the target singer (on a CUDA
device K9, issued first on the uploaded waveform; else a host thread
overlapping the device work) and [device: mel energy, 24->16 kHz resample,
Whisper log-mel and encoder (30 s windows), 480->256 hop remap] ->
condition encoder -> the sampler -> mel denormalisation -> BigVGAN (K2 per
stage, K3 for the last activation) -> fade-out and trim at the true length. Frame counts are padded
to a multiple of ``bucket`` frames, as in the JAX pipeline. A batch pads every
clip to the longest one's bucket, stacks their Whisper windows into one
encode and masks each clip's features past its true length; every kernel
runs once per call for the whole batch.

Samplers (``cfg.mapper.sampler``, ``plms_speedup``, or per call): "ddpm"
runs one K1 launch per reverse step; "plms", "ddim" and "dpmpp" evaluate the
denoiser through K5. ``cfg.denoiser_quantize`` "int8" or "int8-w1" runs
the denoiser's int8 form (K6) on either; ``denoiser_quantize_tail`` runs
the last K DDPM steps on the unquantised stack.

``self.timings`` holds the wall seconds of the last conversion's phases
(front-end, sampling ``ddpm_s`` whichever sampler ran it, vocoder, total),
each closed by a device synchronisation, and of its F0 (``f0_s``) and the
wait on it (``f0_wait_s``), with the clips' true and padded frames
(``frames_true``, ``frames_padded``). They are read from the call's spans
(``utils/observability.py``): ``pipeline.call``, and in it
``pipeline.load``, ``frontend.device``, ``frontend.f0_wait``,
``frontend.upload``, ``sampling``, ``vocoder`` and ``pipeline.download``.
On the host route ``frontend.f0`` is a clip on the F0 thread, ``f0_s`` the
clips' spans summed and ``f0_wait_s`` the ``frontend.f0_wait`` span; on the
device route ``frontend.f0`` is K9's issue on the driving thread (in
``frontend.device``), ``f0_s`` K9's device seconds between two CUDA events
read after the front-end's sync, and ``f0_wait_s`` 0.0: nothing waits. The
``route`` attribute of ``frontend.f0`` and the counters
``frontend/f0_clips_device`` and ``frontend/f0_clips_host`` tell the two
apart. ``sampling`` carries the denoiser's ``channels`` and ``layers`` and
the kernel launches its K1/K5 calls issued (``launches``; 0 on the composed
and GPipe routes).
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from svc_inference_pipeline_tpu_torch.checkpoints.from_jax import load_jax_params, random_init_
from svc_inference_pipeline_tpu_torch.config import HParams
from svc_inference_pipeline_tpu_torch.models.bigvgan import BigVGANGenerator, vocoder_output_finalize
from svc_inference_pipeline_tpu_torch.models.diffsvc import DiffSVCDenoiser, make_composed_denoise_fn
from svc_inference_pipeline_tpu_torch.models.encoder import ConditionEncoder
from svc_inference_pipeline_tpu_torch.models.whisper import WhisperDims
from svc_inference_pipeline_tpu_torch.ops.f0 import get_f0_features, praat_f0_device
from svc_inference_pipeline_tpu_torch.ops.mel import extract_mel_features
from svc_inference_pipeline_tpu_torch.ops.pallas.denoiser_step import QUANTIZE_MODES, denoiser_stacks, make_denoise_fn
from svc_inference_pipeline_tpu_torch.ops.remap import remap_features_device
from svc_inference_pipeline_tpu_torch.ops.resample import _out_len, _resample_conv
from svc_inference_pipeline_tpu_torch.ops.whisper_mel import N_SAMPLES, log_mel_spectrogram
from svc_inference_pipeline_tpu_torch.parallel.mesh import (
    DATA_AXIS, MODEL_AXIS, PIPE_AXIS, axis_group, axis_rank, axis_size, mesh_over)
from svc_inference_pipeline_tpu_torch.parallel.pp import make_pp_denoise_fn
from svc_inference_pipeline_tpu_torch.parallel.sharding import (
    MAPPER_TP_RULES, WHISPER_TP_RULES, all_gather_dim, batch_shard, fold_generator, shard_params)
from svc_inference_pipeline_tpu_torch.parallel.sp_whisper import encode_sequence_parallel
from svc_inference_pipeline_tpu_torch.parallel.tp_vocoder import chunked_vocoder_apply, vocoder_receptive_radius
from svc_inference_pipeline_tpu_torch.pipeline.content import WhisperPPGExtractor
from svc_inference_pipeline_tpu_torch.sampling.ddim import ddim_sample
from svc_inference_pipeline_tpu_torch.sampling.ddpm import ddpm_sample
from svc_inference_pipeline_tpu_torch.sampling.dpmpp import dpmpp_sample
from svc_inference_pipeline_tpu_torch.sampling.plms import plms_sample
from svc_inference_pipeline_tpu_torch.sampling.schedule import DiffusionSchedule
from svc_inference_pipeline_tpu_torch.utils.artifacts import load_mel_min_max, pitch_shift
from svc_inference_pipeline_tpu_torch.utils.audio_io import load_audio, save_audio
from svc_inference_pipeline_tpu_torch.utils.devices import resolve_device
from svc_inference_pipeline_tpu_torch.utils.observability import Metrics, current_span, get_logger, trace
from svc_inference_pipeline_tpu_torch.utils.registry import get_singer_id

DEFAULT_BUCKET = 64  # frame-count padding granularity


def pad_to_bucket(n: int, bucket: int = DEFAULT_BUCKET) -> int:
    return ((n + bucket - 1) // bucket) * bucket


def mel_frame_count(cfg: HParams, n_samples: int) -> int:
    """Frame count of the mel front-end for ``n_samples`` samples, analytically."""
    padded_len = n_samples + 2 * int((cfg.n_fft - cfg.hop_length) / 2)
    return 1 + (padded_len - cfg.n_fft) // cfg.hop_length


def compute_dtype(cfg: HParams) -> torch.dtype:
    """The config's compute dtype (``compute_dtype``, default bfloat16)."""
    return torch.bfloat16 if cfg.get("compute_dtype", "bfloat16") == "bfloat16" else torch.float32


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class SVCPipeline:
    """Holds the models on one device and runs conversions. The kernels'
    copies of the weights are made when it is built (see
    :meth:`refresh_kernel_params`). With ``mesh`` it is one rank's part of a
    multi-device pipeline (:meth:`_setup_mesh`). ``last_mel`` holds the
    denormalised mel [B, T, M] of this rank's last conversion."""

    def __init__(self, cfg: HParams, cond_encoder: ConditionEncoder, denoiser: DiffSVCDenoiser,
                 vocoder: BigVGANGenerator, whisper: WhisperPPGExtractor,
                 device: Union[str, torch.device], bucket: int = DEFAULT_BUCKET, mesh=None):
        if int(bucket) < 1:
            raise ValueError(f"bucket must be >= 1 frame, got {bucket}")
        self.cfg = cfg
        self.bucket = int(bucket)
        self.device = torch.device(device)
        self.compute_dtype = cd = compute_dtype(cfg)
        self._setup_mesh(mesh, whisper)
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
        if self.tp:
            shard_params(self.cond_encoder, self.mesh, MAPPER_TP_RULES, self._model_axis)
            shard_params(self.denoiser, self.mesh, MAPPER_TP_RULES, self._model_axis)
            if not self._sp:  # SP keeps Whisper whole and shards its frames instead
                whisper.shard(self.mesh, WHISPER_TP_RULES, self._model_axis)
        self.schedule = DiffusionSchedule.from_config(cfg.mapper)
        mel_min, mel_max = load_mel_min_max(cfg.min_mel_file, cfg.max_mel_file)
        self._mel_min = torch.as_tensor(mel_min, device=self.device)
        self._mel_max = torch.as_tensor(mel_max, device=self.device)
        self.timings: Dict[str, float] = {}
        self._f0_events = None  # K9's CUDA events, read in _frontend_done
        self.sampler = cfg.mapper.get("sampler", "ddpm")
        self.plms_speedup = int(cfg.mapper.get("plms_speedup", 10))
        self.set_quantize(cfg.get("denoiser_quantize", None), int(cfg.get("denoiser_quantize_tail", 0)))

    def _setup_mesh(self, mesh, whisper: WhisperPPGExtractor) -> None:
        """The multi-device routes of ``cfg.parallel`` over ``mesh`` (one rank
        a device, ``parallel/mesh.py``), checked in JAX's order:
        ``pipeline_stages`` > 1 splits the denoiser into GPipe stages over a
        ``pipe`` axis of that size (from the first S ranks when no mesh is
        given); ``sequence_parallel`` shards the Whisper encoder's frames
        over a model axis of at least 2; a model axis > 1 is tensor
        parallelism (the mapper and Whisper sharded, the vocoder
        time-chunked over it); a data axis > 1 splits batches."""
        cfg = self.cfg
        par = cfg.parallel if "parallel" in cfg else HParams()
        self._model_axis = par.get("model_axis", MODEL_AXIS)
        self._data_axis = par.get("data_axis", DATA_AXIS)
        self._pp_axis = par.get("pipe_axis", PIPE_AXIS)
        self._pp_stages = int(par.get("pipeline_stages", 1))
        self._pp_microbatch = int(par.get("pp_microbatch", 0))
        self._sp = bool(par.get("sequence_parallel", False))
        if self._pp_stages > 1:
            if cfg.mapper.residual_layer_num % self._pp_stages:
                raise ValueError(f"pipeline_stages={self._pp_stages} must divide "
                                 f"residual_layer_num={cfg.mapper.residual_layer_num}")
            if mesh is None:
                world = dist.get_world_size() if dist.is_initialized() else 1
                if world < self._pp_stages:
                    raise ValueError(f"pipeline_stages={self._pp_stages} needs at least that many "
                                     f"devices; found {world}")
                mesh = mesh_over(range(self._pp_stages), (self._pp_stages,), (self._pp_axis,))
            elif axis_size(mesh, self._pp_axis) != self._pp_stages or self._pp_axis not in mesh.mesh_dim_names:
                raise ValueError(f"pipeline_stages={self._pp_stages} needs a '{self._pp_axis}' mesh axis "
                                 f"of that size; got {mesh}")
        if self._sp:
            sp_size = axis_size(mesh, self._model_axis)
            if sp_size < 2:
                raise ValueError(f"sequence_parallel needs a mesh with a >1 '{self._model_axis}' axis")
            if whisper.dims.n_audio_ctx % sp_size:
                raise ValueError(f"whisper n_audio_ctx={whisper.dims.n_audio_ctx} must divide by the "
                                 f"{sp_size}-way sequence shard")
        self.mesh = mesh
        self.tp = axis_size(mesh, self._model_axis) > 1
        self._tp_group = axis_group(mesh, self._model_axis) if self.tp else None
        self._dp_size = axis_size(mesh, self._data_axis)
        # the kernel denoiser (K1/K5/K6) runs on one device, and on each data
        # rank of a data-only mesh; TP and PP run their own denoisers
        self._kernel_denoiser = not self.tp and self._pp_stages == 1
        if self.tp:
            self._voc_chunks = axis_size(mesh, self._model_axis)
            self._voc_halo = int(cfg.vocoder.get("tp_halo_frames", vocoder_receptive_radius(cfg.vocoder)))
        else:
            self._voc_chunks, self._voc_halo = 1, 0
        self._logged_composed = False

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
                    seed: int = 0, device: Optional[str] = None,
                    bucket: int = DEFAULT_BUCKET, mesh=None) -> "SVCPipeline":
        """Build from the config's checkpoint files, as the JAX pipeline does:
        ``cfg.whisper_model`` (a ``.pt`` path, or a registry name resolved
        through ``checkpoints/fetch.py``), ``cfg.svc_model_path`` and
        ``cfg.vocoder_model_path``. A mapper or vocoder file that does not
        exist is replaced by random weights, as in the JAX package, with a
        warning on the ``svc_tpu.pipeline`` logger that names the path. A
        registry name that is neither cached nor downloadable raises
        ``FileNotFoundError`` unless ``cfg.allow_random_whisper`` or
        ``SVC_ALLOW_RANDOM_WHISPER=1`` opts into random Whisper weights at the
        configured size. ``random_weights=True`` draws every model from one
        ``torch.Generator`` seeded with ``seed`` (Whisper at
        ``whisper_size``). ``mesh``: the multi-device routes (see
        :meth:`_setup_mesh`); every rank builds the same weights and keeps
        its shards."""
        import os

        dev = resolve_device(device or cfg.get("device"))
        cd = compute_dtype(cfg)
        g = torch.Generator(device=dev).manual_seed(seed)
        whisper_ref = str(cfg.whisper_model)
        if not random_weights and not os.path.exists(whisper_ref):
            from svc_inference_pipeline_tpu_torch.checkpoints.fetch import WHISPER_URLS, fetch_whisper_checkpoint

            if whisper_ref in WHISPER_URLS:
                try:
                    whisper_ref = fetch_whisper_checkpoint(whisper_ref)
                except FileNotFoundError as e:
                    allow = bool(cfg.get("allow_random_whisper", False)) or (
                        os.environ.get("SVC_ALLOW_RANDOM_WHISPER", "") == "1")
                    if not allow:
                        raise FileNotFoundError(
                            f"whisper checkpoint {whisper_ref!r} unavailable ({e}); set "
                            "SVC_ALLOW_DOWNLOAD=1 to fetch it, point cfg.whisper_model at a "
                            "local .pt, or opt into random weights for smoke runs with "
                            "cfg.allow_random_whisper / SVC_ALLOW_RANDOM_WHISPER=1"
                        ) from e
                    get_logger("svc_tpu.pipeline").warning(
                        "whisper checkpoint unavailable — falling back to RANDOM weights at the "
                        "configured size (%s)", e)
                    whisper_size = str(cfg.whisper_model)
        if not random_weights and os.path.exists(whisper_ref):
            whisper = WhisperPPGExtractor.from_torch_checkpoint(whisper_ref, dev, cd, fs=cfg.fs)
        else:
            whisper = WhisperPPGExtractor.random_init(whisper_size, g, dev, cd, fs=cfg.fs)
            # a non-medium random whisper emits another feature width: adapt
            # the content-encoder input to it
            cfg = cls._adapt_content_width(cfg, whisper.dims.n_audio_state)
        with torch.device(dev):
            models = cls._models(cfg, cd)

        def missing(what: str, path) -> None:
            get_logger("svc_tpu.pipeline").warning(
                "%s checkpoint %s not found — falling back to RANDOM weights", what, path)

        if not random_weights and os.path.exists(str(cfg.svc_model_path)):
            from svc_inference_pipeline_tpu_torch.checkpoints.torch_convert import load_mapper_params

            for m, p in zip(models[:2], load_mapper_params(cfg.svc_model_path, cfg.mapper)):
                load_jax_params(m, p)
        else:
            if not random_weights:
                missing("mapper", cfg.svc_model_path)
            for m in models[:2]:
                random_init_(m, g)
        if not random_weights and os.path.exists(str(cfg.vocoder_model_path)):
            from svc_inference_pipeline_tpu_torch.checkpoints.torch_convert import load_vocoder_params

            load_jax_params(models[2], load_vocoder_params(cfg.vocoder_model_path, cfg.vocoder))
        else:
            if not random_weights:
                missing("vocoder", cfg.vocoder_model_path)
            random_init_(models[2], g)
        return cls(cfg, *models, whisper, dev, bucket, mesh)

    @classmethod
    def from_jax_params(cls, cfg: HParams, cond_params, den_params, voc_params,
                        whisper_dims: WhisperDims, whisper_params, device=None,
                        bucket: int = DEFAULT_BUCKET, mesh=None) -> "SVCPipeline":
        """Build from JAX parameter trees (numpy), through the weights bridge,
        on ``device`` (None: the GPU, see ``resolve_device``)."""
        device = resolve_device(device)
        cd = compute_dtype(cfg)
        whisper = WhisperPPGExtractor.from_jax_params(whisper_dims, whisper_params, device, cd, cfg.fs)
        cfg = cls._adapt_content_width(cfg, whisper_dims.n_audio_state)
        cond, den, voc = cls._models(cfg, cd)
        for m, p in ((cond, cond_params), (den, den_params), (voc, voc_params)):
            load_jax_params(m, p)
        return cls(cfg, cond, den, voc, whisper, device, bucket, mesh)

    # ------------------------------------------------------------------
    # Front-end
    # ------------------------------------------------------------------

    def mel_frame_count(self, n_samples: int) -> int:
        """Frame count of the mel front-end for ``n_samples`` samples."""
        return mel_frame_count(self.cfg, n_samples)

    def _frame_counts(self, n_samples: int) -> Tuple[int, int]:
        """(true frame count, Whisper 30 s windows) of a clip: the content is
        encoded window by window, and frames past the windows' span are cut."""
        len16 = _out_len(n_samples, 2, 3)  # 24 kHz -> 16 kHz length
        n_windows = max(1, -(-len16 // N_SAMPLES))
        return min(self.mel_frame_count(n_samples), n_windows * 1500 * 15 // 8), n_windows

    def _load(self, wav: Union[str, np.ndarray]) -> np.ndarray:
        return load_audio(wav, self.cfg.fs)[0] if isinstance(wav, str) else np.asarray(wav, np.float32)

    def _whisper_encode(self, wmel: torch.Tensor) -> torch.Tensor:
        """The encoder (K4; its TP form on a model axis), or with
        ``sequence_parallel`` its frames sharded over the model axis."""
        if self._sp:
            return encode_sequence_parallel(self.whisper.encoder, wmel, self.mesh, self._model_axis,
                                            self.whisper.encoder.conv1.weight.dtype)
        return self.whisper.embed_audio(wmel)

    @torch.no_grad()
    def _frontend_device(self, audio24: torch.Tensor, n_windows: int, n_frames: int,
                         padded: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Mel energy + resample + Whisper log-mel + encoder (30 s windows)
        + hop remap + bucket padding, on the device."""
        _, energy = extract_mel_features(audio24, self.cfg)
        audio16 = _resample_conv(audio24, self.cfg.fs, 16000, "kaiser_best")
        audio16 = F.pad(audio16, (0, n_windows * N_SAMPLES - audio16.shape[-1]))
        wmel = log_mel_spectrogram(audio16.reshape(n_windows, N_SAMPLES))
        feats = self._whisper_encode(wmel)
        feats = feats.reshape(-1, feats.shape[-1])
        content = remap_features_device(feats.float(), n_frames)
        energy = F.pad(energy[:n_frames], (0, padded - n_frames))
        content = F.pad(content, (0, 0, 0, padded - n_frames))
        return energy[None], content[None]

    @torch.no_grad()
    def _frontend_device_batch(self, audios24: torch.Tensor, n_true: torch.Tensor, n_windows: int,
                               padded: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Batched device front-end of B zero-padded clips [B, L]: their
        Whisper windows stack into one [B * W, 80, 3000] encode; features past
        each clip's true length (``n_true`` [B]) are 0. Loudness of a shorter
        clip's last frames sees the batch's zero padding instead of its
        reflect padding, as in the JAX batch."""
        b = audios24.shape[0]
        _, energy = extract_mel_features(audios24, self.cfg)  # [B, T]
        audio16 = _resample_conv(audios24, self.cfg.fs, 16000, "kaiser_best")
        audio16 = F.pad(audio16, (0, n_windows * N_SAMPLES - audio16.shape[-1]))
        wmel = log_mel_spectrogram(audio16.reshape(b * n_windows, N_SAMPLES))
        feats = self._whisper_encode(wmel)
        content = remap_features_device(feats.reshape(b, -1, feats.shape[-1]).float(), padded)
        mask = torch.arange(padded, device=audios24.device)[None, :] < n_true[:, None]
        energy = F.pad(energy[:, :padded], (0, max(0, padded - energy.shape[-1])))
        return torch.where(mask, energy, 0.0), torch.where(mask[..., None], content, 0.0)

    def _features(self, audios: Sequence[np.ndarray], frame_counts: Sequence[int], padded: int, upload,
                  frontend, pitch_factor: Optional[float] = None):
        """(melody [B, padded], energy, content) of the clips ``audios``:
        ``frontend(upload())`` is the device front-end on the uploaded
        waveform, and F0 with the median shift (or ``pitch_factor``) runs on
        a CUDA pipeline as K9 (``ops/f0.py::praat_f0_device``) on that
        waveform [B, L], issued first; elsewhere as numpy, clip by clip, on
        a thread overlapping the device front-end. Sets
        ``timings``' ``f0_s`` (on the device route in :meth:`_frontend_done`,
        from the CUDA events kept in ``_f0_events``, which the host route
        clears) and ``f0_wait_s``."""
        cfg, metrics = self.cfg, Metrics.default()
        if self.device.type == "cuda":
            metrics.incr("frontend/f0_clips_device", len(audios))
            with trace("frontend.device"):
                wave = upload()
                with trace("frontend.f0", samples=sum(len(a) for a in audios), frames=sum(frame_counts),
                           route="device"):
                    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                    start.record()
                    melody = praat_f0_device(wave.reshape(len(audios), -1), [len(a) for a in audios], frame_counts,
                                             padded, cfg, pitch_factor)
                    end.record()
                energy, content = frontend(wave)
            self._f0_events = (start, end)
            self.timings["f0_wait_s"] = 0.0
            return melody, energy, content
        metrics.incr("frontend/f0_clips_host", len(audios))
        self._f0_events = None
        caller = current_span()

        def f0_job():
            f0s, f0_s = np.zeros((len(audios), padded), np.float32), 0.0
            for i, (a, n) in enumerate(zip(audios, frame_counts)):
                with trace("frontend.f0", parent=caller, samples=len(a), frames=n, route="host") as span:
                    f0, _ = get_f0_features(a, n, cfg)
                    f0s[i, :n] = (f0 * pitch_factor if pitch_factor is not None else pitch_shift(f0, cfg))[:n]
                f0_s += span.seconds
            return f0s, f0_s

        with ThreadPoolExecutor(max_workers=1) as pool:
            f0_future = pool.submit(f0_job)
            with trace("frontend.device"):
                energy, content = frontend(upload())
            with trace("frontend.f0_wait") as wait:
                melody, f0_s = f0_future.result()
        self.timings.update(f0_s=f0_s, f0_wait_s=wait.seconds)
        return melody, energy, content

    def extract_features(self, wav: Union[str, np.ndarray], singer_name: str,
                         upload_pcm16: bool = False, pitch_factor: Optional[float] = None):
        """(batch dict padded to the bucket, true frame count). On a CUDA
        device F0 runs as K9 on the uploaded waveform before the device
        front-end; else on a host thread while the device computes the
        Whisper chain (:meth:`_features`). ``upload_pcm16`` sends the
        waveform to the device as int16, scaled back by 1/32768 there (K9
        reads that signal, the host thread the float one); ``pitch_factor``
        replaces the median pitch shift with a fixed multiplier (streaming
        pins it per stream)."""
        cfg = self.cfg
        audio = self._load(wav)
        singer = get_singer_id(cfg, singer_name)
        n_frames, n_windows = self._frame_counts(len(audio))
        padded = pad_to_bucket(n_frames, self.bucket)

        def upload():
            if upload_pcm16 and audio.dtype == np.float32:
                pcm = np.clip(np.round(audio * 32768.0), -32768, 32767).astype(np.int16)
                return torch.as_tensor(pcm, device=self.device).float() * (1.0 / 32768.0)
            return torch.as_tensor(audio, device=self.device)

        melody, energy, content = self._features(
            [audio], [n_frames], padded, upload, lambda wave: self._frontend_device(wave, n_windows, n_frames, padded),
            pitch_factor)
        with trace("frontend.upload"):
            batch = {
                "content_whisper": content,
                "melody": torch.as_tensor(melody, device=self.device),
                "loudness": energy,
                "singer": torch.as_tensor(singer[None].astype(np.int64), device=self.device),
            }
        return batch, n_frames

    def extract_features_batch(self, wavs: Sequence[Union[str, np.ndarray]],
                               singer_names: Sequence[str]) -> Tuple[Dict[str, torch.Tensor], List[int]]:
        """Batched front-end: (batch dict [B, padded, ...], true frame
        counts). One device pass for the whole batch; F0 as K9 for the whole
        batch on a CUDA device, else clip by clip on a host thread overlapped
        with the device pass (:meth:`_features`)."""
        cfg = self.cfg
        if len(wavs) != len(singer_names) or not wavs:
            raise ValueError(f"need one singer per clip and at least one clip: {len(wavs)} clips, "
                             f"{len(singer_names)} singers")
        singer_ids = np.concatenate([get_singer_id(cfg, s) for s in singer_names]).astype(np.int64)[:, None]
        audios = [self._load(w) for w in wavs]
        frame_counts, window_counts = zip(*(self._frame_counts(len(a)) for a in audios))
        frame_counts = list(frame_counts)
        padded = pad_to_bucket(max(frame_counts), self.bucket)
        # enough windows that the remap's source span covers `padded`
        n_windows = max(max(window_counts), -(-(padded * 8 // 15 + 1) // 1500))

        def upload():
            block = np.zeros((len(audios), max(len(a) for a in audios)), np.float32)
            for i, a in enumerate(audios):
                block[i, : len(a)] = a
            return torch.as_tensor(block, device=self.device)

        def frontend(block):
            return self._frontend_device_batch(block, torch.tensor(frame_counts, device=self.device), n_windows,
                                               padded)

        melody, energy, content = self._features(audios, frame_counts, padded, upload, frontend)
        with trace("frontend.upload"):
            batch = {
                "content_whisper": content,
                "melody": torch.as_tensor(melody, device=self.device),
                "loudness": energy,
                "singer": torch.as_tensor(singer_ids, device=self.device),
            }
        return batch, frame_counts

    # ------------------------------------------------------------------
    # Core: cond encode -> sampler -> denorm -> vocode -> finalize
    # ------------------------------------------------------------------

    SAMPLERS = ("ddpm", "plms", "ddim", "dpmpp")

    def _resolve_sampler(self, sampler: Optional[str], speedup: Optional[int]) -> Tuple[str, int]:
        """Validated (sampler, speedup) with the pipeline defaults; ddpm pins
        the stride to 1 (it has none)."""
        sampler = sampler or self.sampler
        if sampler not in self.SAMPLERS:
            raise ValueError(f"unknown sampler {sampler!r} (choose from {self.SAMPLERS})")
        speedup = int(speedup) if speedup is not None else self.plms_speedup
        if speedup < 1:
            raise ValueError(f"speedup must be >= 1, got {speedup}")
        if sampler == "ddpm":
            speedup = 1
        return sampler, speedup

    def set_sampler(self, sampler: str, speedup: Optional[int] = None) -> None:
        """Switch the default sampler ("ddpm" | "plms" | "ddim" | "dpmpp")."""
        if sampler not in self.SAMPLERS:
            raise ValueError(f"unknown sampler {sampler!r} (choose from {self.SAMPLERS})")
        if speedup is not None and int(speedup) < 1:
            raise ValueError(f"speedup must be >= 1, got {speedup}")
        self.sampler = sampler
        if speedup is not None:
            self.plms_speedup = int(speedup)

    def refresh_kernel_params(self) -> None:
        """Make the kernels' copies of the weights anew from the modules as
        they are now: the vocoder's kernel form (K2, K7) and the denoiser's
        stacks (K1, K5, K6). The pipeline makes them once, when it is built;
        they do not follow a later change of the weights' values. After
        changing the weights in place (loading, training), call this."""
        self.vocoder.prepare_kernel_params()
        self.set_quantize(self.denoiser_quantize, self.denoiser_quantize_tail)

    def set_quantize(self, quantize: Optional[str], tail: int = 0) -> None:
        """Switch the denoiser's int8 mode: None, "int8" (conv and output
        matmuls) or "int8-w1" (conv only); ``tail`` runs the last K DDPM
        steps on the unquantised stack. Takes effect at the next conversion.
        The kernels' weight stacks are made here, from the denoiser's
        weights as they are now."""
        if quantize not in QUANTIZE_MODES:
            raise ValueError(f"denoiser_quantize={quantize!r}: use 'int8', "
                             "'int8-w1' (output projection stays at compute dtype) or unset")
        if quantize and not self._kernel_denoiser:
            # TP and PP run the composed and GPipe denoisers at the compute
            # dtype: an int8 mode would be silently ignored
            raise ValueError(
                "denoiser_quantize is set but the selected denoiser path cannot honor it: TP "
                "(model-axis) meshes and pipeline_stages>1 use the composed/GPipe denoisers. Unset "
                "denoiser_quantize, or run single-device / data-only-mesh.")
        self.denoiser_quantize = quantize
        self.denoiser_quantize_tail = tail = int(tail)
        self._stacks = None
        if self._kernel_denoiser:
            with torch.no_grad():
                self._stacks = denoiser_stacks(self.denoiser, self.compute_dtype, quantize, tail)

    def _denoise_fn(self, cond: torch.Tensor, composed: bool = False):
        """The sampler's denoiser: the GPipe stages with ``pipeline_stages``
        > 1, the composed layers (no kernel, compute dtype) under TP or for a
        batch that does not divide by the data axis, else K1/K5/K6."""
        steps = self.schedule.num_steps
        if self._pp_stages > 1:
            return make_pp_denoise_fn(self.denoiser, cond, steps, self.cfg.mapper, self.mesh, self._pp_axis,
                                      self._pp_microbatch or None)
        if composed or self.tp:
            return make_composed_denoise_fn(self.denoiser, cond, steps, self.compute_dtype, self._tp_group)
        return make_denoise_fn(self.denoiser, cond, steps, self.compute_dtype, self.denoiser_quantize,
                               self.denoiser_quantize_tail, self._stacks)

    def _run_sampler(self, denoise_fn, cond, shape, sampler, speedup, generator, noise):
        if sampler == "plms":
            return plms_sample(denoise_fn, cond, shape, self.schedule, speedup, generator, noise)
        if sampler == "ddim":
            return ddim_sample(denoise_fn, cond, shape, self.schedule, speedup,
                               generator=generator, noise=noise)
        if sampler == "dpmpp":
            return dpmpp_sample(denoise_fn, cond, shape, self.schedule, speedup,
                                generator=generator, noise=noise)
        fused = getattr(denoise_fn, "fused_ddpm", None)
        if fused is not None:
            return fused(self.schedule, shape, generator, noise)
        return ddpm_sample(denoise_fn, cond, shape, self.schedule, generator, noise)

    def _data_split(self, b: int) -> bool:
        """Whether a batch of ``b`` clips splits over the data axis."""
        return self._dp_size > 1 and b % self._dp_size == 0

    def rank_generator(self, generator: Optional[torch.Generator]) -> torch.Generator:
        """This data rank's generator: the caller's seed folded with the rank."""
        return fold_generator(generator, axis_rank(self.mesh, self._data_axis), self.device)

    @torch.no_grad()
    def _convert_core(self, batch: Dict[str, torch.Tensor], n_true: torch.Tensor, n_frames: int,
                      generator: Optional[torch.Generator] = None, noise=None,
                      sampler: Optional[str] = None, speedup: Optional[int] = None,
                      pcm16: bool = False) -> torch.Tensor:
        """Waveform [B, n_frames * hop] of a padded feature batch: f32, or
        with ``pcm16`` peak-normalised int16 finalised on the device.
        ``noise`` injects the sampler's draws: (x_T, z [steps, B, T, M]) for
        DDPM and DDIM, x_T for PLMS and DPM++ (x_T scaled by INIT_NOISE_STD).

        On a data axis a batch that divides by it is split: each data rank
        converts its slice with :meth:`rank_generator` (or its slice of
        ``noise``), and the waves are gathered to every rank. One that does
        not divide runs whole on every rank through the composed denoiser
        at the compute dtype, as JAX routes it."""
        b = batch["melody"].shape[0]
        if self._data_split(b):
            local = {k: batch_shard(v, self.mesh, self._data_axis) for k, v in batch.items()}
            if noise is not None:
                noise = (batch_shard(noise, self.mesh, self._data_axis) if torch.is_tensor(noise) else
                         (batch_shard(noise[0], self.mesh, self._data_axis),
                          batch_shard(noise[1].transpose(0, 1), self.mesh, self._data_axis).transpose(0, 1)))
            wave = self._core(local, batch_shard(n_true, self.mesh, self._data_axis), n_frames,
                              self.rank_generator(generator), noise, sampler, speedup, pcm16)
            return all_gather_dim(wave, 0, axis_group(self.mesh, self._data_axis))
        composed = self._dp_size > 1 and self._kernel_denoiser
        if composed and not self._logged_composed:
            get_logger("svc_tpu.pipeline").info(
                "batch of %d does not divide by the %d-way data axis: the whole batch runs on every "
                "rank through the composed denoiser at the compute dtype", b, self._dp_size)
            self._logged_composed = True
        return self._core(batch, n_true, n_frames, generator, noise, sampler, speedup, pcm16, composed)

    @torch.no_grad()
    def _core(self, batch, n_true, n_frames, generator, noise, sampler, speedup, pcm16,
              composed: bool = False) -> torch.Tensor:
        """This rank's conversion of a padded feature batch (see
        :meth:`_convert_core`)."""
        sampler, speedup = self._resolve_sampler(sampler, speedup)
        mcfg = self.cfg.mapper
        counters = Metrics.default().counters
        with trace("sampling", channels=mcfg.residual_channels, layers=mcfg.residual_layer_num) as sampling:
            launched = counters["denoiser/launches"]
            cond = self.cond_encoder(batch, self._tp_group)
            shape = (cond.shape[0], n_frames, self.cfg.mapper.n_mel)
            denoise_fn = self._denoise_fn(cond, composed)
            mel_norm = self._run_sampler(denoise_fn, cond, shape, sampler, speedup, generator, noise)
            _sync(self.device)
            # the K1/K5 launches of this call: the device lock keeps other calls' out
            sampling.attrs["launches"] = int(counters["denoiser/launches"] - launched)
        with trace("vocoder") as vocoding:
            lo, hi = self._mel_min, self._mel_max
            mel = (mel_norm + 1.0) / 2.0 * (hi - lo + 1e-12) + lo
            self.last_mel = mel
            if self._voc_chunks > 1:
                # TP: overlap-save time chunks over the model axis, K2/K3 on every rank
                wave = chunked_vocoder_apply(self.vocoder, mel, self._voc_chunks, self._voc_halo,
                                             self.cfg.hop_length, self.mesh, self._model_axis)
            else:
                wave = self.vocoder(mel)
            hop = self.cfg.hop_length
            wave = vocoder_output_finalize(wave[..., : n_frames * hop], n_true, hop, pcm16=pcm16)
            _sync(self.device)
        self.timings.update(ddpm_s=sampling.seconds, vocoder_s=vocoding.seconds)
        return wave

    def convert(self, wav: Union[str, np.ndarray], singer_name: str,
                generator: Optional[torch.Generator] = None, sampler: Optional[str] = None,
                speedup: Optional[int] = None, output_path: Optional[str] = None, pcm16: bool = False,
                upload_pcm16: bool = False, pitch_factor: Optional[float] = None) -> np.ndarray:
        """Convert one utterance to the target singer -> waveform at cfg.fs.
        ``sampler``/``speedup`` override the pipeline defaults for this call.
        ``pcm16`` finalises on the device (peak 0.9, int16) and returns int16;
        ``upload_pcm16`` and ``pitch_factor`` as in :meth:`extract_features`;
        ``output_path`` also writes the WAV."""
        sampler, speedup = self._resolve_sampler(sampler, speedup)
        with trace("pipeline.call", clips=1) as call:
            self.timings = {}
            (audio,) = self._load_clips(call, [wav])
            batch, n_frames = self.extract_features(audio, singer_name, upload_pcm16, pitch_factor)
            padded = batch["melody"].shape[1]
            self._frontend_done(call, n_frames, padded)
            n_true = torch.tensor([n_frames], device=self.device)
            wave = self._convert_core(batch, n_true, padded, generator, sampler=sampler, speedup=speedup,
                                      pcm16=pcm16)
            with trace("pipeline.download"):
                audio = wave[0, : n_frames * self.cfg.hop_length].cpu().numpy().copy()
                self._total_done(call)
        if output_path is not None:
            save_audio(output_path, audio, self.cfg.fs, turn_up=not pcm16)
        return audio

    def convert_batch(self, wavs: Sequence[Union[str, np.ndarray]], singer_names: Sequence[str],
                      generator: Optional[torch.Generator] = None, sampler: Optional[str] = None,
                      speedup: Optional[int] = None) -> List[np.ndarray]:
        """Convert several utterances (each to its own singer) in one device
        batch padded to the longest one's bucket -> one waveform per clip,
        each of its own true length. ``sampler``/``speedup`` as in
        :meth:`convert`."""
        sampler, speedup = self._resolve_sampler(sampler, speedup)
        with trace("pipeline.call", clips=len(wavs)) as call:
            self.timings = {}
            split = self._data_split(len(wavs))
            if split:  # this data rank converts its slice, as one device would
                mine = np.array_split(np.arange(len(wavs)), self._dp_size)[axis_rank(self.mesh, self._data_axis)]
                wavs, singer_names = [wavs[i] for i in mine], [singer_names[i] for i in mine]
            batch, frame_counts = self.extract_features_batch(self._load_clips(call, wavs), singer_names)
            padded = batch["melody"].shape[1]
            self._frontend_done(call, sum(frame_counts), len(frame_counts) * padded)
            n_true = torch.tensor(frame_counts, device=self.device)
            if split:
                waves = self._core(batch, n_true, padded, self.rank_generator(generator), None, sampler, speedup,
                                   False)
                waves, n_true = self._gather_waves(waves, n_true)
                frame_counts = n_true.tolist()
            else:
                waves = self._convert_core(batch, n_true, padded, generator, sampler=sampler, speedup=speedup)
            with trace("pipeline.download"):
                waves = waves.cpu().numpy()
                self._total_done(call)
                return [waves[i, : n * self.cfg.hop_length].copy() for i, n in enumerate(frame_counts)]

    def _load_clips(self, call, wavs) -> List[np.ndarray]:
        """The call's clips as float waveforms at cfg.fs (``pipeline.load``);
        their samples go on the call's span."""
        with trace("pipeline.load", clips=len(wavs)):
            audios = [self._load(w) for w in wavs]
        call.attrs["samples"] = sum(len(a) for a in audios)
        return audios

    def _frontend_done(self, call, frames_true: int, frames_padded: int) -> None:
        """Wait for the front-end; ``frontend_s`` runs from the call's entry
        to here. Counts the frames the core will compute, true and padded."""
        _sync(self.device)
        self.timings.update(frontend_s=(time.perf_counter_ns() - call.start_ns) / 1e9,
                            frames_true=int(frames_true), frames_padded=int(frames_padded))
        if self._f0_events is not None:  # K9's device seconds, done by the sync above
            start, end = self._f0_events
            self._f0_events = None
            self.timings["f0_s"] = start.elapsed_time(end) / 1e3
        metrics = Metrics.default()
        metrics.incr("pipeline/frames_true", frames_true)
        metrics.incr("pipeline/frames_padded", frames_padded)

    def _total_done(self, call) -> None:
        self.timings["total_s"] = (time.perf_counter_ns() - call.start_ns) / 1e9

    def _gather_waves(self, waves: torch.Tensor, n_true: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """The data ranks' waves [b, n] (n may differ by rank) and true frame
        counts, gathered in rank order to every rank."""
        group = axis_group(self.mesh, self._data_axis)
        longest = torch.tensor([waves.shape[1]], device=waves.device)
        dist.all_reduce(longest, op=dist.ReduceOp.MAX, group=group)
        waves = F.pad(waves, (0, int(longest) - waves.shape[1]))
        return all_gather_dim(waves, 0, group), all_gather_dim(n_true, 0, group)

    def convert_multi_singer(self, wav: Union[str, np.ndarray], singer_names: Sequence[str],
                             generator: Optional[torch.Generator] = None) -> List[np.ndarray]:
        """One utterance -> one waveform per target singer: the features are
        extracted once and tiled over the singers into one batch (the
        pipeline's default sampler)."""
        b = len(singer_names)
        with trace("pipeline.call", clips=b) as call:
            self.timings = {}
            ids = np.concatenate([get_singer_id(self.cfg, s) for s in singer_names]).astype(np.int64)[:, None]
            (audio,) = self._load_clips(call, [wav])
            batch, n_frames = self.extract_features(audio, singer_names[0])
            padded = batch["melody"].shape[1]
            self._frontend_done(call, b * n_frames, b * padded)
            tiled = {k: v.expand(b, *v.shape[1:]).contiguous() for k, v in batch.items()}
            tiled["singer"] = torch.as_tensor(ids, device=self.device)
            n_true = torch.full((b,), n_frames, device=self.device)
            waves = self._convert_core(tiled, n_true, padded, generator)
            with trace("pipeline.download"):
                waves = waves.cpu().numpy()
                self._total_done(call)
                return [waves[i, : n_frames * self.cfg.hop_length].copy() for i in range(b)]

    def convert_streaming(self, wav: Union[str, np.ndarray], singer_name: str, chunk_seconds: float = 10.0,
                          context_seconds: float = 1.0, generator: Optional[torch.Generator] = None,
                          upload_pcm16: bool = False, sampler: Optional[str] = None,
                          speedup: Optional[int] = None):
        """Generator of converted chunks (``pipeline/streaming.py``): bounded
        time to first audio and O(chunk) memory for any input length, equal-
        power crossfades at the seams, every chunk padded to one bucket."""
        from svc_inference_pipeline_tpu_torch.pipeline.streaming import stream_convert

        return stream_convert(self, wav, singer_name, chunk_seconds=chunk_seconds,
                              context_seconds=context_seconds, generator=generator,
                              upload_pcm16=upload_pcm16, sampler=sampler, speedup=speedup)
