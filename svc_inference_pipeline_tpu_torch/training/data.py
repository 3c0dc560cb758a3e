"""Training data: a corpus of clips -> bucketed feature batches.

Counterpart of ``svc_inference_pipeline_tpu/training/data.py``:

* :class:`FeatureExtractor`: the conversion front-end's features of one
  clip (normalised mel target, F0, energy, the waveform and, given a Whisper
  extractor, content), computed once and cached as npz;
* :func:`bucket_length` and :class:`BucketedLoader`: batches of one bucket
  length (cropped at random or zero-padded), shuffled by a numpy
  ``default_rng`` and prefetched by a background thread.

The mel runs on the extractor's device, the F0 on the host
(``ops/f0.py::get_f0_features``), the content through
``WhisperPPGExtractor.extract`` (K4 on the card, under ``no_grad``).
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from svc_inference_pipeline_tpu_torch.ops.f0 import get_f0_features
from svc_inference_pipeline_tpu_torch.ops.mel import extract_mel_features
from svc_inference_pipeline_tpu_torch.utils.artifacts import load_mel_min_max, normalize_mel_channel
from svc_inference_pipeline_tpu_torch.utils.audio_io import load_audio
from svc_inference_pipeline_tpu_torch.utils.devices import resolve_device
from svc_inference_pipeline_tpu_torch.utils.registry import load_singer_lut


class FeatureExtractor:
    """Clip path -> training feature dict of numpy arrays: ``mel`` [T, M]
    normalised to [-1, 1], ``melody`` [T], ``loudness`` [T], ``wave``
    [T * hop], ``content_whisper`` [T, D] with a Whisper extractor, and
    ``singer`` [1]. With ``cache_dir`` each clip's features are kept in
    ``<cache_dir>/<file name without extension>.npz`` and read back."""

    def __init__(self, cfg, whisper=None, cache_dir: Optional[str] = None, device=None):
        self.cfg = cfg
        self.whisper = whisper
        self.cache_dir = cache_dir
        self.device = resolve_device(device)
        if cache_dir:
            os.makedirs(cache_dir, exist_ok=True)

    def __call__(self, wav_path: str, singer_id: int) -> Dict[str, np.ndarray]:
        cache_path = None
        if self.cache_dir:
            key = os.path.basename(wav_path).rsplit(".", 1)[0]
            cache_path = os.path.join(self.cache_dir, f"{key}.npz")
            if os.path.exists(cache_path):
                with np.load(cache_path) as f:
                    out = {k: f[k] for k in f.files}
                out["singer"] = np.array([singer_id], dtype=np.int32)
                return out

        audio, _ = load_audio(wav_path, self.cfg.fs)
        with torch.no_grad():
            mel, energy = extract_mel_features(torch.as_tensor(audio, device=self.device), self.cfg)
        mel = mel.cpu().numpy()  # [n_mels, T]
        n_frames = mel.shape[-1]
        f0, _ = get_f0_features(np.asarray(audio), n_frames, self.cfg)
        mel_min, mel_max = load_mel_min_max(self.cfg.min_mel_file, self.cfg.max_mel_file)
        feats: Dict[str, np.ndarray] = {
            "mel": normalize_mel_channel(mel, mel_min, mel_max).T.astype(np.float32),
            "melody": f0.astype(np.float32),
            "loudness": energy.cpu().numpy().astype(np.float32),
            "wave": np.asarray(audio[: n_frames * self.cfg.hop_length], dtype=np.float32),
        }
        if self.whisper is not None:
            feats["content_whisper"] = self.whisper.extract(np.asarray(audio), n_frames).astype(np.float32)
        if cache_path:
            np.savez(cache_path, **feats)
        feats["singer"] = np.array([singer_id], dtype=np.int32)
        return feats


def bucket_length(n: int, buckets: Sequence[int]) -> int:
    """The first bucket that holds ``n`` frames, else the largest."""
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


class BucketedLoader:
    """(clip path, singer name) manifest -> shuffled, bucketed, prefetched
    batches: dicts of stacked arrays cropped or zero-padded to the bucket of
    the batch's longest clip; clips longer than the largest bucket are
    cropped at a random start. Each pass reshuffles; a last partial batch is
    dropped."""

    def __init__(self, manifest: List[Tuple[str, str]], cfg, extractor: FeatureExtractor,
                 batch_size: int = 8, buckets: Sequence[int] = (256, 512, 1024, 2048),
                 seed: int = 0, prefetch: int = 2):
        self.cfg = cfg
        self.extractor = extractor
        self.batch_size = batch_size
        self.buckets = tuple(sorted(buckets))
        self.rng = np.random.default_rng(seed)
        lut = load_singer_lut(cfg.singer_file)
        self.items = [(path, lut[name]) for path, name in manifest]
        self.prefetch = prefetch

    def _make_batch(self, idxs: Sequence[int]) -> Dict[str, np.ndarray]:
        feats = [self.extractor(*self.items[i]) for i in idxs]
        blen = bucket_length(max(f["melody"].shape[0] for f in feats), self.buckets)
        hop = self.cfg.hop_length

        def fit(x: np.ndarray, length: int) -> np.ndarray:
            if x.shape[0] > length:
                start = int(self.rng.integers(0, x.shape[0] - length + 1))
                return x[start: start + length]
            return np.pad(x, [(0, length - x.shape[0])] + [(0, 0)] * (x.ndim - 1))

        batch: Dict[str, np.ndarray] = {}
        for key in feats[0]:
            if key == "singer":
                batch[key] = np.stack([f[key] for f in feats])
            elif key == "wave":
                batch[key] = np.stack([fit(f[key], blen * hop) for f in feats])
            else:
                batch[key] = np.stack([fit(f[key], blen) for f in feats])
        return batch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        order = self.rng.permutation(len(self.items))
        batches = [order[i: i + self.batch_size]
                   for i in range(0, len(order) - self.batch_size + 1, self.batch_size)]
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        done = object()

        def producer():
            try:
                for idxs in batches:
                    q.put(self._make_batch(idxs))
            except Exception as e:  # handed to the consumer, which raises it
                q.put(e)
            q.put(done)

        threading.Thread(target=producer, daemon=True).start()
        while True:
            item = q.get()
            if item is done:
                break
            if isinstance(item, Exception):
                raise item
            yield item
