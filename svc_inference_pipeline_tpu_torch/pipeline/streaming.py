"""Streaming conversion: bounded-latency chunked conversion of long input.

Counterpart of ``svc_inference_pipeline_tpu/pipeline/streaming.py``:

* the input is cut into fixed-length chunks, each carrying ``context``
  seconds of audio on both sides, so every chunk is one segment of
  ``chunk + 2 * context`` samples and pads to the same frame bucket,
* adjacent outputs are joined by an equal-power crossfade over the overlap
  (each chunk draws its own noise, and the crossfade bounds the seam),
* the pitch-shift factor is computed once from the first chunk's voiced
  median and pinned for the whole stream,
* chunk ``idx`` samples from its own generator, seeded from the call's
  generator (its initial seed; a generator seeded with 0 when none is given)
  and ``idx``.

Chunks are yielded as soon as they are converted: peak memory and time to
first audio are O(chunk), whatever the stream's length.
"""

from __future__ import annotations

from typing import Iterator, Optional, Union

import numpy as np
import torch

from svc_inference_pipeline_tpu_torch.ops.f0 import get_f0_features
from svc_inference_pipeline_tpu_torch.utils.artifacts import get_target_f0_median
from svc_inference_pipeline_tpu_torch.utils.audio_io import load_audio


def chunk_generator(device, base_seed: int, idx: int) -> torch.Generator:
    """The generator of chunk ``idx`` of a stream seeded with ``base_seed``."""
    seed = int(np.random.SeedSequence([base_seed, idx]).generate_state(1, np.uint64)[0]) >> 1
    return torch.Generator(device=device).manual_seed(seed)


def stream_convert(pipe, wav: Union[str, np.ndarray], singer_name: str, chunk_seconds: float = 10.0,
                   context_seconds: float = 1.0, generator: Optional[torch.Generator] = None,
                   upload_pcm16: bool = False, sampler=None, speedup=None) -> Iterator[np.ndarray]:
    """Yield converted waveform chunks of ``wav`` (path or array at cfg.fs).

    Concatenated, the chunks have the input's length, with equal-power
    crossfades at the ``context``-second seams.
    """
    cfg = pipe.cfg
    fs = cfg.fs
    audio = load_audio(wav, fs)[0] if isinstance(wav, str) else np.asarray(wav, dtype=np.float32)
    if generator is None:
        generator = torch.Generator(device=pipe.device).manual_seed(0)
    chunk = int(round(chunk_seconds * fs))
    # context clamps to a quarter chunk so tiny chunk sizes stay valid
    ctx = max(1, min(int(round(context_seconds * fs)), chunk // 4))

    if len(audio) <= chunk + ctx:
        yield pipe.convert(audio, singer_name, generator=generator, upload_pcm16=upload_pcm16,
                           sampler=sampler, speedup=speedup)
        return

    # pin the pitch-shift factor from the first chunk's voiced median
    first = audio[: chunk + ctx]
    f0_first, _ = get_f0_features(first, pipe.mel_frame_count(len(first)), cfg)
    voiced = f0_first[f0_first > 0]
    factor = get_target_f0_median(cfg.target_f0_file) / float(np.median(voiced)) if len(voiced) else None

    base_seed = generator.initial_seed()
    tail_prev: Optional[np.ndarray] = None  # converted right context of the previous chunk
    fade = None
    seg_len = chunk + 2 * ctx  # one segment length -> one bucket for every chunk
    for idx, s in enumerate(range(0, len(audio), chunk)):
        lo = max(0, s - ctx)
        hi = min(len(audio), s + chunk + ctx)
        seg = np.zeros(seg_len, np.float32)
        off = ctx - (s - lo)  # zero left-pad at the stream head
        seg[off: off + (hi - lo)] = audio[lo:hi]
        out = pipe.convert(seg, singer_name, generator=chunk_generator(pipe.device, base_seed, idx),
                           upload_pcm16=upload_pcm16, pitch_factor=factor, sampler=sampler, speedup=speedup)
        out = np.asarray(out, dtype=np.float32)

        core_len = min(chunk, len(audio) - s)
        body = out[ctx: ctx + core_len]
        rctx = out[ctx + core_len: ctx + core_len + ctx]
        if tail_prev is not None:
            n = min(len(tail_prev), min(ctx, len(body)))
            if fade is None or len(fade) != n:
                fade = np.sin(np.linspace(0.0, np.pi / 2.0, n, dtype=np.float32)) ** 2  # equal-power pair
            body = np.concatenate([body[:n] * fade + tail_prev[:n] * (1.0 - fade), body[n:]])
        tail_prev = rctx
        yield body


def convert_streaming(pipe, wav, singer_name, **kw) -> np.ndarray:
    """Run the stream to its end and concatenate the chunks."""
    return np.concatenate(list(stream_convert(pipe, wav, singer_name, **kw)))
