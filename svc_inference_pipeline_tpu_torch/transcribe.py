"""Whisper transcription CLI of the port.

Counterpart of ``svc_inference_pipeline_tpu/transcribe.py``, flag for flag,
with ``--device`` (default cuda) in place of the JAX CLI's ``--cpu``:
transcribe audio files and write txt/vtt/srt transcripts.

    python -m svc_inference_pipeline_tpu_torch.transcribe audio.wav \\
        --model /path/to/medium.pt --output_dir out/

``--model`` is a local checkpoint path, or a size name with
``--random-weights`` for smoke runs.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="svc-transcribe", formatter_class=argparse.ArgumentDefaultsHelpFormatter
    )
    p.add_argument("audio", nargs="+", help="audio file(s) to transcribe")
    p.add_argument("--model", default="tiny",
                   help="Whisper checkpoint path (.pt) or size name with --random-weights")
    p.add_argument("--output_dir", "-o", default=".")
    p.add_argument("--output_format", default="all", choices=["txt", "vtt", "srt", "all"])
    p.add_argument("--task", default="transcribe", choices=["transcribe", "translate"])
    p.add_argument("--language", default=None)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--best_of", type=int, default=5)
    p.add_argument("--beam_size", type=int, default=5)
    p.add_argument("--patience", type=float, default=None)
    p.add_argument("--length_penalty", type=float, default=None)
    p.add_argument("--suppress_tokens", default="-1")
    p.add_argument("--initial_prompt", default=None)
    p.add_argument("--condition_on_previous_text", type=lambda s: s.lower() != "false",
                   default=True)
    p.add_argument("--temperature_increment_on_fallback", type=float, default=0.2)
    p.add_argument("--compression_ratio_threshold", type=float, default=2.4)
    p.add_argument("--logprob_threshold", type=float, default=-1.0)
    p.add_argument("--no_speech_threshold", type=float, default=0.6)
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--random-weights", action="store_true",
                   help="random-init the model (smoke runs; no checkpoint needed)")
    p.add_argument("--device", default="cuda", help="cuda (also: tpu, gpu) or cpu")
    return p


def load_decoder(model: str, random_weights: bool, device=None):
    """A ``WhisperDecoder`` from a ``.pt`` file, or random weights at a size
    name (tiny for anything else), on ``device`` (None: the GPU)."""
    from svc_inference_pipeline_tpu_torch.models.whisper import WHISPER_SIZES
    from svc_inference_pipeline_tpu_torch.models.whisper_decoding import WhisperDecoder

    if not random_weights and os.path.exists(model):
        return WhisperDecoder.from_torch_checkpoint(model, device)
    return WhisperDecoder.random_init(model if model in WHISPER_SIZES else "tiny", device=device)


def main(argv=None, built: Optional[dict] = None) -> int:
    """Run the CLI; ``built``, when given, receives the decoder under
    ``"decoder"``."""
    args = build_parser().parse_args(argv)

    import torch

    from svc_inference_pipeline_tpu_torch.models.whisper_decoding import (
        DecodingOptions,
        get_tokenizer,
        write_srt,
        write_txt,
        write_vtt,
    )
    from svc_inference_pipeline_tpu_torch.ops.resample import resample_host
    from svc_inference_pipeline_tpu_torch.utils.audio_io import load_audio
    from svc_inference_pipeline_tpu_torch.utils.devices import resolve_device

    device = resolve_device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("transcribe: --device cuda asked for, but no CUDA device is available")
    decoder = load_decoder(args.model, args.random_weights, device)
    if built is not None:
        built["decoder"] = decoder
    multilingual = decoder.dims.n_vocab >= 51865
    tokenizer = get_tokenizer(multilingual=multilingual)

    if args.temperature_increment_on_fallback is not None:
        temperatures = tuple(
            np.arange(args.temperature, 1.0 + 1e-6, args.temperature_increment_on_fallback)
        )
    else:
        temperatures = (args.temperature,)

    options = DecodingOptions(
        task=args.task,
        language=args.language,
        best_of=args.best_of,
        beam_size=args.beam_size,
        patience=args.patience,
        length_penalty=args.length_penalty,
        suppress_tokens=args.suppress_tokens,
    )

    os.makedirs(args.output_dir, exist_ok=True)
    for path in args.audio:
        audio, sr = load_audio(path, None)
        audio16 = resample_host(np.asarray(audio), sr, 16000)
        result = decoder.transcribe(
            audio16,
            tokenizer,
            options=options,
            temperatures=temperatures,
            compression_ratio_threshold=args.compression_ratio_threshold,
            logprob_threshold=args.logprob_threshold,
            no_speech_threshold=args.no_speech_threshold,
            condition_on_previous_text=args.condition_on_previous_text,
            initial_prompt=args.initial_prompt,
            verbose=args.verbose or None,
        )
        base = os.path.join(args.output_dir, os.path.basename(path))
        if args.output_format in ("txt", "all"):
            with open(base + ".txt", "w", encoding="utf-8") as f:
                write_txt(result["segments"], file=f)
        if args.output_format in ("vtt", "all"):
            with open(base + ".vtt", "w", encoding="utf-8") as f:
                write_vtt(result["segments"], file=f)
        if args.output_format in ("srt", "all"):
            with open(base + ".srt", "w", encoding="utf-8") as f:
                write_srt(result["segments"], file=f)
        print(f"{path}: {len(result['segments'])} segment(s) → {base}.*")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
