"""Command-line interface of the PyTorch/CUDA pipeline.

    python -m svc_inference_pipeline_tpu_torch.cli \\
        --input clip.wav --singer svcc_CDF1 --output out.wav

Flags follow ``svc_inference_pipeline_tpu.cli`` (``--sampler
{ddpm,plms,ddim,dpmpp}``, ``--speedup``, ``--quantize {int8,int8-w1}``,
``--quantize-tail``, mapped onto the config as there; ``--bucket``,
``--pcm16-io``, ``--profile DIR``), plus ``--device`` (default cuda) and
``--timings-json``. ``--input/--singer/--output`` repeat: one input goes
through ``SVCPipeline.convert``, several through one ``convert_batch``.
The models load from the checkpoint files that ``--config`` names
(``whisper_model``, ``svc_model_path``, ``vocoder_model_path``; see
``SVCPipeline.from_config``); ``--random-weights`` draws them at random
instead, Whisper at ``--whisper-size``. Inputs may be WAV, FLAC, or another
format that soundfile or ffmpeg decodes.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from typing import Optional


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="svc_inference_pipeline_tpu_torch",
        description="Singing voice conversion (PyTorch + CUDA kernels)",
    )
    p.add_argument("--config", default="./config/config.json", help="json5 config path")
    p.add_argument("--input", "-i", action="append", required=True, help="source wav (repeatable)")
    p.add_argument("--singer", "-s", action="append", required=True, help="target singer name (repeatable)")
    p.add_argument("--output", "-o", action="append", required=True, help="output wav path (repeatable)")
    p.add_argument("--sampler", choices=["ddpm", "plms", "ddim", "dpmpp"], default=None,
                   help="override cfg.mapper.sampler")
    p.add_argument("--speedup", type=int, default=None, help="stride of plms/ddim/dpmpp (default from config)")
    p.add_argument("--quantize", choices=["int8", "int8-w1"], default=None,
                   help="int8 denoiser matmuls (int8-w1 keeps the output projection at the compute dtype)")
    p.add_argument("--quantize-tail", type=int, default=None, metavar="K",
                   help="run the LAST K DDPM steps unquantised (cfg.denoiser_quantize_tail)")
    p.add_argument("--seed", type=int, default=0, help="seed of the weight and sampling generators")
    p.add_argument("--random-weights", action="store_true", help="random-init models (no checkpoints needed)")
    p.add_argument("--whisper-size", default="tiny", help="whisper size when random-init (tiny...large)")
    p.add_argument("--device", default="cuda", help="cuda (also: tpu, gpu) or cpu")
    p.add_argument("--bucket", type=int, default=None,
                   help="frame padding granularity (smaller = less padded compute)")
    p.add_argument("--pcm16-io", action="store_true",
                   help="send the waveform to the device as int16 (single input)")
    p.add_argument("--profile", metavar="DIR", default=None,
                   help="write a torch.profiler Chrome trace of the conversion to DIR")
    p.add_argument("--timings-json", default=None, metavar="PATH",
                   help="write the conversion's phase wall times (seconds) as JSON")
    return p


def main(argv=None, built: Optional[dict] = None) -> int:
    """Run the CLI; a caller that converts again on the same models passes a
    dict as ``built`` and finds the pipeline under ``built["pipeline"]``."""
    args = build_parser().parse_args(argv)
    import torch

    from svc_inference_pipeline_tpu_torch.config import load_config
    from svc_inference_pipeline_tpu_torch.pipeline.convert import DEFAULT_BUCKET, SVCPipeline
    from svc_inference_pipeline_tpu_torch.utils.audio_io import save_audio
    from svc_inference_pipeline_tpu_torch.utils.observability import profile

    if not (len(args.input) == len(args.singer) == len(args.output)):
        print("error: --input/--singer/--output must repeat the same number of times", file=sys.stderr)
        return 2
    cfg = load_config(args.config)
    if args.sampler:
        cfg.mapper.sampler = args.sampler
    if args.speedup:
        cfg.mapper.plms_speedup = args.speedup
    if args.quantize:
        cfg.denoiser_quantize = args.quantize
    if args.quantize_tail is not None:
        cfg.denoiser_quantize_tail = args.quantize_tail
    print(f"Loading models ({'random weights' if args.random_weights else 'checkpoints'})...")
    t0 = time.perf_counter()
    pipe = SVCPipeline.from_config(cfg, random_weights=args.random_weights, whisper_size=args.whisper_size,
                                   seed=args.seed, device=args.device, bucket=args.bucket or DEFAULT_BUCKET)
    print(f"Models ready in {time.perf_counter() - t0:.2f}s on {pipe.device}")
    if built is not None:
        built["pipeline"] = pipe
    generator = torch.Generator(device=pipe.device).manual_seed(args.seed)
    with profile(args.profile) if args.profile else contextlib.nullcontext():
        if len(args.input) == 1:
            waves = [pipe.convert(args.input[0], args.singer[0], generator=generator,
                                  upload_pcm16=args.pcm16_io)]
        else:
            waves = pipe.convert_batch(args.input, args.singer, generator=generator)
    for wave, path in zip(waves, args.output):
        save_audio(path, wave, cfg.fs)
    t = pipe.timings
    seconds = sum(len(w) for w in waves) / cfg.fs
    print(f"Converted {len(waves)} clip(s), {seconds:.2f}s of audio in {t['total_s']:.2f}s "
          f"(RTF {t['total_s'] / max(seconds, 1e-9):.4f}): front-end {t['frontend_s']:.3f}s, "
          f"{sampler_name(pipe)} {t['ddpm_s']:.3f}s, vocoder {t['vocoder_s']:.3f}s")
    print("Saved", ", ".join(args.output))
    if args.timings_json:
        with open(args.timings_json, "w") as f:
            json.dump(dict(t, audio_s=seconds), f)
    return 0


def sampler_name(pipe) -> str:
    """The pipeline's default sampler and int8 mode, e.g. "plms@10 int8-w1"."""
    sampler, speedup = pipe._resolve_sampler(None, None)
    name = sampler if sampler == "ddpm" else f"{sampler}@{speedup}"
    if pipe.denoiser_quantize:
        name += f" {pipe.denoiser_quantize}"
        if pipe.denoiser_quantize_tail:
            name += f" (tail {pipe.denoiser_quantize_tail})"
    return name


if __name__ == "__main__":
    sys.exit(main())
