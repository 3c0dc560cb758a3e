"""Command-line interface of the PyTorch/CUDA pipeline.

    python -m svc_inference_pipeline_tpu_torch.cli \\
        --input clip.wav --singer svcc_CDF1 --output out.wav \\
        --random-weights --whisper-size medium

Flags follow ``svc_inference_pipeline_tpu.cli`` where they apply, plus
``--device`` (default cuda) and ``--timings-json``. One clip per call;
checkpoint loading is not ported yet, so ``--random-weights`` is required.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="svc_inference_pipeline_tpu_torch",
        description="Singing voice conversion (PyTorch + CUDA kernels)",
    )
    p.add_argument("--config", default="./config/config.json", help="json5 config path")
    p.add_argument("--input", "-i", required=True, help="source wav")
    p.add_argument("--singer", "-s", required=True, help="target singer name")
    p.add_argument("--output", "-o", required=True, help="output wav path")
    p.add_argument("--seed", type=int, default=0, help="seed of the weight and sampling generators")
    p.add_argument("--random-weights", action="store_true", help="random-init models (no checkpoints needed)")
    p.add_argument("--whisper-size", default="tiny", help="whisper size when random-init (tiny...large)")
    p.add_argument("--device", default="cuda", help="cuda (also: tpu, gpu) or cpu")
    p.add_argument("--timings-json", default=None, metavar="PATH",
                   help="write the conversion's phase wall times (seconds) as JSON")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    import torch

    from svc_inference_pipeline_tpu_torch.config import load_config
    from svc_inference_pipeline_tpu_torch.pipeline.convert import SVCPipeline
    from svc_inference_pipeline_tpu_torch.utils.audio_io import save_audio

    if not args.random_weights:
        print("error: checkpoint loading is not ported yet; pass --random-weights", file=sys.stderr)
        return 2
    cfg = load_config(args.config)
    print("Loading models (random weights)...")
    t0 = time.perf_counter()
    pipe = SVCPipeline.from_config(cfg, random_weights=True, whisper_size=args.whisper_size,
                                   seed=args.seed, device=args.device)
    print(f"Models ready in {time.perf_counter() - t0:.2f}s on {pipe.device}")
    generator = torch.Generator(device=pipe.device).manual_seed(args.seed)
    wave = pipe.convert(args.input, args.singer, generator=generator)
    save_audio(args.output, wave, cfg.fs)
    t = pipe.timings
    seconds = len(wave) / cfg.fs
    print(f"Converted {seconds:.2f}s of audio in {t['total_s']:.2f}s (RTF {t['total_s'] / max(seconds, 1e-9):.4f}): "
          f"front-end {t['frontend_s']:.3f}s, DDPM {t['ddpm_s']:.3f}s, vocoder {t['vocoder_s']:.3f}s")
    print("Saved", args.output)
    if args.timings_json:
        with open(args.timings_json, "w") as f:
            json.dump(dict(t, audio_s=seconds), f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
