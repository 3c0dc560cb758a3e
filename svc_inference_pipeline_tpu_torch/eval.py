"""Quality metrics (mel MAE, F0 RMSE, MCD, waveform SNR) and the golden run.

Counterpart of ``svc_inference_pipeline_tpu/eval.py``, on the port's own mel
front-end (``ops/mel.py``, run on the host) and Praat F0 (``ops/f0.py``):

    # score two existing waveforms
    python -m svc_inference_pipeline_tpu_torch.eval ref.wav test.wav

    # convert a clip with trained checkpoints (the reference's file layouts:
    # mapper ``state_dict``, vocoder ``generator_state_dict``, Whisper
    # ``dims`` + ``model_state_dict``) on the GPU and score it against a
    # golden output
    python -m svc_inference_pipeline_tpu_torch.eval --golden \\
        --mapper ckpts/mapper.pt --vocoder ckpts/vocoder.pt \\
        [--whisper medium|/path/medium.pt] [--input clip.flac --golden-wav gold.wav]

A Whisper registry name is fetched only under ``SVC_ALLOW_DOWNLOAD=1``.
"""

from __future__ import annotations

import json
import os
import sys
from typing import Dict

import numpy as np


def _align(a: np.ndarray, b: np.ndarray):
    n = min(len(a), len(b))
    return a[:n], b[:n]


def _log_mel(wav: np.ndarray, cfg) -> np.ndarray:
    """[n_mels, T] log-mel of a waveform (f32, on the host)."""
    import torch

    from svc_inference_pipeline_tpu_torch.ops.mel import extract_mel_features

    with torch.no_grad():
        return extract_mel_features(torch.from_numpy(np.ascontiguousarray(wav, np.float32)), cfg)[0].numpy()


def mel_mae(wav_a: np.ndarray, wav_b: np.ndarray, cfg) -> float:
    """Mean absolute log-mel difference."""
    a, b = _align(np.asarray(wav_a), np.asarray(wav_b))
    return float(np.abs(_log_mel(a, cfg) - _log_mel(b, cfg)).mean())


def f0_rmse_cents(wav_a: np.ndarray, wav_b: np.ndarray, cfg) -> Dict[str, float]:
    """F0 RMSE in cents over frames voiced in both, and voicing agreement."""
    from svc_inference_pipeline_tpu_torch.ops.f0 import get_f0_features

    a, b = _align(np.asarray(wav_a), np.asarray(wav_b))
    n_frames = len(a) // cfg.hop_length
    fa, _ = get_f0_features(a, n_frames, cfg)
    fb, _ = get_f0_features(b, n_frames, cfg)
    both = (fa > 0) & (fb > 0)
    if both.sum() == 0:
        return {"f0_rmse_cents": float("nan"), "voicing_agreement": 0.0}
    cents = 1200.0 * np.log2(fa[both] / fb[both])
    return {
        "f0_rmse_cents": float(np.sqrt(np.mean(cents**2))),
        "voicing_agreement": float(((fa > 0) == (fb > 0)).mean()),
    }


def mcd_from_mels(ma: np.ndarray, mb: np.ndarray, n_coeffs: int = 13) -> float:
    """MCD (dB) from two ln-mel spectrograms shaped [n_mels, T]."""
    from scipy.fftpack import dct

    # per-frame DCT-II over the mel axis -> cepstra, c0 (frame energy) left out
    ca = dct(np.asarray(ma).T, type=2, axis=-1, norm="ortho")[:, 1: n_coeffs + 1]
    cb = dct(np.asarray(mb).T, type=2, axis=-1, norm="ortho")[:, 1: n_coeffs + 1]
    n = min(len(ca), len(cb))
    dist = np.sqrt(np.sum((ca[:n] - cb[:n]) ** 2, axis=-1))
    return float((10.0 / np.log(10.0)) * np.sqrt(2.0) * dist.mean())


def mcd_db(wav_a: np.ndarray, wav_b: np.ndarray, cfg, n_coeffs: int = 13) -> float:
    """Mel-cepstral distortion (dB): per-frame DCT-II of the log-mel ->
    cepstra c1..cK, MCD = (10/ln10)·√2 · mean‖c_a − c_b‖₂."""
    a, b = _align(np.asarray(wav_a), np.asarray(wav_b))
    return mcd_from_mels(_log_mel(a, cfg), _log_mel(b, cfg), n_coeffs)


def waveform_snr_db(ref: np.ndarray, test: np.ndarray) -> float:
    """SNR of ``test`` against ``ref`` (dB), sample-aligned."""
    a, b = _align(np.asarray(ref, np.float64), np.asarray(test, np.float64))
    denom = float(np.mean((a - b) ** 2))
    if denom == 0:
        return float("inf")
    return float(10.0 * np.log10(np.mean(a**2) / denom))


def evaluate_waveforms(ref: np.ndarray, test: np.ndarray, cfg) -> Dict[str, float]:
    """Every metric between two waveforms at the same rate."""
    a, b = _align(np.asarray(ref), np.asarray(test))
    ma, mb = _log_mel(a, cfg), _log_mel(b, cfg)  # one mel pass each, for both spectral metrics
    out: Dict[str, float] = {
        "mel_mae": float(np.abs(ma - mb).mean()),
        "mcd_db": mcd_from_mels(ma, mb),
        "snr_db": waveform_snr_db(ref, test),
    }
    out.update(f0_rmse_cents(ref, test, cfg))
    return out


def evaluate_pair(ref_path: str, test_path: str, cfg=None) -> Dict[str, float]:
    from svc_inference_pipeline_tpu_torch.config import DEFAULT_CONFIG, load_config
    from svc_inference_pipeline_tpu_torch.utils.audio_io import load_audio

    cfg = cfg or load_config(DEFAULT_CONFIG)
    ref, _ = load_audio(ref_path, cfg.fs)
    test, _ = load_audio(test_path, cfg.fs)
    return evaluate_waveforms(ref, test, cfg)


#: the reference repository's test clip and its committed converted output,
#: in a checkout of that repository named ``reference`` in the working
#: directory
GOLDEN_INPUT = os.path.join("reference", "test_set", "1100000814.wav")
GOLDEN_WAV = os.path.join("reference", "gen", "1100000814_svcc_CDF1.wav")
GOLDEN_SINGER = "svcc_CDF1"


def golden_eval(cfg, input_path: str = GOLDEN_INPUT, singer: str = GOLDEN_SINGER,
                golden_path: str = GOLDEN_WAV, output_path: str | None = None,
                pipeline=None) -> Dict[str, float]:
    """Convert ``input_path`` with the trained checkpoints that ``cfg`` names
    and score the result against ``golden_path``.

    The checkpoints load through ``SVCPipeline.from_config(cfg,
    random_weights=False)`` (on the config's device, the GPU unless it says
    ``cpu``); a missing mapper or vocoder file raises instead of falling
    back to random weights. The conversion draws its noise from a
    ``torch.Generator`` seeded 0 on the pipeline's device.
    """
    import time

    import torch

    from svc_inference_pipeline_tpu_torch.utils.audio_io import load_audio, save_audio

    for role, path in (("mapper (--mapper / cfg.svc_model_path)", cfg.svc_model_path),
                       ("vocoder (--vocoder / cfg.vocoder_model_path)", cfg.vocoder_model_path)):
        if not os.path.exists(str(path)):
            raise FileNotFoundError(
                f"{role}: {path!r} not found. The reference's trained "
                "checkpoints are not publicly downloadable (its config "
                "points at a private mount); point the flag at a local copy."
            )

    if pipeline is None:
        from svc_inference_pipeline_tpu_torch.pipeline.convert import SVCPipeline

        pipeline = SVCPipeline.from_config(cfg, random_weights=False)

    audio, _ = load_audio(input_path, cfg.fs)
    generator = torch.Generator(device=pipeline.device).manual_seed(0)
    t0 = time.perf_counter()
    wave = np.asarray(pipeline.convert(audio, singer, generator=generator))
    wall = time.perf_counter() - t0
    if output_path:
        save_audio(output_path, wave, cfg.fs)

    golden, _ = load_audio(golden_path, cfg.fs)
    out = evaluate_waveforms(np.asarray(golden), wave, cfg)
    out["rtf"] = wall / (len(audio) / cfg.fs)
    out["duration_s"] = len(audio) / cfg.fs
    return out


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(
        prog="python -m svc_inference_pipeline_tpu_torch.eval",
        description="Score two waveforms, or run the golden real-checkpoint validation",
    )
    p.add_argument("wavs", nargs="*", metavar="WAV", help="REF.wav TEST.wav (pair mode)")
    p.add_argument("--golden", action="store_true",
                   help="convert --input with trained checkpoints and score it against --golden-wav")
    p.add_argument("--config", default="./config/config.json")
    p.add_argument("--mapper", default=None, help="mapper .pt (ckpt['state_dict'])")
    p.add_argument("--vocoder", default=None, help="vocoder .pt (ckpt['generator_state_dict'])")
    p.add_argument("--whisper", default=None,
                   help="whisper .pt path or registry name (fetched under SVC_ALLOW_DOWNLOAD=1)")
    p.add_argument("--input", default=GOLDEN_INPUT)
    p.add_argument("--singer", default=GOLDEN_SINGER)
    p.add_argument("--golden-wav", default=GOLDEN_WAV)
    p.add_argument("--output", default=None, help="also save the converted WAV here")
    args = p.parse_args(argv)

    if not args.golden:
        if len(args.wavs) != 2:
            p.error("pair mode takes exactly REF.wav TEST.wav (or use --golden)")
        print(json.dumps(evaluate_pair(args.wavs[0], args.wavs[1]), indent=2))
        return 0

    from svc_inference_pipeline_tpu_torch.config import load_config

    cfg = load_config(args.config)
    if args.mapper:
        cfg.svc_model_path = args.mapper
    if args.vocoder:
        cfg.vocoder_model_path = args.vocoder
    if args.whisper:
        cfg.whisper_model = args.whisper
    print(json.dumps(golden_eval(
        cfg, input_path=args.input, singer=args.singer,
        golden_path=args.golden_wav, output_path=args.output,
    )))
    return 0


if __name__ == "__main__":
    sys.exit(main())
