"""A configuration small enough for the CPU: Whisper at "tiny" width, a
2 x 64 denoiser over a 4-step schedule, a 64-channel vocoder. Only the
tests use it; the benchmark's cells run the published widths."""

import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def tiny(cfg: dict) -> dict:
    cfg = json.loads(json.dumps(cfg))
    cfg["whisper_dims"] = {"n_mels": 80, "n_audio_ctx": 1500, "n_audio_state": 384, "n_audio_head": 6,
                           "n_audio_layer": 4}
    cfg["mapper"].update(noise_schedule_factors=[0.0001, 0.02, 4], residual_layer_num=2, residual_channels=64)
    cfg["mapper"]["input_content_dim"]["whisper"] = 384
    cfg["vocoder"]["upsample_initial_channel"] = 64
    for k in ("singer_file", "min_mel_file", "max_mel_file", "target_f0_file"):
        cfg[k] = str(ROOT / cfg[k].lstrip("./"))
    return cfg
