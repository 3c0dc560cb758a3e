"""The work counts of ``flops.py`` against hand counts at stated shapes."""

import json
import math
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from portbench import flops  # noqa: E402

CFG = json.loads((Path(__file__).resolve().parents[1] / "configs" / "svc-ddpm1000-bf16.json").read_text())


def test_denoiser_counts():
    m = CFG["mapper"]
    # T = 384 frames, C = 384, 20 layers: (3 taps x C x 2C + C x 2C) x 2 flops = 16 C^2 a frame a layer
    assert flops.denoiser_eval_flops(384, m) == 16 * 384 * 384 * 384 * 20
    assert math.isclose(flops.denoiser_eval_flops(384, m) / flops.PEAK_BF16_FLOPS * 1e3, 0.01832, rel_tol=1e-3)
    assert flops.denoiser_cond_flops(384, m) == 4 * 384 * 384 * 384 * 20
    weights = 20 * (3 * 384 * 768 + 384 * 768) * 2
    assert flops.denoiser_eval_bytes(384, m) == weights + 384 * (20 * 768 * 2 + 2 * 100 * 4)
    # at 384 frames the operations bound an evaluation; at 32 frames the weights' bytes do
    per_eval = flops.sampling_bound_s(384, 1, m) - flops.denoiser_cond_flops(384, m) / 989e12
    assert math.isclose(per_eval, 16 * 384 ** 3 * 20 / 989e12)
    small = flops.sampling_bound_s(32, 1, m) - flops.denoiser_cond_flops(32, m) / 989e12
    assert math.isclose(small, flops.denoiser_eval_bytes(32, m) / 3.35e12)
    assert flops.sampler_evals("ddpm", 1, 1000) == 1000 and flops.sampler_evals("plms", 10, 1000) == 101


def test_whisper_counts():
    d, n = 1024, 1500  # one 30 s window
    stem = 2 * 3000 * 80 * d * 3 + 2 * n * d * d * 3
    want = stem + 24 * (24 * n * d * d + 4 * n * n * d)
    assert math.isclose(flops.whisper_flops(30.0, CFG["whisper_dims"]), want)


def test_vocoder_counts():
    v = CFG["vocoder"]
    t = 10  # mel frames
    want = 2 * t * 100 * 1536 * 7
    chans, length = 1536, t
    for u, k in zip((4, 4, 2, 2, 2, 2), (8, 8, 4, 4, 4, 4)):
        want += 2 * length * k * chans * (chans // 2)
        chans, length = chans // 2, length * u
        want += 2 * length * chans * chans * (2 * 3 * (3 + 7 + 11))  # 3 blocks x 3 dilations x 2 convs
    want += 2 * length * 24 * 7
    assert length == t * 256
    assert math.isclose(flops.vocoder_flops(t, v), want)
    # a 10 s clip (938 frames): about 1.7 TFLOP, bound by the operations
    assert 1.6e12 < flops.vocoder_flops(938, v) < 1.9e12
