"""Windowed-sinc polyphase resampling.

Counterpart of ``svc_inference_pipeline_tpu/ops/resample.py``: the same
Kaiser-windowed sinc filter evaluated at each rational phase (resampy's
kaiser_best/kaiser_fast parameters). :func:`_resample_conv` runs on the
tensor's device as one strided conv per output phase; :func:`resample_host`
is the numpy gather form for host-side file loading.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

_QUALITY = {
    # (num_zeros, kaiser beta, rolloff)
    "kaiser_best": (64, 14.769656459379492, 0.9475937167399596),
    "kaiser_fast": (16, 8.555504641634386, 0.85),
}


@lru_cache(maxsize=None)
def _polyphase_taps(sr_orig: int, sr_new: int, quality: str) -> Tuple[np.ndarray, int, int, int]:
    """Tap table [up, K] for every rational phase, plus (up, down, half_width)."""
    num_zeros, beta, rolloff = _QUALITY[quality]
    g = math.gcd(sr_orig, sr_new)
    up, down = sr_new // g, sr_orig // g
    scale = min(1.0, up / down)
    half_width = int(math.ceil(num_zeros / scale))
    offsets = np.arange(-half_width, half_width + 1, dtype=np.float64)
    frac = np.arange(up, dtype=np.float64)[:, None] / up
    t = (offsets[None, :] - frac) * scale
    x = t / num_zeros
    kaiser = np.where(
        np.abs(x) <= 1.0,
        np.i0(beta * np.sqrt(np.maximum(0.0, 1.0 - x * x))) / np.i0(beta),
        0.0,
    )
    taps = scale * rolloff * np.sinc(rolloff * t) * kaiser
    return taps.astype(np.float32), up, down, half_width


def _out_len(n_in: int, up: int, down: int) -> int:
    return -((-n_in * up) // down)  # ceil(n_in * up / down), exact


def _resample_conv(x: torch.Tensor, sr_orig: int, sr_new: int,
                   quality: str = "kaiser_best") -> torch.Tensor:
    """x [..., L] -> [..., ceil(L * sr_new / sr_orig)] on x's device:
    out[p + m*up] = sum_k x[m*down + (p*down)//up + k - half] taps[(p*down)%up][k]."""
    taps, up, down, half = _polyphase_taps(sr_orig, sr_new, quality)
    n_in = int(x.shape[-1])
    n_out = _out_len(n_in, up, down)
    k = taps.shape[1]
    lead = x.shape[:-1]
    xp = F.pad(x.reshape(-1, 1, n_in), (half, half))
    outs = []
    for p in range(up):
        n_p = -(-(n_out - p) // up)
        offset = (p * down) // up
        w = torch.as_tensor(taps[(p * down) % up], dtype=x.dtype, device=x.device).view(1, 1, k)
        seg = xp[..., offset: offset + (n_p - 1) * down + k]
        outs.append(F.conv1d(seg, w, stride=down)[:, 0])
    n_max = max(o.shape[1] for o in outs)
    stacked = torch.stack([F.pad(o, (0, n_max - o.shape[1])) for o in outs], dim=2)
    return stacked.reshape(-1, n_max * up)[:, :n_out].reshape(*lead, n_out)


def resample_host(x: np.ndarray, sr_orig: int, sr_new: int,
                  quality: str = "kaiser_best") -> np.ndarray:
    """Host-side numpy resampling, the same math as :func:`_resample_conv`."""
    if sr_orig == sr_new:
        return np.asarray(x, dtype=np.float32)
    taps, up, down, half = _polyphase_taps(sr_orig, sr_new, quality)
    xf = np.asarray(x, dtype=np.float32).reshape(-1)
    n_out = _out_len(len(xf), up, down)
    xp = np.pad(xf, (half, half))
    n = np.arange(n_out, dtype=np.int64)
    idx = (n * down) // up
    windows = np.lib.stride_tricks.sliding_window_view(xp, taps.shape[1])[idx]
    return np.einsum("ok,ok->o", windows, taps[(n * down) % up]).astype(np.float32)
