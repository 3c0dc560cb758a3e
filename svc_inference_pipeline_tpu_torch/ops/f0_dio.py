"""DIO + StoneMask pitch tracking in numpy, on the host.

Counterpart of ``svc_inference_pipeline_tpu/ops/f0_dio.py`` (a copy; the
reference's pyworld ``dio`` + ``stonemask`` call, re-derived without
pyworld):

* **DIO** (Morise 2009): the signal is low-passed by a bank of
  Nuttall-windowed sinc filters whose cutoffs step ``channels_in_octave``
  per octave across [f0_floor, f0_ceil]. A channel whose cutoff sits just
  above the true F0 passes a near-sinusoid at F0, so its four event-interval
  estimators (positive and negative zero crossings, peaks, dips) agree. Each
  channel yields a per-frame candidate (the mean of the four tracks) and a
  reliability (their spread); the most reliable channel wins each frame and
  unreliable frames are unvoiced.
* **StoneMask**: voiced frames are refined by spectral reassignment, the
  instantaneous frequency at the estimate from the windowed DFT and its
  derivative-window DFT; two iterations.

Serial per-frame scalar work: it stays on the host, as the Praat tracker
(``ops/f0.py``) does.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


# ---------------------------------------------------------------------------
# filtering
# ---------------------------------------------------------------------------


def _nuttall(n: int) -> np.ndarray:
    t = np.arange(n, dtype=np.float64) * (2.0 * np.pi / (n - 1))
    return (
        0.355768
        - 0.487396 * np.cos(t)
        + 0.144232 * np.cos(2.0 * t)
        - 0.012604 * np.cos(3.0 * t)
    )


def _lowpass(x: np.ndarray, fs: float, cutoff: float) -> np.ndarray:
    """Zero-phase Nuttall-windowed-sinc low-pass via FFT convolution."""
    half = int(round(fs / cutoff * 2.0))  # ~4 periods of the cutoff
    k = 2 * half + 1
    t = (np.arange(k, dtype=np.float64) - half) / fs
    h = 2.0 * cutoff * np.sinc(2.0 * cutoff * t) * _nuttall(k)
    h /= h.sum()
    n = len(x) + k - 1
    nfft = 1 << (n - 1).bit_length()
    y = np.fft.irfft(np.fft.rfft(x, nfft) * np.fft.rfft(h, nfft), nfft)[:n]
    return y[half : half + len(x)]


# ---------------------------------------------------------------------------
# event-interval F0 candidates
# ---------------------------------------------------------------------------


def _crossing_times(y: np.ndarray, fs: float) -> np.ndarray:
    """Times (s) of negative→positive zero crossings, linearly interpolated."""
    s = np.signbit(y)
    idx = np.nonzero(s[:-1] & ~s[1:])[0]
    if len(idx) == 0:
        return np.empty(0)
    frac = -y[idx] / (y[idx + 1] - y[idx])
    return (idx + frac) / fs


def _interval_track(events: np.ndarray, frame_times: np.ndarray) -> np.ndarray:
    """Event times → per-frame inst. F0 (1/interval at interval midpoints);
    0 where fewer than 2 events cover the frame."""
    if len(events) < 2:
        return np.zeros_like(frame_times)
    intervals = np.diff(events)
    mids = 0.5 * (events[:-1] + events[1:])
    good = intervals > 0
    if good.sum() < 2:
        return np.zeros_like(frame_times)
    f = np.interp(frame_times, mids[good], 1.0 / intervals[good])
    f[(frame_times < mids[good][0]) | (frame_times > mids[good][-1])] = 0.0
    return f


def _channel_candidate(
    y: np.ndarray, fs: float, frame_times: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """One filtered channel → (candidate F0 per frame, deviation per frame)."""
    dy = np.diff(y)
    tracks = np.stack(
        [
            _interval_track(_crossing_times(y, fs), frame_times),
            _interval_track(_crossing_times(-y, fs), frame_times),
            _interval_track(_crossing_times(dy, fs), frame_times),  # dips
            _interval_track(_crossing_times(-dy, fs), frame_times),  # peaks
        ]
    )
    valid = (tracks > 0).all(axis=0)
    cand = np.where(valid, tracks.mean(axis=0), 0.0)
    dev = np.where(valid, tracks.std(axis=0), np.inf)
    return cand, dev


# ---------------------------------------------------------------------------
# DIO
# ---------------------------------------------------------------------------


def dio(
    x: np.ndarray,
    fs: int,
    f0_floor: float = 71.0,
    f0_ceil: float = 800.0,
    channels_in_octave: float = 2.0,
    frame_period: float = 5.0,
    allowed_range: float = 0.1,
) -> Tuple[np.ndarray, np.ndarray]:
    """F0 track + frame times. Matches pyworld.dio's contract:
    ``n_frames = floor(1000·len/fs / frame_period) + 1``, unvoiced = 0."""
    x = np.asarray(x, dtype=np.float64)
    n_frames = int(1000.0 * len(x) / fs / frame_period) + 1
    frame_times = np.arange(n_frames) * (frame_period / 1000.0)

    # candidate channel cutoffs: half-octave steps spanning the range
    n_ch = int(np.ceil(np.log2(f0_ceil / f0_floor) * channels_in_octave))
    cutoffs = f0_floor * 2.0 ** ((np.arange(n_ch) + 1) / channels_in_octave)

    # DC removal keeps zero crossings meaningful
    x = x - x.mean()

    cands = np.zeros((n_ch, n_frames))
    devs = np.full((n_ch, n_frames), np.inf)
    for i, fc in enumerate(cutoffs):
        y = _lowpass(x, fs, fc)
        cand, dev = _channel_candidate(y, fs, frame_times)
        in_range = (cand >= f0_floor) & (cand <= f0_ceil) & (cand <= fc * 1.1)
        cands[i] = np.where(in_range, cand, 0.0)
        devs[i] = np.where(in_range, dev, np.inf)

    # best channel per frame = smallest relative deviation
    rel = np.where(cands > 0, devs / np.maximum(cands, 1e-12), np.inf)
    best = rel.argmin(axis=0)
    f0 = cands[best, np.arange(n_frames)]
    f0[rel[best, np.arange(n_frames)] > allowed_range] = 0.0

    # remove single-frame spikes/jumps (> 20 % step against both neighbours)
    if n_frames > 2:
        prev, nxt = f0[:-2], f0[2:]
        mid = f0[1:-1]
        jump = (
            (mid > 0)
            & (prev > 0)
            & (nxt > 0)
            & (np.abs(mid - prev) > 0.2 * mid)
            & (np.abs(mid - nxt) > 0.2 * mid)
        )
        f0[1:-1][jump] = 0.0
    return f0, frame_times


# ---------------------------------------------------------------------------
# StoneMask refinement
# ---------------------------------------------------------------------------


def _refine_once(x: np.ndarray, fs: int, t: float, f: float) -> float:
    """Instantaneous frequency at ``f`` via derivative-window reassignment.

    Window = 6 periods: the Nuttall mainlobe then ends well inside ±f, so
    neighbouring harmonics don't bias the reassigned frequency (a 3-period
    window leaves harmonic 2 inside the mainlobe — measured ~30 cent bias
    on harmonic complexes; 6 periods measures < 0.1 cent)."""
    half = int(round(3.0 * fs / f))
    c = int(round(t * fs))
    lo, hi = c - half, c + half + 1
    if lo < 0 or hi > len(x) or half < 2:
        return f
    seg = x[lo:hi]
    n = np.arange(-half, half + 1, dtype=np.float64)
    w = _nuttall(len(seg))
    dw = np.gradient(w) * fs  # derivative window (per second)
    ph = np.exp(-2j * np.pi * f * n / fs)
    X = np.sum(seg * w * ph)
    Xd = np.sum(seg * dw * ph)
    if abs(X) < 1e-12:
        return f
    # reassigned frequency: f + Im(Xd·conj(X)) / (2π|X|²)
    return f + float(np.imag(Xd * np.conj(X)) / (2.0 * np.pi * abs(X) ** 2))


def stonemask(
    x: np.ndarray, f0: np.ndarray, frame_times: np.ndarray, fs: int
) -> np.ndarray:
    """Refine voiced frames; estimates drifting > 20 % are zeroed
    (pyworld.stonemask contract)."""
    x = np.asarray(x, dtype=np.float64)
    x = x - x.mean()
    out = np.array(f0, dtype=np.float64)
    for i, (t, f) in enumerate(zip(frame_times, f0)):
        if f <= 0:
            continue
        r = _refine_once(x, fs, t, f)
        r = _refine_once(x, fs, t, r)
        out[i] = r if abs(r - f) <= 0.2 * f else f
    return out
