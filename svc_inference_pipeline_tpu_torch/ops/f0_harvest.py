"""Harvest pitch tracking in numpy, on the host.

Counterpart of ``svc_inference_pipeline_tpu/ops/f0_harvest.py`` (a copy; the
reference's pyworld ``harvest`` call, re-derived without pyworld after
Morise 2017), sharing the band filters and event intervals of
``ops/f0_dio.py``:

1. **Multi-channel candidates**: a dense bank of low-passed copies of the
   signal (``channels_in_octave`` per octave across [f0_floor, f0_ceil]);
   each channel yields an interval-based F0 track from four event detectors.
   Unlike DIO, which keeps the single steadiest channel a frame, every
   channel whose four detectors agree proposes a candidate.
2. **Refinement and scoring**: candidates deduplicated (5 cents) and refined
   by derivative-window spectral reassignment (StoneMask's); the score is
   the channel's relative spread of its four tracks.
3. **Contour connection**: candidates are linked frame to frame into
   contours (relative step <= ``step_tol``), seeded from the most reliable
   frames; short contours are dropped, compatible contours are bridged
   across gaps <= ``max_gap`` frames, and overlaps resolve by score.
4. **Smoothing**: forward-backward exponential smoothing of log-F0 inside
   each voiced segment.

Serial per-frame scalar work: it stays on the host, as the Praat tracker
(``ops/f0.py``) does.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from svc_inference_pipeline_tpu_torch.ops.f0_dio import (
    _channel_candidate,
    _lowpass,
    _nuttall,
)


def _if_at(x: np.ndarray, fs: int, t: float, f: float,
           win_f: float = None) -> Tuple[float, float]:
    """(instantaneous frequency near ``f``, energy weight |X|²) via the
    derivative-window reassignment. The Nuttall window spans 6 periods of
    ``win_f`` (default ``f``) — when probing harmonic k·f0, pass
    ``win_f=f0`` so the mainlobe (±⅔·win_f) keeps the neighbouring
    harmonics (±f0 away) outside; sizing by k·f0 pulls them inside and
    biases the reassigned frequency (measured: +19 cents at k=2 on a
    clean harmonic complex)."""
    half = int(round(3.0 * fs / (win_f or f)))
    c = int(round(t * fs))
    lo, hi = c - half, c + half + 1
    if lo < 0 or hi > len(x) or half < 2:
        return f, 0.0
    seg = x[lo:hi]
    n = np.arange(-half, half + 1, dtype=np.float64)
    w = _nuttall(len(seg))
    dw = np.gradient(w) * fs
    ph = np.exp(-2j * np.pi * f * n / fs)
    X = np.sum(seg * w * ph) / w.sum()  # amplitude-normalised (window-
    # length invariant — the weight must compare across different f)
    if abs(X) < 1e-15:
        return f, 0.0
    Xd = np.sum(seg * dw * ph) / w.sum()
    return (
        f + float(np.imag(Xd * np.conj(X)) / (2.0 * np.pi * abs(X) ** 2)),
        float(abs(X) ** 2),
    )


def _refine_harmonic(x: np.ndarray, fs: int, t: float, f: float,
                     n_harm: int = 3) -> float:
    """Refine F0 by harmonic-energy grid search + energy-weighted
    instantaneous-frequency voting across the first harmonics (Harvest's
    GetRefinedF0 idea). The plain reassignment has a narrow basin — from a
    noise-biased start it locks onto noise energy and diverges; the coarse
    grid (±90 cents) re-centres on the true harmonic stack first, and the
    harmonics' independent SNR stabilises the final vote."""
    # coarse: maximise Σ_k |X(k·f')|² over a local log grid
    grid = f * 2.0 ** np.linspace(-0.075, 0.075, 13)
    best_s, best_f = -1.0, f
    for fc in grid:
        s = 0.0
        for k in range(1, n_harm + 1):
            if k * fc > 0.45 * fs:
                break
            _, wk = _if_at(x, fs, t, k * fc, win_f=fc)
            s += wk
        if s > best_s:
            best_s, best_f = s, fc
    f = best_f

    for _ in range(2):
        num = den = 0.0
        for k in range(1, n_harm + 1):
            fk = k * f
            if fk > 0.45 * fs:
                break
            rk, wk = _if_at(x, fs, t, fk, win_f=f)
            est = rk / k
            if wk > 0 and abs(est - f) <= 0.05 * f:
                num += wk * est
                den += wk
        if den <= 0:
            return f
        f = num / den
    return f


def _smooth_log_segment(f: np.ndarray, alpha: float = 0.5) -> np.ndarray:
    """Zero-phase EMA of log-F0 over one voiced segment."""
    if len(f) < 3:
        return f
    lf = np.log(f)
    fwd = np.empty_like(lf)
    acc = lf[0]
    for i, v in enumerate(lf):
        acc = alpha * v + (1 - alpha) * acc
        fwd[i] = acc
    bwd = np.empty_like(lf)
    acc = lf[-1]
    for i in range(len(lf) - 1, -1, -1):
        acc = alpha * lf[i] + (1 - alpha) * acc
        bwd[i] = acc
    return np.exp(0.5 * (fwd + bwd))


def harvest(
    x: np.ndarray,
    fs: int,
    f0_floor: float = 71.0,
    f0_ceil: float = 800.0,
    channels_in_octave: float = 12.0,
    frame_period: float = 5.0,
    step_tol: float = 0.12,
    min_contour_frames: int = 4,
    max_gap: int = 3,
    dev_tol: float = 0.2,
) -> Tuple[np.ndarray, np.ndarray]:
    """F0 track + frame times; pyworld.harvest's contract
    (``n_frames = floor(1000·len/fs / frame_period) + 1``, unvoiced = 0)."""
    x = np.asarray(x, dtype=np.float64)
    n_frames = int(1000.0 * len(x) / fs / frame_period) + 1
    frame_times = np.arange(n_frames) * (frame_period / 1000.0)
    x = x - x.mean()

    # ---- 1. dense candidate generation -------------------------------
    n_ch = int(np.ceil(np.log2(f0_ceil / f0_floor) * channels_in_octave))
    cutoffs = f0_floor * 2.0 ** ((np.arange(n_ch) + 1) / channels_in_octave)

    cand_f: List[List[float]] = [[] for _ in range(n_frames)]
    cand_s: List[List[float]] = [[] for _ in range(n_frames)]
    for fc in cutoffs:
        y = _lowpass(x, fs, fc)
        cand, dev = _channel_candidate(y, fs, frame_times)
        rel = np.where(cand > 0, dev / np.maximum(cand, 1e-12), np.inf)
        ok = (cand >= f0_floor) & (cand <= f0_ceil) & (cand <= fc * 1.1) & (rel < dev_tol)
        for i in np.nonzero(ok)[0]:
            cand_f[i].append(float(cand[i]))
            cand_s[i].append(float(rel[i]))

    # ---- 2. dedupe (5 cents) + refine --------------------------------
    for i in range(n_frames):
        if not cand_f[i]:
            continue
        order = np.argsort(cand_f[i])
        fu, su = [], []
        for j in order:
            f, s = cand_f[i][j], cand_s[i][j]
            if fu and abs(np.log2(f / fu[-1])) < 5.0 / 1200.0:
                if s < su[-1]:
                    fu[-1], su[-1] = f, s
                continue
            fu.append(f)
            su.append(s)
        # refine the surviving hypotheses (harmonic-voting reassignment)
        t = frame_times[i]
        for j, f in enumerate(fu):
            r = _refine_harmonic(x, fs, t, f)
            if f0_floor <= r <= f0_ceil and abs(r - f) <= 0.2 * f:
                fu[j] = r
        cand_f[i], cand_s[i] = fu, su

    # ---- 3. contour connection ---------------------------------------
    used = [np.zeros(len(c), dtype=bool) for c in cand_f]
    contours = []  # (score, {frame: (f0, s)})

    seeds = sorted(
        ((s, i, j) for i in range(n_frames) for j, s in enumerate(cand_s[i])),
        key=lambda t: t[0],
    )
    for s0, i0, j0 in seeds:
        if used[i0][j0]:
            continue
        track = {i0: (cand_f[i0][j0], s0)}
        used[i0][j0] = True
        for step in (1, -1):
            i, f_prev = i0, cand_f[i0][j0]
            while True:
                i += step
                if not (0 <= i < n_frames) or not cand_f[i]:
                    break
                diffs = [abs(f - f_prev) / f_prev for f in cand_f[i]]
                j = int(np.argmin(diffs))
                if diffs[j] > step_tol or used[i][j]:
                    break
                used[i][j] = True
                track[i] = (cand_f[i][j], cand_s[i][j])
                f_prev = cand_f[i][j]
        if len(track) >= min_contour_frames:
            contours.append(track)

    # resolve per-frame: best (lowest score) contour value wins
    f0 = np.zeros(n_frames)
    score = np.full(n_frames, np.inf)
    for track in contours:
        for i, (f, s) in track.items():
            if s < score[i]:
                f0[i], score[i] = f, s

    # ---- 3b. bridge short gaps between compatible segments -----------
    voiced = f0 > 0
    idx = np.nonzero(voiced)[0]
    for a, b in zip(idx[:-1], idx[1:]):
        gap = b - a - 1
        if 0 < gap <= max_gap and abs(np.log2(f0[b] / f0[a])) < 0.3:
            f0[a + 1 : b] = np.exp(np.linspace(np.log(f0[a]), np.log(f0[b]), gap + 2))[1:-1]

    # ---- 4. smooth log-F0 inside voiced segments ---------------------
    voiced = f0 > 0
    i = 0
    while i < n_frames:
        if not voiced[i]:
            i += 1
            continue
        j = i
        while j < n_frames and voiced[j]:
            j += 1
        f0[i:j] = _smooth_log_segment(f0[i:j])
        i = j
    return f0, frame_times
