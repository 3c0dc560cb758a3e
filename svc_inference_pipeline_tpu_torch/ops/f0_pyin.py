"""pYIN pitch tracking in numpy, on the host.

Counterpart of ``svc_inference_pipeline_tpu/ops/f0_pyin.py`` (a copy; the
reference's ``librosa.pyin`` call, re-derived without librosa after Mauch &
Dixon 2014, with librosa's parameter names and defaults):

1. **YIN front half**: per-frame difference function over a ``win_length``
   correlation window (FFT cross-correlation), cumulative-mean-normalised,
   parabolic interpolation at troughs.
2. **Probabilistic thresholding**: a Beta(2, 18) prior over 100 thresholds;
   for each threshold the troughs below it share its mass under a Boltzmann
   distribution over their rank (``boltzmann_parameter``); a threshold with
   no trough below sends ``no_trough_prob`` of its mass to the global
   minimum. Each trough (pitch candidate) gets a voicing probability.
3. **Viterbi smoothing**: an HMM over ``n_bins`` pitch states (10 cents apart
   between fmin and fmax) x {voiced, unvoiced}; pitch transitions fall off
   triangularly within the reachable band (``max_transition_rate`` octaves a
   second), voicing flips with ``switch_prob``. A decoded voiced state emits
   the refined candidate nearest its bin (the bin centre when none landed
   in it). Unlike librosa, the transition mixes in a ``jump_prob`` uniform
   floor, so a pitch step beyond the band with sustained evidence stays
   reachable.

Serial per-frame scalar work: it stays on the host, as the Praat tracker
(``ops/f0.py``) does.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


# ---------------------------------------------------------------------------
# YIN difference function
# ---------------------------------------------------------------------------


def _frame(x: np.ndarray, frame_length: int, hop_length: int) -> np.ndarray:
    n = 1 + max(0, (len(x) - frame_length)) // hop_length
    idx = np.arange(frame_length)[None, :] + hop_length * np.arange(n)[:, None]
    return x[idx]


def _difference_function(frames: np.ndarray, win_length: int, tau_max: int) -> np.ndarray:
    """d[t, τ] = Σ_{j<W} (x[j] − x[j+τ])² for τ ∈ [0, tau_max]; FFT-based.

    d(τ) = P0 + P(τ) − 2·r(τ) with P0 = Σ_{j<W} x²[j],
    P(τ) = Σ_{j<W} x²[j+τ], r(τ) = Σ_{j<W} x[j]·x[j+τ].
    """
    n_frames, frame_length = frames.shape
    assert win_length + tau_max <= frame_length, (win_length, tau_max, frame_length)

    # correlation of the full frame with its first W samples
    nfft = 1 << (2 * frame_length - 1).bit_length()
    fx = np.fft.rfft(frames, nfft, axis=1)
    fw = np.fft.rfft(frames[:, :win_length][:, ::-1], nfft, axis=1)
    corr = np.fft.irfft(fx * fw, nfft, axis=1)
    r = corr[:, win_length - 1 : win_length + tau_max]  # r(0..tau_max)

    sq = np.cumsum(np.square(frames), axis=1)
    zero = np.zeros((n_frames, 1))
    csq = np.concatenate([zero, sq], axis=1)
    p0 = csq[:, win_length] - csq[:, 0]
    taus = np.arange(tau_max + 1)
    p_tau = csq[:, taus + win_length] - csq[:, taus]
    return p0[:, None] + p_tau - 2.0 * r


def _cmnd(d: np.ndarray) -> np.ndarray:
    """Cumulative-mean-normalised difference: d'(0)=1, d'(τ)=d(τ)·τ/Σ_{1..τ}d."""
    tau = np.arange(1, d.shape[1])
    denom = np.cumsum(d[:, 1:], axis=1)
    out = np.ones_like(d)
    with np.errstate(divide="ignore", invalid="ignore"):
        out[:, 1:] = d[:, 1:] * tau[None, :] / np.where(denom > 0, denom, np.inf)
    return out


def _parabolic_shifts(y: np.ndarray) -> np.ndarray:
    """Per-sample parabolic vertex offset of y (for trough refinement)."""
    shifts = np.zeros_like(y)
    a = y[:, :-2]
    b = y[:, 1:-1]
    c = y[:, 2:]
    denom = a - 2.0 * b + c
    with np.errstate(divide="ignore", invalid="ignore"):
        s = 0.5 * (a - c) / denom
    s = np.where(np.abs(denom) > 1e-12, s, 0.0)
    shifts[:, 1:-1] = np.clip(s, -1.0, 1.0)
    return shifts


# ---------------------------------------------------------------------------
# pYIN
# ---------------------------------------------------------------------------


def _beta_prior(n_thresholds: int, a: float, b: float) -> np.ndarray:
    """Mass of Beta(a, b) in each threshold bin (numeric CDF — no scipy)."""
    grid = np.linspace(0.0, 1.0, 20 * n_thresholds + 1)
    pdf = grid ** (a - 1.0) * (1.0 - grid) ** (b - 1.0)
    pdf[~np.isfinite(pdf)] = 0.0
    cdf = np.cumsum(pdf)
    cdf /= cdf[-1]
    edges = cdf[::20]  # CDF at 0, 1/n, …, 1
    return np.diff(edges)


def pyin(
    x: np.ndarray,
    fs: float,
    fmin: float,
    fmax: float,
    frame_length: int = 2048,
    win_length: int = None,
    hop_length: int = None,
    n_thresholds: int = 100,
    beta_parameters: Tuple[float, float] = (2.0, 18.0),
    boltzmann_parameter: float = 2.0,
    resolution: float = 0.1,
    max_transition_rate: float = 35.92,
    switch_prob: float = 0.01,
    no_trough_prob: float = 0.01,
    center: bool = True,
    jump_prob: float = 1e-4,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """→ (f0 [Hz, 0 where unvoiced-nan], voiced_flag, voiced_prob) per frame."""
    x = np.asarray(x, dtype=np.float64)
    win_length = win_length or frame_length // 2
    hop_length = hop_length or frame_length // 4
    if center:
        x = np.pad(x, frame_length // 2)

    frames = _frame(x, frame_length, hop_length)
    n_frames = len(frames)

    tau_min = max(int(np.floor(fs / fmax)), 1)
    tau_max = min(int(np.ceil(fs / fmin)), frame_length - win_length - 1)

    d = _difference_function(frames, win_length, tau_max)
    dp = _cmnd(d)
    shifts = _parabolic_shifts(dp)

    # troughs: local minima of d' within [tau_min, tau_max]
    interior = dp[:, 1:-1]
    is_trough = (interior < dp[:, :-2]) & (interior <= dp[:, 2:])
    trough_mask = np.zeros_like(dp, dtype=bool)
    trough_mask[:, 1:-1] = is_trough
    trough_mask[:, :tau_min] = False

    # pad per-frame trough lists to a rectangle
    counts = trough_mask.sum(axis=1)
    k_max = max(int(counts.max()), 1)
    taus = np.zeros((n_frames, k_max), dtype=np.int64)
    heights = np.full((n_frames, k_max), np.inf)
    for i in range(n_frames):
        tt = np.nonzero(trough_mask[i])[0]
        taus[i, : len(tt)] = tt
        heights[i, : len(tt)] = dp[i, tt]
    valid = np.isfinite(heights)

    # probabilistic thresholding: mass over troughs
    prior = _beta_prior(n_thresholds, *beta_parameters)  # [n_thresholds]
    thresholds = np.linspace(0.0, 1.0, n_thresholds + 1)[1:]
    below = heights[:, None, :] < thresholds[None, :, None]  # [F, S, K]
    rank = np.cumsum(below, axis=2) - 1
    boltz = np.exp(-rank / boltzmann_parameter) * below
    z = boltz.sum(axis=2, keepdims=True)
    boltz = np.divide(boltz, z, out=np.zeros_like(boltz), where=z > 0)
    probs = (boltz * prior[None, :, None]).sum(axis=1)  # [F, K]

    # thresholds with no trough below → global-minimum trough, damped
    any_below = below.any(axis=2)  # [F, S]
    lost = ((~any_below) * prior[None, :]).sum(axis=1)  # [F]
    gmin = np.where(valid, heights, np.inf).argmin(axis=1)
    has_trough = counts > 0
    probs[np.arange(n_frames), gmin] += np.where(has_trough, no_trough_prob * lost, 0.0)

    # candidate frequencies (parabolic-refined periods)
    periods = taus.astype(np.float64) + shifts[np.arange(n_frames)[:, None], taus]
    with np.errstate(divide="ignore"):
        cand_freq = np.where(valid & (periods > 0), fs / np.maximum(periods, 1e-9), 0.0)

    # ---------------- HMM over pitch bins × voicing ----------------
    n_bins = int(np.ceil(12.0 * np.log2(fmax / fmin) / resolution))
    bin_freqs = fmin * 2.0 ** (np.arange(n_bins) * resolution / 12.0)

    in_range = valid & (cand_freq >= fmin) & (cand_freq <= fmax)
    octaves = np.log2(np.maximum(cand_freq, 1e-9) / fmin)
    bins = np.clip((octaves * 12.0 / resolution).round().astype(np.int64), 0, n_bins - 1)

    obs_v = np.zeros((n_frames, n_bins))
    np.add.at(obs_v, (np.repeat(np.arange(n_frames), k_max)[in_range.ravel()],
                      bins.ravel()[in_range.ravel()]),
              probs.ravel()[in_range.ravel()])
    voiced_mass = np.clip(obs_v.sum(axis=1), 0.0, 1.0)
    obs_u = (1.0 - voiced_mass)[:, None] / n_bins * np.ones((1, n_bins))

    # transition band: reachable bins per frame hop
    max_jump = max(1, int(round(12.0 * max_transition_rate * hop_length / fs / resolution)))
    offsets = np.arange(-max_jump, max_jump + 1)
    tri = (max_jump + 1 - np.abs(offsets)).astype(np.float64)
    tri /= tri.sum()
    log_tri = np.log(tri)

    log_stay = np.log1p(-switch_prob)
    log_switch = np.log(switch_prob)
    neg_inf = -1e30

    with np.errstate(divide="ignore"):
        lobs_v = np.log(np.maximum(obs_v, 1e-300))
        lobs_u = np.log(np.maximum(obs_u, 1e-300))

    # Viterbi, factorised: pitch-band max ⊗ voicing switch
    delta_v = np.full(n_bins, np.log(1.0 / (2 * n_bins))) + lobs_v[0]
    delta_u = np.full(n_bins, np.log(1.0 / (2 * n_bins))) + lobs_u[0]
    ptr_v = np.zeros((n_frames, n_bins), dtype=np.int32)  # best source bin
    ptr_u = np.zeros((n_frames, n_bins), dtype=np.int32)
    ptr_vv = np.zeros((n_frames, n_bins), dtype=bool)  # came from voiced?
    ptr_uv = np.zeros((n_frames, n_bins), dtype=bool)

    # tempered transition: T = (1−jump_prob)·triangular-band + jump_prob·uniform.
    # librosa's transition is purely banded, which makes a > max_jump pitch
    # step (e.g. a hard octave cut) unreachable once the voicing probability
    # saturates — the tiny uniform floor lets sustained contrary evidence win.
    log_keep = np.log1p(-jump_prob) if jump_prob > 0 else 0.0
    log_jump = np.log(jump_prob / n_bins) if jump_prob > 0 else neg_inf

    def band_max(delta):
        """For each target bin: max over sources of delta + log T(Δ)."""
        best = np.full(n_bins, neg_inf)
        arg = np.zeros(n_bins, dtype=np.int32)
        for off, lt in zip(offsets, log_tri):
            lo, hi = max(0, -off), n_bins - max(0, off)
            if lo >= hi:
                continue
            cand = delta[lo + off : hi + off] + lt + log_keep
            seg = slice(lo, hi)
            upd = cand > best[seg]
            best[seg] = np.where(upd, cand, best[seg])
            arg[seg] = np.where(upd, np.arange(lo + off, hi + off, dtype=np.int32), arg[seg])
        if jump_prob > 0:
            g = int(delta.argmax())
            cand = delta[g] + log_jump
            upd = cand > best
            best = np.where(upd, cand, best)
            arg = np.where(upd, g, arg)
        return best, arg

    for t in range(1, n_frames):
        bv, av = band_max(delta_v)
        bu, au = band_max(delta_u)
        # to voiced
        from_v = bv + log_stay
        from_u = bu + log_switch
        take_v = from_v >= from_u
        delta_v_new = np.where(take_v, from_v, from_u) + lobs_v[t]
        ptr_v[t] = np.where(take_v, av, au)
        ptr_vv[t] = take_v
        # to unvoiced
        from_v2 = bv + log_switch
        from_u2 = bu + log_stay
        take_v2 = from_v2 >= from_u2
        delta_u_new = np.where(take_v2, from_v2, from_u2) + lobs_u[t]
        ptr_u[t] = np.where(take_v2, av, au)
        ptr_uv[t] = take_v2
        delta_v, delta_u = delta_v_new, delta_u_new

    # backtrack
    f0 = np.zeros(n_frames)
    voiced = np.zeros(n_frames, dtype=bool)
    vp = np.clip(voiced_mass, 0.0, 1.0)

    v = delta_v.max() >= delta_u.max()
    b = int((delta_v if v else delta_u).argmax())
    for t in range(n_frames - 1, -1, -1):
        voiced[t] = v
        if v:
            # refined candidate nearest the decoded bin, else bin centre
            sel = in_range[t] & (np.abs(bins[t] - b) <= 1)
            if sel.any():
                k = np.where(sel, probs[t], -1.0).argmax()
                f0[t] = cand_freq[t, k]
            else:
                f0[t] = bin_freqs[b]
        if t > 0:
            if v:
                b, v = int(ptr_v[t, b]), bool(ptr_vv[t, b])
            else:
                b, v = int(ptr_u[t, b]), bool(ptr_uv[t, b])

    return f0, voiced, vp
