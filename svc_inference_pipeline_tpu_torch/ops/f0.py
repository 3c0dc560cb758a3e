"""F0 estimation: Praat's autocorrelation pitch tracker (Boersma 1993) in
numpy on the host and, with the median pitch shift, on the device (K9,
:func:`praat_f0_device`), the ``method=`` dispatch over the other trackers,
and the coarse mel-scale quantiser.

Counterpart of ``svc_inference_pipeline_tpu/ops/f0.py`` (``praat_pitch_ac``,
``get_f0_features``, ``f0_to_coarse``, ``get_log_f0``,
``interpolate_unvoiced`` and the ``get_f0_features_using_*`` backends). The
JAX Praat tracker is one jit region; here the framing, FFT autocorrelation
and candidate search are vectorised numpy (numpy's FFT of a float32 frame is
float32) and the Viterbi pass is a loop over frames. pYIN, DIO and Harvest
are the numpy modules ``ops/f0_{pyin,dio,harvest}.py``, CREPE is
``ops/f0_crepe.py`` (its net on a torch device).

Candidate selection keeps the ``max_candidates - 1`` best-ranked maxima per
frame by a stable descending sort, so ties go to the lower lag — the order
``lax.top_k`` returns.
"""

from __future__ import annotations

import ctypes
import math
from functools import lru_cache
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

_SILENCE_THRESHOLD = 0.03
_OCTAVE_COST = 0.01
_OCTAVE_JUMP_COST = 0.35
_VOICED_UNVOICED_COST = 0.14
_MAX_CANDIDATES = 15
_PERIODS_PER_WINDOW = 3.0
_INTERPOLATION_DEPTH = 0.5


def _next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


def _hann_window_praat(n: int) -> np.ndarray:
    i = np.arange(1, n + 1, dtype=np.float64)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * i / (n + 1))).astype(np.float32)


def _hann_autocorr(n_window: int, max_lag: int, dtype=np.float32) -> np.ndarray:
    """Analytic normalised autocorrelation of the Hanning window (eq. 18)."""
    x = np.arange(max_lag + 1, dtype=np.float64) / n_window
    r = (1.0 - x) * (2.0 / 3.0 + 1.0 / 3.0 * np.cos(2 * np.pi * x)) + np.sin(2 * np.pi * x) / (2 * np.pi)
    return r.astype(dtype)


class PraatGrid(NamedTuple):
    """The tracker's frame geometry at (fs, hop, f0_min, f0_max): a window of
    three longest periods, lags up to half of it."""

    fs: int
    dt: float
    window_dur: float
    nsamp_window: int
    half_window: int
    nsamp_period: int
    half_period: int
    max_lag: int
    lag_min: int
    f0_min: float
    f0_max: float


def praat_grid(fs: int, hop_length: int, f0_min: float, f0_max: float) -> PraatGrid:
    window_dur = _PERIODS_PER_WINDOW / f0_min
    nsamp_window = 2 * (int(math.floor(window_dur * fs)) // 2)
    nsamp_period = int(math.floor(fs / f0_min))
    return PraatGrid(fs, hop_length / fs, window_dur, nsamp_window, nsamp_window // 2, nsamp_period,
                     nsamp_period // 2, int(nsamp_window * _INTERPOLATION_DEPTH),
                     max(int(math.ceil(fs / f0_max)), 2), f0_min, f0_max)


def praat_frames(n: int, grid: PraatGrid) -> Tuple[int, float]:
    """(frames, centre of the first in seconds) of ``n`` samples: Praat's
    grid centred in the signal, floor((dur - window_dur) / dt) + 1 frames."""
    duration = n / grid.fs
    n_frames = max(int(math.floor((duration - grid.window_dur) / grid.dt)) + 1, 1)
    return n_frames, 0.5 * duration - 0.5 * (n_frames - 1) * grid.dt


def praat_pitch_ac(
    audio: np.ndarray,
    fs: int,
    hop_length: int,
    f0_min: float,
    f0_max: float,
    voicing_threshold: float = 0.45,
    silence_threshold: float = _SILENCE_THRESHOLD,
    octave_cost: float = _OCTAVE_COST,
    octave_jump_cost: float = _OCTAVE_JUMP_COST,
    voiced_unvoiced_cost: float = _VOICED_UNVOICED_COST,
    max_candidates: int = _MAX_CANDIDATES,
) -> np.ndarray:
    """F0 track [n_frames] of a mono waveform (0 = unvoiced), Praat's centred
    frame grid: n_frames = floor((dur - window_dur) / dt) + 1."""
    grid = praat_grid(fs, hop_length, f0_min, f0_max)
    dt, nsamp_window, half_window = grid.dt, grid.nsamp_window, grid.half_window
    nsamp_period, half_period, max_lag, lag_min = grid.nsamp_period, grid.half_period, grid.max_lag, grid.lag_min
    nfft = _next_pow2(int(nsamp_window * (1.0 + _INTERPOLATION_DEPTH)))
    n_frames, t1 = praat_frames(int(np.shape(audio)[-1]), grid)

    x = np.asarray(audio, dtype=np.float32)
    global_peak = np.max(np.abs(x - np.mean(x))) + 1e-30

    centers = np.round((t1 + np.arange(n_frames) * dt) * fs).astype(np.int64)
    pad = nsamp_window
    xp = np.pad(x, (pad, pad))
    frames = xp[centers[:, None] - half_window + np.arange(nsamp_window)[None, :] + pad]
    mean_idx = (centers[:, None] - nsamp_period) + np.arange(2 * nsamp_period)[None, :] + pad
    local_mean = np.mean(xp[mean_idx], axis=-1, keepdims=True)
    fw = (frames - local_mean) * _hann_window_praat(nsamp_window)[None, :]

    lo = max(half_window - half_period, 0)
    hi = min(half_window + half_period, nsamp_window)
    intensity = np.minimum(np.max(np.abs(fw[:, lo:hi]), axis=-1) / global_peak, 1.0)

    spec = np.fft.rfft(fw, n=nfft, axis=-1)
    ac = np.fft.irfft(spec * np.conj(spec), n=nfft, axis=-1)[:, : max_lag + 1]
    r = ac / (ac[:, :1] + 1e-30)
    r = r / _hann_autocorr(nsamp_window, max_lag)[None, :]

    # masked lanes may divide by zero; np.where discards them
    with np.errstate(divide="ignore", invalid="ignore"):
        rm1, r0, rp1 = r[:, :-2], r[:, 1:-1], r[:, 2:]
        lags = np.arange(1, max_lag, dtype=np.float64)
        is_peak = (r0 > rm1) & (r0 >= rp1) & (lags >= lag_min)[None, :]
        denom = rm1 - 2.0 * r0 + rp1
        shift = np.where(np.abs(denom) > 1e-12, 0.5 * (rm1 - rp1) / denom, 0.0)
        shift = np.clip(shift, -0.5, 0.5)
        lag_star = lags[None, :] + shift
        r_star = r0 - 0.25 * (rm1 - rp1) * shift
        r_star = np.where(r_star > 1.0, 1.0 / r_star, r_star)
        freq = fs / lag_star
        valid = is_peak & (freq <= f0_max) & (freq > 0)
        rank = np.where(valid, r_star - octave_cost * np.log2(f0_min * lag_star / fs), -np.inf)

        top_idx = np.argsort(-rank, axis=-1, kind="stable")[:, : max_candidates - 1]
        top_rank = np.take_along_axis(rank, top_idx, axis=-1)
        cand_valid = np.isfinite(top_rank)
        cand_freq = np.where(cand_valid, np.take_along_axis(freq, top_idx, axis=-1), 0.0)
        cand_r = np.take_along_axis(r_star, top_idx, axis=-1)

        unvoiced = voicing_threshold + np.maximum(
            0.0, 2.0 - intensity * (1.0 + voicing_threshold) / silence_threshold
        )
        voiced = np.where(
            cand_valid, cand_r - octave_cost * np.log2(f0_max / np.maximum(cand_freq, 1e-6)), -np.inf
        )
    local = np.concatenate([unvoiced[:, None], voiced], axis=-1)  # [F, K]
    freqs_all = np.concatenate([np.zeros_like(cand_freq[:, :1]), cand_freq], axis=-1)

    time_step_correction = 0.01 / dt
    ojc = octave_jump_cost * time_step_correction
    vuc = voiced_unvoiced_cost * time_step_correction

    def transition_cost(f_prev, f_cur):
        pv = f_prev[:, None] > 0
        cv = f_cur[None, :] > 0
        jump = ojc * np.abs(np.log2(np.maximum(f_prev[:, None], 1e-6) / np.maximum(f_cur[None, :], 1e-6)))
        return np.where(pv & cv, jump, np.where(pv == cv, 0.0, vuc))

    # Viterbi: forward pass keeping back-pointers, then the backtrace
    score = local[0]
    backptr = np.zeros((n_frames, local.shape[1]), dtype=np.int64)
    for t in range(1, n_frames):
        total = score[:, None] - transition_cost(freqs_all[t - 1], freqs_all[t]) + local[t][None, :]
        backptr[t] = np.argmax(total, axis=0)
        score = np.max(total, axis=0)
    states = np.zeros(n_frames, dtype=np.int64)
    states[-1] = int(np.argmax(score))
    for t in range(n_frames - 1, 0, -1):
        states[t - 1] = backptr[t, states[t]]
    return freqs_all[np.arange(n_frames), states].astype(np.float32)


# ---------------------------------------------------------------------------
# The same tracker and the median shift on the device (K9, csrc/f0.cu)
# ---------------------------------------------------------------------------

VOICING_THRESHOLD = 0.6  # get_f0_features' Praat voicing threshold
MAX_CLIPS = 64  # clips a K9 call (csrc/f0.cu); larger batches take several calls
K = _MAX_CANDIDATES  # Viterbi states: unvoiced + 14 peaks
KS = 16  # state stride of K9's candidate rows


def _clip_grids(n_samples: Sequence[int], n_frames: Sequence[int], grid: PraatGrid, hop: int):
    """Per clip: (Praat frames, first centre, left padding onto the mel grid),
    as ``get_f0_features`` computes them; refuses a clip it would refuse."""
    if len(n_samples) != len(n_frames) or not n_samples:
        raise ValueError(f"need one frame count per clip and at least one clip: {len(n_samples)} clips, "
                         f"{len(n_frames)} frame counts")
    out = []
    for n, m in zip(n_samples, n_frames):
        if m < 1 or n < 1:
            raise ValueError(f"clip too short for F0 extraction: {n} samples -> {m} mel frames (need at least "
                             f"one hop of {hop} samples)")
        nf, t1 = praat_frames(n, grid)
        out.append((nf, t1, (n // hop - nf + 1) // 2))
    return out


@lru_cache(maxsize=None)
def _tables(nsamp_window: int, max_lag: int, device: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """Praat's Hann window (float32, as the host tracker's) and its analytic
    normalised autocorrelation (float64), on ``device``, made once."""
    return (torch.as_tensor(_hann_window_praat(nsamp_window), device=device),
            torch.as_tensor(_hann_autocorr(nsamp_window, max_lag, np.float64), device=device))


def _costs(grid: PraatGrid) -> Tuple[float, float]:
    """(octave-jump, voiced-unvoiced) transition costs per frame (Praat's are per 10 ms)."""
    correction = 0.01 / grid.dt
    return _OCTAVE_JUMP_COST * correction, _VOICED_UNVOICED_COST * correction


def praat_f0_device(audios: torch.Tensor, n_samples: Sequence[int], n_frames: Sequence[int], padded: int, cfg,
                    pitch_factor: Optional[float] = None) -> torch.Tensor:
    """Melody [B, padded] float32 of the clips in ``audios`` [B, L] (float32,
    clip b in its first ``n_samples[b]`` samples): Praat's tracker as
    ``get_f0_features`` runs it (voicing threshold 0.6, padded onto each
    clip's ``n_frames[b]`` mel frames), shifted by ``pitch_shift``'s median
    factor, or by ``pitch_factor`` where given, zero past each clip's frames.

    CPU tensors run :func:`praat_f0_plain`; CUDA tensors launch K9
    (``csrc/f0.cu``, three launches a call of up to 64 clips, counted in
    ``praat_f0_device.launches``) on the current stream, which nothing
    synchronises. Both hold the autocorrelation in float64 and sum it directly
    (the host tracker takes it from a float32 FFT), so the two agree with the
    host tracker to its voicing and cents, not bit for bit. A clip in a batch
    gives the same bits as the clip alone."""
    from svc_inference_pipeline_tpu_torch.utils.artifacts import get_target_f0_median

    grid = praat_grid(cfg.fs, cfg.hop_length, float(cfg.f0_min), float(cfg.f0_max))
    n_samples, n_frames = [int(n) for n in n_samples], [int(m) for m in n_frames]
    clips = _clip_grids(n_samples, n_frames, grid, cfg.hop_length)
    if audios.dim() != 2 or audios.dtype != torch.float32 or audios.shape[0] != len(n_samples):
        raise ValueError(f"praat_f0_device: audios must be float32 [{len(n_samples)}, L], got {audios.dtype} "
                         f"{tuple(audios.shape)}")
    if max(n_samples) > audios.shape[1] or max(n_frames) > padded:
        raise ValueError(f"praat_f0_device: {max(n_samples)} samples in rows of {audios.shape[1]}, "
                         f"{max(n_frames)} frames in a melody of {padded}")
    target = None if pitch_factor is not None else get_target_f0_median(cfg.target_f0_file)
    if audios.device.type == "cpu":
        return praat_f0_plain(audios, n_samples, n_frames, padded, grid, clips, target, pitch_factor)
    from svc_inference_pipeline_tpu_torch.ops.pallas import _build

    if not audios.is_contiguous():
        raise ValueError("praat_f0_device: audios must be contiguous")
    dev = audios.device
    window, hann_ac = _tables(grid.nsamp_window, grid.max_lag, str(dev))
    ojc, vuc = _costs(grid)
    geom = (ctypes.c_int * 7)(grid.nsamp_window, grid.half_window, grid.nsamp_period,
                              max(grid.half_window - grid.half_period, 0),
                              min(grid.half_window + grid.half_period, grid.nsamp_window), grid.max_lag, grid.lag_min)
    consts = (ctypes.c_double * 8)(grid.fs, grid.dt, grid.f0_min, grid.f0_max, _OCTAVE_COST, ojc, vuc,
                                   target or 0.0)
    fconsts = (ctypes.c_float * 4)(VOICING_THRESHOLD, 1.0 + VOICING_THRESHOLD, _SILENCE_THRESHOLD,
                                   pitch_factor or 0.0)
    melody = torch.empty((len(n_samples), padded), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for s in range(0, len(n_samples), MAX_CLIPS):
        part = range(s, min(s + MAX_CLIPS, len(n_samples)))
        b, f = len(part), max(clips[i][0] for i in part)
        # scratch: gpeak [b] | local, lf [b, f, KS] f64 | freq [b, f, KS] f32 | back [b, f, KS] u8 | track [b, f]
        sizes = (4 * b, 8 * b * f * KS, 8 * b * f * KS, 4 * b * f * KS, b * f * KS, 4 * b * f)
        offs = np.cumsum((0,) + tuple(-(-n // 256) * 256 for n in sizes))
        scratch = torch.empty(int(offs[-1]), dtype=torch.uint8, device=dev)
        ptrs = [scratch.data_ptr() + int(o) for o in offs[:-1]]
        status = _build.lib().svc_praat_f0(
            audios[s].data_ptr(), b, audios.shape[1], (ctypes.c_int * b)(*(n_samples[i] for i in part)),
            (ctypes.c_int * b)(*(clips[i][0] for i in part)), (ctypes.c_double * b)(*(clips[i][1] for i in part)),
            (ctypes.c_int * b)(*(clips[i][2] for i in part)), (ctypes.c_int * b)(*(n_frames[i] for i in part)),
            f, padded, window.data_ptr(), hann_ac.data_ptr(), geom, consts, fconsts, int(pitch_factor is not None),
            *ptrs, melody[s].data_ptr(), stream)
        _build.check(status, "svc_praat_f0")
        praat_f0_device.launches += 3
    return melody


praat_f0_device.launches = 0


def praat_f0_plain(audios: torch.Tensor, n_samples: Sequence[int], n_frames: Sequence[int], padded: int,
                   grid: PraatGrid, clips, target: Optional[float], pitch_factor: Optional[float]) -> torch.Tensor:
    """Plain PyTorch version of K9 on CPU tensors (see :func:`praat_f0_device`):
    clip by clip, the float32 framing, the direct float64 autocorrelation, the
    candidates and the Viterbi of the kernel, in its order of operations where
    it rounds."""
    melody = torch.zeros((len(n_samples), padded), dtype=torch.float32)
    for b, (n, n_mel, (nf, t1, pad)) in enumerate(zip(n_samples, n_frames, clips)):
        local, freqs = _candidates_plain(audios[b, :n], grid, nf, t1)
        track = _viterbi_plain(local, freqs, *_costs(grid))
        f0 = torch.zeros(n_mel, dtype=torch.float32)
        lo, hi = max(pad, 0), min(n_mel, pad + nf)
        if hi > lo:
            f0[lo:hi] = track[lo - pad: hi - pad]
        melody[b, :n_mel] = shift_plain(f0, target, pitch_factor)
    return melody


def shift_plain(f0: torch.Tensor, target: Optional[float], pitch_factor: Optional[float]) -> torch.Tensor:
    """``f0`` [n] float32 times ``pitch_factor``, or times target / its voiced
    median (numpy's: the mean of the two middle values for an even count, in
    float32), the factor rounded to float32; unchanged without a voiced
    frame. ``utils.artifacts.pitch_shift``'s arithmetic, which K9 repeats."""
    factor = pitch_factor
    if factor is None:
        voiced = torch.sort(f0[f0 != 0]).values
        c = voiced.numel()
        if not c:
            return f0.clone()
        med = voiced[c // 2] if c % 2 else (voiced[c // 2 - 1] + voiced[c // 2]) * 0.5
        factor = target / float(med)
    return f0 * torch.tensor(factor, dtype=torch.float32)


def _candidates_plain(x: torch.Tensor, grid: PraatGrid, n_frames: int, t1: float):
    """(local strengths [F, 15], frequencies [F, 15]) float64 of one clip; the
    unvoiced candidate first, then the 14 best peaks (-inf, 0 past them)."""
    f32, f64 = torch.float32, torch.float64
    x = x.to(f32)
    w, hw, period = grid.nsamp_window, grid.half_window, grid.nsamp_period
    mean = (x.double().sum() / x.numel()).to(f32)
    global_peak = (x - mean).abs().max() + 1e-30
    centers = torch.round((torch.arange(n_frames, dtype=f64) * grid.dt + t1) * grid.fs).long()
    xp = F.pad(x, (w, w))
    frames = xp[centers[:, None] - hw + torch.arange(w) + w]
    local_mean = (xp[centers[:, None] - period + torch.arange(2 * period) + w].double().sum(-1)
                  / (2 * period)).to(f32)
    window, hann_ac = _tables(w, grid.max_lag, "cpu")
    fw = (frames - local_mean[:, None]) * window
    lo, hi = max(hw - grid.half_period, 0), min(hw + grid.half_period, w)
    intensity = torch.minimum(fw[:, lo:hi].abs().amax(-1) / global_peak, torch.tensor(1.0))
    fwd = fw.double()
    # direct linear autocorrelation, lags 0..max_lag: each frame correlated with itself
    ac = F.conv1d(F.pad(fwd, (0, grid.max_lag))[None], fwd[:, None, :], groups=n_frames)[0]
    r = ac / (ac[:, :1] + 1e-30) / hann_ac
    rm1, r0, rp1 = r[:, :-2], r[:, 1:-1], r[:, 2:]
    lags = torch.arange(1, grid.max_lag, dtype=f64)
    is_peak = (r0 > rm1) & (r0 >= rp1) & (lags >= grid.lag_min)
    denom = rm1 - 2.0 * r0 + rp1
    shift = torch.where(denom.abs() > 1e-12, 0.5 * (rm1 - rp1) / denom, torch.zeros_like(denom)).clamp(-0.5, 0.5)
    lag_star = lags + shift
    r_star = r0 - 0.25 * (rm1 - rp1) * shift
    r_star = torch.where(r_star > 1.0, 1.0 / r_star, r_star)
    freq = torch.full_like(lag_star, float(grid.fs)) / lag_star
    valid = is_peak & (freq <= grid.f0_max) & (freq > 0)
    rank = torch.where(valid, r_star - _OCTAVE_COST * torch.log2(grid.f0_min * lag_star / grid.fs), -math.inf)
    top = torch.sort(rank, dim=-1, descending=True, stable=True).indices[:, : K - 1]
    cand_valid = torch.isfinite(rank.gather(-1, top))
    cand_freq = torch.where(cand_valid, freq.gather(-1, top), 0.0)
    voiced = torch.where(cand_valid, r_star.gather(-1, top) - _OCTAVE_COST * torch.log2(
        torch.full_like(cand_freq, grid.f0_max) / cand_freq.clamp_min(1e-6)), -math.inf)
    drop = intensity * (1.0 + VOICING_THRESHOLD) / _SILENCE_THRESHOLD
    unvoiced = VOICING_THRESHOLD + torch.clamp_min(2.0 - drop, 0.0)
    local = torch.cat([unvoiced.double()[:, None], voiced], -1)
    return local, torch.cat([torch.zeros_like(cand_freq[:, :1]), cand_freq], -1)


def _viterbi_plain(local: torch.Tensor, freqs: torch.Tensor, ojc: float, vuc: float) -> torch.Tensor:
    """The best path's F0 [F] float32: float64 scores, transitions from the
    log2 frequencies, argmax ties to the lowest previous state."""
    lf = torch.log2(freqs)  # -inf: unvoiced, or no candidate
    voiced = torch.isfinite(lf)
    score = local[0]
    back = torch.zeros(local.shape, dtype=torch.long)
    for t in range(1, local.shape[0]):
        pv, cv = voiced[t - 1][:, None], voiced[t][None, :]
        jump = ojc * (lf[t - 1][:, None] - lf[t][None, :]).abs()
        cost = torch.where(pv & cv, jump, torch.where(pv == cv, 0.0, vuc))
        total = (score[:, None] - cost) + local[t][None, :]
        back[t] = torch.argmax(total, dim=0)
        score = total.amax(0)
    states = torch.zeros(local.shape[0], dtype=torch.long)
    states[-1] = torch.argmax(score)
    for t in range(local.shape[0] - 1, 0, -1):
        states[t - 1] = back[t, states[t]]
    return freqs[torch.arange(local.shape[0]), states].float()


METHODS = ("parselmouth", "ac", "dio", "pyin", "harvest")


def get_f0_features(audio: np.ndarray, mel_len: int, cfg, speed: int = 1,
                    method: str = "parselmouth") -> Tuple[np.ndarray, np.ndarray]:
    """(f0 [mel_len], coarse pitch [mel_len]). ``parselmouth``/``ac``: Praat's
    tracker with voicing threshold 0.6 and the centred padding onto the mel
    frame grid; ``dio``, ``pyin`` and ``harvest``: their tracks at the same
    hop, zero-padded at the end (pYIN's also cut) to ``mel_len``. CREPE is
    called through :func:`get_f0_features_using_crepe`."""
    if method not in METHODS:
        raise NotImplementedError(
            f"F0 method {method!r}: 'parselmouth' (Praat ac), 'dio', 'pyin' and 'harvest' are "
            "implemented natively; 'crepe' needs its trained checkpoint (see ops/f0_crepe.py) and is "
            "called via get_f0_features_using_crepe."
        )
    if mel_len < 1 or len(np.asarray(audio)) < 1:
        raise ValueError(
            f"clip too short for F0 extraction: {len(np.asarray(audio))} samples -> "
            f"{mel_len} mel frames (need at least one hop of {cfg.hop_length} samples)"
        )
    hop_size = int(np.round(cfg.hop_length * speed))
    f0_min, f0_max = float(cfg.f0_min), float(cfg.f0_max)
    if method in ("dio", "harvest", "pyin"):
        if method == "pyin":
            f0 = get_f0_features_using_pyin(audio, cfg.fs, cfg.win_length, hop_size, f0_min, f0_max)
        else:
            backend = get_f0_features_using_dio if method == "dio" else get_f0_features_using_harvest
            f0 = backend(audio, mel_len, cfg.fs, hop_size, f0_min, f0_max)
        f0 = np.pad(f0, (0, max(0, mel_len - len(f0))))[:mel_len]
        return f0, f0_to_coarse(f0, cfg.pitch_bin, cfg.pitch_min, cfg.pitch_max)
    f0 = praat_pitch_ac(np.asarray(audio), cfg.fs, hop_size, f0_min, f0_max, voicing_threshold=0.6)
    pad_size = (int(len(audio) // hop_size) - len(f0) + 1) // 2
    total = mel_len - len(f0) - pad_size
    if total < 0:
        f0 = f0[: mel_len - pad_size]
        total = 0
    f0 = np.pad(f0, [[pad_size, total]], mode="constant")
    return f0, f0_to_coarse(f0, cfg.pitch_bin, cfg.pitch_min, cfg.pitch_max)


def f0_to_coarse(f0: np.ndarray, pitch_bin: int, pitch_min: float, pitch_max: float) -> np.ndarray:
    """Mel-scale quantisation of F0 to [1, pitch_bin-1]; 0 Hz stays in bin 1."""
    f0_mel_min = 1127.0 * np.log(1.0 + pitch_min / 700.0)
    f0_mel_max = 1127.0 * np.log(1.0 + pitch_max / 700.0)
    f0_mel = 1127.0 * np.log(1.0 + np.asarray(f0, dtype=np.float64) / 700.0)
    f0_mel = np.where(f0_mel > 0, (f0_mel - f0_mel_min) * (pitch_bin - 2) / (f0_mel_max - f0_mel_min) + 1.0,
                      f0_mel)
    return np.rint(np.clip(f0_mel, 1.0, pitch_bin - 1)).astype(np.int64)


def get_log_f0(f0: np.ndarray) -> np.ndarray:
    """log-F0 with unvoiced frames mapped to log(1) = 0."""
    f0 = np.array(f0, dtype=np.float64)
    f0[f0 == 0] = 1.0
    return np.log(f0)


def get_f0_features_using_pyin(audio, fs, win_length, hop_length, f0_min, f0_max) -> np.ndarray:
    """pYIN (``ops/f0_pyin.py``) with librosa.pyin's parameters; unvoiced
    frames (nan in librosa) are 0."""
    from svc_inference_pipeline_tpu_torch.ops.f0_pyin import pyin

    f0, voiced, _ = pyin(np.asarray(audio, dtype=np.float64), fs=fs, fmin=float(f0_min), fmax=float(f0_max),
                         win_length=int(win_length), hop_length=int(hop_length))
    f0 = f0.astype(np.float64)
    f0[~voiced] = 0.0
    return f0


def get_f0_features_using_dio(audio, mel_len, fs, hop_length, f0_min, f0_max) -> np.ndarray:
    """DIO + StoneMask (``ops/f0_dio.py``): channels_in_octave 2, frame period
    1000 hop / fs ms, cut to ``mel_len``."""
    from svc_inference_pipeline_tpu_torch.ops.f0_dio import dio, stonemask

    x = np.asarray(audio, dtype=np.float64)
    raw, t = dio(x, fs, f0_floor=float(f0_min), f0_ceil=float(f0_max), channels_in_octave=2.0,
                 frame_period=1000.0 * hop_length / fs)
    return stonemask(x, raw, t, fs).astype(np.float64)[:mel_len]


def get_f0_features_using_harvest(audio, mel_len, fs, hop_length, f0_min, f0_max) -> np.ndarray:
    """Harvest (``ops/f0_harvest.py``): frame period 1000 hop / fs ms, cut to
    ``mel_len``."""
    from svc_inference_pipeline_tpu_torch.ops.f0_harvest import harvest

    f0, _ = harvest(np.asarray(audio, dtype=np.float64), fs, f0_floor=float(f0_min), f0_ceil=float(f0_max),
                    frame_period=1000.0 * hop_length / fs)
    return f0.astype(np.float64)[:mel_len]


def get_f0_features_using_crepe(audio, mel_len, fs, hop_length, hop_length_new, f0_min, f0_max,
                                threshold=0.3, **kw) -> np.ndarray:
    """CREPE (``ops/f0_crepe.py``): the net on a torch device (``device=``,
    default the GPU), then Viterbi decode, periodicity median filter, -60 dB
    silence gate, threshold, mean filter and interpolation of the voiced
    frames onto the mel grid. The trained weights come from ``params=`` or
    the torchcrepe file named by ``SVC_CREPE_WEIGHTS``."""
    from svc_inference_pipeline_tpu_torch.ops.f0_crepe import get_f0_features_using_crepe as impl

    return impl(audio, mel_len, fs, hop_length, hop_length_new, f0_min, f0_max, threshold, **kw)


def get_f0_features_using_parselmouth(audio, mel_len, cfg, speed=1) -> Tuple[np.ndarray, np.ndarray]:
    """The Praat tracker under the reference's name."""
    return get_f0_features(np.asarray(audio), mel_len, cfg, speed=speed)


def interpolate_unvoiced(f0: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Linear interpolation across unvoiced gaps; returns (f0, uv mask) with
    the mask eroded by a 3-tap minimum."""
    f0 = np.array(f0, dtype=np.float64)
    uv = f0 == 0
    if (~uv).any():
        f0[uv] = np.interp(np.where(uv)[0], np.where(~uv)[0], f0[~uv])
        uvf = uv.astype(np.float64)
        uvf = np.min(np.array([uvf[:-2], uvf[1:-1], uvf[2:]]), axis=0)
        return f0, np.pad(uvf, (1, 1))
    return f0, uv.astype(np.float64)
