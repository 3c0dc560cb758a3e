"""F0 estimation on the host: Praat's autocorrelation pitch tracker
(Boersma 1993) in numpy, the ``method=`` dispatch over the other trackers,
and the coarse mel-scale quantiser.

Counterpart of ``svc_inference_pipeline_tpu/ops/f0.py`` (``praat_pitch_ac``,
``get_f0_features``, ``f0_to_coarse``, ``get_log_f0``,
``interpolate_unvoiced`` and the ``get_f0_features_using_*`` backends). The
JAX Praat tracker is one jit region; here the framing, FFT autocorrelation
and candidate search are vectorised numpy (float64 FFTs) and the Viterbi
pass is a loop over frames. pYIN, DIO and Harvest are the numpy modules
``ops/f0_{pyin,dio,harvest}.py``, CREPE is ``ops/f0_crepe.py`` (its net on a
torch device).

Candidate selection keeps the ``max_candidates - 1`` best-ranked maxima per
frame by a stable descending sort, so ties go to the lower lag — the order
``lax.top_k`` returns.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np

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


def _hann_autocorr(n_window: int, max_lag: int) -> np.ndarray:
    """Analytic normalised autocorrelation of the Hanning window (eq. 18)."""
    x = np.arange(max_lag + 1, dtype=np.float64) / n_window
    r = (1.0 - x) * (2.0 / 3.0 + 1.0 / 3.0 * np.cos(2 * np.pi * x)) + np.sin(2 * np.pi * x) / (2 * np.pi)
    return r.astype(np.float32)


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
    n = int(np.shape(audio)[-1])
    dt = hop_length / fs
    window_dur = _PERIODS_PER_WINDOW / f0_min
    nsamp_window = 2 * (int(math.floor(window_dur * fs)) // 2)
    half_window = nsamp_window // 2
    nsamp_period = int(math.floor(fs / f0_min))
    half_period = nsamp_period // 2
    duration = n / fs
    n_frames = max(int(math.floor((duration - window_dur) / dt)) + 1, 1)
    t1 = 0.5 * duration - 0.5 * (n_frames - 1) * dt
    max_lag = int(nsamp_window * _INTERPOLATION_DEPTH)
    lag_min = max(int(math.ceil(fs / f0_max)), 2)
    nfft = _next_pow2(int(nsamp_window * (1.0 + _INTERPOLATION_DEPTH)))

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
