"""Signal processing of the plain reference: WAV decode and encode, Praat
F0 with the median shift to the target singer, the mel energy, the 24 ->
16 kHz resample, Whisper's log-mel and the 480 -> 256 hop remap.

Plain numpy and PyTorch, written from the reference system's definitions
(Praat's autocorrelation tracker, librosa's slaney filterbank, resampy's
kaiser_best filter, OpenAI Whisper's log-mel). It imports nothing of the
program: the Praat tracker is a frozen copy of the one the program runs on
the host, everything else is written anew.
"""

from __future__ import annotations

import math
import struct

import numpy as np
import torch
import torch.nn.functional as F

WHISPER_SR, WHISPER_N_FFT, WHISPER_HOP, WHISPER_MELS = 16000, 400, 160, 80
WINDOW_SAMPLES = 30 * WHISPER_SR  # one 30 s Whisper window
WINDOW_FRAMES = 1500  # encoder frames per window (20 ms)
REMAP_SRC, REMAP_TGT = 15, 8  # 480 / 256 reduced by their gcd


# ---------------------------------------------------------------------------
# WAV
# ---------------------------------------------------------------------------


def wav_pcm16(data: bytes) -> np.ndarray:
    """The int16 samples of a 16-bit PCM RIFF/WAVE byte string (the first
    channel of a multi-channel file)."""
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError("not a RIFF/WAVE byte string")
    pos, fmt, body = 12, None, None
    while pos + 8 <= len(data):
        cid, size = data[pos:pos + 4], struct.unpack_from("<I", data, pos + 4)[0]
        if cid == b"fmt ":
            fmt = struct.unpack_from("<HHIIHH", data, pos + 8)
        elif cid == b"data":
            body = data[pos + 8:pos + 8 + size]
        pos += 8 + size + (size & 1)
    if fmt is None or body is None or fmt[0] != 1 or fmt[5] != 16:
        raise ValueError("expected a 16-bit PCM WAV")
    return np.frombuffer(body, dtype="<i2").reshape(-1, fmt[1])[:, 0]


def decode_wav(data: bytes) -> np.ndarray:
    """Mono float32 samples of a 16-bit PCM WAV, scaled by 1/32768 (the
    reader's rule for integer samples)."""
    return wav_pcm16(data).astype(np.float32) / np.float32(32768.0)


def encode_wav(wave: np.ndarray, fs: int, volume_peak: float = 0.9) -> np.ndarray:
    """The int16 samples the server writes for a float waveform: peak
    normalised to ``volume_peak``, 50 ms of silence on each side, rounded
    and clipped."""
    wav = np.asarray(wave, dtype=np.float32)
    peak = max(float(wav.max()), abs(float(wav.min())))
    if peak > 0:
        wav = wav * (volume_peak / peak)
    silence = np.zeros((fs // 20,), dtype=wav.dtype)
    wav = np.concatenate([silence, wav, silence])
    return np.clip(np.round(wav * 32767.0), -32768, 32767).astype(np.int16)


def wav_bytes(pcm: np.ndarray, fs: int) -> bytes:
    """A mono 16-bit PCM WAV byte string of int16 samples."""
    body = np.asarray(pcm, dtype="<i2").tobytes()
    return (b"RIFF" + struct.pack("<I", 36 + len(body)) + b"WAVE" + b"fmt "
            + struct.pack("<IHHIIHH", 16, 1, 1, fs, 2 * fs, 2, 16) + b"data"
            + struct.pack("<I", len(body)) + body)


# ---------------------------------------------------------------------------
# F0: Praat's autocorrelation tracker (Boersma 1993), frozen copy
# ---------------------------------------------------------------------------


def _hann_praat(n: int) -> np.ndarray:
    i = np.arange(1, n + 1, dtype=np.float64)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * i / (n + 1))).astype(np.float32)


def _hann_autocorr(n_window: int, max_lag: int) -> np.ndarray:
    x = np.arange(max_lag + 1, dtype=np.float64) / n_window
    r = (1.0 - x) * (2.0 / 3.0 + 1.0 / 3.0 * np.cos(2 * np.pi * x)) + np.sin(2 * np.pi * x) / (2 * np.pi)
    return r.astype(np.float32)


def praat_f0(audio: np.ndarray, fs: int, hop: int, f0_min: float, f0_max: float,
             voicing_threshold: float = 0.6, silence_threshold: float = 0.03, octave_cost: float = 0.01,
             octave_jump_cost: float = 0.35, voiced_unvoiced_cost: float = 0.14,
             max_candidates: int = 15) -> np.ndarray:
    """F0 track (0 = unvoiced) on Praat's centred frame grid."""
    n = len(audio)
    dt = hop / fs
    window_dur = 3.0 / f0_min
    nsamp_window = 2 * (int(math.floor(window_dur * fs)) // 2)
    half_window = nsamp_window // 2
    nsamp_period = int(math.floor(fs / f0_min))
    half_period = nsamp_period // 2
    duration = n / fs
    n_frames = max(int(math.floor((duration - window_dur) / dt)) + 1, 1)
    t1 = 0.5 * duration - 0.5 * (n_frames - 1) * dt
    max_lag = int(nsamp_window * 0.5)
    lag_min = max(int(math.ceil(fs / f0_max)), 2)
    nfft = 1 << (int(nsamp_window * 1.5) - 1).bit_length()
    x = np.asarray(audio, dtype=np.float32)
    global_peak = np.max(np.abs(x - np.mean(x))) + 1e-30
    centers = np.round((t1 + np.arange(n_frames) * dt) * fs).astype(np.int64)
    pad = nsamp_window
    xp = np.pad(x, (pad, pad))
    frames = xp[centers[:, None] - half_window + np.arange(nsamp_window)[None, :] + pad]
    mean_idx = (centers[:, None] - nsamp_period) + np.arange(2 * nsamp_period)[None, :] + pad
    local_mean = np.mean(xp[mean_idx], axis=-1, keepdims=True)
    fw = (frames - local_mean) * _hann_praat(nsamp_window)[None, :]
    lo, hi = max(half_window - half_period, 0), min(half_window + half_period, nsamp_window)
    intensity = np.minimum(np.max(np.abs(fw[:, lo:hi]), axis=-1) / global_peak, 1.0)
    spec = np.fft.rfft(fw, n=nfft, axis=-1)
    ac = np.fft.irfft(spec * np.conj(spec), n=nfft, axis=-1)[:, : max_lag + 1]
    r = ac / (ac[:, :1] + 1e-30)
    r = r / _hann_autocorr(nsamp_window, max_lag)[None, :]
    with np.errstate(divide="ignore", invalid="ignore"):
        rm1, r0, rp1 = r[:, :-2], r[:, 1:-1], r[:, 2:]
        lags = np.arange(1, max_lag, dtype=np.float64)
        is_peak = (r0 > rm1) & (r0 >= rp1) & (lags >= lag_min)[None, :]
        denom = rm1 - 2.0 * r0 + rp1
        shift = np.clip(np.where(np.abs(denom) > 1e-12, 0.5 * (rm1 - rp1) / denom, 0.0), -0.5, 0.5)
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
        unvoiced = voicing_threshold + np.maximum(0.0, 2.0 - intensity * (1.0 + voicing_threshold)
                                                  / silence_threshold)
        voiced = np.where(cand_valid, cand_r - octave_cost * np.log2(f0_max / np.maximum(cand_freq, 1e-6)),
                          -np.inf)
    local = np.concatenate([unvoiced[:, None], voiced], axis=-1)
    freqs_all = np.concatenate([np.zeros_like(cand_freq[:, :1]), cand_freq], axis=-1)
    ojc = octave_jump_cost * 0.01 / dt
    vuc = voiced_unvoiced_cost * 0.01 / dt

    def transition(f_prev, f_cur):
        pv, cv = f_prev[:, None] > 0, f_cur[None, :] > 0
        jump = ojc * np.abs(np.log2(np.maximum(f_prev[:, None], 1e-6) / np.maximum(f_cur[None, :], 1e-6)))
        return np.where(pv & cv, jump, np.where(pv == cv, 0.0, vuc))

    score = local[0]
    back = np.zeros((n_frames, local.shape[1]), dtype=np.int64)
    for t in range(1, n_frames):
        total = score[:, None] - transition(freqs_all[t - 1], freqs_all[t]) + local[t][None, :]
        back[t] = np.argmax(total, axis=0)
        score = np.max(total, axis=0)
    states = np.zeros(n_frames, dtype=np.int64)
    states[-1] = int(np.argmax(score))
    for t in range(n_frames - 1, 0, -1):
        states[t - 1] = back[t, states[t]]
    return freqs_all[np.arange(n_frames), states].astype(np.float32)


def f0_on_mel_grid(audio: np.ndarray, n_frames: int, cfg: dict) -> np.ndarray:
    """Praat F0 padded (centred) onto ``n_frames`` mel frames."""
    hop = int(cfg["hop_length"])
    f0 = praat_f0(audio, int(cfg["fs"]), hop, float(cfg["f0_min"]), float(cfg["f0_max"]))
    pad = (len(audio) // hop - len(f0) + 1) // 2
    total = n_frames - len(f0) - pad
    if total < 0:
        f0, total = f0[: n_frames - pad], 0
    return np.pad(f0, [[pad, total]], mode="constant")


def shift_to_target(f0: np.ndarray, target_median: float) -> np.ndarray:
    """Scale F0 so its voiced median is the target singer's."""
    voiced = f0[f0 != 0]
    if voiced.size == 0:
        return f0
    return f0 * (target_median / float(np.median(voiced)))


# ---------------------------------------------------------------------------
# Spectral front-end
# ---------------------------------------------------------------------------


def _hz_to_mel(f):
    f = np.asanyarray(f, dtype=np.float64)
    lin = f / (200.0 / 3)
    return np.where(f >= 1000.0, 15.0 + np.log(np.maximum(f, 1000.0) / 1000.0) / (np.log(6.4) / 27.0), lin)


def _mel_to_hz(m):
    m = np.asanyarray(m, dtype=np.float64)
    return np.where(m >= 15.0, 1000.0 * np.exp((np.log(6.4) / 27.0) * (m - 15.0)), m * (200.0 / 3))


def slaney_filterbank(sr: int, n_fft: int, n_mels: int, fmin: float = 0.0, fmax=None) -> np.ndarray:
    """librosa.filters.mel (slaney scale and norm) [n_mels, 1 + n_fft // 2]."""
    fmax = sr / 2.0 if fmax is None else fmax
    fft_f = np.linspace(0.0, sr / 2.0, 1 + n_fft // 2)
    mel_f = _mel_to_hz(np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax), n_mels + 2))
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fft_f[None, :]
    w = np.maximum(0.0, np.minimum(-ramps[:-2] / fdiff[:-1, None], ramps[2:] / fdiff[1:, None]))
    w *= (2.0 / (mel_f[2:n_mels + 2] - mel_f[:n_mels]))[:, None]
    return w.astype(np.float32)


def _periodic_hann(n: int, device) -> torch.Tensor:
    return torch.hann_window(n, periodic=True, dtype=torch.float32, device=device)


def mel_spectrum(audio: torch.Tensor, cfg: dict) -> torch.Tensor:
    """Mel magnitudes [n_mels, T] of a 24 kHz waveform [L]: reflect padding
    (n_fft - hop) / 2, Hann frames (center off), sqrt(re^2 + im^2 + 1e-9),
    the slaney filterbank."""
    n_fft, hop, win = int(cfg["n_fft"]), int(cfg["hop_length"]), int(cfg["win_length"])
    pad = (n_fft - hop) // 2
    y = F.pad(audio[None, None], (pad, pad), mode="reflect")[0, 0]
    spec = torch.stft(y, n_fft, hop, win, window=_periodic_hann(win, audio.device), center=False,
                      return_complex=True)
    mag = torch.sqrt(spec.real ** 2 + spec.imag ** 2 + 1e-9)
    basis = torch.as_tensor(slaney_filterbank(int(cfg["fs"]), n_fft, int(cfg["n_mels"]), float(cfg["fmin"]),
                                              float(cfg["fmax"])), device=audio.device)
    return basis @ mag


def mel_energy(audio: torch.Tensor, cfg: dict) -> torch.Tensor:
    """Frame energy [T] of a 24 kHz waveform [L]: sqrt of the summed squared
    mel magnitudes, the mel taken as exp(log(clamp(mel, 1e-5)))."""
    mel = torch.clamp(mel_spectrum(audio, cfg), min=1e-5)
    return torch.sqrt(torch.sum(mel ** 2, dim=0))


def resample_24k_to_16k(audio: torch.Tensor) -> torch.Tensor:
    """resampy's kaiser_best windowed-sinc filter at the two phases of a
    2/3 rate change: [L] -> [ceil(2L/3)]."""
    num_zeros, beta, rolloff = 64, 14.769656459379492, 0.9475937167399596
    up, down = 2, 3
    scale = up / down
    half = int(math.ceil(num_zeros / scale))
    offsets = np.arange(-half, half + 1, dtype=np.float64)
    t = (offsets[None, :] - np.arange(up)[:, None] / up) * scale
    x = t / num_zeros
    kaiser = np.where(np.abs(x) <= 1.0, np.i0(beta * np.sqrt(np.maximum(0.0, 1.0 - x * x))) / np.i0(beta), 0.0)
    taps = torch.as_tensor((scale * rolloff * np.sinc(rolloff * t) * kaiser).astype(np.float32),
                           device=audio.device)
    n_out = -((-len(audio) * up) // down)
    xp = F.pad(audio, (half, half))
    n = torch.arange(n_out, device=audio.device)
    out = torch.empty(n_out, dtype=torch.float32, device=audio.device)
    windows = xp.unfold(0, 2 * half + 1, 1)
    for p in range(up):  # output sample n reads input (n * down) // up with phase (n * down) % up
        sel = n[(n * down) % up == p]
        out[sel] = windows[(sel * down) // up] @ taps[p]
    return out


def whisper_log_mel(audio16: torch.Tensor) -> torch.Tensor:
    """Whisper's log-mel [80, 3000] of one 30 s window of 16 kHz audio."""
    spec = torch.stft(audio16, WHISPER_N_FFT, WHISPER_HOP, window=_periodic_hann(WHISPER_N_FFT, audio16.device),
                      center=True, pad_mode="reflect", return_complex=True)
    power = spec[:, :-1].abs() ** 2
    basis = torch.as_tensor(slaney_filterbank(WHISPER_SR, WHISPER_N_FFT, WHISPER_MELS), device=audio16.device)
    log_spec = torch.log10(torch.clamp(basis @ power, min=1e-10))
    return (torch.maximum(log_spec, log_spec.max() - 8.0) + 4.0) / 4.0


def remap_hops(feats: torch.Tensor, n_out: int) -> torch.Tensor:
    """Content frames at hop 480 [S, D] -> ``n_out`` frames at hop 256: each
    source frame repeated 15 times, then means of groups of 8."""
    n_src = n_out * REMAP_TGT // REMAP_SRC + 1
    up = feats[:n_src].repeat_interleave(REMAP_SRC, dim=0)
    keep = n_src * REMAP_SRC // REMAP_TGT * REMAP_TGT
    return up[:keep].reshape(-1, REMAP_TGT, feats.shape[-1]).mean(dim=1)[:n_out]
