"""Main-path mel front-end (24 kHz / n_fft 1024 / hop 256 / 100 slaney mels).

Counterpart of ``svc_inference_pipeline_tpu/ops/mel.py``: reflect pad
(n_fft - hop)/2, Hann-windowed STFT (center=False), magnitude
sqrt(re^2 + im^2 + 1e-9), slaney mel filterbank, ln(clamp(., 1e-5)), and
per-frame energy sqrt(sum exp(logmel)^2). Runs on the waveform's device.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


def hz_to_mel(freq, htk: bool = False):
    freq = np.asanyarray(freq, dtype=np.float64)
    if htk:
        return 2595.0 * np.log10(1.0 + freq / 700.0)
    f_sp = 200.0 / 3
    mels = freq / f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(
        freq >= min_log_hz,
        min_log_mel + np.log(np.maximum(freq, min_log_hz) / min_log_hz) / logstep,
        mels,
    )


def mel_to_hz(mels, htk: bool = False):
    mels = np.asanyarray(mels, dtype=np.float64)
    if htk:
        return 700.0 * (10.0 ** (mels / 2595.0) - 1.0)
    f_sp = 200.0 / 3
    freqs = mels * f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(mels >= min_log_mel, min_log_hz * np.exp(logstep * (mels - min_log_mel)), freqs)


@lru_cache(maxsize=None)
def mel_filterbank(sr: int, n_fft: int, n_mels: int, fmin: float = 0.0,
                   fmax: float | None = None, htk: bool = False,
                   norm: str | None = "slaney") -> np.ndarray:
    """Triangular mel filterbank [n_mels, 1 + n_fft // 2] (librosa defaults)."""
    if fmax is None:
        fmax = sr / 2.0
    n_freqs = 1 + n_fft // 2
    fftfreqs = np.linspace(0.0, sr / 2.0, n_freqs, dtype=np.float64)
    mel_f = mel_to_hz(np.linspace(hz_to_mel(fmin, htk=htk), hz_to_mel(fmax, htk=htk), n_mels + 2), htk=htk)
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    if norm == "slaney":
        weights *= (2.0 / (mel_f[2: n_mels + 2] - mel_f[:n_mels]))[:, None]
    return weights.astype(np.float32)


def hann(win_length: int) -> np.ndarray:
    """torch.hann_window(periodic=True)."""
    n = np.arange(win_length)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)).astype(np.float32)


def reflect_pad(y: torch.Tensor, left: int, right: int) -> torch.Tensor:
    shape = y.shape
    out = F.pad(y.reshape(-1, 1, shape[-1]), (left, right), mode="reflect")
    return out.reshape(*shape[:-1], out.shape[-1])


def stft_magnitude(y: torch.Tensor, n_fft: int, hop: int, win_length: int,
                   magnitude_floor: float = 1e-9) -> torch.Tensor:
    """|STFT| (center=False) of y [..., L] -> [..., F, T]."""
    frames = y.unfold(-1, n_fft, hop)
    window = torch.as_tensor(hann(win_length), device=y.device)
    if win_length < n_fft:
        lpad = (n_fft - win_length) // 2
        window = F.pad(window, (lpad, n_fft - win_length - lpad))
    spec = torch.fft.rfft(frames * window, n=n_fft, dim=-1)
    mag = torch.sqrt(spec.real ** 2 + spec.imag ** 2 + magnitude_floor)
    return mag.transpose(-1, -2)


def mel_spectrogram(y: torch.Tensor, n_fft: int, num_mels: int, sampling_rate: int,
                    hop_size: int, win_size: int, fmin: float, fmax: float) -> torch.Tensor:
    """Log-mel [..., n_mels, T] of y [..., L]."""
    pad = int((n_fft - hop_size) / 2)
    mag = stft_magnitude(reflect_pad(y, pad, pad), n_fft, hop_size, win_size)
    basis = torch.as_tensor(
        mel_filterbank(sampling_rate, n_fft, num_mels, float(fmin), float(fmax)), device=y.device
    )
    return torch.log(torch.clamp(basis @ mag, min=1e-5))


def extract_mel_features(audio: torch.Tensor, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """(log-mel [..., n_mels, T], energy [..., T]) of a waveform at cfg.fs."""
    mel = mel_spectrogram(audio.float(), cfg.n_fft, cfg.n_mels, cfg.fs, cfg.hop_length,
                          cfg.win_length, cfg.fmin, cfg.fmax)
    energy = torch.sqrt(torch.sum(torch.exp(mel) ** 2, dim=-2))
    return mel, energy
