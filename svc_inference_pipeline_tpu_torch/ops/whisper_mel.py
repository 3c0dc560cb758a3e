"""Whisper's log-mel front-end (16 kHz / n_fft 400 / hop 160 / 80 mels).

Counterpart of ``svc_inference_pipeline_tpu/ops/whisper_mel.py``:
center=True STFT (reflect padding n_fft/2), power spectrum with the final
frame dropped, log10 with a 1e-10 floor, dynamic floor at max - 8, then
(x + 4) / 4. ``pad_or_trim`` cuts or zero-pads audio to one 30 s window,
``log_mel_spectrogram_frames`` is the whole clip's log-mel for
sliding-window transcription, ``load_and_preprocess`` resamples to 16 kHz
and pads or trims.
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch
import torch.nn.functional as F

from svc_inference_pipeline_tpu_torch.ops.mel import hann, mel_filterbank, pad_last
from svc_inference_pipeline_tpu_torch.utils.devices import resolve_device

SAMPLE_RATE = 16000
N_FFT = 400
N_MELS = 80
HOP_LENGTH = 160
CHUNK_LENGTH = 30
N_SAMPLES = CHUNK_LENGTH * SAMPLE_RATE  # 480000
N_FRAMES = N_SAMPLES // HOP_LENGTH  # 3000

Array = Union[np.ndarray, torch.Tensor]


def pad_or_trim(array: Array, length: int = N_SAMPLES, axis: int = -1) -> Array:
    """Pad with zeros or trim to ``length`` along ``axis`` (a numpy array or
    a tensor, returned as the same kind)."""
    n = array.shape[axis]
    if n > length:
        sl = [slice(None)] * array.ndim
        sl[axis] = slice(0, length)
        return array[tuple(sl)]
    if n < length:
        if isinstance(array, torch.Tensor):
            axis %= array.ndim
            return F.pad(array, [0, 0] * (array.ndim - 1 - axis) + [0, length - n])
        pads = [(0, 0)] * array.ndim
        pads[axis] = (0, length - n)
        return np.pad(array, pads)
    return array


def log_mel_spectrogram(audio: torch.Tensor, n_mels: int = N_MELS) -> torch.Tensor:
    """Whisper log-mel of 16 kHz audio [..., L] -> [..., n_mels, L // 160]."""
    y = pad_last(audio.float(), N_FFT // 2, N_FFT // 2)
    frames = y.unfold(-1, N_FFT, HOP_LENGTH)
    spec = torch.fft.rfft(frames * torch.as_tensor(hann(N_FFT), device=audio.device), n=N_FFT, dim=-1)
    magnitudes = (spec.real ** 2 + spec.imag ** 2)[..., :-1, :].transpose(-1, -2)  # [..., F, T]
    filters = torch.as_tensor(mel_filterbank(SAMPLE_RATE, N_FFT, n_mels), device=audio.device)
    log_spec = torch.log10(torch.clamp(filters @ magnitudes, min=1e-10))
    floor = log_spec.amax(dim=(-2, -1), keepdim=True) - 8.0
    return (torch.maximum(log_spec, floor) + 4.0) / 4.0


def log_mel_spectrogram_frames(audio_16k: np.ndarray, device=None) -> np.ndarray:
    """The whole clip's log-mel [80, T] on ``device`` (None: the GPU), back
    on the host: the max - 8 floor is taken over the whole clip before any
    window is cut, as Whisper's transcription does."""
    audio = torch.as_tensor(np.asarray(audio_16k, np.float32), device=resolve_device(device))
    return log_mel_spectrogram(audio).cpu().numpy()


def load_and_preprocess(audio_24k: Array, fs: int, device=None) -> torch.Tensor:
    """Resample to 16 kHz on ``device`` (None: the GPU) and pad or trim to
    one 30 s window."""
    from svc_inference_pipeline_tpu_torch.ops.resample import _resample_conv

    audio = torch.as_tensor(np.asarray(audio_24k, np.float32), device=resolve_device(device))
    return pad_or_trim(_resample_conv(audio, fs, SAMPLE_RATE))
