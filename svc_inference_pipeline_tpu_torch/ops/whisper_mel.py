"""Whisper's log-mel front-end (16 kHz / n_fft 400 / hop 160 / 80 mels).

Counterpart of ``svc_inference_pipeline_tpu/ops/whisper_mel.py``:
center=True STFT (reflect padding n_fft/2), power spectrum with the final
frame dropped, log10 with a 1e-10 floor, dynamic floor at max - 8, then
(x + 4) / 4.
"""

from __future__ import annotations

import torch

from svc_inference_pipeline_tpu_torch.ops.mel import hann, mel_filterbank, reflect_pad

SAMPLE_RATE = 16000
N_FFT = 400
N_MELS = 80
HOP_LENGTH = 160
CHUNK_LENGTH = 30
N_SAMPLES = CHUNK_LENGTH * SAMPLE_RATE  # 480000
N_FRAMES = N_SAMPLES // HOP_LENGTH  # 3000


def log_mel_spectrogram(audio: torch.Tensor, n_mels: int = N_MELS) -> torch.Tensor:
    """Whisper log-mel of 16 kHz audio [..., L] -> [..., n_mels, L // 160]."""
    y = reflect_pad(audio.float(), N_FFT // 2, N_FFT // 2)
    frames = y.unfold(-1, N_FFT, HOP_LENGTH)
    spec = torch.fft.rfft(frames * torch.as_tensor(hann(N_FFT), device=audio.device), n=N_FFT, dim=-1)
    magnitudes = (spec.real ** 2 + spec.imag ** 2)[..., :-1, :].transpose(-1, -2)  # [..., F, T]
    filters = torch.as_tensor(mel_filterbank(SAMPLE_RATE, N_FFT, n_mels), device=audio.device)
    log_spec = torch.log10(torch.clamp(filters @ magnitudes, min=1e-10))
    floor = log_spec.amax(dim=(-2, -1), keepdim=True) - 8.0
    return (torch.maximum(log_spec, floor) + 4.0) / 4.0
