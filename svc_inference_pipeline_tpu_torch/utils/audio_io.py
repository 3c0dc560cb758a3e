"""Audio file I/O.

Counterpart of ``svc_inference_pipeline_tpu/utils/audio_io.py``. ``load_audio``
dispatches on the file's first bytes: FLAC (``fLaC``) goes to the native
decoder, RIFF/WAVE to the native codec with this module's numpy codec as the
fallback, anything else (mp3, ogg, ...) to an optional external decoder (the
``soundfile`` package, then an ``ffmpeg`` binary). The native library is the
repo's ``native/*.cc``, built by ``native/wav_codec.py``.

Loader contract (the reference's): channel 0 of multichannel files, integer
PCM normalised by ``-iinfo.min``, float data with magnitude > 1.01 treated as
16/32-bit-scaled, NaN/Inf input returns an empty array, then a windowed-sinc
resample to the requested rate. Writer contract: peak normalise to 0.9,
50 ms of silence each side, 16-bit PCM.
"""

from __future__ import annotations

import struct
from typing import Optional, Tuple

import numpy as np

def pack_data(data: dict, device=None) -> dict:
    """Dict of numpy arrays -> dict of tensors with a leading batch axis of
    one, on ``device`` (None: the GPU). The reference's helper; prefer
    ``SVCPipeline.extract_features`` for real use."""
    import torch

    from svc_inference_pipeline_tpu_torch.utils.devices import resolve_device

    device = resolve_device(device)
    return {key: torch.as_tensor(np.asarray(value), device=device)[None] for key, value in data.items()}


_WAVE_FORMAT_PCM = 0x0001
_WAVE_FORMAT_IEEE_FLOAT = 0x0003
_WAVE_FORMAT_EXTENSIBLE = 0xFFFE


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """Read a RIFF/WAVE file → (samples ``[n, channels]`` raw dtype, rate).

    Supports PCM 8/16/24/32-bit and IEEE float 32/64-bit, plus
    WAVE_FORMAT_EXTENSIBLE wrappers of either. 24-bit samples come back
    in the top three bytes of an int32 (x * 256).
    """
    with open(path, "rb") as f:
        data = f.read()

    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError(f"{path}: not a RIFF/WAVE file")

    fmt = None
    raw = None
    pos = 12
    while pos + 8 <= len(data):
        chunk_id = data[pos : pos + 4]
        (chunk_size,) = struct.unpack_from("<I", data, pos + 4)
        body = data[pos + 8 : pos + 8 + chunk_size]
        if chunk_id == b"fmt ":
            fmt = struct.unpack_from("<HHIIHH", body, 0)
            if fmt[0] == _WAVE_FORMAT_EXTENSIBLE and chunk_size >= 40:
                (sub_format,) = struct.unpack_from("<H", body, 24)
                fmt = (sub_format,) + fmt[1:]
        elif chunk_id == b"data":
            raw = body
        pos += 8 + chunk_size + (chunk_size & 1)  # chunks are word-aligned

    if fmt is None or raw is None:
        raise ValueError(f"{path}: missing fmt/data chunk")

    audio_format, n_channels, sample_rate, _, block_align, bits = fmt

    if audio_format == _WAVE_FORMAT_PCM:
        if bits == 8:
            samples = data_u8 = np.frombuffer(raw, dtype=np.uint8)
            samples = (data_u8.astype(np.int16) - 128).astype(np.int8)
        elif bits == 16:
            samples = np.frombuffer(raw, dtype="<i2")
        elif bits == 24:
            b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
            # left-justified in int32, so load_audio's -iinfo.min rule gives
            # x / 2^23, as the native codec does
            samples = (
                (b[:, 0].astype(np.int32) << 8)
                | (b[:, 1].astype(np.int32) << 16)
                | (b[:, 2].astype(np.int32) << 24)
            )
        elif bits == 32:
            samples = np.frombuffer(raw, dtype="<i4")
        else:
            raise ValueError(f"{path}: unsupported PCM bit depth {bits}")
    elif audio_format == _WAVE_FORMAT_IEEE_FLOAT:
        samples = np.frombuffer(raw, dtype="<f4" if bits == 32 else "<f8")
    else:
        raise ValueError(f"{path}: unsupported WAVE format 0x{audio_format:04x}")

    n_frames = len(samples) // n_channels
    samples = samples[: n_frames * n_channels].reshape(n_frames, n_channels)
    return samples, sample_rate


def write_wav(path: str, waveform: np.ndarray, fs: int) -> None:
    """Write mono/stereo float waveform as 16-bit PCM WAV."""
    wav = np.asarray(waveform)
    if wav.ndim == 1:
        wav = wav[:, None]
    pcm = np.clip(np.round(wav * 32767.0), -32768, 32767).astype("<i2")
    n_channels = pcm.shape[1]
    byte_rate = fs * n_channels * 2
    block_align = n_channels * 2
    body = pcm.tobytes()
    with open(path, "wb") as f:
        f.write(b"RIFF")
        f.write(struct.pack("<I", 36 + len(body)))
        f.write(b"WAVE")
        f.write(b"fmt ")
        f.write(struct.pack("<IHHIIHH", 16, _WAVE_FORMAT_PCM, n_channels, fs, byte_rate, block_align, 16))
        f.write(b"data")
        f.write(struct.pack("<I", len(body)))
        f.write(body)


# ---------------------------------------------------------------------------
# Optional decoders (mp3 / ogg / anything outside WAV and FLAC)
# ---------------------------------------------------------------------------


class UnsupportedAudioFormatError(RuntimeError):
    """No available decoder for this audio format.

    WAV and FLAC decode natively; other formats (mp3, ogg, ...) need an
    optional external decoder, the ``soundfile`` package or an ``ffmpeg``
    binary, as the reference reads them through librosa/audioread."""


def _decode_external(path: str) -> Tuple[np.ndarray, int]:
    """Decode through soundfile or ffmpeg, whichever works.

    Returns raw ``(samples [n, ch] float32, rate)``: the caller applies the
    reference's magnitude rules, as for the native paths. Raises
    :class:`UnsupportedAudioFormatError` listing every decoder's failure
    when none works."""
    errors = []
    try:
        import soundfile as sf
    except Exception as e:  # noqa: BLE001 - any import failure disables it
        sf = None
        errors.append(f"soundfile unavailable ({type(e).__name__}: {e})")
    if sf is not None:
        try:
            data, rate = sf.read(path, always_2d=True, dtype="float32")
            return np.asarray(data, dtype=np.float32), int(rate)
        except Exception as e:  # noqa: BLE001 - fall through to ffmpeg
            errors.append(f"soundfile failed ({type(e).__name__}: {e})")

    import shutil

    ffmpeg = shutil.which("ffmpeg")
    if ffmpeg is None:
        errors.append("ffmpeg not on PATH")
    else:
        import os
        import subprocess
        import tempfile

        fd, tmp = tempfile.mkstemp(suffix=".wav")
        os.close(fd)
        try:
            # to a temp WAV (a RIFF header piped to stdout carries no sizes),
            # at f32 so nothing is quantised; the channels are kept and
            # load_audio takes channel 0
            proc = subprocess.run(
                [ffmpeg, "-nostdin", "-v", "error", "-y", "-i", path, "-c:a", "pcm_f32le", tmp],
                capture_output=True,
                timeout=600,
            )
            if proc.returncode == 0:
                return read_wav(tmp)
            errors.append("ffmpeg failed (" + proc.stderr.decode(errors="replace").strip() + ")")
        finally:
            os.unlink(tmp)
    raise UnsupportedAudioFormatError(
        f"{path}: not WAV/FLAC and no external decoder succeeded — "
        + "; ".join(errors)
        + ". Install the 'soundfile' package or put an ffmpeg binary on PATH."
    )


def load_audio(path: str, fs: Optional[int] = None,
               resampler: str = "kaiser_best") -> Tuple[np.ndarray, int]:
    """(mono float32 waveform, sample rate) of an audio file, resampled to ``fs``."""
    with open(path, "rb") as f:
        magic = f.read(4)
    if magic == b"fLaC":
        # no Python fallback: the FLAC decoder is C++ only
        from svc_inference_pipeline_tpu_torch.native import wav_codec as _native

        samples, sample_rate = _native.read_flac(path)
    elif magic == b"RIFF":
        try:
            from svc_inference_pipeline_tpu_torch.native import wav_codec as _native

            samples, sample_rate = _native.read_wav(path)
        except Exception:
            samples, sample_rate = read_wav(path)
    else:
        samples, sample_rate = _decode_external(path)
    audio = samples[:, 0] if samples.ndim > 1 else samples
    if np.issubdtype(audio.dtype, np.integer):
        max_mag = -float(np.iinfo(audio.dtype).min)
    else:
        max_mag = float(max(np.amax(audio), -np.amin(audio), 0.0))
        max_mag = (2**31) + 1 if max_mag > (2**15) else ((2**15) + 1 if max_mag > 1.01 else 1.0)
    audio = audio.astype(np.float32) / max_mag
    if np.isnan(audio).any() or np.isinf(audio).any():
        return np.zeros((0,), dtype=np.float32), sample_rate or fs or 48000
    if fs is not None and fs != sample_rate:
        from svc_inference_pipeline_tpu_torch.ops.resample import resample_host

        audio = resample_host(audio, sample_rate, fs, quality=resampler)
        sample_rate = fs
    return audio, sample_rate


def save_audio(path: str, waveform: np.ndarray, fs: int, add_silence: bool = True,
               turn_up: bool = True, volume_peak: float = 0.9) -> None:
    """Write a waveform with the reference post-processing; int16 input is
    taken as finalised PCM and written bit-exactly."""
    if np.asarray(waveform).dtype == np.int16:
        wav = np.asarray(waveform, dtype=np.float32) / 32767.0
        turn_up = False
    else:
        wav = np.asarray(waveform, dtype=np.float32)
    if turn_up:
        peak = max(float(wav.max()), abs(float(wav.min())))
        if peak > 0:
            wav = wav * (volume_peak / peak)
    if add_silence:
        silence = np.zeros((fs // 20,), dtype=wav.dtype)
        wav = np.concatenate([silence, wav, silence])
    write_wav(path, wav, fs)
