"""ctypes binding of the native audio codecs (``native/wav_codec.cc`` and
``native/flac_codec.cc`` at the repository root).

Counterpart of ``svc_inference_pipeline_tpu/native/wav_codec.py``, with the
same functions and compiler flags (``g++ -O2 -shared -fPIC ... -lm``; ``CXX``
names another compiler). The library is built at first use into
``build/native/`` under the repository root (ignored by git), named by a
hash of the sources and flags, so an edited source triggers a rebuild and an
unchanged one is reused; the JAX package's own ``native/libsvc_native.so``
is never written. A build that fails raises (``OSError`` or
``subprocess.CalledProcessError``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Tuple

import numpy as np

_ROOT = Path(__file__).resolve().parents[2]
SOURCES = (_ROOT / "native" / "wav_codec.cc", _ROOT / "native" / "flac_codec.cc")
BUILD_DIR = _ROOT / "build" / "native"
CXX_FLAGS = ("-O2", "-shared", "-fPIC")

_lock = threading.Lock()
_lib = None


class _WavInfo(ctypes.Structure):
    _fields_ = [
        ("sample_rate", ctypes.c_int32),
        ("n_frames", ctypes.c_int32),
        ("n_channels", ctypes.c_int32),
        ("error", ctypes.c_int32),
    ]


def library_path() -> Path:
    """Where the library of the current sources and flags is built."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for src in SOURCES:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libsvc_native_{h.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    """Compile into a file of this process, then rename it into place, so
    that processes building at once never load a half-written library."""
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", str(tmp), *map(str, SOURCES), "-lm"]
    try:
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, out)
    finally:
        if tmp.exists():
            tmp.unlink()


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not path.exists():
            _build(path)
        lib = ctypes.CDLL(str(path))
        f32p, i32p, i32 = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32), ctypes.c_int32
        lib.wav_probe.argtypes = [ctypes.c_char_p, ctypes.POINTER(_WavInfo)]
        lib.wav_decode_ch0.argtypes = [ctypes.c_char_p, f32p, i32, i32p]
        lib.wav_encode_pcm16.argtypes = [ctypes.c_char_p, f32p, i32, i32, i32p]
        lib.flac_probe.argtypes = [ctypes.c_char_p, ctypes.POINTER(_WavInfo)]
        lib.flac_decode_ch0.argtypes = [ctypes.c_char_p, f32p, i32, i32p]
        lib.resample_out_len.argtypes = [i32] * 3
        lib.resample_out_len.restype = i32
        lib.resample_f32.argtypes = [f32p, i32, i32, i32, f32p, i32]
        _lib = lib
        return lib


def loaded_library() -> str | None:
    """Path of the library this process has loaded, or None."""
    return None if _lib is None else _lib._name


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """Channel 0 of a WAV -> (float32 samples [n, 1], rate), integer PCM
    already normalised by the reference's rule (by ``-iinfo.min``)."""
    lib = _load()
    info = _WavInfo()
    lib.wav_probe(path.encode(), ctypes.byref(info))
    if info.error:
        raise OSError(f"{path}: wav probe failed (code {info.error})")
    out = np.empty(info.n_frames, dtype=np.float32)
    err = ctypes.c_int32()
    lib.wav_decode_ch0(path.encode(), _f32p(out), info.n_frames, ctypes.byref(err))
    if err.value:
        raise OSError(f"{path}: wav decode failed (code {err.value})")
    return out[:, None], int(info.sample_rate)


def read_flac(path: str) -> Tuple[np.ndarray, int]:
    """Channel 0 of a FLAC stream -> (float32 samples [n, 1] normalised by
    2^(bits-1), rate)."""
    lib = _load()
    info = _WavInfo()
    lib.flac_probe(path.encode(), ctypes.byref(info))
    if info.error:
        raise OSError(f"{path}: flac probe failed (code {info.error})")
    if info.n_frames <= 0:
        # STREAMINFO total_samples=0 is legal ("unknown length", written by
        # streaming encoders), but the decoder sizes its output from it
        raise OSError(f"{path}: FLAC with unknown total_samples is unsupported")
    out = np.empty(info.n_frames, dtype=np.float32)
    err = ctypes.c_int32()
    lib.flac_decode_ch0(path.encode(), _f32p(out), info.n_frames, ctypes.byref(err))
    if err.value:
        raise OSError(f"{path}: flac decode failed (code {err.value})")
    return out[:, None], int(info.sample_rate)


def write_wav(path: str, samples: np.ndarray, rate: int) -> None:
    """Mono float samples -> 16-bit PCM WAV."""
    lib = _load()
    flat = np.ascontiguousarray(np.asarray(samples, dtype=np.float32).reshape(-1))
    err = ctypes.c_int32()
    lib.wav_encode_pcm16(path.encode(), _f32p(flat), len(flat), rate, ctypes.byref(err))
    if err.value:
        raise OSError(f"{path}: wav encode failed (code {err.value})")


def resample(x: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """Host polyphase resample (kaiser_best), the math of ``ops/resample.py``."""
    if sr_in == sr_out:
        return np.asarray(x, dtype=np.float32)
    lib = _load()
    xf = np.ascontiguousarray(np.asarray(x, dtype=np.float32).reshape(-1))
    n_out = lib.resample_out_len(len(xf), sr_in, sr_out)
    out = np.empty(n_out, dtype=np.float32)
    lib.resample_f32(_f32p(xf), len(xf), sr_in, sr_out, _f32p(out), n_out)
    return out
