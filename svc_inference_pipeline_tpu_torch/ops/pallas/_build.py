"""Build and load the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` (in parallel,
one process per file) and linked into ONE shared library with a plain C
interface, loaded with :mod:`ctypes`. No PyTorch header is included, so a
build takes seconds rather than the minutes of
``torch.utils.cpp_extension``.

The library is built at first use into ``build/cuda_kernels/`` under the
repository root (ignored by git) and named by a hash of the sources and
flags, so an edited source triggers a rebuild and an unchanged one is
reused. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "cuda_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures of the entry points (csrc/*.cu)
_SIGNATURES = {
    "svc_ddpm_step": [_P] * 22 + [_I] * 6 + [_F] * 5 + [_P],
    "svc_denoise": [_P] * 21 + [_I] * 7 + [_P],
    "svc_encoder_attention": [_P] * 4 + [_I] * 3 + [_F, _P],
    "svc_activation1d": [_P, _I, _P, _I, _P, _P, _P] + [_I] * 4 + [_P],
    "svc_amp_stage": [_P] * 9 + [_I, _P] + [_I] * 4 + [_P],
    "svc_amp_pair": [_P] * 13 + [_I] * 5 + [_P],
    "svc_denoise_v2": [_P] * 18 + [_I] * 6 + [_P, _P],
    "svc_praat_f0": [_P, _I, _I] + [_P] * 5 + [_I, _I] + [_P] * 5 + [_I] + [_P] * 8,
}

_lock = threading.Lock()
_state: dict = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    found = cand if os.path.exists(cand) else shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> tuple[Path, float, str]:
    """Compile csrc/ into the shared library if it is not built yet.

    Returns (library path, seconds spent building, compiler log).
    """
    out = BUILD_DIR / f"libsvc_kernels_{_source_hash()}.so"
    if out.exists():
        return out, 0.0, ""
    t0 = time.perf_counter()
    nvcc = _nvcc()
    obj_dir = BUILD_DIR / f"obj_{os.getpid()}"
    obj_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = obj_dir / (src.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for src, _obj, proc in procs:
        text, _ = proc.communicate()
        logs.append(f"== {src.name}\n{text}")
        if proc.returncode != 0:
            failed.append(src.name)
    log = "\n".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n{log}")
    tmp = obj_dir / out.name
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(tmp), *(str(o) for _, o, _ in procs)],
        capture_output=True, text=True,
    )
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
    shutil.rmtree(obj_dir, ignore_errors=True)
    return out, time.perf_counter() - t0, log


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    with _lock:
        if "lib" not in _state:
            path, seconds, log = build()
            handle = ctypes.CDLL(str(path))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _state.update(lib=handle, path=path, build_seconds=seconds, build_log=log)
        return _state["lib"]


def build_info() -> dict:
    """Path, build seconds and compiler log of the loaded library."""
    lib()
    return {k: _state[k] for k in ("path", "build_seconds", "build_log")}


def check(status: int, name: str) -> None:
    """Raise if a kernel entry point reported a CUDA error."""
    if status != 0:
        raise RuntimeError(f"{name}: CUDA error {status}")


def _tensors(args):
    for a in args:
        if isinstance(a, torch.Tensor):
            yield a
        elif isinstance(a, (tuple, list)):  # stacks, stage and pair parameters
            yield from _tensors(a)


def refuse_autograd(name: str, *args) -> None:
    """Raise if a kernel would be launched where autograd is recording: grad
    mode on and any tensor among ``args`` (nested tuples included) requiring
    grad. The kernels write their outputs through ctypes, so those outputs
    would carry no gradient and training would silently skip the layers
    behind them."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in _tensors(args)):
        raise RuntimeError(
            f"{name}: a hand-written kernel has no backward, and an input requires grad under "
            "autograd. Run inference under torch.no_grad() or torch.inference_mode(); to train, "
            "build the model with use_kernels=False (BigVGANGenerator) or use the module's own "
            "forward (DiffSVCDenoiser, the Whisper encoder)"
        )
