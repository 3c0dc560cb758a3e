"""Whisper checkpoint registry: cached download and sha256 verification.

Counterpart of ``svc_inference_pipeline_tpu/checkpoints/fetch.py``, itself a
mirror of the reference's model registry: a name -> URL table keyed by the
checkpoint's own sha256, a local cache directory, an integrity check on
every cache hit, and a fresh download on a mismatch.

Downloading is opt-in: pass ``allow_download=True`` or set
``SVC_ALLOW_DOWNLOAD=1``; otherwise a checkpoint missing from the cache
raises at once, naming the URL to fetch it from elsewhere. The digest table
is shared with ``checkpoints.torch_convert``.
"""

from __future__ import annotations

import os
import tempfile
from typing import Callable, Optional

from svc_inference_pipeline_tpu_torch.checkpoints.torch_convert import WHISPER_SHA256, file_sha256

_URL_BASE = "https://openaipublic.azureedge.net/main/whisper/models"

#: name -> download URL; the sha256 path component is the integrity key, and
#: "large" is the large-v2 file
WHISPER_URLS = {
    name: f"{_URL_BASE}/{sha}/{'large-v2' if name == 'large' else name}.pt"
    for name, sha in WHISPER_SHA256.items()
}


def default_cache_dir() -> str:
    return os.path.join(os.environ.get("XDG_CACHE_HOME", os.path.expanduser("~/.cache")), "whisper")


def download_allowed(allow_download: Optional[bool] = None) -> bool:
    if allow_download is not None:
        return allow_download
    return os.environ.get("SVC_ALLOW_DOWNLOAD", "") in ("1", "true", "yes")


def fetch_whisper_checkpoint(
    name: str,
    cache_dir: Optional[str] = None,
    allow_download: Optional[bool] = None,
    _urlopen: Optional[Callable] = None,
) -> str:
    """Path to a verified local copy of the named Whisper checkpoint.

    * the cache is ``<cache_dir>/<name>.pt``;
    * a cached file whose sha256 matches is returned as it is;
    * a cached file that does not match is deleted and downloaded again;
    * a downloaded file that still fails the check raises, and leaves no
      file behind.

    ``_urlopen`` injects the opener (tests).
    """
    if name not in WHISPER_SHA256:
        raise KeyError(f"unknown whisper model {name!r}; choose from {sorted(WHISPER_SHA256)}")
    cache_dir = cache_dir or default_cache_dir()
    target = os.path.join(cache_dir, f"{name}.pt")
    expected = WHISPER_SHA256[name]

    if os.path.exists(target):
        if file_sha256(target) == expected:
            return target
        os.remove(target)

    if not download_allowed(allow_download):
        raise FileNotFoundError(
            f"whisper checkpoint {name!r} not cached at {target} and downloading "
            "is disabled in this environment — set SVC_ALLOW_DOWNLOAD=1 (or pass "
            f"allow_download=True) to fetch {WHISPER_URLS[name]}, or place the "
            "file there yourself"
        )

    if _urlopen is None:  # pragma: no cover - needs the network
        from urllib.request import urlopen as _urlopen

    os.makedirs(cache_dir, exist_ok=True)
    # a temp file per process, removed in any case: a transfer that fails
    # half way strands no partial file, and two fetches do not race
    fd, tmp = tempfile.mkstemp(prefix=f"{name}.pt.download.", dir=cache_dir)
    try:
        with _urlopen(WHISPER_URLS[name]) as src, os.fdopen(fd, "wb") as out:
            for block in iter(lambda: src.read(1 << 20), b""):
                out.write(block)
        if file_sha256(tmp) != expected:
            raise RuntimeError(f"{name}: downloaded checkpoint failed its sha256 check — retry, "
                               "the transfer was corrupt")
        os.replace(tmp, target)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return target
