"""Logging, wall-clock spans, device profiles and metrics.

Counterpart of ``svc_inference_pipeline_tpu/utils/observability.py``:

* :func:`get_logger` — the same format and ``svc_tpu.*`` names,
* :func:`trace` — a wall-clock span under ``torch.profiler.record_function``
  (visible in a :func:`profile` trace) observed as ``span/<name>``,
* :func:`profile` — a ``torch.profiler`` trace of a code region (CUDA
  activity when a GPU is present), written as a Chrome trace,
* :class:`Metrics` — counters and observations with one-line JSON export.

``capture_intermediates`` (flax ``sow`` collections) has no counterpart.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import time
from collections import defaultdict
from typing import Any, Dict, Iterator, Optional

import torch

_LOG_FORMAT = "%(asctime)s %(levelname).1s %(name)s: %(message)s"


def get_logger(name: str = "svc_tpu", level: int = logging.INFO) -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter(_LOG_FORMAT))
        logger.addHandler(handler)
        logger.setLevel(level)
        logger.propagate = False
    return logger


@contextlib.contextmanager
def trace(name: str, logger: Optional[logging.Logger] = None) -> Iterator[None]:
    """Wall-clock span + profiler annotation."""
    start = time.perf_counter()
    with torch.profiler.record_function(name):
        yield
    elapsed = time.perf_counter() - start
    (logger or get_logger()).debug("%s: %.3fs", name, elapsed)
    Metrics.default().observe(f"span/{name}", elapsed)


@contextlib.contextmanager
def profile(log_dir: str) -> Iterator[None]:
    """Profile the region (CPU, and CUDA when a GPU is present) and write a
    Chrome trace (open with Perfetto or chrome://tracing) into ``log_dir``."""
    from torch.profiler import ProfilerActivity

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        try:
            yield
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


class Metrics:
    """Minimal counters/gauges/observations with JSON export."""

    _default: Optional["Metrics"] = None

    def __init__(self) -> None:
        self.counters: Dict[str, float] = defaultdict(float)
        self.observations: Dict[str, list] = defaultdict(list)

    @classmethod
    def default(cls) -> "Metrics":
        if cls._default is None:
            cls._default = cls()
        return cls._default

    def incr(self, name: str, value: float = 1.0) -> None:
        self.counters[name] += value

    def observe(self, name: str, value: float) -> None:
        self.observations[name].append(float(value))

    def summary(self) -> Dict[str, Any]:
        out: Dict[str, Any] = dict(self.counters)
        for name, values in self.observations.items():
            if values:
                out[name] = {
                    "count": len(values),
                    "mean": sum(values) / len(values),
                    "max": max(values),
                    "last": values[-1],
                }
        return out

    def to_json(self) -> str:
        return json.dumps(self.summary(), sort_keys=True)

    def reset(self) -> None:
        self.counters.clear()
        self.observations.clear()
