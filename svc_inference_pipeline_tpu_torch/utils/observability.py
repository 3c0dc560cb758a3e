"""Logging, wall-clock spans, device profiles and metrics.

Counterpart of ``svc_inference_pipeline_tpu/utils/observability.py``:

* :func:`get_logger` — the same format and ``svc_tpu.*`` names,
* :func:`trace` — a wall-clock span under ``torch.profiler.record_function``
  (visible in a :func:`profile` trace) observed as ``span/<name>``,
* :func:`profile` — a ``torch.profiler`` trace of a code region (CUDA
  activity when a GPU is present), written as a Chrome trace,
* :func:`capture_intermediates` and :func:`sow` — flax's
  ``capture_intermediates=True`` and ``Module.sow``: a model's activations
  (step embeddings, each block's gated pre-activation, ...) recorded for
  one call, without changing its signature or its numbers,
* :class:`Metrics` — counters and observations with one-line JSON export.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import time
from collections import defaultdict
from typing import Any, Dict, Iterator, Optional, Tuple

import torch
from torch import nn

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


# the active capture: {id(module): its entry dict in the intermediates tree}
_capture: Optional[Dict[int, Dict[str, Any]]] = None


def sow(module: nn.Module, name: str, value: Any) -> None:
    """Record ``value`` under ``name`` in ``module``'s entry while a
    :func:`capture_intermediates` call runs (appended to a tuple, as flax's
    ``sow`` does); otherwise nothing, at the cost of one check."""
    if _capture is None:
        return
    entry = _capture.get(id(module))
    if entry is not None:
        entry[name] = entry.get(name, ()) + (value,)


def capture_intermediates(model: nn.Module, *args, **kwargs) -> Tuple[Any, Dict[str, Any]]:
    """``model(*args, **kwargs)`` with every intermediate recorded: (output,
    intermediates). The tree is keyed by flax's module paths (``residual_0``,
    ``diffusion_embedding``, ...): each module's entry holds what it sows
    (:func:`sow`) and, under ``__call__``, the outputs of each call of it as
    a module (forward hooks, registered for this call and removed after
    it); the model's own output is the root's ``__call__``. Values are
    tuples, one element a call, as flax gives them.

    The port's denoiser sows JAX's three points: ``diffusion_embedding``'s
    ``step_embedding`` and ``step_encoder_output``, each ``residual_i``'s
    ``noise_step_condition`` (the conv output plus the conditioner
    projection, before the gate split). It calls its Dense and conv leaves
    functionally, so their ``__call__`` entries (``mel_preprocess``,
    ``projection1``/``projection2``, each block's ``diffusion_projection``,
    ``dilated_conv``, ``conditioner_projection`` and ``output_projection``,
    ``skip_projection``, ``output_projection``), which JAX's tree has, are
    absent. Recording copies nothing and changes no number."""
    global _capture
    if _capture is not None:
        raise RuntimeError("capture_intermediates is already running")
    tree: Dict[str, Any] = {}
    entries, hooks = {}, []
    for path, sub in model.named_modules():
        entry = tree
        for key in filter(None, path.split(".")):
            entry = entry.setdefault(key, {})
        entries[id(sub)] = entry

        def record(_m, _args, out, entry=entry):
            entry["__call__"] = entry.get("__call__", ()) + (out,)

        hooks.append(sub.register_forward_hook(record))
    _capture = entries
    try:
        out = model(*args, **kwargs)
    finally:
        _capture = None
        for h in hooks:
            h.remove()

    def prune(d):  # modules that recorded nothing have no entry, as in flax
        kept = {k: prune(v) if isinstance(v, dict) else v for k, v in d.items()}
        return {k: v for k, v in kept.items() if not isinstance(v, dict) or v}

    return out, prune(tree)


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
