"""What the readers of the program's own spans and phase timings share.

The program keeps its spans in a bounded ring in memory
(``svc_inference_pipeline_tpu_torch/utils/observability.py``), stamped on
``time.perf_counter_ns``: the clock of ``run.t0`` and ``run.t_close``. A
reader sees the spans that started in the window, and the phase timings of
the window's calls. Where the program has no such ring, span or timing key,
or the ring has dropped spans of the window, a reader returns None and the
metric is left out of the line.
"""

from __future__ import annotations

from typing import List, Optional


def window_spans(run, name: str) -> Optional[List]:
    """The program's ``name`` spans that started in [run.t0, run.t_close]."""
    try:
        from svc_inference_pipeline_tpu_torch.utils import observability
    except ImportError:
        return None
    ring_cls = getattr(observability, "SpanRing", None)
    if ring_cls is None or run.t0 is None or run.t_close is None:
        return None
    ring = ring_cls.default()
    since, until = int(run.t0 * 1e9), int(run.t_close * 1e9)
    oldest = ring.oldest_start_ns()
    if ring.dropped and (oldest is None or oldest > since):
        return None
    return ring.spans(since, until, name)


def _ms_per_audio_s(run, key: str) -> Optional[float]:
    calls = run.window_calls()
    if not calls or any(key not in c.timings for c in calls):
        return None
    secs = sum(len(a) for c in calls for a in c.audios) / run.fs
    return 1e3 * sum(c.timings[key] for c in calls) / secs if secs else None


def f0_ms_per_audio_s(run) -> Optional[float]:
    return _ms_per_audio_s(run, "f0_s")


def f0_wait_ms_per_audio_s(run) -> Optional[float]:
    return _ms_per_audio_s(run, "f0_wait_s")


def queue_wait_ms(run) -> Optional[float]:
    spans = window_spans(run, "server.queue")
    return 1e3 * sum(s.seconds for s in spans) / len(spans) if spans else None


def groups_per_drain(run) -> Optional[float]:
    spans = window_spans(run, "server.drain")
    return sum(s.attrs["groups"] for s in spans) / len(spans) if spans else None
