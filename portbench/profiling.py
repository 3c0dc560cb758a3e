"""The device's busy time, and where the time went, from a ``torch.profiler``
trace of a sub-window.

``busy_ms`` and the choice of device events follow the program's own
``measure.py`` (``busy_ms``, ``device_breakdown``): the union of the
device-side spans (kernels, copies, fills), leaving out the device ranges
of ``record_function`` annotations, so that nothing counts twice. The
trace records device activity only, with the CUDA runtime calls beside it:
an idle gap between busy spans is labelled by the runtime call open when it
began, or as host work where none was (Python, numpy, the host F0).
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Tuple

TOP = 10
MIN_GAP_US = 20.0


def busy_ms(spans) -> float:
    """Milliseconds covered by the union of (start_us, end_us) spans."""
    total, end = 0.0, -float("inf")
    for s, e in sorted(spans):
        if e > end:
            total += e - max(s, end)
            end = e
    return total / 1e3


def _merged(spans) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def summarize(prof, window_s: float) -> Dict:
    """{"busy_s", "window_s", "breakdown": {"device_ops", "idle_gaps"}}."""
    from torch.autograd import DeviceType

    events = prof.events()
    dev = [ev for ev in events
           if ev.device_type == DeviceType.CUDA and not getattr(ev, "is_user_annotation", False)]
    spans = [(ev.time_range.start, ev.time_range.end) for ev in dev]
    busy_s = min(busy_ms(spans) / 1e3, window_s)
    by_op: Dict[str, float] = {}
    for ev in dev:
        by_op[ev.name[:120]] = by_op.get(ev.name[:120], 0.0) + (ev.time_range.end - ev.time_range.start) / 1e6
    host = sorted(((ev.time_range.start, ev.time_range.end, ev.name[:120]) for ev in events
                   if ev.device_type == DeviceType.CPU), key=lambda x: x[0])
    starts = [h[0] for h in host]
    merged = _merged(spans)
    gaps = sorted(((b[0] - a[1], a[1]) for a, b in zip(merged, merged[1:]) if b[0] - a[1] > MIN_GAP_US),
                  reverse=True)[:400]
    by_host: Dict[str, float] = {}
    for length, at in gaps:
        label = "host work, no CUDA call"
        i = bisect.bisect_right(starts, at)
        for s, e, name in reversed(host[max(0, i - 400):i]):  # the innermost open one began last
            if e >= at:
                label = name
                break
        by_host[label] = by_host.get(label, 0.0) + length / 1e6
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]  # noqa: E731
    return {"busy_s": busy_s, "window_s": window_s,
            "breakdown": {"device_ops": top(by_op), "idle_gaps": top(by_host)}}
