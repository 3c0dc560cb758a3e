"""Logging, spans, device profiles and metrics.

Counterpart of ``svc_inference_pipeline_tpu/utils/observability.py``:

* :func:`get_logger` — the same format and ``svc_tpu.*`` names,
* :class:`trace` — a span: name, thread, start and end on
  ``time.perf_counter_ns``, parent, an id shared by the spans of one
  request or call, and a few integer attributes. Spans are kept in a
  bounded ring (:class:`SpanRing`, read with :func:`spans`) and aggregated
  per name in :class:`Metrics` as ``span/<name>``; while a
  ``torch.profiler`` records on the thread, a span is also a
  ``record_function`` range in its trace,
* :func:`export` and :func:`idle_by_span` — spans on the device trace's
  clock, and a profile's device idle time put down to the spans open when
  it passed,
* :func:`profile` — a ``torch.profiler`` trace of a code region (CUDA
  activity when a GPU is present), written as a Chrome trace with its idle
  time by span beside it,
* :func:`capture_intermediates` and :func:`sow` — flax's
  ``capture_intermediates=True`` and ``Module.sow``: a model's activations
  (step embeddings, each block's gated pre-activation, ...) recorded for
  one call, without changing its signature or its numbers,
* :class:`Metrics` — counters and observations (count, sum, max and last
  a name) with one-line JSON export.

Spans sit at request, call and phase granularity, tens a conversion; none
is opened per sampler step or per kernel.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import itertools
import json
import logging
import math
import os
import sys
import threading
import time
from collections import defaultdict
from typing import Any, Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

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


# ---------------------------------------------------------------------------
# Spans
# ---------------------------------------------------------------------------

#: spans the ring holds before it drops the oldest (a 50 s window of eight
#: clients records about 800)
SPAN_CAPACITY = 16384
#: the span of one pipeline call: the thread that opened the latest one
#: drives the device (see :func:`idle_by_span`)
CALL_SPAN = "pipeline.call"
#: device idle gaps shorter than this are left out of :func:`idle_by_span`
MIN_GAP_US = 20.0

_ids = itertools.count(1)
_get_ident = threading.get_ident
_local = threading.local()
_profiler_enabled = torch._C._autograd._profiler_enabled


class Span:
    """A span around a block: ``with trace("sampling") as span: ...``, and
    the record of it that the ring keeps (stamps in ``perf_counter_ns``).

    Its parent is the span open on this thread, or ``parent`` (a
    :class:`Span`) for work handed to another thread; its ``trace_id`` is
    the parent's, else ``trace_id``, else its own id. Keyword arguments are
    its attributes (``span.attrs``, which the block may add to): integers,
    or a short string such as ``frontend.f0``'s ``route``.
    While a ``torch.profiler`` records on this thread the span is also a
    ``record_function`` range of its trace. When the block ends, the span
    goes into the ring and its seconds into ``Metrics.default()`` under
    ``span/<name>``."""

    __slots__ = ("name", "thread", "start_ns", "end_ns", "parent", "trace_id", "span_id", "attrs", "_rf")

    def __init__(self, name: str, parent: Optional["Span"] = None, trace_id: Optional[int] = None,
                 **attrs: int) -> None:
        self.name, self.parent, self.trace_id, self.attrs = name, parent, trace_id, attrs
        self.start_ns = self.end_ns = 0

    def _bind(self, parent: Optional["Span"], thread: int) -> None:
        self.span_id = sid = next(_ids)
        self.thread = thread
        if self.trace_id is None:
            self.trace_id = parent.trace_id if parent is not None else sid
        self.parent = None if parent is None else parent.span_id

    def __enter__(self) -> "Span":
        try:
            stack = _local.stack
        except AttributeError:
            stack = _local.stack = []
        self._bind(stack[-1] if self.parent is None and stack else self.parent, _get_ident())
        stack.append(self)
        self.start_ns = time.perf_counter_ns()
        if _profiler_enabled():  # the range's own stamps fall inside the span's
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        else:
            self._rf = None
        return self

    def __exit__(self, *exc) -> bool:
        if self._rf is not None:
            self._rf.__exit__(*exc)
            self._rf = None
        self.end_ns = time.perf_counter_ns()
        stack = _local.stack
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:
            stack.remove(self)
        _finish(self)
        return False

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


#: ``with trace(name, **attrs) as span:`` opens a :class:`Span`
trace = Span


class SpanRing:
    """The process's finished spans, in the order they ended: at most
    ``capacity``, the oldest dropped first and counted in ``dropped``."""

    _default: Optional["SpanRing"] = None

    def __init__(self, capacity: int = SPAN_CAPACITY) -> None:
        self.capacity = int(capacity)
        self._spans: collections.deque = collections.deque(maxlen=self.capacity)
        self._added = itertools.count(1)
        self._last = 0  # spans added so far (a deque's append is atomic; so is next() on a count)

    @classmethod
    def default(cls) -> "SpanRing":
        if cls._default is None:
            cls._default = cls()
        return cls._default

    def add(self, span: Span) -> None:
        self._spans.append(span)
        self._last = next(self._added)

    @property
    def dropped(self) -> int:
        return max(0, self._last - len(self._spans))

    def _held(self) -> List[Span]:
        while True:
            try:
                return list(self._spans)
            except RuntimeError:  # appended to while copied: copy again
                continue

    def spans(self, since_ns: int = 0, until_ns: Optional[int] = None, name: Optional[str] = None) -> List[Span]:
        """The spans that started in [since_ns, until_ns], by start."""
        out = [s for s in self._held() if s.start_ns >= since_ns and (until_ns is None or s.start_ns <= until_ns)
               and (name is None or s.name == name)]
        return sorted(out, key=lambda s: s.start_ns)

    def oldest_start_ns(self) -> Optional[int]:
        """The earliest start the ring still holds; where spans were
        dropped, spans that started before it may be missing."""
        return min((s.start_ns for s in self._held()), default=None)

    def __len__(self) -> int:
        return len(self._spans)


def spans(since_ns: int = 0, until_ns: Optional[int] = None, name: Optional[str] = None) -> List[Span]:
    """The finished spans of the process that started in [since_ns,
    until_ns] (``time.perf_counter_ns``), by start; only ``name``'s if given."""
    return SpanRing.default().spans(since_ns, until_ns, name)


def new_trace_id() -> int:
    """An id for the spans of one request, taken before its first span."""
    return next(_ids)


def current_span() -> Optional[Span]:
    """The innermost span open on this thread, or None."""
    stack = getattr(_local, "stack", None)
    return stack[-1] if stack else None


def _finish(span: Span) -> None:
    ring, metrics = SpanRing._default, Metrics._default
    (SpanRing.default() if ring is None else ring).add(span)
    (Metrics.default() if metrics is None else metrics).observe("span/" + span.name,
                                                                (span.end_ns - span.start_ns) / 1e9)


def record_span(name: str, start_ns: int, end_ns: int, trace_id: Optional[int] = None,
                thread: Optional[int] = None, **attrs: int) -> Span:
    """A root span whose stamps were taken apart (a request's wait in a
    queue, from its enqueue on one thread to its call on another), recorded
    as :class:`trace` records one."""
    span = Span(name, trace_id=trace_id, **attrs)
    span._bind(None, _get_ident() if thread is None else thread)
    span.start_ns, span.end_ns, span._rf = int(start_ns), int(end_ns), None
    _finish(span)
    return span


_clock_offset: Optional[int] = None


def clock_offset_ns() -> int:
    """Nanoseconds that place a ``perf_counter_ns`` stamp on the clock of
    ``torch.profiler``'s events (kineto's: Unix time, to which CUPTI's
    device stamps are converted). Measured once, from the tightest of 64
    readings of ``time.time_ns`` between two of ``perf_counter_ns``."""
    global _clock_offset
    if _clock_offset is None:
        best = None
        for _ in range(64):
            a = time.perf_counter_ns()
            unix = time.time_ns()
            b = time.perf_counter_ns()
            if best is None or b - a < best[0]:
                best = (b - a, unix - (a + b) // 2)
        _clock_offset = best[1]
    return _clock_offset


def export(span_list: Iterable[Span], offset_ns: Optional[int] = None) -> List[Dict[str, Any]]:
    """Spans as plain dicts with their stamps on the device trace's clock
    (``clock_offset_ns()`` added, or ``offset_ns``)."""
    off = clock_offset_ns() if offset_ns is None else int(offset_ns)
    return [{"name": s.name, "thread": s.thread, "start_ns": s.start_ns + off, "end_ns": s.end_ns + off,
             "parent": s.parent, "trace_id": s.trace_id, "span_id": s.span_id, "attrs": dict(s.attrs)}
            for s in span_list]


def device_intervals(prof) -> List[Tuple[int, int]]:
    """(start_ns, end_ns) on the trace's clock of every device operation of
    a finished ``torch.profiler.profile`` (kernels, copies, fills; the
    device ranges of ``record_function`` annotations left out)."""
    from torch.autograd import DeviceType

    base = prof.profiler.kineto_results.trace_start_ns()
    return [(base + round(ev.time_range.start * 1e3), base + round(ev.time_range.end * 1e3))
            for ev in prof.events()
            if ev.device_type == DeviceType.CUDA and not getattr(ev, "is_user_annotation", False)]


def _merged(intervals: Iterable[Tuple[int, int]]) -> List[List[int]]:
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _segments(recs: Sequence[Dict[str, Any]]) -> Tuple[List[int], List[Tuple[int, int, str]]]:
    """One thread's time cut into (start, end, name) pieces, each under the
    innermost span open through it (the one that started last); time under
    no span is no piece."""
    events = sorted([(r["start_ns"], 1, i) for i, r in enumerate(recs)]
                    + [(r["end_ns"], 0, i) for i, r in enumerate(recs)])
    active: Dict[int, Dict[str, Any]] = {}
    segs: List[Tuple[int, int, str]] = []
    for k, (t, opens, i) in enumerate(events):
        if opens:
            active[i] = recs[i]
        else:
            active.pop(i, None)
        if active and k + 1 < len(events) and events[k + 1][0] > t:
            inner = max(active.values(), key=lambda r: (r["start_ns"], -r["end_ns"]))["name"]
            if segs and segs[-1][2] == inner and segs[-1][1] == t:
                segs[-1] = (segs[-1][0], events[k + 1][0], inner)
            else:
                segs.append((t, events[k + 1][0], inner))
    return [s[0] for s in segs], segs


def _innermost_at(timeline, t: int) -> Optional[str]:
    starts, segs = timeline
    i = bisect.bisect_right(starts, t) - 1
    return segs[i][2] if i >= 0 and segs[i][1] > t else None


def idle_by_span(prof, span_list: Iterable[Span], offset_ns: Optional[int] = None,
                 thread: Optional[int] = None) -> Dict[str, Any]:
    """The device's idle time in a profile, put down to the program's spans.

    ``prof`` is a finished ``torch.profiler.profile`` (or its
    :func:`device_intervals`). Every gap of at least ``MIN_GAP_US`` between
    device operations is cut by the innermost span open on the thread that
    drives the device while it lasts: the thread of the latest
    ``pipeline.call`` span begun before the gap, or before any, ``thread``
    (default: the calling thread). Time under no span there is uncovered.
    Each gap is also put down, whole, to the innermost span open on each
    other thread at its start (``beside``: the host F0, a client's
    decode). Returns seconds: ``idle_s``, ``covered_s``, ``covered_share``,
    ``gaps``, ``by_span`` and ``beside`` (name -> seconds, largest first)."""
    intervals = device_intervals(prof) if hasattr(prof, "events") else list(prof)
    merged = _merged(intervals)
    gaps = [(a[1], b[0]) for a, b in zip(merged, merged[1:]) if b[0] - a[1] >= MIN_GAP_US * 1e3]
    recs = export(span_list, offset_ns)
    by_thread: Dict[int, list] = defaultdict(list)
    for r in recs:
        by_thread[r["thread"]].append(r)
    timelines = {t: _segments(rs) for t, rs in by_thread.items()}
    calls = sorted((r["start_ns"], r["thread"]) for r in recs if r["name"] == CALL_SPAN)
    call_starts = [c[0] for c in calls]
    default_thread = threading.get_ident() if thread is None else thread
    by_span: Dict[str, float] = defaultdict(float)
    beside: Dict[str, float] = defaultdict(float)
    idle = covered = 0
    for a, b in gaps:
        idle += b - a
        i = bisect.bisect_right(call_starts, a) - 1
        device_thread = calls[i][1] if i >= 0 else default_thread
        if device_thread in timelines:
            starts, segs = timelines[device_thread]
            j = max(0, bisect.bisect_right(starts, a) - 1)
            while j < len(segs) and segs[j][0] < b:
                part = min(b, segs[j][1]) - max(a, segs[j][0])
                if part > 0:
                    by_span[segs[j][2]] += part / 1e9
                    covered += part
                j += 1
        for t, timeline in timelines.items():
            if t != device_thread:
                name = _innermost_at(timeline, a)
                if name is not None:
                    beside[name] += (b - a) / 1e9
    order = lambda d: dict(sorted(d.items(), key=lambda kv: -kv[1]))  # noqa: E731
    return {"idle_s": idle / 1e9, "covered_s": covered / 1e9, "covered_share": covered / idle if idle else None,
            "gaps": len(gaps), "by_span": order(by_span), "beside": order(beside)}


@contextlib.contextmanager
def profile(log_dir: str) -> Iterator[None]:
    """Profile the region (CPU, and CUDA when a GPU is present) and write a
    Chrome trace (open with Perfetto or chrome://tracing) into ``log_dir``,
    ``trace_<pid>_<ns>.json``; the spans of the region are ranges in it.
    Beside it, ``idle_<pid>_<ns>.json`` holds the device's idle time by
    span (:func:`idle_by_span`)."""
    from torch.profiler import ProfilerActivity

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    t0 = time.perf_counter_ns()
    with torch.profiler.profile(activities=activities) as prof:
        try:
            yield
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    stem = f"{os.getpid()}_{time.time_ns()}"
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{stem}.json"))
    idle = idle_by_span(prof, spans(t0))
    with open(os.path.join(log_dir, f"idle_{stem}.json"), "w") as f:
        json.dump(idle, f, indent=1)
    if idle["idle_s"]:
        get_logger().info("device idle %.4f s over %d gaps, %.1f%% under spans; most under %s", idle["idle_s"],
                          idle["gaps"], 100.0 * idle["covered_share"], next(iter(idle["by_span"]), "none"))


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


class _Observed:
    """count, sum, max and last of one name's observations. The sum is
    kept as Python's ``sum`` of the values would give it (compensated from
    3.12 on), so the summary equals one made from the whole list."""

    __slots__ = ("count", "total", "comp", "max", "last")

    def __init__(self) -> None:
        self.count, self.total, self.comp, self.max, self.last = 0, 0.0, 0.0, None, None

    @property
    def sum(self) -> float:
        if self.comp and math.isfinite(self.comp):
            return self.total + self.comp
        return self.total


_COMPENSATED_SUM = sys.version_info >= (3, 12)


class Metrics:
    """Counters and observations with JSON export. An observation keeps
    count, sum, max and last for its name, not the values: the memory does
    not grow with the number observed."""

    _default: Optional["Metrics"] = None

    def __init__(self) -> None:
        self.counters: Dict[str, float] = defaultdict(float)
        self.observations: Dict[str, _Observed] = defaultdict(_Observed)
        self._lock = threading.Lock()

    @classmethod
    def default(cls) -> "Metrics":
        if cls._default is None:
            cls._default = cls()
        return cls._default

    def incr(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self.counters[name] += value

    def observe(self, name: str, value: float) -> None:
        x = float(value)
        with self._lock:
            o = self.observations[name]
            if o.count == 0 or x > o.max:
                o.max = x
            o.count += 1
            o.last = x
            total = o.total
            o.total = t = total + x
            if _COMPENSATED_SUM:  # Neumaier's sum, as the builtin's
                o.comp += ((total - t) + x) if abs(total) >= abs(x) else ((x - t) + total)

    def summary(self) -> Dict[str, Any]:
        with self._lock:
            out: Dict[str, Any] = dict(self.counters)
            for name, o in self.observations.items():
                if o.count:
                    out[name] = {"count": o.count, "mean": o.sum / o.count, "max": o.max, "last": o.last}
        return out

    def to_json(self) -> str:
        return json.dumps(self.summary(), sort_keys=True)

    def reset(self) -> None:
        with self._lock:
            self.counters.clear()
            self.observations.clear()
