"""The port's spans and counters (``utils/observability.py``) on the CPU: the
bounded ring, parents and ids across the F0 thread, ``Metrics``' constant
size against the JAX package's summary, the pipeline's timings read from
its spans, the server's drains and groups, idle-time attribution on
synthetic device events, the clock shared with ``torch.profiler``, and the
benchmark's readers of the new spans in a tiny run of each cell."""

import json
import random
import sys
import threading
import time
import tracemalloc
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

from svc_inference_pipeline_tpu.utils import observability as jax_obs
from svc_inference_pipeline_tpu_torch.config import HParams, load_config
from svc_inference_pipeline_tpu_torch.measure import synth_clip
from svc_inference_pipeline_tpu_torch.pipeline.convert import SVCPipeline, mel_frame_count
from svc_inference_pipeline_tpu_torch.serving import SVCServer, length_class
from svc_inference_pipeline_tpu_torch.utils import observability as obs
from svc_inference_pipeline_tpu_torch.utils.audio_io import write_wav

ROOT = Path(__file__).resolve().parents[1]
CONFIG = ROOT / "config" / "config.json"
SINGER = "svcc_CDF1"
US = 1000  # ns


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this module runs: the suite runs in several
    worker processes at once, and PyTorch's thread pools, each as wide as the
    machine, slow one another down many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _made(name, thread, start_us, end_us, span_id=0, parent=None):
    """A finished span on a synthetic clock (microseconds), kept out of the ring."""
    s = obs.Span(name)
    s.thread, s.start_ns, s.end_ns, s.span_id, s.parent, s.trace_id = (
        thread, start_us * US, end_us * US, span_id, parent, span_id)
    return s


# ---------------------------------------------------------------------------
# The ring and the aggregates
# ---------------------------------------------------------------------------


def test_ring_is_bounded_and_counts_what_it_drops():
    ring = obs.SpanRing(capacity=8)
    for i in range(20):
        ring.add(_made(f"s{i}", 1, i, i + 1))
    assert len(ring) == 8 and ring.dropped == 12
    assert [s.name for s in ring.spans()] == [f"s{i}" for i in range(12, 20)]
    assert ring.oldest_start_ns() == 12 * US
    assert [s.name for s in ring.spans(14 * US, 15 * US)] == ["s14", "s15"]
    assert [s.name for s in ring.spans(name="s19")] == ["s19"]


def test_default_ring_stays_at_its_capacity():
    ring = obs.SpanRing.default()
    dropped = ring.dropped
    for _ in range(ring.capacity + 5):
        with obs.trace("ring-fill"):
            pass
    assert len(ring) == ring.capacity and ring.dropped >= dropped + 5


def test_parent_thread_and_id_across_the_f0_thread():
    t0 = time.perf_counter_ns()
    with obs.trace("call", clips=2) as call:
        with obs.trace("phase") as phase:
            pass

        def job():
            with obs.trace("helper", parent=call, samples=7) as helper:
                with obs.trace("leaf") as leaf:
                    pass
            return helper, leaf, threading.get_ident()

        with ThreadPoolExecutor(max_workers=1) as pool:
            helper, leaf, worker = pool.submit(job).result()
    assert obs.current_span() is None
    assert phase.parent == call.span_id and phase.trace_id == call.trace_id == call.span_id
    assert helper.parent == call.span_id and helper.trace_id == call.trace_id and helper.attrs == {"samples": 7}
    assert leaf.parent == helper.span_id and leaf.trace_id == call.trace_id
    assert call.thread == phase.thread == threading.get_ident() != worker == helper.thread == leaf.thread
    assert call.parent is None and call.attrs == {"clips": 2}
    assert call.start_ns <= phase.start_ns <= phase.end_ns <= call.end_ns
    assert call.start_ns <= helper.start_ns <= leaf.start_ns <= leaf.end_ns <= helper.end_ns <= call.end_ns
    got = {s.name: s for s in obs.spans(t0) if s.name in ("call", "phase", "helper", "leaf")}
    assert got == {"call": call, "phase": phase, "helper": helper, "leaf": leaf}
    rid = obs.new_trace_id()
    with obs.trace("request", trace_id=rid) as req:
        pass
    queued = obs.record_span("request.queue", req.start_ns, req.end_ns, trace_id=rid, thread=worker, clips=1)
    assert req.trace_id == queued.trace_id == rid and queued.thread == worker and queued.parent is None
    assert queued in obs.spans(t0, name="request.queue")


def test_metrics_keep_constant_size_and_jax_summary():
    """A million observations and more: the port keeps count, sum, max and
    last a name, and its summary equals the JAX package's made from every
    value."""
    ours, ref = obs.Metrics(), jax_obs.Metrics()
    rng = random.Random(18)
    values = [rng.choice((rng.random(), rng.random() * 1e-6, rng.random() * 1e6, -rng.random(), 3))
              for _ in range(1_000_000)]
    for v in values:
        ours.observe("span/pipeline.call", v)
        ref.observe("span/pipeline.call", v)
    ours.incr("server/drains", 3)
    ref.incr("server/drains", 3)
    assert ours.summary() == ref.summary() and ours.to_json() == ref.to_json()
    tracemalloc.start()
    try:
        before = tracemalloc.get_traced_memory()[0]
        for v in values[:100_000]:
            ours.observe("span/pipeline.call", v)
        grown = tracemalloc.get_traced_memory()[0] - before
    finally:
        tracemalloc.stop()
    assert grown < 4096, grown
    for v in values[:100_000]:
        ref.observe("span/pipeline.call", v)
    assert ours.summary() == ref.summary()
    assert ours.summary()["span/pipeline.call"]["count"] == 1_100_000


def test_span_without_profiler_records_no_profiler_range():
    with obs.trace("unprofiled") as span:
        pass
    assert span._rf is None and span.end_ns >= span.start_ns


# ---------------------------------------------------------------------------
# The pipeline's timings from its spans
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_pipe():
    d = load_config(str(CONFIG)).to_dict()
    for k in ("singer_file", "min_mel_file", "max_mel_file", "target_f0_file"):
        d[k] = str(ROOT / d[k].lstrip("./"))
    d["mapper"].update(noise_schedule_factors=[0.0001, 0.02, 4], residual_layer_num=2, residual_channels=64)
    d["vocoder"]["upsample_initial_channel"] = 64
    return SVCPipeline.from_config(HParams(**d), random_weights=True, device="cpu")


def _call_spans(t0):
    """{name: [spans]} of everything recorded since t0."""
    out = {}
    for s in obs.spans(t0):
        out.setdefault(s.name, []).append(s)
    return out


def test_timings_come_from_the_call_spans(tiny_pipe):
    pipe = tiny_pipe
    clip = synth_clip(24000, 1.0)
    t0 = time.perf_counter_ns()
    pipe.convert(clip, SINGER, generator=torch.Generator().manual_seed(0))
    t = pipe.timings
    got = _call_spans(t0)
    (call,) = got["pipeline.call"]
    assert {"frontend_s", "ddpm_s", "vocoder_s", "total_s", "f0_s", "f0_wait_s", "frames_true",
            "frames_padded"} <= set(t)
    # the old keys keep their meaning: the front-end from the call's entry to its sync, then sampling, vocoder
    (sampling,), (vocoder,), (f0,), (wait,) = got["sampling"], got["vocoder"], got["frontend.f0"], got[
        "frontend.f0_wait"]
    assert t["ddpm_s"] == sampling.seconds and t["vocoder_s"] == vocoder.seconds
    assert call.start_ns + t["frontend_s"] * 1e9 <= sampling.start_ns + 1
    assert t["frontend_s"] + t["ddpm_s"] + t["vocoder_s"] <= t["total_s"] <= call.seconds
    assert 0 <= t["f0_wait_s"] <= t["frontend_s"] and t["f0_s"] > 0
    assert t["f0_s"] == f0.seconds and t["f0_wait_s"] == wait.seconds
    n = mel_frame_count(pipe.cfg, len(clip))
    assert t["frames_true"] == n and t["frames_padded"] == -(-n // pipe.bucket) * pipe.bucket
    assert call.attrs == {"clips": 1, "samples": len(clip)}
    assert f0.parent == call.span_id and f0.thread != call.thread and f0.trace_id == call.trace_id
    for name in ("pipeline.load", "frontend.device", "frontend.f0_wait", "frontend.upload", "sampling", "vocoder",
                 "pipeline.download"):
        (s,) = got[name]
        assert s.parent == call.span_id and s.thread == call.thread, name
        assert call.start_ns <= s.start_ns <= s.end_ns <= call.end_ns, name


def test_batch_timings_sum_each_clips_f0(tiny_pipe):
    pipe = tiny_pipe
    metrics = obs.Metrics.default()
    true0, padded0 = metrics.counters["pipeline/frames_true"], metrics.counters["pipeline/frames_padded"]
    clips = [synth_clip(24000, 1.0), synth_clip(24000, 0.6)]
    t0 = time.perf_counter_ns()
    pipe.convert_batch(clips, [SINGER, "svcc_CDM1"], generator=torch.Generator().manual_seed(0))
    t = pipe.timings
    got = _call_spans(t0)
    (call,) = got["pipeline.call"]
    f0s = got["frontend.f0"]
    assert len(f0s) == 2 and all(s.parent == call.span_id for s in f0s)
    assert t["f0_s"] == pytest.approx(sum(s.seconds for s in f0s), rel=1e-12)
    frames = [mel_frame_count(pipe.cfg, len(c)) for c in clips]
    padded = -(-max(frames) // pipe.bucket) * pipe.bucket
    assert (t["frames_true"], t["frames_padded"]) == (sum(frames), 2 * padded)
    assert metrics.counters["pipeline/frames_true"] - true0 == sum(frames)
    assert metrics.counters["pipeline/frames_padded"] - padded0 == 2 * padded
    assert call.attrs == {"clips": 2, "samples": sum(len(c) for c in clips)}
    assert 0 <= t["f0_wait_s"] <= t["frontend_s"]


# ---------------------------------------------------------------------------
# The server
# ---------------------------------------------------------------------------


class StubPipe:
    """Pipeline stand-in: returns a constant waveform of each clip's length."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.batches = []

    def _resolve_sampler(self, sampler, speedup):
        return "ddpm", 1

    def mel_frame_count(self, n_samples):
        return mel_frame_count(self.cfg, n_samples)

    def convert_batch(self, wavs, singers, sampler=None, speedup=None):
        self.batches.append(sorted(len(w) for w in wavs))
        return [np.full(len(w), 0.25, np.float32) for w in wavs]


class HeldServer(SVCServer):
    """A server whose worker starts to take requests only once released."""

    def __init__(self, *a, **kw):
        self.release = threading.Event()
        super().__init__(*a, **kw)

    def _worker(self):
        self.release.wait(timeout=60)
        super()._worker()


def _wav(tmp_path, n, name):
    path = tmp_path / f"{name}.wav"
    write_wav(str(path), 0.3 * np.sin(2 * np.pi * 220.0 * np.arange(n) / 24000), 24000)
    return path.read_bytes()


def test_three_requests_in_two_length_classes_make_one_drain_of_two_groups(tmp_path):
    cfg = HParams(**load_config(str(CONFIG)).to_dict())
    cfg.singer_file = str(ROOT / cfg.singer_file.lstrip("./"))
    pipe = StubPipe(cfg)
    short, long_ = 24000, 12 * 24000  # classes 256 and 2048
    bodies = [_wav(tmp_path, n, i) for i, n in enumerate((short, short, long_))]
    metrics = obs.Metrics.default()
    drains0, groups0 = metrics.counters["server/drains"], metrics.counters["server/groups"]
    t0 = time.perf_counter_ns()
    server = HeldServer(pipe, cfg, coalesce_ms=50.0, max_batch=8)
    out = [None] * 3
    threads = [threading.Thread(target=lambda i=i: out.__setitem__(i, server.convert_bytes(bodies[i], SINGER)))
               for i in range(3)]
    try:
        for t in threads:
            t.start()
        deadline = time.time() + 30
        while server.queue.qsize() < 3 and time.time() < deadline:  # all queued before the worker takes one
            time.sleep(0.005)
        assert server.queue.qsize() == 3
        server.release.set()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads) and all(o is not None for o in out)
    finally:
        server.release.set()
        server.close(drain_s=0.0)
        server.worker.join(timeout=10)
    assert not server.worker.is_alive()
    assert sorted(pipe.batches) == [[short, short], [long_]]
    got = _call_spans(t0)
    (drain,) = got["server.drain"]
    assert drain.attrs == {"requests": 3, "groups": 2}
    assert sorted((g.attrs["clips"], g.attrs["length_class"]) for g in got["server.group"]) == [
        (1, length_class(mel_frame_count(cfg, long_))), (2, length_class(mel_frame_count(cfg, short)))]
    assert all(g.parent == drain.span_id for g in got["server.group"])
    assert len(got["server.coalesce"]) == 1
    queued = got["server.queue"]
    assert len(queued) == 3 and all(q.attrs == {"drain": drain.span_id} for q in queued)
    ids = {q.trace_id for q in queued}
    assert len(ids) == 3
    assert {s.trace_id for s in got["server.decode"]} == ids == {s.trace_id for s in got["server.encode"]}
    for q in queued:  # each waited from its enqueue, on its client's thread, to its group's call
        (dec,) = [s for s in got["server.decode"] if s.trace_id == q.trace_id]
        assert sum(g.start_ns <= q.end_ns <= g.end_ns for g in got["server.group"]) == 1
        assert dec.end_ns <= q.start_ns <= q.end_ns and dec.thread == q.thread != drain.thread
    assert metrics.counters["server/drains"] - drains0 == 1
    assert metrics.counters["server/groups"] - groups0 == 2
    summary = metrics.summary()
    assert summary["span/server.queue"]["count"] >= 3 and summary["server/groups"] >= 2


# ---------------------------------------------------------------------------
# Idle time by span, and the clock
# ---------------------------------------------------------------------------


def test_idle_by_span_on_synthetic_events():
    main, f0 = 1, 2
    device = [(0, 100 * US), (200 * US, 300 * US), (310 * US, 400 * US), (1000 * US, 1100 * US),
              (1400 * US, 1500 * US)]
    spans = [_made("pipeline.call", main, 50, 600, 1), _made("X", main, 90, 210, 2, 1),
             _made("frontend.f0", f0, 250, 700, 3, 1)]
    got = obs.idle_by_span(device, spans, offset_ns=0, thread=99)
    # gaps: 100-200 (under X), 300-310 (under 20 us: left out), 400-1000 (pipeline.call to 600, then none),
    # 1100-1400 (no span)
    assert got["gaps"] == 3
    assert got["idle_s"] == pytest.approx((100 + 600 + 300) * 1e-6)
    assert got["by_span"] == pytest.approx({"X": 100e-6, "pipeline.call": 200e-6})
    assert got["covered_s"] == pytest.approx(300e-6) and got["covered_share"] == pytest.approx(0.3)
    assert got["beside"] == pytest.approx({"frontend.f0": 600e-6})
    # before any pipeline.call the given thread drives the device
    early = obs.idle_by_span([(0, 10 * US), (60 * US, 70 * US)], [_made("host.sleep", 7, 5, 65)], offset_ns=0,
                             thread=7)
    assert early["by_span"] == pytest.approx({"host.sleep": 50e-6}) and early["covered_share"] == 1.0
    none = obs.idle_by_span([(0, 10 * US), (60 * US, 70 * US)], [], offset_ns=0)
    assert none["by_span"] == {} and none["covered_share"] == 0.0 and none["idle_s"] == pytest.approx(50e-6)


def test_exported_start_matches_the_profiler_event():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs.trace("clock-warm-up"):  # the process's first range looks its operator up
            torch.ones(8).sum()
        with obs.trace("clock-check") as span:
            torch.ones(8).sum()
    (rec,) = obs.export([span])
    (ev,) = [e for e in prof.profiler.kineto_results.events() if e.name() == "clock-check"]
    assert abs(rec["start_ns"] - ev.start_ns()) < 1_000_000, rec["start_ns"] - ev.start_ns()
    assert rec["end_ns"] - rec["start_ns"] == span.end_ns - span.start_ns


# ---------------------------------------------------------------------------
# The benchmark's readers of the new spans
# ---------------------------------------------------------------------------

NEW_METRICS = {"frontend.f0_ms_per_audio_s.tput": {"ddpm1000-offline-10s", "ddpm1000-serve-closed8"},
               "frontend.f0_wait_ms_per_audio_s.tput": {"ddpm1000-offline-10s", "ddpm1000-serve-closed8"},
               "server.queue_wait_ms.tput": {"ddpm1000-serve-closed8"},
               "server.groups_per_drain.tput": {"ddpm1000-serve-closed8"}}


@pytest.mark.parametrize("cell", ["ddpm1000-offline-10s", "ddpm1000-serve-closed8"])
def test_readers_report_the_new_metrics_in_their_cells(cell):
    sys.path.insert(0, str(ROOT / "portbench" / "tests"))
    from _tiny import tiny

    from portbench import harness

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    listed = {m["name"]: set(m["workloads"]) for m in bench["per_layer"] if m["name"] in NEW_METRICS}
    assert listed == NEW_METRICS
    torch.set_num_threads(2)
    try:
        out = harness.run_cell(cell, 2**31 + 1818, 2.0, True, ROOT, "cpu", cfg_override=tiny,
                               limits_override=lambda lim: {**lim, "sample": 1})
    finally:
        torch.set_num_threads(1)
    metrics, run = out["line"]["metrics"], out["run"]
    for name, cells in NEW_METRICS.items():
        assert (name in metrics) == (cell in cells), (name, sorted(metrics))
    assert out["line"]["failed"] == 0
    # a call's F0 and its wait on it both lie within its front-end's time
    frontend = metrics["frontend.ms_per_audio_s.tput"]["value"]
    assert 0 < metrics["frontend.f0_ms_per_audio_s.tput"]["value"] <= frontend
    assert 0 <= metrics["frontend.f0_wait_ms_per_audio_s.tput"]["value"] <= frontend
    assert metrics["frontend.f0_ms_per_audio_s.tput"]["unit"] == "ms/audio-s"
    if cell == "ddpm1000-serve-closed8":
        drains = [s for s in obs.spans(int(run.t0 * 1e9), int(run.t_close * 1e9), "server.drain")]
        requests = sum(d.attrs["requests"] for d in drains)
        assert requests == len(run.completed())  # every request of the window, one drain each
        assert metrics["server.groups_per_drain.tput"]["value"] == pytest.approx(
            sum(d.attrs["groups"] for d in drains) / len(drains))
        assert metrics["server.queue_wait_ms.tput"]["value"] > 0


def test_readers_find_nothing_in_a_program_without_the_spans():
    """A parent program: no f0 timings in its calls and no spans in the
    window; every new reader returns None and raises nothing."""
    from types import SimpleNamespace

    from portbench import program_spans

    call = SimpleNamespace(audios=[np.zeros(24000, np.float32)], timings={"frontend_s": 0.1})
    now = time.perf_counter()
    run = SimpleNamespace(window_calls=lambda: [call], fs=24000, t0=now, t_close=now + 1e-6)
    for read in (program_spans.f0_ms_per_audio_s, program_spans.f0_wait_ms_per_audio_s,
                 program_spans.queue_wait_ms, program_spans.groups_per_drain):
        assert read(run) is None
    assert program_spans.f0_ms_per_audio_s(SimpleNamespace(window_calls=lambda: [], fs=24000)) is None
