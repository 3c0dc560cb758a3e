"""One run of one cell: build the configuration, warm up, drive the cell's
traffic for the window, judge the outputs against the plain reference, and
print the result line.

Everything a cell names is found by name: its configuration
(``BENCHMARK.json`` ``configs[].file``), its traffic mix
(``portbench/traffic/<traffic>.json``), the mix's loop kind
(``portbench/loops/<loop>.py``), each metric's reader
(``portbench/metrics/<metric>.py``) and the cell's limits
(``portbench/limits/<workload>.json``).
"""

from __future__ import annotations

import dataclasses
import gc
import hashlib
import importlib.util
import json
import os
import sys
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "svc_inference_pipeline_tpu")


def process_age_s() -> float:
    """Seconds since this process started (the kernel's start time)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    return time.clock_gettime(time.CLOCK_BOOTTIME) - start_ticks / os.sysconf("SC_CLK_TCK")


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def derived_seed(seed: int, *tags: int) -> int:
    state = np.random.SeedSequence([int(seed)] + [int(t) for t in tags]).generate_state(2, dtype=np.uint32)
    return int(state[0]) << 31 | int(state[1]) >> 1


def fingerprint(audio: np.ndarray) -> str:
    return hashlib.blake2b(np.ascontiguousarray(audio, dtype=np.float32).tobytes(), digest_size=12).hexdigest()


# ---------------------------------------------------------------------------
# The recording proxy
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Call:
    """One device call of the pipeline, as the reference needs to replay it."""
    index: int
    gseed: int
    audios: list  # the members' waveforms as the pipeline received them
    singers: list
    sampler: str
    speedup: int
    timings: dict
    mel: Any  # the pipeline's ``last_mel`` [B, T, M] of this call
    t_start: float  # host clock (perf_counter) at the call and at its return
    t_end: float
    requests: Optional[list] = None  # request indices, where the caller knows them


class RecordingPipeline:
    """Stands where the server holds its pipeline, or wraps the offline
    loop's calls: each ``convert``/``convert_batch`` gets a generator seeded
    from the run's seed and the call's number, and is recorded with its
    members, that seed and the pipeline's phase timings. ``tick`` runs
    before and after each call, in the thread that drives the device.
    Everything else passes through."""

    def __init__(self, pipe, seed: int, tick=lambda: None):
        self._pipe = pipe
        self._seed = seed
        self._tick = tick
        self._lock = threading.Lock()
        self.calls: List[Call] = []

    def __getattr__(self, name):
        return getattr(self._pipe, name)

    def _generator(self):
        import torch

        with self._lock:
            index = len(self.calls)
            self.calls.append(None)
        gseed = derived_seed(self._seed, 4, index)
        return index, gseed, torch.Generator(device=self._pipe.device).manual_seed(gseed)

    def _record(self, index, gseed, audios, singers, sampler, speedup, t_start, requests=None):
        s, u = self._pipe._resolve_sampler(sampler, speedup)
        self.calls[index] = Call(index, gseed, list(audios), list(singers), s, u, dict(self._pipe.timings),
                                 self._pipe.last_mel, t_start, time.perf_counter(), requests)

    def convert_batch(self, wavs, singer_names, generator=None, sampler=None, speedup=None):
        from torch.profiler import record_function

        self._tick()
        index, gseed, g = self._generator()
        t = time.perf_counter()
        with record_function("portbench.convert_batch"):
            out = self._pipe.convert_batch(wavs, singer_names, generator=g, sampler=sampler, speedup=speedup)
        self._record(index, gseed, wavs, singer_names, sampler, speedup, t)
        self._tick()
        return out

    def convert(self, wav, singer_name, generator=None, sampler=None, speedup=None, request=None, **kw):
        from torch.profiler import record_function

        self._tick()
        index, gseed, g = self._generator()
        t = time.perf_counter()
        with record_function("portbench.convert"):
            out = self._pipe.convert(wav, singer_name, generator=g, sampler=sampler, speedup=speedup, **kw)
        self._record(index, gseed, [wav], [singer_name], sampler, speedup, t,
                     None if request is None else [request])
        self._tick()
        return out


# ---------------------------------------------------------------------------
# A run
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Result:
    """One request as its client saw it."""
    index: int
    t_due: float
    t_sent: float = 0.0
    t_done: Optional[float] = None
    output: Any = None
    error: Optional[str] = None

    @property
    def ok(self) -> bool:
        return self.t_done is not None and self.error is None


class Run:
    """What a loop drives and what the readers read."""

    def __init__(self, workload: dict, cfg: dict, mix: dict, seed: int, seconds: float, trace: bool,
                 device, bench: dict):
        self.workload, self.cfg, self.mix = workload, cfg, mix
        self.seed, self.seconds, self.trace, self.device = seed, float(seconds), bool(trace), device
        self.bench = bench
        self.fs = int(cfg["fs"])
        self.requests = []
        self.results: List[Result] = []
        self.pipe = self.proxy = self.server = None
        self.t0 = self.t_close = None
        self.setup_s = None
        self.setup_parts: Dict[str, float] = {}
        self.server_counts: Dict[str, int] = {}
        self.device_trace: Optional[dict] = None
        self._prof = None
        self._prof_t0 = None
        self._lock = threading.Lock()

    # -- requests ----------------------------------------------------------

    def audio(self, req) -> np.ndarray:
        """A request's waveform as a WAV reader returns its 16-bit samples."""
        return req.pcm.astype(np.float32) / np.float32(32768.0)

    def wav(self, req) -> bytes:
        from portbench.reference.dsp import wav_bytes

        return wav_bytes(req.pcm, self.fs)

    def new_result(self, req, t_due: float) -> Result:
        r = Result(req.index, t_due, time.perf_counter())
        with self._lock:
            self.results.append(r)
        return r

    # -- the window --------------------------------------------------------

    def start_window(self) -> float:
        self.setup_s = process_age_s()
        if self.server is not None:
            self._counts0 = self._server_counts()
        self.t0 = time.perf_counter()
        return self.t0

    def close_window(self) -> None:
        done = [r.t_done for r in self.results if r.t_done is not None]
        self.t_close = max(done + [self.t0 + 1e-9])
        self.stop_trace()
        if self.server is not None:
            now = self._server_counts()
            self.server_counts = {k: now[k] - self._counts0[k] for k in now}

    def _server_counts(self) -> Dict[str, int]:
        s = self.server
        with s._stats_lock:
            return {"conversions": s.conversions, "batches": s.batches, "batch_failures": s.batch_failures,
                    "sheds": s.sheds}

    @property
    def window_s(self) -> float:
        return self.t_close - self.t0

    def tick(self) -> None:
        """Start or stop the profiled sub-window of a traced run. The proxy
        calls this before and after each pipeline call, in the thread that
        drives the device: the profiler stopped from another thread while a
        server's worker thread drove the device crashed 2 runs in 7."""
        if not self.trace or self.t0 is None or self.device.type != "cuda":
            return
        now = time.perf_counter()
        at, span = float(self.mix.get("trace_at_s", 2.0)), float(self.mix.get("trace_s", 2.0))
        if self._prof is None and self._prof_t0 is None and now >= self.t0 + at:
            from torch.profiler import ProfilerActivity, profile

            self._prof = profile(activities=[ProfilerActivity.CUDA])
            self._prof.__enter__()
            self._prof_t0 = time.perf_counter()
        elif self._prof is not None and now >= self._prof_t0 + span:
            self.stop_trace()

    def stop_trace(self) -> None:
        """Stop the profiler; its events are read after the window
        (:meth:`read_trace`), so that their parsing holds up no request."""
        if self._prof is None:
            return
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._prof_span = time.perf_counter() - self._prof_t0
        self._prof.__exit__(None, None, None)
        self._prof_done, self._prof = self._prof, None

    def read_trace(self) -> None:
        from portbench import profiling

        if getattr(self, "_prof_done", None) is not None:
            self.device_trace = profiling.summarize(self._prof_done, self._prof_span)
            self._prof_done = None

    # -- what the readers use ------------------------------------------------

    def completed(self) -> List[Result]:
        return [r for r in self.results if r.ok]

    def window_calls(self) -> List[Call]:
        return [c for c in self.proxy.calls if c is not None]


# ---------------------------------------------------------------------------
# Set-up
# ---------------------------------------------------------------------------


def load_cell(workload: str, root: Path):
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has {sorted(cells)}")
    cell = cells[workload]
    config = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    cfg = json.loads((root / config["file"]).read_text())
    mix = json.loads((HERE / "traffic" / f"{cell['traffic']}.json").read_text())
    return bench, cell, cfg, mix


def build_pipeline(cfg: dict, seed: int, device, parts: dict):
    """The program built from the seed's checkpoint-layout weights through
    its own loading path: the checkpoint converters, then
    ``SVCPipeline.from_jax_params``."""
    import torch

    from portbench.weights import make_weights
    from svc_inference_pipeline_tpu_torch.checkpoints.torch_convert import (
        convert_mapper_state_dict, convert_vocoder_state_dict, convert_whisper_state_dict)
    from svc_inference_pipeline_tpu_torch.config import HParams
    from svc_inference_pipeline_tpu_torch.models.whisper import WhisperDims
    from svc_inference_pipeline_tpu_torch.pipeline.convert import SVCPipeline

    t = time.perf_counter()
    w = make_weights(cfg, seed, device)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    parts["weights_draw_s"] = time.perf_counter() - t
    t = time.perf_counter()
    hp = HParams(**cfg)
    enc, den = convert_mapper_state_dict(w["mapper"], hp.mapper)
    voc = convert_vocoder_state_dict(w["vocoder"], hp.vocoder)
    wtree = convert_whisper_state_dict(w["whisper"], encoder_only=True)
    del w
    parts["state_dict_convert_s"] = time.perf_counter() - t
    t = time.perf_counter()
    dims = WhisperDims(**{**WhisperDims().__dict__, **cfg["whisper_dims"]})
    pipe = SVCPipeline.from_jax_params(hp, enc, den, voc, dims, wtree, device=device)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    parts["from_jax_params_s"] = time.perf_counter() - t
    return pipe


def warm_up(run: Run, parts: dict) -> None:
    """One conversion per length class the cell's traffic uses, on the
    cell's sampler: the kernel library's build and load, and every shape's
    first call, happen here and not in the window."""
    import torch

    from svc_inference_pipeline_tpu_torch.serving import length_class

    t = time.perf_counter()
    classes = {}
    for req in run.requests:
        frames = run.pipe.mel_frame_count(len(req.pcm))
        classes.setdefault(length_class(frames) if run.server is not None else frames, req)
    for req in classes.values():
        g = torch.Generator(device=run.pipe.device).manual_seed(0)
        if run.server is not None:
            run.pipe.convert_batch([run.audio(req)], [req.singer], generator=g)
        else:
            run.pipe.convert(run.audio(req), req.singer, generator=g)
    parts["warm_up_s"] = time.perf_counter() - t
    parts["warm_up_conversions"] = len(classes)


def run_cell(workload: str, seed: int, seconds: float, trace: bool, root: Path, device="cuda",
             chips: Optional[int] = None, cfg_override=None, limits_override=None, mix_override=None,
             controls=(), fault=None, numbers=None) -> dict:
    """One run: returns {"line": the result dict, "setup": set-up seconds by
    part, "control": the controls' readings, "control_correct": each
    control's ``correct`` by the cell's limits, "run": the Run}. The
    overrides, ``controls`` and ``fault`` serve the tests and
    ``calibrate.py`` (a smaller configuration, another rate, the control's
    readings, a broken program)."""
    import torch

    bench, cell, cfg, mix = load_cell(workload, root)
    if cfg_override is not None:
        cfg = cfg_override(cfg)
    if mix_override is not None:
        mix = mix_override(mix)
    limits = json.loads((HERE / "limits" / f"{workload}.json").read_text())
    if limits_override is not None:
        limits = limits_override(limits)
    run = Run(cell, cfg, mix, seed, seconds, trace, torch.device(device), bench)
    run.sample_size = int(limits["sample"])
    parts = run.setup_parts
    t = time.perf_counter()
    with open(cfg["singer_file"]) as f:
        singers = sorted(json.load(f))
    from portbench.traffic import make_requests

    run.requests = make_requests(mix, seed, seconds, singers, run.fs, run.device)
    parts["traffic_s"] = time.perf_counter() - t
    run.pipe = build_pipeline(cfg, seed, run.device, parts)
    if fault is not None:
        fault(run.pipe)
    run.proxy = RecordingPipeline(run.pipe, seed, run.tick)
    if "server" in mix:
        from svc_inference_pipeline_tpu_torch.serving import SVCServer

        run.server = SVCServer(run.proxy, run.pipe.cfg, **mix["server"])
    run.server_cell = run.server is not None
    warm_up(run, parts)
    if trace and run.device.type == "cuda":  # the tracer's first start initialises it: set-up, not window
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]):
            torch.zeros(1, device=run.device).add_(1)
    if run.device.type == "cuda":
        torch.cuda.synchronize()
    loop = load_module(HERE / "loops" / f"{mix['loop']}.py", f"portbench_loop_{mix['loop']}")
    try:
        loop.run(run)
    finally:
        if run.server is not None:
            run.server.close(drain_s=0)
            run.server.worker.join(timeout=60)
    peak = torch.cuda.max_memory_allocated(run.device) if run.device.type == "cuda" else 0

    from portbench import check, readers

    run.read_trace()
    metrics = readers.read_all(run, per_layer=trace)
    outputs = check.collect(run)
    run.pipe = run.proxy = run.server = None
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    checks, control = check.judge(run, outputs, limits, controls, numbers)
    judge_s = time.perf_counter() - t
    line = {
        "correct": check.verdict({k: c["value"] for k, c in checks.items()}, limits),
        "attempted": len(run.results),
        "failed": sum(not r.ok for r in run.results),
        "metrics": metrics,
        "device": device_info(run, peak, chips),
    }
    if trace and run.device_trace is not None:
        line["breakdown"] = run.device_trace["breakdown"]
    line["checks"] = checks
    return {"line": line, "setup": parts, "control": control, "run": run, "judge_s": judge_s,
            "control_correct": {p: check.verdict(v, limits) for p, v in control.items()}}


def device_info(run: Run, peak: int, chips: Optional[int]) -> dict:
    import torch

    if run.device.type == "cuda":
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(run.device), "count": chips or 1,
                "memory_peak_bytes": int(peak)}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    if run.trace and run.device_trace is not None:
        info["busy_s"] = run.device_trace["busy_s"]
        info["window_s"] = run.device_trace["window_s"]
    return info
