"""What the metric readers share, and the lookup of a cell's metrics.

Each metric of ``BENCHMARK.json`` has its reader in
``portbench/metrics/<name>.py``: a function ``read(run)`` that returns the
number, or None where the run has nothing to read (then the metric is left
out of the result line). A reader never returns 0 for a share of a peak.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

from portbench import flops
from portbench.harness import HERE, load_module
from portbench.reference.pipeline import mel_frames


def percentile(values: List[float], q: float) -> float:
    """The q-th percentile, linear between the closest ranks."""
    v = sorted(values)
    if not v:
        raise ValueError("no values")
    x = (len(v) - 1) * q / 100.0
    lo = math.floor(x)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (x - lo)


def latencies(run) -> List[float]:
    """Seconds from each request's due time to its reply, over every request
    due in the window; one that failed counts as never answered."""
    return [(r.t_done - r.t_due) if r.ok else math.inf for r in run.results]


def latency(run, q: float) -> Optional[float]:
    lat = latencies(run)
    if not lat:
        return None
    return percentile([min(x, run.window_s + 60.0) for x in lat], q)


def _calls(run):
    """(call, [seconds], [true frames]) of every device call of the window."""
    out = []
    for c in run.window_calls():
        secs = [len(a) / run.fs for a in c.audios]
        out.append((c, secs, [mel_frames(len(a), run.cfg) for a in c.audios]))
    return out


def audio_s_per_s(run) -> Optional[float]:
    done = {q.index: q for q in run.requests}
    audio = sum(len(done[r.index].pcm) / run.fs for r in run.completed())
    return audio / run.window_s if audio else None


def batch_mean(run) -> Optional[float]:
    c = run.server_counts
    return c["conversions"] / c["batches"] if c.get("batches") else None


def frontend_ms_per_audio_s(run) -> Optional[float]:
    calls = _calls(run)
    secs = sum(sum(s) for _, s, _ in calls)
    return 1e3 * sum(c.timings["frontend_s"] for c, _, _ in calls) / secs if secs else None


def _evals(run, c) -> int:
    return flops.sampler_evals(c.sampler, c.speedup, int(run.cfg["mapper"]["noise_schedule_factors"][2]))


def denoiser_roofline(run) -> Optional[float]:
    calls = _calls(run)
    spent = sum(c.timings["ddpm_s"] for c, _, _ in calls)
    bound = sum(flops.sampling_bound_s(sum(f), _evals(run, c), run.cfg["mapper"]) for c, _, f in calls)
    return 100.0 * bound / spent if spent else None


def vocoder_roofline(run) -> Optional[float]:
    calls = _calls(run)
    spent = sum(c.timings["vocoder_s"] for c, _, _ in calls)
    bound = sum(flops.vocoder_bound_s(sum(f), run.cfg["vocoder"]) for c, _, f in calls)
    return 100.0 * bound / spent if spent else None


def mfu(run) -> Optional[float]:
    """Model FLOPs of every conversion the window completed over the
    window's seconds at the bf16 peak."""
    work = sum(flops.conversion_flops(s, f, _evals(run, c), run.cfg)
               for c, secs, frames in _calls(run) for s, f in zip(secs, frames))
    return 100.0 * work / (run.window_s * flops.PEAK_BF16_FLOPS) if work else None


def device_idle(run) -> Optional[float]:
    t = run.device_trace
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"]) if t and t["busy_s"] > 0 else None


def cell_metrics(bench: dict, cell: str, per_layer: bool) -> List[dict]:
    """The metrics a cell reports: its end-to-end ones, or with
    ``per_layer`` the per-layer ones whose cells include it (or, with no
    ``workloads`` key, that move an end-to-end metric it reports)."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    if not per_layer:
        return e2e
    mine = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m else m["moves"] in mine)]


def read_all(run, per_layer: bool) -> Dict[str, dict]:
    out = {}
    for m in cell_metrics(run.bench, run.workload["name"], per_layer):
        reader = load_module(HERE / "metrics" / f"{m['name']}.py", f"portbench_metric_{m['name']}")
        value = reader.read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
