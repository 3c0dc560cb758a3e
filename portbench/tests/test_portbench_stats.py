"""Latency from due time, and the percentiles, on synthetic timestamps with a stall."""

import math
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from portbench import readers  # noqa: E402
from portbench.harness import Result  # noqa: E402


def test_percentile_matches_linear_interpolation():
    rng = np.random.default_rng(0)
    for n in (1, 2, 7, 200):
        v = list(rng.exponential(size=n))
        for q in (0, 50, 95, 100):
            assert math.isclose(readers.percentile(v, q), float(np.percentile(v, q)), rel_tol=1e-12)


def test_latency_from_due_time_counts_a_stall():
    # requests due every 0.1 s; the server stalls 2 s at t = 1.0, so the
    # requests due during the stall are answered at 3.0 + 0.05 k
    results = []
    for k in range(40):
        due = 0.1 * k
        sent = due + 0.01  # sent a little late: the latency still runs from the due time
        done = due + 0.05 if not 1.0 <= due < 3.0 else 3.0 + 0.05 * (k - 10)
        results.append(Result(k, due, sent, done, b"", None))
    results.append(Result(40, 4.0, 4.0, None, None, "ServerOverloaded: shed"))
    run = SimpleNamespace(results=results, window_s=4.0)
    lat = readers.latencies(run)
    assert math.isclose(lat[5], 0.05) and math.isclose(lat[10], 2.0) and lat[-1] == math.inf
    stalled = [3.0 + 0.05 * (k - 10) - 0.1 * k for k in range(10, 30)]
    want = sorted([0.05] * 20 + stalled + [64.0])  # the failed request counts as the window + 60 s
    assert math.isclose(readers.latency(run, 50), float(np.percentile(want, 50)))
    assert math.isclose(readers.latency(run, 95), float(np.percentile(want, 95)))
    assert readers.latency(run, 95) > 1.5  # the stall shows in the tail, though each was sent late
