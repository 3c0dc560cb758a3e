"""The traffic generator: the same requests for the same seed, and the
stated length and arrival distributions."""

import json
import math
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from portbench.traffic import BLOCK, make_requests  # noqa: E402

MIXES = Path(__file__).resolve().parents[1] / "traffic"
SINGERS = ["a", "b", "c"]
OPEN = {"loop": "poisson", "rate_per_s": 5.0, "length_s": {"dist": "loguniform", "low": 2.0, "high": 16.0},
        "singers": "all"}


def mix(name):
    return json.loads((MIXES / f"{name}.json").read_text())


def test_same_seed_same_requests():
    for m in (mix("offline-10s"), OPEN, mix("serve-closed8")):
        m = {**m, "pool": 20}
        a = make_requests(m, 2**31 + 17, 12.0, SINGERS, 24000)
        b = make_requests(m, 2**31 + 17, 12.0, SINGERS, 24000)
        c = make_requests(m, 5, 12.0, SINGERS, 24000)
        assert [(q.seconds, q.singer, q.due_s) for q in a] == [(q.seconds, q.singer, q.due_s) for q in b]
        assert all(np.array_equal(x.pcm, y.pcm) for x, y in zip(a, b))
        assert any(not np.array_equal(x.pcm[:1000], y.pcm[:1000]) for x, y in zip(a, c))


def test_lengths_log_uniform_in_blocks():
    m = {**mix("serve-closed8"), "pool": 64}
    reqs = make_requests(m, 11, 30.0, SINGERS, 24000)
    want = np.exp(np.log(2.0) + (np.arange(BLOCK) + 0.5) / BLOCK * (np.log(16.0) - np.log(2.0)))
    for k in range(0, 64, BLOCK):  # every block holds the same 16 quantiles, in another order
        got = sorted(q.seconds for q in reqs[k:k + BLOCK])
        assert np.allclose(got, want, atol=1 / 24000)
    other = make_requests(m, 12, 30.0, SINGERS, 24000)
    assert [q.seconds for q in reqs] != [q.seconds for q in other]
    assert all(q.pcm.dtype == np.int16 and len(q.pcm) == round(q.seconds * 24000) for q in reqs)


def test_poisson_arrivals():
    """Due times uniform over the window given their count: exponential gaps
    of mean 1/rate, bursts included, and as many requests for every seed."""
    counts, gaps, dues = set(), [], []
    for seed in range(40):
        reqs = make_requests(OPEN, 2**31 + seed, 32.0, SINGERS, 24000)
        due = np.array([q.due_s for q in reqs])
        assert np.all(np.diff(due) >= 0) and 0.0 <= due[0] and due[-1] < 32.0
        counts.add(len(reqs))
        gaps.append(np.diff(due))
        dues.append(due)
    assert counts == {160}
    g = np.concatenate(gaps) * 5.0  # in units of the mean gap
    assert math.isclose(g.mean(), 1.0, rel_tol=0.05)
    # the exponential's quantiles: a fifth of the gaps under 0.223, a tenth over 2.303
    assert abs(np.mean(g < -math.log(0.8)) - 0.2) < 0.02 and abs(np.mean(g > -math.log(0.1)) - 0.1) < 0.015
    # requests in 2 s windows vary as a Poisson process's do given its count
    # (variance 160 (1/16) (15/16) = 9.4); evenly spaced arrivals would vary by ~0
    per_window = np.concatenate([np.histogram(d, bins=16, range=(0, 32.0))[0] for d in dues])
    assert 7.5 < per_window.var() < 11.5 and per_window.max() >= 18
