"""The one traffic generator: a mix file's parameters and a seed -> requests.

A mix (``portbench/traffic/<name>.json``) gives:

- ``loop``: the loop kind that sends it (``portbench/loops/<loop>.py``);
- ``clients`` (a closed loop of several) or ``rate_per_s`` (an open loop);
- ``length_s``: ``{"dist": "fixed", "value": s}`` or
  ``{"dist": "loguniform", "low": a, "high": b}``. Lengths come in blocks
  of ``BLOCK`` equal-probability quantiles of the distribution, each block
  shuffled by the seed: every seed sends the same set of sizes in another
  order, and any run of whole blocks has the distribution's shape exactly;
- ``pool``: requests prepared for a closed loop (sent in order, cycled).
  An open loop sends round(``rate_per_s`` x seconds) requests, due at
  times drawn uniformly over the window and sorted: a Poisson process
  given its count, so the gaps between arrivals are exponential and
  bursts come as they come, while every seed sends as many requests;
- ``singers``: ``"all"`` (the config's singer table) or a list of names;
- ``server``: the in-process server's settings, absent for a loop that
  calls the pipeline directly;
- ``trace_at_s``, ``trace_s``: the profiled sub-window of a traced run.

Each request's clip is a sung phrase synthesised from the seed and the
request's index: a glide between notes with vibrato, harmonics, a short
breath pause and a little noise, stored as 16-bit PCM as a WAV file holds it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import numpy as np

BLOCK = 16  # length quantiles a shuffled block holds

@dataclasses.dataclass
class Request:
    index: int
    seconds: float
    singer: str
    due_s: Optional[float] = None  # open loops: offset of its due time from the window's start
    pcm: Optional[np.ndarray] = None  # int16 samples at the config's rate


def _rng(seed: int, *tags: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([int(seed)] + [int(t) for t in tags]))


def _quantiles(dist: dict, n: int) -> np.ndarray:
    """The n equal-probability midpoint quantiles of a length distribution."""
    u = (np.arange(n) + 0.5) / n
    if dist["dist"] == "fixed":
        return np.full(n, float(dist["value"]))
    if dist["dist"] == "loguniform":
        lo, hi = math.log(dist["low"]), math.log(dist["high"])
        return np.exp(lo + u * (hi - lo))
    raise ValueError(f"unknown length distribution {dist['dist']!r}")


def _blocks(values: np.ndarray, count: int, rng: np.random.Generator) -> np.ndarray:
    """``count`` values from shuffled copies of the block ``values``."""
    out = [rng.permutation(values) for _ in range(-(-count // len(values)))]
    return np.concatenate(out)[:count]


def synth_phrase(seconds: float, fs: int, rng: np.random.Generator, device="cpu") -> np.ndarray:
    """A sung phrase: notes 0.25-0.8 s long stepping by up to 5 semitones
    around a base pitch of 110-440 Hz, 50 ms glides between them, vibrato of
    4.5-7 Hz and 0.2-0.6 semitone, six harmonics falling as 1/k, a 0.2-0.4 s
    pause, a little noise; peak 0.3-0.8; int16. The parameters come from
    ``rng``; the waveform is computed on ``device`` in float32 (the same
    seed gives the same samples on the same kind of device)."""
    import torch

    n = int(round(seconds * fs))
    base = 110.0 * 4.0 ** rng.random()
    n_notes = int(seconds / 0.25) + 2
    steps = np.cumsum(rng.integers(-5, 6, n_notes)).astype(np.float32)
    bounds = np.cumsum(rng.uniform(0.25, 0.8, n_notes)).astype(np.float32)
    depth, rate = rng.uniform(0.2, 0.6), rng.uniform(4.5, 7.0)
    pause = rng.uniform(0.2, 0.4)
    at = rng.uniform(0.1, max(0.11, seconds - pause - 0.1))
    peak = rng.uniform(0.3, 0.8)
    noise_seed = int(rng.integers(0, 2**62))
    t = torch.arange(n, device=device, dtype=torch.float32) / fs
    note = torch.clamp(torch.searchsorted(torch.as_tensor(bounds, device=device), t), max=n_notes - 1)
    semis = torch.as_tensor(steps, device=device)[note]
    glide = max(1, int(0.05 * fs))  # 50 ms moving average between notes
    c = torch.cumsum(torch.nn.functional.pad(semis[None, None], (glide, glide), mode="replicate")[0, 0]
                     .double(), 0)
    semis = ((c[2 * glide:] - c[:-2 * glide])[:n] / (2 * glide)).float()
    semis = semis + depth * torch.sin(2 * np.pi * rate * t)
    phase = torch.cumsum((2 * np.pi / fs) * base * 2.0 ** (semis.double() / 12.0), 0)
    s1, c1 = torch.sin(phase).float(), torch.cos(phase).float()
    x, prev, cur = s1.clone(), torch.zeros_like(s1), s1
    for k in range(2, 7):  # sin(k p) = 2 cos(p) sin((k-1) p) - sin((k-2) p)
        prev, cur = cur, 2.0 * c1 * cur - prev
        x = x + cur / k
    x = torch.where((t > at) & (t < at + pause), torch.zeros_like(x), x)
    g = torch.Generator(device=device).manual_seed(noise_seed)
    x = x + 2e-3 * torch.randn(n, generator=g, device=device)
    x = x * (peak / torch.clamp(x.abs().max(), min=1e-9))
    return torch.clamp(torch.round(x * 32767.0), -32768, 32767).to(torch.int16).cpu().numpy()


def make_requests(mix: dict, seed: int, seconds: float, singers: List[str], fs: int,
                  device="cpu") -> List[Request]:
    """The requests of one run of ``mix`` (see the module docstring), their
    clips synthesised on ``device``."""
    loop_rng = _rng(seed, 1)
    if "rate_per_s" in mix:
        count = int(round(float(mix["rate_per_s"]) * seconds))
        due = np.sort(loop_rng.uniform(0.0, seconds, count))
    else:
        count, due = int(mix["pool"]), None
    lengths = _blocks(_quantiles(mix["length_s"], BLOCK), count, loop_rng)
    names = singers if mix.get("singers", "all") == "all" else list(mix["singers"])
    picks = loop_rng.integers(0, len(names), count)
    out = []
    for i in range(count):
        pcm = synth_phrase(float(lengths[i]), fs, _rng(seed, 2, i), device)
        out.append(Request(i, len(pcm) / fs, names[picks[i]], None if due is None else float(due[i]), pcm))
    return out
