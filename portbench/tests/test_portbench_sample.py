"""The sample that decides ``correct`` holds the last row of a call that
served several clips, so a fault in a batch's second half shows at the
cells' own sample size of 3."""

import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from portbench import check  # noqa: E402
from portbench.harness import Call, Result  # noqa: E402
from portbench.reference.pipeline import mel_frames  # noqa: E402

CFG = {"hop_length": 256, "n_fft": 1024}


def fake_run(seed, widths):
    rng = np.random.default_rng(0)
    requests, calls, results = [], [], []
    for i, width in enumerate(widths):
        audios = []
        for _ in range(width):
            q = SimpleNamespace(index=len(requests), pcm=rng.integers(-3000, 3000, int(rng.integers(2, 9)) * 4800)
                                .astype(np.int16))
            requests.append(q)
            audios.append(q.pcm.astype(np.float32) / np.float32(32768.0))
            results.append(Result(q.index, 0.0, 0.0, 1.0, b"", None))
        calls.append(Call(i, 0, audios, ["s"] * width, "ddpm", 10, {}, torch.zeros(width, 4, 2), 0.0, 1.0))
    run = SimpleNamespace(seed=seed, sample_size=3, cfg=CFG, requests=requests, results=results,
                          window_calls=lambda: calls)
    run.audio = lambda q: q.pcm.astype(np.float32) / np.float32(32768.0)
    return run


def test_sample_holds_a_batch_last_row():
    for seed in range(40):
        run = fake_run(2**31 + seed, [1, 2, 3, 1, 2, 1, 4, 1, 1, 2] * 3)
        sample = check.collect(run)["sample"]
        assert len(sample) == 3
        assert len({(id(s["call"]), s["row"]) for s in sample}) == 3
        assert any(len(s["call"].audios) > 1 and s["row"] == len(s["call"].audios) - 1 for s in sample)
        assert max(s["frames"] for s in sample) == max(mel_frames(len(q.pcm), CFG) for q in run.requests)


def test_sample_of_single_clip_calls():
    run = fake_run(7, [1] * 12)
    sample = check.collect(run)["sample"]
    assert len(sample) == 3 and all(s["row"] == 0 for s in sample)
