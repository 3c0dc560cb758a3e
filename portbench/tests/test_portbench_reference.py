"""The plain reference against the port on the CPU at a tiny size, with the
same weights and noise, through the harness's whole run (its look for a
card skipped); the fp8 control in the program's place, judged by the same
verdict; and faults planted in the program under the timed path, which the
comparison has to call not correct at the cell's own sample size."""

import json
import sys

import pytest
import torch

from _tiny import ROOT, tiny

sys.path.insert(0, str(ROOT))

from portbench import check, harness  # noqa: E402

CELLS = ["ddpm1000-offline-10s", "ddpm1000-serve-closed8"]
# Limits for the tiny size, set as the cells' were, between the program's
# readings and the fp8 control's there (seed 2**31 + 99, sample 3;
# program / control): mel 6.2e-4 / 1.07e-2 (offline), 6.6e-4 / 1.12e-2
# (closed8); vocoder_rel_l2 6.6e-3 / 3.9e-2; vocoder_spec_db 1.2e-3 / 1.8e-2;
# wave_spec_db 1.2e-3 / 8.7e-3 (offline), 7.6e-4 / 1.23e-2 (closed8).
TINY_LIMITS = {"mel_rel_l2": 3e-3, "wave_spec_db": 4e-3, "vocoder_rel_l2": 0.02, "vocoder_spec_db": 0.006}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def run(cell, seconds=2.0, sample=None, limits=None, cfg=tiny, **kw):
    def override(lim):
        lim = {**lim, **{k: v for k, v in (limits or {}).items() if k in lim}}
        return {**lim, "sample": sample} if sample else lim

    return harness.run_cell(cell, 2**31 + 99, seconds, False, ROOT, "cpu", cfg_override=cfg,
                            limits_override=override, **kw)


def cell_limits(cell):
    return json.loads((ROOT / "portbench" / "limits" / f"{cell}.json").read_text())


def plms(cfg):
    cfg = tiny(cfg)
    cfg["mapper"].update(sampler="plms", plms_speedup=2)
    return cfg


@pytest.mark.parametrize("cell,cfg", [(c, tiny) for c in CELLS] + [("ddpm1000-offline-10s", plms)])
def test_reference_agrees_and_control_does_not(cell, cfg):
    out = run(cell, sample=2, controls=("fp8",), cfg=cfg)
    line, lim = out["line"], cell_limits(cell)
    assert line["correct"] and line["failed"] == 0 and line["attempted"] >= 1
    for name, c in line["checks"].items():
        assert c["value"] < lim[name] / 3, (name, c)
        # the control, the reference in float8 in the program's place, lands far further off
        assert out["control"]["fp8"][name] > 5 * c["value"], (name, out["control"])


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    """The control in the program's place comes out not correct by the
    verdict that decides the program's ``correct``, with the same limits."""
    out = run(cell, sample=3, limits=TINY_LIMITS, controls=("fp8",))
    assert out["line"]["correct"], out["line"]["checks"]
    assert out["control_correct"] == {"fp8": False}, out["control"]


@pytest.mark.parametrize("cell", CELLS)
def test_limits_part_the_full_size_readings(cell):
    """At the cell's own size (readings on the card, kept beside the
    limits): the program's worst reading is correct and the control's
    least is not, by the harness's verdict with the cell's limits."""
    lim = cell_limits(cell)
    numbers = [k for k in check.NUMBERS if k in lim]
    assert sorted(lim["readings"]["program_max"]) == sorted(numbers)
    assert check.verdict(lim["readings"]["program_max"], lim)
    assert not check.verdict(lim["readings"]["control_fp8_min"], lim)
    for name in numbers:  # each limit lies between its two readings
        assert lim["readings"]["program_max"][name] < lim[name] < lim["readings"]["control_fp8_min"][name]


def altered_answer(pipe):
    """The vocoder's output corrupted where it is produced: its second half zeroed."""
    forward = pipe.vocoder.forward

    def broken(mel, *a, **kw):
        wave = forward(mel, *a, **kw)
        wave[..., wave.shape[-1] // 2:] = 0.0
        return wave

    pipe.vocoder.forward = broken


def half_batch(pipe):
    """Half of each batch left out: the first half converted and its results
    handed to the rest."""
    core = pipe._core

    def broken(batch, n_true, n_frames, *a, **kw):
        b = batch["melody"].shape[0]
        if b == 1:
            return core(batch, n_true, n_frames, *a, **kw)
        h = b // 2
        wave = core({k: v[:h] for k, v in batch.items()}, n_true[:h], n_frames, *a, **kw)
        idx = torch.arange(b) % h
        pipe.last_mel = pipe.last_mel[idx]
        return wave[idx]

    pipe._core = broken


@pytest.mark.parametrize("cell,fault", [("ddpm1000-offline-10s", altered_answer),
                                        ("ddpm1000-serve-closed8", altered_answer),
                                        ("ddpm1000-serve-closed8", half_batch)])
def test_faults_are_not_correct(cell, fault):
    """At the cell's own sample size and limits."""
    out = run(cell, seconds=2.5, fault=fault)
    assert out["run"].sample_size == cell_limits(cell)["sample"] == 3
    assert not out["line"]["correct"], out["line"]["checks"]
