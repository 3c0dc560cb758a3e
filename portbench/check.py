"""The comparison that decides ``correct``.

Once the window has closed, a sample of the requests the program finished
is drawn from the seed: the longest, the last row of a call that served two
clips or more (where a batch's second half goes wrong, this row shows it),
and others at random. For each, the plain
reference (``portbench/reference``) replays the device call that served it,
on the same members and from a generator seeded as the program's was, and
the numbers that the cell's limits (``portbench/limits/<workload>.json``)
name are compared with them, each the worst over the sample:

- ``mel_rel_l2``: the relative L2 distance of the program's mel from the
  reference's over the clip's frames, both normalised to [-1, 1] by the
  dataset's per-channel range (the space the sampler works in);
- ``wave_rel_l2``: the relative L2 distance of what the client received
  from the reference's: the float waveform of ``convert``, or the 16-bit
  samples of the server's WAV reply; ``wave_spec_db``, the mean |dB|
  between their log-mel spectra, floored 60 dB below the loudest band;
- ``vocoder_rel_l2``, ``vocoder_spec_db``: the same two distances for the
  reference's vocoder, fade-out and encoding run on the program's own mel.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from portbench.harness import derived_seed, fingerprint
from portbench.reference import dsp
from portbench.reference.pipeline import mel_frames


def rel_l2(a: np.ndarray, b: np.ndarray) -> float:
    """||a - b|| / ||b||; infinite where the shapes differ."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if a.shape != b.shape:
        return float("inf")
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _placements(run) -> Dict[int, tuple]:
    """Result position -> (call, row). The offline loop names its requests;
    a server's members are matched by their samples, and a member whose
    samples more than one outstanding request shares is left out."""
    calls = run.window_calls()
    out = {}
    named = [c for c in calls if c.requests is not None]
    for c in named:
        out[c.requests[0]] = (c, 0)
    if named:
        return out
    free: Dict[str, List[tuple]] = {}
    for c in calls:
        for row, audio in enumerate(c.audios):
            free.setdefault(fingerprint(audio), []).append((c, row))
    by_index = {q.index: q for q in run.requests}
    for pos, res in enumerate(run.results):
        if not res.ok:
            continue
        spots = free.get(fingerprint(run.audio(by_index[res.index])), [])
        if len(spots) == 1:
            out[pos] = spots.pop()
    return out


def collect(run) -> dict:
    """The sample and the program's outputs for it, taken to the host before
    the program's state is freed."""
    placed = _placements(run)
    by_index = {q.index: q for q in run.requests}
    cands = sorted(placed, key=lambda p: (-len(by_index[run.results[p].index].pcm), p))
    rng = np.random.default_rng(derived_seed(run.seed, 3))
    want = run.sample_size
    picked = cands[:1]
    width = {p: len(placed[p][0].audios) for p in cands}
    last_rows = [p for p in cands[1:] if width[p] > 1 and placed[p][1] == width[p] - 1]
    if last_rows and want > 1:
        picked.append(last_rows[int(rng.integers(len(last_rows)))])
    rest = [p for p in cands if p not in picked]
    if rest and want > len(picked):
        picked += list(rng.choice(rest, size=min(want - len(picked), len(rest)), replace=False))
    sample = []
    for pos in picked:
        call, row = placed[int(pos)]
        req = by_index[run.results[int(pos)].index]
        frames = mel_frames(len(req.pcm), run.cfg)
        sample.append({"call": call, "row": row, "frames": frames,
                       "mel": call.mel[row].float().cpu().numpy(),  # the padded row, as the vocoder saw it
                       "output": run.results[int(pos)].output})
    for c in run.window_calls():
        c.mel = None  # the program's device memory is freed before the reference runs
    return {"sample": sample}


def _member_audio(run, call, by_fp: dict) -> List[np.ndarray]:
    """The call's members as the reference decodes them from what the
    clients sent (``by_fp``: the requests by the fingerprint of their samples)."""
    out = []
    for audio in call.audios:
        q = by_fp[fingerprint(audio)]
        out.append(dsp.decode_wav(run.wav(q)) if run.server_cell else run.audio(q))
    return out


def _delivered(run, wave):
    """What the client receives for a float waveform."""
    return dsp.encode_wav(wave, run.fs) if run.server_cell else wave


def _got(run, out_p):
    return dsp.wav_pcm16(out_p) if isinstance(out_p, bytes) else out_p


def _spec_db(run, got: np.ndarray, want: np.ndarray) -> float:
    """Mean |dB| between the log-mel spectrograms of two waveforms."""
    import torch

    if got.shape != want.shape:
        return float("inf")

    def mel(w):
        return dsp.mel_spectrum(torch.as_tensor(np.asarray(w, np.float32), device=run.device), run.cfg)

    m_got, m_want = mel(got), mel(want)
    floor = m_want.max() * 1e-3  # -60 dB
    db = lambda m: 20.0 * torch.log10(torch.clamp(m, min=floor))  # noqa: E731
    return float((db(m_got) - db(m_want)).abs().mean())


def _mel_rel(run, mel_p, mel_r) -> float:
    lo, hi = run.ref_range
    norm = lambda m: (m - lo) / (hi - lo + 1e-12) * 2.0 - 1.0  # noqa: E731
    return rel_l2(norm(mel_p), norm(mel_r))


NUMBERS = ("mel_rel_l2", "wave_rel_l2", "wave_spec_db", "vocoder_rel_l2", "vocoder_spec_db")


def verdict(values: Dict[str, float], limits: dict) -> bool:
    """``correct``: some number was compared, and each is at most its limit
    (a number the limits do not name, a NaN or an infinity fails). The
    program's numbers and each control's go through this one test."""
    return bool(values) and all(float(v) <= float(limits.get(k, float("nan"))) for k, v in values.items())


def judge(run, outputs: dict, limits: dict, controls: Sequence[str] = (), numbers=None):
    """(checks {name: {"value", "limit"}}, control readings {precision:
    {name: value}}) of the sample, the reference on the run's device.
    ``numbers`` (default: those the limits name) are computed; a control
    stands in for the program: its own mel and waveform against the f32
    reference's, and its vocoder on the program's mel against the f32
    vocoder on it. :func:`verdict` with the same limits turns either into
    ``correct``."""
    import torch

    from portbench.reference.pipeline import Reference
    from portbench.weights import make_weights

    numbers = [n for n in NUMBERS if n in (numbers or limits)]
    if not outputs["sample"]:
        return {}, {}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    weights = make_weights(run.cfg, run.seed, run.device)
    ref = Reference(run.cfg, weights, run.device, "f32")
    run.ref_range = (ref.mel_min.cpu().numpy(), ref.mel_max.cpu().numpy())
    others = {p: Reference(run.cfg, weights, run.device, p) for p in controls}
    del weights
    worst = dict.fromkeys(numbers, 0.0)
    control = {p: dict.fromkeys(numbers, 0.0) for p in controls}

    def keep(into, name, value):
        into[name] = max(into[name], value)

    by_fp = {}
    for q in run.requests:
        by_fp.setdefault(fingerprint(run.audio(q)), q)
    by_call: Dict[int, list] = {}
    for s in outputs["sample"]:
        by_call.setdefault(s["call"].index, []).append(s)
    for items in by_call.values():
        call = items[0]["call"]
        rows = [s["row"] for s in items]
        voc = [n for n in ("vocoder_rel_l2", "vocoder_spec_db") if n in numbers]
        for s in items if voc else ():
            want = _delivered(run, ref.vocode_clip(s["mel"], s["frames"]))
            outs = [(worst, _got(run, s["output"]))] + [
                (control[p], _delivered(run, other.vocode_clip(s["mel"], s["frames"]))) for p, other in others.items()]
            for into, got in outs:
                if "vocoder_rel_l2" in voc:
                    keep(into, "vocoder_rel_l2", rel_l2(got, want))
                if "vocoder_spec_db" in voc:
                    keep(into, "vocoder_spec_db", _spec_db(run, got, want))
        if not {"mel_rel_l2", "wave_rel_l2", "wave_spec_db"} & set(numbers):
            continue
        args = (_member_audio(run, call, by_fp), call.singers, call.gseed, call.sampler, call.speedup, rows)
        refs = ref.convert_call(*args)
        results = [(None, {"mel": s["mel"][: s["frames"]], "output": s["output"]}, r) for s, r in zip(items, refs)]
        for p, other in others.items():
            results += [(p, {"mel": c["mel"], "output": _delivered(run, c["wave"])}, r)
                        for c, r in zip(other.convert_call(*args), refs)]
        for p, s, r in results:
            into = worst if p is None else control[p]
            if "mel_rel_l2" in numbers:
                keep(into, "mel_rel_l2", _mel_rel(run, s["mel"], r["mel"]))
            if "wave_rel_l2" in numbers:
                keep(into, "wave_rel_l2", rel_l2(_got(run, s["output"]), _delivered(run, r["wave"])))
            if "wave_spec_db" in numbers:
                keep(into, "wave_spec_db", _spec_db(run, _got(run, s["output"]), _delivered(run, r["wave"])))
    checks = {k: {"value": worst[k], "limit": float(limits[k]) if k in limits else float("nan")}
              for k in numbers}
    return checks, control
