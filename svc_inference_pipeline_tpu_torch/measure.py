"""Warm conversion times of the port on one GPU, by sampler and int8 mode.

    python -m svc_inference_pipeline_tpu_torch.measure [--profile | --steps | --k2 | --batch | --decode | --train |
                                                       --k6-ties | --spans]

Builds one pipeline at the width of ``config/config.json`` with random
weights (Whisper-medium), converts synthetic 4 s and 10 s clips with every
sampler and int8 mode of the port, three times each, and prints one JSON
line per (clip, path): the median over runs 2-3 of each phase's wall seconds
(``SVCPipeline.timings``) and the RTF. ``--profile`` adds, for one warm 4 s
conversion per path, the device time by kernel from ``torch.profiler`` and
the device's busy share of the conversion. ``--steps`` times K1 steps alone
instead (:func:`step_times`), ``--k2`` the vocoder's AMP stages
(:func:`k2_times`), ``--batch`` warm ``convert_batch`` calls on B copies of
the 4 s clip (:func:`batch_times`), ``--decode`` the Whisper text
decoder's steps at medium width (:func:`decode_times`), ``--train`` the
training steps at full width (:func:`train_times`), ``--k6-ties`` where
K6 int8-w1 parts from its plain version on a card test's operands
(:func:`k6_ties`), ``--spans`` the cost of a span and a warm 10 s
conversion's spans and device idle time by span (:func:`span_costs`).
Every line names the
card (``nvidia-smi`` name and power limit). Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

CLIP_SECONDS = (4.0, 10.0)
STEP_FRAMES = (384, 960)  # the denoiser's padded frames of those clips
RUNS = 3
# (sampler, speedup, int8 mode, tail) of every measured path
PATHS = (
    ("ddpm", 1, None, 0), ("ddpm", 1, "int8-w1", 0), ("ddpm", 1, "int8", 0), ("ddpm", 1, "int8", 50),
    ("plms", 10, None, 0), ("plms", 10, "int8-w1", 0), ("ddim", 10, None, 0),
    ("dpmpp", 10, None, 0), ("dpmpp", 10, "int8", 0),
)


def synth_clip(fs: int, seconds: float) -> np.ndarray:
    """A harmonic tone with vibrato, a 0.4 s silent gap and a little noise."""
    t = np.arange(int(seconds * fs)) / fs
    f0 = 220.0 * 2 ** (0.5 / 12 * np.sin(2 * np.pi * 5.5 * t))
    phase = 2 * np.pi * np.cumsum(f0) / fs
    x = sum((0.3 / k) * np.sin(k * phase) for k in range(1, 7))
    x[(t > 1.8) & (t < 2.2)] = 0.0
    return (x + 1e-3 * np.random.default_rng(0).standard_normal(len(t))).astype(np.float32)


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def path_name(sampler: str, speedup: int, quantize, tail: int) -> str:
    name = sampler if sampler == "ddpm" else f"{sampler}@{speedup}"
    name += f" {quantize or 'bf16'}"
    return name + (f" tail {tail}" if tail else "")


def busy_ms(spans) -> float:
    """Milliseconds covered by the union of (start_us, end_us) spans."""
    total, end = 0.0, -float("inf")
    for s, e in sorted(spans):
        if e > end:
            total += e - max(s, end)
            end = e
    return total / 1e3


def profile_conversion(pipe, wav, sampler, speedup) -> dict:
    """Device milliseconds by kernel over one warm conversion under
    ``torch.profiler``, and the device's busy share of it: the time covered
    by at least one device span (kernel, copy or fill) over the
    conversion's wall time, both under the profiler. The denoiser's kernels
    run with programmatic dependent launch, so a kernel's span starts while
    the one before it ends: it includes its weight prefetch and its wait.
    ``device_span_overlap_ms`` is the summed span time less the covered
    time, the part counted twice in the per-kernel times."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        pipe.convert(wav, "svcc_CDF1", generator=torch.Generator(device=pipe.device).manual_seed(0),
                     sampler=sampler, speedup=speedup)
        torch.cuda.synchronize()
    return device_breakdown(prof, pipe.timings["total_s"] * 1e3)


def device_breakdown(prof, wall_ms: float, top_n: int = 12) -> dict:
    """Device ms by kernel (the ``top_n`` largest, with their launch counts)
    of a ``torch.profiler`` run whose wall time was ``wall_ms``, the device's
    covered time and its share of the wall time. Kernels are the device-side
    events (copies and fills count in the covered time only); the host-side
    events that carry device time (operators, autograd nodes) and the
    device-side ranges of ``record_function`` annotations (AdamW's step) are
    left out, so nothing is counted twice."""
    from torch.autograd import DeviceType

    device_events = [ev for ev in prof.events()
                     if ev.device_type == DeviceType.CUDA and not getattr(ev, "is_user_annotation", False)]
    by_kernel = {}
    for ev in device_events:
        if not ev.name.startswith(("Memcpy", "Memset")):
            ms, n = by_kernel.get(ev.name[:90], (0.0, 0))
            by_kernel[ev.name[:90]] = (ms + (ev.time_range.end - ev.time_range.start) / 1e3, n + 1)
    by_kernel = {k: (round(ms, 3), n) for k, (ms, n) in by_kernel.items()}
    top = dict(sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:top_n])
    kernel_ms = sum(ms for ms, _ in by_kernel.values())
    spans = [(ev.time_range.start, ev.time_range.end) for ev in device_events]
    covered_ms = busy_ms(spans)
    return {"device_ms_by_kernel": top, "device_kernel_ms": round(kernel_ms, 3),
            "device_launches": sum(n for _, n in by_kernel.values()),
            "device_busy_ms": round(covered_ms, 3),
            "device_span_overlap_ms": round(sum(e - s for s, e in spans) / 1e3 - covered_ms, 3),
            "profiled_total_ms": round(wall_ms, 3), "device_busy_share": round(covered_ms / wall_ms, 4)}


BATCH_SIZES = (1, 2, 4, 8)
# (sampler, speedup, int8 mode) of every path --batch measures
BATCH_PATHS = (("ddpm", 1, None), ("ddpm", 1, "int8-w1"), ("plms", 10, None))


def batch_times(pipe, gpu: str) -> None:
    """``--batch``: ``convert_batch`` on B copies of the 4 s clip (one singer),
    B in BATCH_SIZES, on each of BATCH_PATHS, three times: one JSON line per
    (path, B) with the median over runs 2-3 of each phase's wall seconds,
    seconds per clip and the peak device memory of the three runs."""
    import torch

    wav = synth_clip(pipe.cfg.fs, CLIP_SECONDS[0])
    for sampler, speedup, quantize in BATCH_PATHS:
        pipe.set_quantize(quantize)
        for b in BATCH_SIZES:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            runs = []
            for _ in range(RUNS):
                t0 = time.perf_counter()
                pipe.convert_batch([wav] * b, ["svcc_CDF1"] * b, sampler=sampler, speedup=speedup,
                                   generator=torch.Generator(device=pipe.device).manual_seed(0))
                runs.append(dict(pipe.timings, wall_s=time.perf_counter() - t0))
            med = {k: statistics.median(r[k] for r in runs[1:]) for k in runs[0]}
            print(json.dumps({"card": gpu, "clip_s": CLIP_SECONDS[0], "path": path_name(sampler, speedup, quantize, 0),
                              "batch": b, **med, "s_per_clip": med["total_s"] / b,
                              "rtf_per_clip": med["total_s"] / (b * CLIP_SECONDS[0]),
                              "peak_gb": torch.cuda.max_memory_allocated() / 1e9}), flush=True)


def step_times(cfg, gpu: str) -> None:
    """``--steps``: K1 on one clip of each of STEP_FRAMES at the config's
    denoiser width (random weights from a seed), for each stack mode (bf16,
    "int8-w1", "int8"): ten steps back to back between CUDA events, the
    median of ten such loops, measured twice; one JSON line each."""
    import torch

    from svc_inference_pipeline_tpu_torch.checkpoints.from_jax import random_init_
    from svc_inference_pipeline_tpu_torch.models.diffsvc import DiffSVCDenoiser
    from svc_inference_pipeline_tpu_torch.ops.pallas import denoiser_step as ds
    from svc_inference_pipeline_tpu_torch.sampling.schedule import DiffusionSchedule

    dev, bf = torch.device("cuda"), torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(1)
    with torch.device(dev):
        den = DiffSVCDenoiser(cfg.mapper, compute_dtype=bf)
    random_init_(den, g)
    den = den.to(bf)
    sched = DiffusionSchedule.from_config(cfg.mapper)
    srow = (1.0, 0.01, 0.5, 0.5, 0.01)
    for t_len in STEP_FRAMES:
        cond = torch.randn((1, t_len, cfg.mapper.conditioner_size), generator=g, device=dev)
        with torch.no_grad():
            cond_projs, step_rows = den.precompute(cond, sched.num_steps, bf)
            condb = ds.fold_conditioner(den, cond_projs, bf)
        x = torch.zeros((1, t_len, ds.LANE), device=dev)
        x[..., :cfg.mapper.n_mel] = torch.randn((1, t_len, cfg.mapper.n_mel), generator=g, device=dev)
        z = torch.zeros_like(x)
        row = step_rows[sched.num_steps // 2].contiguous()
        for quantize in (None, "int8-w1", "int8"):
            st = ds.stack_denoiser_params(den, bf, quantize)

            def ten_steps():
                y = x
                for _ in range(10):
                    y = ds.ddpm_step(st, condb, row, y, z, srow)

            ms = [cuda_ms(ten_steps) / 10 for _ in range(2)]
            print(json.dumps({"card": gpu, "kernel": "K1 ddpm_step", "frames": t_len, "mode": st.mode,
                              "ms_per_step": ms}), flush=True)


def back_to_back_ms(fn, n: int = 10, loops: int = 5) -> float:
    """Milliseconds per call of n calls of fn() between CUDA events (the
    card kept busy while the host issues the next), median of ``loops``."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(loops):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    return statistics.median(times)


def k2_times(cfg, gpu: str) -> None:
    """``--k2``: K2 on each of the six stages of a 4 s clip (384 frames) at
    the config's vocoder width, random weights from a seed: the stage call
    back to back, measured twice; the host seconds to issue it; and its device
    time by kernel under ``torch.profiler``. One JSON line per stage."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from svc_inference_pipeline_tpu_torch.checkpoints.from_jax import random_init_
    from svc_inference_pipeline_tpu_torch.models.bigvgan import BigVGANGenerator
    from svc_inference_pipeline_tpu_torch.ops.pallas import amp_stage

    dev, bf = torch.device("cuda"), torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(1)
    vcfg = cfg.vocoder
    with torch.device(dev):
        voc = BigVGANGenerator(vcfg, compute_dtype=bf)
    random_init_(voc, g)
    with torch.no_grad():
        for p in voc.parameters():
            if p.dim() == 1:
                p.copy_(0.1 * torch.randn(p.shape, generator=g, device=dev))
            else:
                p.data = p.data.to(bf)
    voc.prepare_kernel_params()
    ks = tuple(vcfg.resblock_kernel_sizes)
    dils = tuple(tuple(d) for d in vcfg.resblock_dilation_sizes)
    t_len = STEP_FRAMES[0]
    for i, u in enumerate(vcfg.upsample_rates):
        t_len *= u
        c = vcfg.upsample_initial_channel // 2 ** (i + 1)
        x = (0.5 * torch.randn((1, t_len, c), generator=g, device=dev)).to(bf)
        params = voc.kernel_stages[i]

        def stage():
            return amp_stage.fused_amp_stage(x, params, ks, dils)

        line = {"card": gpu, "kernel": "K2 fused_amp_stage", "stage": i, "T": t_len, "C": c,
                "plan": amp_stage.stage_plan(1, t_len, c, ks, dils)._asdict(), "ms": back_to_back_ms(stage),
                "ms_again": back_to_back_ms(stage)}
        hosts = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            stage()
            hosts.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        line["host_issue_ms"] = 1e3 * statistics.median(hosts)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                stage()
            torch.cuda.synchronize()
        line["device_ms_by_kernel"] = {
            ev.key[:60]: round((getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0)) / 3e3, 4)
            for ev in prof.key_averages()
            if (getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0))}
        print(json.dumps(line), flush=True)


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median milliseconds of fn() between CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


DECODE_STEPS = 32


def decode_times(gpu: str) -> None:
    """The Whisper text decoder's incremental steps at Whisper-medium's width
    (random weights, the 4 s clip's window encoded through K4), greedy (one
    row) and beam (five rows, reordered every step), over ``DECODE_STEPS``
    steps after a warm-up: ms a step on the host clock (the step returns its
    logits to the host, which waits for the device), the host's time to
    issue the step's launches, the device's busy ms a step and kernel
    launches a step under ``torch.profiler``, and the host's logit filters
    and token choice of the decode loop on those logits."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from svc_inference_pipeline_tpu_torch.models import whisper_decoding as wd
    from svc_inference_pipeline_tpu_torch.ops.resample import resample_host
    from svc_inference_pipeline_tpu_torch.ops.whisper_mel import N_FRAMES, log_mel_spectrogram_frames, pad_or_trim

    dec = wd.WhisperDecoder.random_init("medium", device="cuda")
    tok = wd.get_tokenizer(True)
    audio16 = resample_host(synth_clip(24000, CLIP_SECONDS[0]), 24000, 16000)
    feats = dec.embed_audio(pad_or_trim(log_mel_spectrogram_frames(audio16, "cuda"), N_FRAMES)[None])
    inc = dec.incremental
    for rows in (1, 5):
        f = feats.repeat(rows, 1, 1)
        initial = tok.sot_sequence("en")
        filters = dec._build_filters(tok, wd.DecodingOptions(), len(initial))

        def steps(n, timed=None):
            tokens = np.tile(np.asarray(initial, np.int32), (rows, 1))
            logits, cache, off = inc.prime(tokens, f)
            step_logits = logits[:, -1].copy()
            for _ in range(n):
                t0 = time.perf_counter()
                for flt in filters:
                    flt.apply(step_logits, tokens)
                lp = wd._log_softmax_np(step_logits)
                nxt = (np.argsort(lp, axis=-1)[:, ::-1][:, :1] if rows > 1 else lp.argmax(-1)[:, None])
                nxt = nxt.astype(np.int32)
                tokens = np.concatenate([tokens, nxt], axis=1)
                t1 = time.perf_counter()
                if rows > 1:
                    cache = inc.reorder(cache, list(range(rows)))
                with torch.no_grad():
                    out, cache = dec.decoder(torch.as_tensor(nxt, dtype=torch.long, device="cuda"), f, cache, off)
                t2 = time.perf_counter()
                step_logits = out[:, -1].cpu().numpy()
                off += 1
                if timed is not None:
                    timed.append((t1 - t0, t2 - t1, time.perf_counter() - t1))

        steps(4)
        timed = []
        steps(DECODE_STEPS, timed)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            steps(DECODE_STEPS)
            torch.cuda.synchronize()
        kernels = [ev for ev in prof.events() if ev.device_type == DeviceType.CUDA]
        busy = busy_ms([(ev.time_range.start, ev.time_range.end) for ev in kernels])
        host = statistics.median(h for h, _, _ in timed)
        step = statistics.median(s for _, _, s in timed)
        print(json.dumps({
            "card": gpu, "decode": "beam" if rows > 1 else "greedy", "rows": rows, "steps": DECODE_STEPS,
            "ms_per_step": 1e3 * step, "issue_ms_per_step": 1e3 * statistics.median(i for _, i, _ in timed),
            "host_filter_ms_per_step": 1e3 * host, "host_share": host / (host + step),
            "device_busy_ms_per_step": busy / (DECODE_STEPS + 1),
            "device_spans_per_step": len(kernels) / (DECODE_STEPS + 1)}), flush=True)


TRAIN_BATCH, TRAIN_FRAMES = 8, 512  # the diffusion step: chip_smoke path v's batch
GAN_BATCH, GAN_FRAMES = 2, 32  # the GAN steps: chip_smoke path w's segments
TRAIN_RUNS = 7  # the first two are warm-up


def train_times(cfg, gpu: str) -> None:
    """Warm training steps at the widths of ``config/config.json`` on
    synthetic batches: the diffusion step (B = 8, 512 frames, random
    features of the loader's shapes) and the GAN's discriminator and
    generator steps (B = 2 segments of 32 frames of the synthetic clip and
    their log-mels). One JSON line each: the median wall ms of runs 3-7 to
    a synchronisation, the peak device memory, and one more step under
    ``torch.profiler`` (:func:`device_breakdown`)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from svc_inference_pipeline_tpu_torch.ops.mel import mel_spectrogram
    from svc_inference_pipeline_tpu_torch.training.diffusion import (
        init_diffusion_train_state, make_diffusion_train_step)
    from svc_inference_pipeline_tpu_torch.training.gan import init_gan_train_state, make_gan_train_steps

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    b, t = TRAIN_BATCH, TRAIN_FRAMES
    batch = {"mel": np.clip(0.5 * rng.standard_normal((b, t, cfg.mapper.n_mel)), -1, 1).astype(np.float32),
             "content_whisper": rng.standard_normal((b, t, cfg.mapper.input_content_dim["whisper"])).astype(np.float32),
             "melody": rng.uniform(100, 500, (b, t)).astype(np.float32),
             "loudness": rng.uniform(0, 1, (b, t)).astype(np.float32),
             "singer": rng.integers(0, 4, (b, 1)).astype(np.int32)}
    state, opt = init_diffusion_train_state(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    step = make_diffusion_train_step(cfg, opt)
    gen = torch.Generator(device=dev).manual_seed(1)

    def diffusion():
        nonlocal state
        state, loss = step(state, batch, gen)
        float(loss)

    n = GAN_FRAMES * cfg.hop_length
    audio = synth_clip(cfg.fs, 4.0)
    wave = torch.as_tensor(np.stack([audio[i * cfg.fs: i * cfg.fs + n] for i in range(GAN_BATCH)]), device=dev)
    mel = mel_spectrogram(wave, cfg.n_fft, cfg.n_mels, cfg.fs, cfg.hop_length, cfg.win_length, cfg.fmin,
                          cfg.fmax).transpose(1, 2)
    gan_batch = {"mel": mel, "wave": wave}
    gstate, gopt, dopt = init_gan_train_state(cfg, torch.Generator(device=dev).manual_seed(2), device=dev)
    disc_step, gen_step = make_gan_train_steps(cfg, gopt, dopt)

    def disc():
        nonlocal gstate
        gstate, loss = disc_step(gstate, gan_batch)
        float(loss)

    def generator():
        nonlocal gstate
        gstate, loss, _ = gen_step(gstate, gan_batch)
        float(loss)

    for name, fn, shape in (("diffusion step", diffusion, f"B={b}, T={t}"),
                            ("gan discriminator step", disc, f"B={GAN_BATCH}, {n} samples"),
                            ("gan generator step", generator, f"B={GAN_BATCH}, {n} samples")):
        torch.cuda.reset_peak_memory_stats()
        runs = []
        for _ in range(TRAIN_RUNS):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            runs.append(time.perf_counter() - t0)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
        line = {"card": gpu, "path": name, "shape": shape, "ms": 1e3 * statistics.median(runs[2:]),
                "first_ms": 1e3 * runs[0], "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                "profiled_ms": wall_ms, **device_breakdown(prof, wall_ms, top_n=10)}
        print(json.dumps(line), flush=True)


def k6_ties(gpu: str) -> None:
    """``--k6-ties``: where K6 int8-w1 parts from its plain version on the
    operands of ``tests/test_torch_kernels.py::
    test_k6_tiles_and_halos_at_clip_boundaries[100-384-int8-w1]`` (seed 0,
    B = 2 clips of T = 100 whose x differ 8x, C = 384, L = 5, weights
    N(0, 1/n) with n the last axis), with the step rows embedded by the host
    table of timescales and by the card's own f32 pow. For each, per layer:
    the kernel's h (read from its scratch after a stack cut to that many
    layers) against the plain chain's and against one plain layer from the
    kernel's own input h; the conv input's scale s_y of each clip (the
    kernel's [L, B] abs-max buffer against the plain one's); and the int8
    codes of the conv input that differ (the kernel's rebuilt from its h and
    s_y with its formula), with the first (layer, clip, row, column) where
    h parts, for the plain version summing its bf16 products in f32. Then
    eps per clip against the plain version summing in f32 and in the
    kernel's order (``wgmma_matmul``), over max|eps|, and the h of each
    layer that the kernel-order plain version does not reproduce. One
    JSON line per embedding."""
    from unittest import mock

    import torch

    from svc_inference_pipeline_tpu_torch.config import HParams
    from svc_inference_pipeline_tpu_torch.models import diffsvc
    from svc_inference_pipeline_tpu_torch.ops.pallas import _build
    from svc_inference_pipeline_tpu_torch.ops.pallas import denoiser_step as ds

    dev, bf = torch.device("cuda"), torch.bfloat16
    b, t_len, c, n_layers = 2, 100, 384, 5

    def device_pow(half):
        return (10.0 ** (torch.arange(half, dtype=torch.float32, device=dev) * 4.0 / (half - 1))).cpu().numpy()

    def operands():
        g = torch.Generator(device=dev).manual_seed(0)
        cfg = HParams(residual_channels=c, residual_layer_num=n_layers, n_mel=100, conditioner_size=c,
                      diffusion_fc_size=128, dilation_cycle_length=4, residual_kernel_size=3)
        with torch.device(dev):
            den = diffsvc.DiffSVCDenoiser(cfg, bf)
        with torch.no_grad():
            for p in den.parameters():
                p.copy_(torch.randn(p.shape, generator=g, device=dev) / (p.shape[-1] ** 0.5 if p.dim() > 1 else 10))
            den = den.to(bf)
            cond = torch.randn((b, t_len, c), generator=g, device=dev)
            cp, rows = den.precompute(cond, 10, bf)
            st = ds.stack_denoiser_params(den, bf, "int8-w1")
            condb = ds.fold_conditioner(den, cp, bf)
        x = (8.0 ** torch.arange(b, device=dev)).view(b, 1, 1) * torch.randn((b, t_len, 100), generator=g, device=dev)
        return st, condb, rows[3].contiguous(), x

    def cut(st, condb, row, k):
        part = st._replace(w1=st.w1[:k].contiguous(), wout=st.wout[:k].contiguous(), bout=st.bout[:k].contiguous(),
                           w1s=st.w1s[:k].contiguous(), w1_kmajor=st.w1_kmajor[:k].contiguous())
        return part, condb[:k].contiguous(), row[:k].contiguous()

    def kernel_h(st, condb, row, x):
        """The kernel's h after the stack's last layer and its [L, B] abs-max buffer."""
        xp = torch.nn.functional.pad(x, (0, st.wmel.shape[0] - x.shape[-1]))
        eps = torch.empty_like(x)
        scratch, ptrs, dims = ds._forward_operands(st, condb, row, x)
        _build.check(_build.lib().svc_denoise(xp.data_ptr(), eps.data_ptr(), *ptrs, *dims, x.shape[-1],
                                              torch.cuda.current_stream().cuda_stream), "svc_denoise")
        torch.cuda.synchronize()
        h, _g, _s1, _skip, amax, _y = scratch
        return h.float().view(b, t_len, c), amax.clone()

    def codes(h, row, s_y):  # the kernel's quantiser: f32 add, times the f32 1/s_y, rint, clip
        inv = (1.0 / s_y).float()
        return torch.clamp(torch.round((h + row.float()) * inv), -127, 127)

    for embedding in ("host table", "card pow"):
        patch = mock.patch.object(diffsvc, "step_timescales", device_pow) if embedding == "card pow" else None
        with torch.no_grad(), (patch or mock.patch.object(diffsvc, "step_timescales", diffsvc.step_timescales)):
            st, condb, row, x = operands()
            xp = torch.nn.functional.pad(x, (0, st.wmel.shape[0] - x.shape[-1]))
            trace = []
            ds.forward_plain(st, condb, row, xp, trace, kernel_order=False)
            layers, first = [], None
            k_in = trace[0]["h"]  # the mel preprocess: a bf16 GEMM on both sides
            for k in range(1, n_layers + 1):
                h_k, amax = kernel_h(*cut(st, condb, row, k), x)
                s_kernel = torch.clamp(amax[k - 1], min=1e-12) * ds.INV_127
                s_plain = trace[k - 1]["s_y"].view(b)
                q_kernel = codes(k_in, row[k - 1], s_kernel.view(b, 1, 1))
                q_plain = trace[k - 1]["yq"]
                h_plain = trace[k]["h"] if k < n_layers else None
                row_k = {"layer": k - 1,
                         "s_y_equal": [bool(a == p) for a, p in zip(s_kernel.tolist(), s_plain.tolist())],
                         "codes_differ": int((q_kernel != q_plain).sum()),
                         "codes_differ_by_clip": [int((q_kernel[i] != q_plain[i]).sum()) for i in range(b)],
                         # layer 0's input is the plain prologue's h on both sides
                         "input_h_differs": int((k_in != trace[k - 1]["h"]).sum())}
                if h_plain is not None:
                    diff = (h_k != h_plain).nonzero()
                    row_k["output_h_differs"] = int(diff.shape[0])
                    if first is None and diff.shape[0]:
                        first = {"layer": k - 1, **dict(zip(("clip", "row", "col"), diff[0].tolist()))}
                layers.append(row_k)
                k_in = h_k
            # one layer of the plain version on the kernel's own input, layer by layer
            one_layer = []
            for k in range(1, n_layers):  # layer k's input is the kernel's h after k layers
                h_prev = kernel_h(*cut(st, condb, row, k), x)[0]
                part, cb, rw = cut(st, condb, row, k + 1)
                h_next = kernel_h(part, cb, rw, x)[0]
                y = h_prev + rw[k].float()
                s = torch.clamp(y.abs().amax(dim=(1, 2), keepdim=True), min=1e-12) * ds.INV_127
                q = torch.clamp(torch.round(y * (1.0 / s)), -127.0, 127.0)
                acc = ds._int8_matmul(ds._taps(q, 2 ** (k % st.cycle)), st.w1[k]) * (s * st.w1s[k]) + cb[k].float()
                gt = torch.sigmoid(acc[..., :c]) * torch.tanh(acc[..., c:])
                yo = gt.to(bf).float() @ st.wout[k].float() + st.bout[k].float()
                h_one = ((h_prev + yo[..., :c]) * diffsvc.INV_SQRT2).to(bf).float()
                one_layer.append(int((h_one != h_next).sum()))
            eps = ds.denoise(st, condb, row, x)
            err = {}
            for order in (False, True):  # the plain version summing in f32, and in the kernel's order
                ref = ds.forward_plain(st, condb, row, xp, kernel_order=order)[..., :100]
                err["kernel order" if order else "f32"] = [
                    float((eps[i] - ref[i]).abs().max() / ref[i].abs().max()) for i in range(b)]
            kt = []
            ds.forward_plain(st, condb, row, xp, kt, kernel_order=True)
            kernel_order_h = [int((kernel_h(*cut(st, condb, row, k), x)[0] != kt[k]["h"]).sum())
                              for k in range(1, n_layers)]
            print(json.dumps({"card": gpu, "k6_ties": embedding, "eps_err_over_max": err,
                              "kernel_order_h_differs": kernel_order_h, "eps_bitwise_kernel_order":
                              bool(torch.equal(eps, ds.denoise_plain(st, condb, row, x))),
                              "tolerance": 1.5e-2, "first_h_part": first, "layers": layers,
                              "one_plain_layer_h_differs": one_layer,
                              "card_pow_differs": int((device_pow(64) != diffsvc.step_timescales(64)).sum())}),
                  flush=True)


def span_costs(pipe, gpu: str, spans_timed: int = 100_000) -> None:
    """The host cost of one span with no profiler running (the median of
    five loops of ``spans_timed`` empty spans), the spans of one warm 10 s
    DDPM conversion and their cost's share of it, then the same conversion
    under ``observability.profile`` (the CLI's ``--profile``): its device
    idle time by span. One JSON line."""
    import collections
    import glob
    import tempfile

    import torch

    from svc_inference_pipeline_tpu_torch.utils import observability as obs

    costs = []
    for _ in range(5):
        t = time.perf_counter_ns()
        for _ in range(spans_timed):
            with obs.trace("measure.span"):
                pass
        costs.append((time.perf_counter_ns() - t) / spans_timed)
    wav = synth_clip(pipe.cfg.fs, 10.0)

    def convert():
        pipe.convert(wav, "svcc_CDF1", generator=torch.Generator(device=pipe.device).manual_seed(0),
                     sampler="ddpm")

    convert()
    convert()
    t0 = time.perf_counter_ns()
    convert()
    names = collections.Counter(s.name for s in obs.spans(t0))
    timings = dict(pipe.timings)
    with tempfile.TemporaryDirectory() as d:
        with obs.profile(d):
            convert()
        (path,) = glob.glob(os.path.join(d, "idle_*.json"))
        with open(path) as f:
            idle = json.load(f)
    span_ns = statistics.median(costs)
    n = sum(names.values())
    print(json.dumps({"card": gpu, "span_ns": span_ns, "span_ns_loops": costs, "spans_per_conversion": n,
                      "spans_by_name": dict(names), "timings": timings,
                      "span_share_of_conversion": n * span_ns / 1e9 / timings["total_s"],
                      "profiled_timings": dict(pipe.timings), "idle_by_span": idle}), flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--profile", action="store_true")
    p.add_argument("--steps", action="store_true")
    p.add_argument("--k2", action="store_true")
    p.add_argument("--batch", action="store_true")
    p.add_argument("--decode", action="store_true")
    p.add_argument("--train", action="store_true")
    p.add_argument("--k6-ties", action="store_true")
    p.add_argument("--spans", action="store_true")
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("measure: no CUDA device", file=sys.stderr)
        return 2
    from svc_inference_pipeline_tpu_torch.config import DEFAULT_CONFIG, load_config
    from svc_inference_pipeline_tpu_torch.pipeline.convert import SVCPipeline

    gpu = card()
    cfg = load_config(DEFAULT_CONFIG)
    if args.steps:
        step_times(cfg, gpu)
        return 0
    if args.k2:
        with torch.no_grad():
            k2_times(cfg, gpu)
        return 0
    if args.decode:
        decode_times(gpu)
        return 0
    if args.train:
        train_times(cfg, gpu)
        return 0
    if args.k6_ties:
        k6_ties(gpu)
        return 0
    root = os.path.dirname(os.path.dirname(DEFAULT_CONFIG))
    for key in ("singer_file", "min_mel_file", "max_mel_file", "target_f0_file"):
        cfg[key] = os.path.join(root, cfg[key].lstrip("./"))
    pipe = SVCPipeline.from_config(cfg, random_weights=True, whisper_size="medium", seed=0)
    if args.batch:
        batch_times(pipe, gpu)
        return 0
    if args.spans:
        span_costs(pipe, gpu)
        return 0
    for seconds in CLIP_SECONDS:
        wav = synth_clip(cfg.fs, seconds)
        for sampler, speedup, quantize, tail in PATHS:
            pipe.set_quantize(quantize, tail)
            runs = []
            for _ in range(RUNS):
                t0 = time.perf_counter()
                pipe.convert(wav, "svcc_CDF1", generator=torch.Generator(device=pipe.device).manual_seed(0),
                             sampler=sampler, speedup=speedup)
                runs.append(dict(pipe.timings, wall_s=time.perf_counter() - t0))
            warm = runs[1:]
            med = {k: statistics.median(r[k] for r in warm) for k in warm[0]}
            line = {"card": gpu, "clip_s": seconds, "path": path_name(sampler, speedup, quantize, tail),
                    **med, "rtf": med["total_s"] / seconds,
                    "first_total_s": runs[0]["total_s"]}
            if args.profile and seconds == CLIP_SECONDS[0]:
                line.update(profile_conversion(pipe, wav, sampler, speedup))
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
