"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. prints the card (nvidia-smi name and power limit) and the torch/CUDA
   versions, and turns TF32 off for the plain references;
2. builds the hand-written kernels from ``svc_inference_pipeline_tpu_torch/csrc``;
3. holds each kernel against its plain PyTorch version on the card at the
   main-path shapes of a 4 s clip (K1 one DDPM step at T=384, K4 one Whisper
   layer's attention and a masked-tail case, K2 the six vocoder stages, K3 the final activation),
   with median CUDA-event times of both;
4. converts a synthetic 4 s clip through the port's CLI (random weights,
   Whisper-medium, DiffSVC 20x384, BigVGAN 1536, DDPM-1000) and checks the
   WAV and the kernels' launch counts;
5. prints the kernels' JSON line, then the result line.

Imports nothing of JAX. Exits non-zero, without a result line, when there is
no CUDA device or any check fails.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
PKG = "svc_inference_pipeline_tpu_torch"
CLIP_SECONDS = 4.0
SINGER = "svcc_CDF1"


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median milliseconds of fn() between CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bf16_ulp(v: float) -> float:
    """Spacing of bf16 numbers (8 significant bits) at magnitude v."""
    return 2.0 ** (math.floor(math.log2(v)) - 7)


# Tolerances, as functions of max|plain| (of the compared view):
# - bf16 outputs (K4, K2, K3): kernel and plain version round the same f32
#   values to bf16 after summing them in another order, so an output may land
#   one bf16 step away; measured at most 1 ulp of max|plain| on an H100. The
#   bound is 2 ulps.
# - K1's eps (f32 out of a 20-layer chain with bf16 h): measured 3.7e-3 of
#   max|eps| on an H100; the bound is 1e-2, 2.7x that.
BF16_TOL = (lambda m: 2 * bf16_ulp(m), "2 bf16 ulps of max|plain|")
EPS_TOL = (lambda m: 1e-2 * m, "1e-2 x max|plain|")


def compare(name: str, kernel_fn, plain_fn, tol, view=None, reps: int = 10):
    """Run kernel and plain once, check max|view(kernel) - view(plain)| against
    tol (a (function of max|view(plain)|, description) pair), then time both.
    Returns (max_abs_err, kernel_ms, plain_ms)."""
    import torch

    got = kernel_fn()
    ref = plain_fn()
    torch.cuda.synchronize()
    if got.shape != ref.shape or got.dtype != ref.dtype:
        raise AssertionError(f"{name}: kernel {got.dtype} {tuple(got.shape)} vs plain {ref.dtype} {tuple(ref.shape)}")
    if not torch.isfinite(got.float()).all():
        raise AssertionError(f"{name}: kernel output is not finite")
    if view is not None:
        got, ref = view(got.float()), view(ref.float())
    err = (got.float() - ref.float()).abs().max().item()
    ref_max = ref.float().abs().max().item()
    tol_of, tol_text = tol
    bound = tol_of(ref_max)
    ms = cuda_ms(kernel_fn, reps)
    plain_ms = cuda_ms(plain_fn, reps)
    print(f"  {name}: max_abs_err {err:.3e} (tol {bound:.3e} = {tol_text}, max|plain| {ref_max:.3e}) "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    if not err <= bound:
        raise AssertionError(f"{name}: max_abs_err {err} > tol {bound}")
    return err, ms, plain_ms


def check_k4(g, device) -> tuple:
    """K4 at one Whisper-medium layer's shape, [1, 1500, 1024], 16 heads, bf16:
    random q/k/v, then a masked-tail case. There every real key scores about
    -8 against every query, while the zero rows that pad the keys to 1536
    would score 0: an unmasked softmax would put ~99% of its weight on them
    and pull the output from ~1 to ~0.01."""
    import torch

    from svc_inference_pipeline_tpu_torch.ops.pallas import attention

    bf = torch.bfloat16
    shape = (1, 1500, 1024)
    print("K4 encoder_attention [1, 1500, 1024], 16 heads, bf16")
    q, k, v = (torch.randn(shape, generator=g, device=device).to(bf) for _ in range(3))
    err, ms, plain_ms = compare(
        "K4 attention",
        lambda: attention.encoder_attention(q, k, v, 16),
        lambda: attention.encoder_attention_plain(q, k, v, 16),
        BF16_TOL,
    )
    qm = (1.0 + 0.1 * torch.randn(shape, generator=g, device=device)).to(bf)
    km = (-1.0 - 0.1 * torch.randn(shape, generator=g, device=device)).to(bf)
    vm = (1.0 + 0.5 * torch.randn(shape, generator=g, device=device)).to(bf)
    err_tail, _, _ = compare(
        "K4 masked tail",
        lambda: attention.encoder_attention(qm, km, vm, 16),
        lambda: attention.encoder_attention_plain(qm, km, vm, 16),
        BF16_TOL, reps=2,
    )
    return max(err, err_tail), ms, plain_ms


def randomize_vectors_(module, generator, scale: float = 0.1) -> None:
    """Random 1-D leaves (biases, snake alpha/beta): the random init zeroes
    them, which would hide a bias or alpha/beta mix-up."""
    import torch

    with torch.no_grad():
        for p in module.parameters():
            if p.dim() == 1:
                p.copy_(scale * torch.randn(p.shape, generator=generator, device=generator.device))


def check_kernels(cfg, device) -> dict:
    """Kernel vs plain at the 4 s main-path shapes; returns per-kernel rows."""
    import torch

    from svc_inference_pipeline_tpu_torch.checkpoints.from_jax import random_init_
    from svc_inference_pipeline_tpu_torch.models.bigvgan import BigVGANGenerator
    from svc_inference_pipeline_tpu_torch.models.diffsvc import DiffSVCDenoiser
    from svc_inference_pipeline_tpu_torch.ops.pallas import amp_stage, denoiser_step, snake
    from svc_inference_pipeline_tpu_torch.sampling.schedule import DiffusionSchedule

    g = torch.Generator(device=device).manual_seed(1234)
    bf = torch.bfloat16
    rows = {}
    n_frames = 384  # 4 s at hop 256, padded to the 64-frame bucket

    # K1: one DDPM step, B=1, T=384, C=384, L=20, bf16
    with torch.device(device):
        den = DiffSVCDenoiser(cfg.mapper, compute_dtype=bf)
    random_init_(den, g)
    randomize_vectors_(den, g)
    den = den.to(bf)
    cond = torch.randn((1, n_frames, cfg.mapper.conditioner_size), generator=g, device=device)
    sched = DiffusionSchedule.from_config(cfg.mapper)
    cond_projs, step_rows = den.precompute(cond, sched.num_steps, bf)
    st = denoiser_step.stack_denoiser_params(den, bf)
    condb = denoiser_step.fold_conditioner(den, cond_projs, bf)
    m_pad = st.wmel.shape[0]
    x = torch.zeros((1, n_frames, m_pad), device=device)
    x[..., : cfg.mapper.n_mel] = torch.randn((1, n_frames, cfg.mapper.n_mel), generator=g, device=device)
    z = torch.zeros_like(x)
    z[..., : cfg.mapper.n_mel] = torch.randn((1, n_frames, cfg.mapper.n_mel), generator=g, device=device)
    t_mid = sched.num_steps // 2
    # a schedule row that gives x' = clamp(eps/16, +-1) * 16 + x/2 + z/2 = eps + x/2 + z/2
    # (|eps| < 16): eps at full weight, and the update's x and z terms in use.
    # A real row scales eps by ~1e-2 or clamps it away; the check holds
    # x' - x/2 - z/2, i.e. eps, against the plain version's.
    probe = (0.0, -1.0 / 16.0, 16.0, 0.5, 0.5)
    print("K1 ddpm_step [1, 384, 128] f32 carry, C=384, L=20, bf16 weights")
    rows["K1"] = compare(
        "K1 eps probe",
        lambda: denoiser_step.ddpm_step(st, condb, step_rows[t_mid], x, z, probe),
        lambda: denoiser_step.ddpm_step_plain(st, condb, step_rows[t_mid], x, z, probe),
        EPS_TOL, view=lambda y: y - 0.5 * x - 0.5 * z,
    )

    rows["K4"] = check_k4(g, device)

    # K2: the six stages of BigVGAN-1536 for a 4 s clip; K3: activation_post
    vcfg = cfg.vocoder
    with torch.device(device):
        voc = BigVGANGenerator(vcfg, compute_dtype=bf)
    random_init_(voc, g)
    randomize_vectors_(voc, g)
    with torch.no_grad():
        for p in voc.parameters():  # the pipeline's cast policy
            if p.dim() >= 2:
                p.data = p.data.to(bf)
    voc.prepare_kernel_params()
    ks = tuple(vcfg.resblock_kernel_sizes)
    dils = tuple(tuple(d) for d in vcfg.resblock_dilation_sizes)
    t_len = n_frames
    errs, ms, plain_ms = [], 0.0, 0.0
    for i, u in enumerate(vcfg.upsample_rates):
        t_len *= u
        c = vcfg.upsample_initial_channel // 2 ** (i + 1)
        xs = (0.5 * torch.randn((1, t_len, c), generator=g, device=device)).to(bf)
        params = voc.kernel_stages[i]
        print(f"K2 fused_amp_stage stage {i} [1, {t_len}, {c}] bf16")
        e, m, pm = compare(
            f"K2 stage {i}",
            lambda xs=xs, params=params: amp_stage.fused_amp_stage(xs, params, ks, dils),
            lambda xs=xs, params=params: amp_stage.amp_stage_plain(xs, params, ks, dils),
            BF16_TOL, reps=5,
        )
        errs.append(e)
        ms += m
        plain_ms += pm
    rows["K2"] = (max(errs), ms, plain_ms)

    c_post = vcfg.upsample_initial_channel // 2 ** len(vcfg.upsample_rates)
    print(f"K3 fused_activation1d [1, {t_len}, {c_post}] bf16")
    xa = (0.5 * torch.randn((1, t_len, c_post), generator=g, device=device)).to(bf)
    alpha, beta = voc.activation_post.params()
    a_eff, inv_b = snake.effective_params(alpha, beta, vcfg.activation, vcfg.snake_logscale)
    rows["K3"] = compare(
        "K3 activation",
        lambda: snake.fused_activation1d(xa, alpha, beta, vcfg.activation, vcfg.snake_logscale),
        lambda: snake.activation1d_plain(xa, a_eff, inv_b),
        BF16_TOL,
    )
    return rows


def synth_clip(path: str, fs: int, seconds: float) -> int:
    """A harmonic tone with vibrato, a 0.4 s silent gap and a little noise."""
    import numpy as np

    from svc_inference_pipeline_tpu_torch.utils.audio_io import write_wav

    t = np.arange(int(seconds * fs)) / fs
    f0 = 220.0 * 2 ** (0.5 / 12 * np.sin(2 * np.pi * 5.5 * t))
    phase = 2 * np.pi * np.cumsum(f0) / fs
    x = sum((0.3 / k) * np.sin(k * phase) for k in range(1, 7))
    gap = (t > 1.8) & (t < 2.2)
    x[gap] = 0.0
    x = x + 1e-3 * np.random.default_rng(0).standard_normal(len(t))
    write_wav(path, x.astype(np.float32), fs)
    return len(t)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    os.chdir(ROOT)
    sys.path.insert(0, ROOT)
    card = card_line()
    print(card)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from svc_inference_pipeline_tpu_torch import cli
    from svc_inference_pipeline_tpu_torch.config import load_config
    from svc_inference_pipeline_tpu_torch.ops.pallas import _build, amp_stage, attention, denoiser_step, snake
    from svc_inference_pipeline_tpu_torch.pipeline.convert import mel_frame_count
    from svc_inference_pipeline_tpu_torch.utils.audio_io import read_wav

    t0 = time.perf_counter()
    info = _build.build_info()
    print(f"kernels built in {info['build_seconds']:.1f}s ({time.perf_counter() - t0:.1f}s with load): {info['path']}")
    for line in info["build_log"].splitlines():
        if "spill" in line and " 0 bytes spill stores, 0 bytes spill loads" not in line:
            print("  ptxas:", line.strip())

    cfg = load_config(os.path.join(ROOT, "config", "config.json"))
    device = torch.device("cuda")
    with torch.no_grad():
        rows = check_kernels(cfg, device)
    torch.cuda.synchronize()

    counters = {"K1": denoiser_step.ddpm_step, "K4": attention.encoder_attention,
                "K2": amp_stage.fused_amp_stage, "K3": snake.fused_activation1d}
    with tempfile.TemporaryDirectory() as tmp:
        wav_in = os.path.join(tmp, "clip.wav")
        n_samples = synth_clip(wav_in, cfg.fs, CLIP_SECONDS)
        wav_out = os.path.join(tmp, "out.wav")
        timings_path = os.path.join(tmp, "timings.json")
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        rc = cli.main(["--input", wav_in, "--singer", SINGER, "--output", wav_out, "--random-weights",
                       "--whisper-size", "medium", "--seed", "0", "--device", "cuda",
                       "--timings-json", timings_path])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in counters.items()}
        if rc != 0:
            raise AssertionError(f"cli.main returned {rc}")
        with open(timings_path) as f:
            timings = json.load(f)
        samples, sr = read_wav(wav_out)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    # the WAV: n_frames * hop samples between save_audio's 50 ms silences
    pipe_frames = mel_frame_count(cfg, n_samples)
    silence = cfg.fs // 20
    audio = samples[silence: len(samples) - silence, 0].astype("float64") / 32768.0
    if sr != cfg.fs or len(audio) != pipe_frames * cfg.hop_length:
        raise AssertionError(f"WAV has {len(audio)} samples at {sr} Hz, expected "
                             f"{pipe_frames * cfg.hop_length} at {cfg.fs}")
    import numpy as np

    if not np.isfinite(audio).all() or not np.abs(audio).max() > 0:
        raise AssertionError("converted audio is not finite or is all zero")
    expected = {"K1": int(cfg.mapper.noise_schedule_factors[2]), "K4": 24, "K2": 6, "K3": 1}
    print(f"end to end: {CLIP_SECONDS:g} s clip -> {len(audio)} samples, launches {launches} "
          f"(expected {expected})")
    print(f"  front-end {timings['frontend_s']:.3f}s, DDPM {timings['ddpm_s']:.3f}s, vocoder "
          f"{timings['vocoder_s']:.3f}s, conversion {timings['total_s']:.3f}s "
          f"(RTF {timings['total_s'] / timings['audio_s']:.4f}), CLI wall with model build {wall:.2f}s, "
          f"peak device memory {peak_gb:.2f} GB")
    if launches != expected:
        raise AssertionError(f"launch counts {launches} != expected {expected}")

    sources = {
        "K1": ("ddpm_step", f"{PKG}/csrc/denoiser_step.cu", "svc_inference_pipeline_tpu/ops/pallas/denoiser_step.py:376"),
        "K4": ("encoder_attention", f"{PKG}/csrc/attention.cu", "svc_inference_pipeline_tpu/ops/pallas/attention.py:57"),
        "K2": ("fused_amp_stage", f"{PKG}/csrc/amp_stage.cu", "svc_inference_pipeline_tpu/ops/pallas/amp_stage.py:432"),
        "K3": ("fused_activation1d", f"{PKG}/csrc/snake.cu", "svc_inference_pipeline_tpu/ops/pallas/snake.py:131"),
    }
    kernels = []
    for key, (name, source, replaces) in sources.items():
        err, ms, plain_ms = rows[key]
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                         "launches": launches[key], "max_abs_err": err, "ms": ms, "plain_ms": plain_ms})
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
