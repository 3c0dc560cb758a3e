"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. prints the card (nvidia-smi name and power limit) and the torch/CUDA
   versions, and turns TF32 off for the plain references;
2. builds the hand-written kernels from ``svc_inference_pipeline_tpu_torch/csrc``;
3. holds each kernel against its plain PyTorch version on the card at the
   main-path shapes of a 4 s clip, with median CUDA-event times of both and
   the least time the card could take for the same work (``bound_ms``):
   K1 one DDPM step at T=384 (with ``torch.matmul`` on the step's GEMM
   shapes timed beside it, ``gemm_library_ms``), K5 the eps-only forward,
   K6 the int8 forms of both ("int8" and "int8-w1", with ``torch._int_mm``
   on the step's int8 GEMM shapes timed beside them, ``int8_library_ms``,
   and a batch of two clips whose int8 scales differ 8x, also on the first
   two layers frame by frame), K4 one Whisper layer's attention and a
   masked-tail case (with ``scaled_dot_product_attention`` timed beside it
   and the ratio printed),
   K2 the six vocoder stages (each with its bound, the host time to issue
   it and ``F.conv1d`` on its 18 conv shapes timed beside it,
   ``conv_library_ms``), K3 the final activation (its kernel's device time
   under torch.profiler: one wrapper call is host-bound), K2 (stages 0 and
   5), K3 and K4 also on a batch of two clips (``batch2_ms``), K7 every AMPBlock1
   pair of stages 1-5 (C <= 384; with the 45 pairs' device time under
   torch.profiler and the host time to issue them, and ``F.conv1d`` on their
   90 convs, ``conv_library_ms``) and two clips shorter than a pair's two
   halos, K8 the one-launch eps forward at T=944 (against its plain version
   and K5), and K1 and K5 on the wide tile at Amphion's BiDilConv widths
   (C=512, L=40, step encoder 512) at the served cell's shapes
   (``WIDE_SHAPES``: K1 at B=1, T=960 and B=2, T=1000, whose last tile is
   partial; K5 at B=2, T=1536 and 1000), each clip to 1e-2 of its range,
   every launch counted as wide (``denoiser/launches_wide``), with bounds
   and ``torch.matmul`` on K1's 82 GEMM shapes timed beside it, and K9
   (Praat F0 and the median shift) on synthetic tones of 10 s at B=1 and
   10 s + 16 s at B=2, the batch bit for bit against its plain version and
   against each clip alone, each clip against the host route's numpy
   tracker (voicing and cents), which is timed beside it (``plain_ms``);
4. drives the main paths, each with the launch counters set to 0 just before
   it and read just after, on a synthetic 4 s clip at full width (random
   weights, Whisper-medium, DiffSVC 20x384, BigVGAN 1536); each
   conversion's front-end call below also launches K9 three times (j: 9 with its two
   clips' solo melodies; k, l: 6; the multi-rank paths y and z: 3 a rank):
   a. the CLI with DDPM-1000 in bf16 (K1 x 1000, K4 x 24, K2 x 6, K3 x 1);
   b. the CLI with ``--sampler plms --speedup 10 --quantize int8-w1``
      (K5 int8-w1 x 101), whose pipeline then runs
   c. DDIM@10 in bf16 (K5 x 100), d. DPM++@10 in "int8" (K5 int8 x 101),
   e. DDPM-1000 in "int8" with a 50-step bf16 tail (K1 int8 x 950, bf16 x 50);
   then the correlation of the int8-w1 DDPM-1000 final mel with the bf16 one
   for the same conditioning and noise, held to >= 0.9999;
   f. the CLI with a resblock-"2" vocoder (AMPBlock2, dilations [1, 3]) and
      PLMS@10 in bf16 (K5 x 101, K4 x 24, K3 x 37);
   g. the vocoder block by block on the clip's mel (384 frames):
      ``forward_per_block`` (K7 x 45, K3 x 19), then the generator's own
      forward on the same mel (K2 x 6, K3 x 1); the two waveforms must
      correlate >= 0.97;
   h. the TPU harness's loop x <- 1e-3 eps + 0.999 x over 100 steps at
      T=944, once through K8 (x 100) and once through K5 (x 100);
   i. the CLI with two inputs (4 s and 3 s, two singers) in one batch,
      DDPM-1000 bf16 (K1 x 1000, K4 x 24, K2 x 6, K3 x 1);
   j. batch independence, PLMS@10 int8-w1: two 4 s clips 8x apart in
      loudness through ``_convert_core`` as a batch and each alone on the
      same x_T rows (K4 x 24, K5 int8-w1 x 303, K2 x 18, K3 x 3); each clip's
      waveforms must correlate >= 0.9999, and its melody from K9 in the
      batch must equal K9's on the clip alone bit for bit;
   k. the HTTP server in process on 127.0.0.1: a burst of four PLMS@10 bf16
      requests, two 4 s and two 2 s clips, coalesced into two batches by
      length class (K5 x 202, K4 x 48, K2 x 12, K3 x 2), ``/metrics``,
      ``/healthz`` and ``/singers``;
   l. a streamed request, PLMS@10 int8-w1, 2 s chunks of the 4 s clip (K5
      int8-w1 x 202, K4 x 48, K2 x 12, K3 x 2);
   m. ``convert_multi_singer`` to three singers, PLMS@10 bf16 (K4 x 24, K5 x
      101 at B = 3, K2 x 6, K3 x 1);
   n. the CLI from checkpoint files and a FLAC clip, DDPM-1000 bf16 (K1 x 1000,
      K4 x 24, K2 x 6, K3 x 1): a seeded random pipeline at full width is
      written in the reference's file layouts (mapper ``state_dict`` behind
      DDP prefixes; BigVGAN ``generator_state_dict`` with every conv a
      weight-norm pair in both key styles; Whisper-medium fp16
      ``{"dims", "model_state_dict"}``, its text decoder cut to 2 layers) by
      this script's exporter, and the 4 s clip as 16-bit FLAC; the loaded
      parameters must equal the files' (the folds within one f32 ulp of
      g v / |v| in float64 on the card; ``torch._weight_norm``'s distance in
      float64 is printed beside it), the content features and final mel
      must equal, bit for bit, those of a pipeline holding the same weights
      directly, and the waveforms correlate >= 0.9999; the native codec's
      library must be loaded from ``build/native/``; prints the load seconds
      and the first and second conversion's wall time;
   o. ``eval --golden`` from the same files on the FLAC clip, scored against
      path n's WAV (K1 x 1000, K4 x 24, K2 x 6, K3 x 1): finite mel MAE, MCD,
      SNR and RTF, and an F0 RMSE that is finite or, where no frame is voiced
      in both waveforms (random weights give unvoiced noise), NaN as the
      metric defines it;
   q. (after o) the transcription CLI from path n's Whisper file (the text
      decoder cut to 2 layers), the 4 s clip at 16 kHz, without the
      temperature fallback (K4 x 24 for each 30 s window the transcription
      encodes: a window ends at its last timestamp pair, so a decode whose
      last pair falls inside the clip takes a second window over the rest):
      .txt/.vtt/.srt written; the
      loaded decoder's parameters equal the file's; the decoder's prime +
      one-token steps equal its full-prefix logits within 2e-4 on the card;
      the log-probs of a forced token sequence from the K4 route's bf16
      features and from the plain route's f32 features agree within
      ``LOGPROB_BF16_BOUND``;
   r. ``get_f0_features(method=m)`` on the 4 s clip for the Praat, DIO, pYIN
      and Harvest trackers (host numpy, no launches): each must voice >= 95%
      of the tone's frames (0.1-1.7 s and 2.3-3.9 s) within 50 cents of the
      true F0; prints each one's seconds and voiced share;
   s. CREPE at capacity "full" from a torchcrepe-layout file of random
      weights with non-trivial BatchNorm statistics (``crepe_checkpoint``)
      named by ``SVC_CREPE_WEIGHTS``: ``get_f0_features_using_crepe`` with its
      net on the card (no launches); f0 of mel_len frames and finite, the
      net's probabilities on the clip's frames within 1e-4 of the same
      module on the CPU; prints the net's ms and the whole call's;
   t. ``WhisperPPGExtractor.extract`` at Whisper-medium width on random
      weights: the 4 s clip (K4 x 24) and a 35 s clip with ``chunked=True``
      (two 30 s windows encoded as one batch: K4 x 24); shapes, finite
      values, and the 4 s features of the K4 route (bf16) against the plain
      route (f32) on the card within ``CONTENT_BF16_BOUND``; prints each
      call's ms;
   u. ContentVec at HuBERT-base width (12 layers, 768, output layer 9,
      ``final_proj`` 256) from a fairseq-layout file (``hubert_checkpoint``:
      ``{"args", "model"}``, the positional conv a weight-norm pair over dim
      2), ``extract`` on the card (no launches): the loaded parameters equal
      the file's (the fold within one f32 ulp of g v / |v| in float64),
      features [mel_len, 256],
      finite and within 1e-3 x max|cpu| of the same file on the CPU; prints
      the load seconds and the extract's ms;
   v. ``train_diffusion`` at the mapper's full width (20 x 384, Whisper-medium
      content 1024) on batches of eight synthetic 4 s clips in the 512-frame
      bucket from ``BucketedLoader`` (content from ``WhisperPPGExtractor.extract``
      on random medium weights, K4 x 24 a clip on the loader's first pass,
      before the counters are set to 0): 20 steps unbroken, and 10 steps, a
      checkpoint and a resumed run to 20, which must equal the unbroken run
      within ``RESUME_REL_BOUND`` (parameters, EMA and losses); no launches.
      Then one step on the card against the same step on the CPU from the
      same weights, batch and draws (both embedding the diffusion steps
      with the host table of timescales, ``diffsvc.step_timescales``):
      gradients per parameter within ``GRAD_CPU_REL_BOUND``. Prints ms a
      step (warm median) and peak memory;
   w. the GAN steps at the vocoder's full width (1536, six stages, MPD
      periods [2, 3, 5, 7, 11], three MRD resolutions) on B = 2 segments of
      32 frames: 3 discriminator and generator step pairs, the generator on
      its training route (``use_kernels=False``): no launches, every loss
      finite, every generator parameter a non-zero gradient. Prints ms per
      discriminator and generator step (warm medians) and peak memory;
   x. a fresh ``SVCPipeline`` from path v's EMA encoder and denoiser (its
      kernel stacks made from them) converts a 4 s clip with PLMS@10 (K5 x
      101, K4 x 24, K2 x 6, K3 x 1); its final mel must differ from the same
      conversion's on the untrained weights;
   aa. (after the int8-w1 mel check) the vocoder in 4 overlap-save chunks
      folded into one batch on the card (``parallel/tp_vocoder.py``, halo the
      receptive radius, 69 frames) on path e's final mel (384 frames), K2 x 6
      and K3 x 1, against the unchunked generator: SNR >= 12 dB and
      correlation >= 0.97 (the bf16 bounds of tests/test_bf16_drift.py); prints
      the max abs error;
   af. (after x) ``capture_intermediates`` on the full-width denoiser's own
      forward (20 x 384, f32, T = 384; no launches): the 44 entries (each
      block's ``noise_step_condition`` and ``__call__``, the step encoder's
      ``step_embedding``, ``step_encoder_output`` and ``__call__``, the
      output) present and finite, the output bit-equal to an uncaptured
      call's; prints both calls' ms;
   ag. (after f) the CLI with the denoiser at Amphion's BiDilConv widths
      (512 x 40, step encoder 512), DDPM-1000 in bf16 (K1 x 1000, K4 x 24,
      K2 x 6, K3 x 1), whose pipeline then runs ah. PLMS@10 in bf16 (K5 x
      101): each launch of their K1/K5 calls (83 a call) on the wide tile;
   y-ad and the train step on a mesh (after af): first which of the port's
      collectives gloo takes on CUDA tensors (``gloo_cuda_probe``: 2 ranks on
      cuda:0; NCCL refuses two ranks on one card). Then one spawn of 2 ranks on
      cuda:0 over gloo, each computing on the card with its kernels:
      y. DP (data 2): ``convert_batch`` of 4 clips, DDPM-1000 bf16 (K1 x 1000,
         K4 x 24, K2 x 6, K3 x 1 a rank), then PLMS@10 int8-w1 (K5 int8-w1 x
         101 a rank); each rank's waves equal, bit for bit, a single-process
         ``convert_batch`` of its two clips with that rank's generator;
      z. TP (model 2): one PLMS@10 conversion, K4 on 8 heads a rank, the
         mapper and denoiser TP (no denoiser kernel), the vocoder in 2 chunks
         (K2 x 6, K3 x 1 a rank); final mel correlation >= 0.999 and waveform
         SNR >= 12 dB, correlation >= 0.97 against the single-device pipeline
         on the same weights and noise;
      ab. SP (model 2): one 30 s window through ``encode_sequence_parallel``
         against the K4 encoder, within ``CONTENT_BF16_BOUND``, relative L2
         printed;
      the train step on a mesh (data 2, then model 2): one step on path v's
         first batch (B = 8, 512 frames) from the same state and global draws
         as one rank's step: loss and parameters within 1e-5 relative L2;
      ac. the GAN step pair on a mesh (data 2, then model 2: the generator's
         channels split by ``VOCODER_TP_RULES``): one discriminator and
         generator step of path w's full-width GAN on path w's batch from
         the same state as one rank's pair: losses, gradients (the
         generator's gathered) and the parameters whose gradient is at least
         ``GAN_SMALL_GRAD`` within ``GAN_MESH_REL_BOUND`` relative L2, or
         within the distance of a second single-rank pair or of one whose
         input mel moved by one f32 ulp, where that is larger (both printed);
         the other parameters within 2 lr; every loss finite, every
         generator parameter a non-zero gradient; no launches; prints ms a
         step on each rank;
      ad. the GPipe forward and backward at 2 stages (the ring's carries sent
         as host copies over gloo): the gradients of mean(eps^2) through the
         full-width denoiser (B = 4 x 256 frames, 2 microbatches, f32),
         summed over the pipe group, within ``PP_GRAD_REL_BOUND`` per leaf of
         one device's autograd, each rank's backward on its own stage's
         layers; no launches.
      Then ab's GPipe route at world size 1 over NCCL (NCCL refuses two ranks
      on one card): PLMS@10 through ``make_pp_denoise_fn`` on a
      one-stage pipe axis, f32, final mel correlation >= 0.9999 with the
      composed f32 denoiser. Each rank's launches go into the kernels' line;
   ae. the elastic supervisor over a real gang on the card: ``run_elastic``
      launches 2 workers (``chip_smoke.py --elastic-worker``, both on cuda:0,
      joined by ``ensure_initialized`` over gloo) that run
      ``train_diffusion`` on a data-2 mesh over path v's first batch, 4
      steps with a checkpoint every 2; worker 1 dies at step 3 of attempt 0.
      One restart, exit code 13 in attempt 0, [0, 0] in attempt 1, both
      workers resumed from step 2, and the final checkpoint within
      ``RESUME_REL_BOUND`` of an unbroken 2-worker run's; prints the seconds
      of each attempt;
   p. (last) the transcription CLI on the 4 s clip with Whisper-medium at
      full width (24 + 24 layers, 1024 wide, vocabulary 51865) on random
      weights, the whole fallback ladder (beam 5 at temperature 0, then
      sampling at 0.2-1.0), K4 x 24 a window as in q: .txt/.vtt/.srt written,
      ``transformers`` not imported; prints the tokens decoded, the decoder
      steps, the median ms of a step, the host's share of it and the whole
      call's seconds;
5. prints the card again, the kernels' JSON line (``launches`` summed over
   the paths; K6 counts K1's and K5's int8 launches), then the result line.

Imports nothing of JAX. Exits non-zero, without a result line, when there is
no CUDA device or any check fails.
"""

from __future__ import annotations

import collections
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
WHISPER_SIZE = "medium"
TPU_KERNELS = "svc_inference_pipeline_tpu/ops/pallas"
HARNESS_FRAMES = 944  # the TPU harness's clip (perf_kernel3.main)
# Amphion's DiffWaveNetSVC decoder, which runs on K1's wide tile (K = 512)
BIDILCONV = {"residual_channels": 512, "residual_layer_num": 40, "diffusion_fc_size": 512}
WIDE_TAG = "512x40"  # ends the names of the main paths on it
# (form, B, T) of the wide tile's checks: the served cell's shapes, a clip of
# 10 s and a batch of two padded to 1536 frames, and two clips of 1000 frames,
# whose last 64-row tile holds 40 rows
WIDE_SHAPES = (("K1", 1, 960), ("K1", 2, 1000), ("K5", 2, 1536), ("K5", 2, 1000))
HARNESS_STEPS = 100
VOCODER_MIN_CORR = 0.97  # per-block vs K2 waveform (the repo's bf16 tolerance, tests/test_bf16_drift.py)
# path n: the waveform from the files against the same weights held directly
# (the vocoder's g v / |v| in float64 on the card); only the folded vocoder
# weights may differ, by an f32 ulp before their bf16 cast
FILES_MIN_CORR = 0.9999

# Published peaks of one H100 SXM (dense): tensor-core bf16 and int8, f32
# and f64 outside the tensor cores (K9's float64 is DFMA on the vector units,
# 33.5 TFLOP/s, not the 67 of the f64 tensor cores), HBM bandwidth. bound_ms
# is the largest of bytes / bandwidth, the tensor-core time (bf16 and int8
# operations share those units, so their times add) and the f32 time (other
# units, which run at the same time as the tensor cores).
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12, "f64": 33.5e12}
TENSOR_CORE_OPS = ("bf16", "int8")
HBM_BYTES_PER_S = 3.35e12
SNAKE_OPS = 58  # f32 operations per element of one anti-aliased SnakeBeta: 24 up-FIR, 10 snake, 24 down-FIR
# K9 against the host tracker: voicing on this share of the frames, and this
# share of the frames both voice within F0_CENTS
F0_VOICING, F0_CENTS_SHARE, F0_CENTS = 0.995, 0.99, 5.0


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


def bound(nbytes: float, ops: dict) -> tuple:
    """(bound_ms, bound_by): the least time for ``nbytes`` of memory traffic
    and ``ops`` operations of each type."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(sum(ops.get(kind, 0) / PEAK_OPS[kind] for kind in TENSOR_CORE_OPS),
                ops.get("f32", 0) / PEAK_OPS["f32"])
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def denoiser_bound(st, condb, b: int, t_len: int, io_bytes: int) -> tuple:
    """K1/K5/K6 forward: every weight the kernel reads (the K-major copies of
    the int8 ones), scale, conditioner block and this step's rows read once
    plus ``io_bytes`` of carry, noise and result; the matmuls at the rate of
    their operand type (int8 where the stack is)."""
    n_layers, _, c2 = st.w1.shape
    c, m_pad, rows = c2 // 2, st.wmel.shape[0], b * t_len
    w1 = st.w1 if st.w1_kmajor is None else st.w1_kmajor
    wout = st.wout if st.wout_kmajor is None else st.wout_kmajor
    weights = [w1, wout, st.bout, st.wmel, st.bmel, st.wskip, st.bskip, st.wo, st.bo, st.w1s, st.wouts]
    nbytes = sum(w.nbytes for w in weights if w is not None) + condb.nbytes + n_layers * c * 2 + io_bytes
    conv, out = n_layers * 2 * rows * 3 * c * c2, n_layers * 2 * rows * c * c2
    ops = {"bf16": 2 * rows * c * (2 * m_pad + c), "int8": 0}
    ops["int8" if st.w1s is not None else "bf16"] += conv
    ops["int8" if st.wouts is not None else "bf16"] += out
    return bound(nbytes, ops)


def bf16_ulp(v: float) -> float:
    """Spacing of bf16 numbers (8 significant bits) at magnitude v."""
    return 2.0 ** (math.floor(math.log2(v)) - 7)


# Tolerances, as functions of max|plain| (of the compared view):
# - bf16 outputs (K4, K2, K3): kernel and plain version round the same f32
#   values to bf16 after summing them in another order, so an output may land
#   one bf16 step away; measured at most 1 ulp of max|plain| on an H100. The
#   bound is 2 ulps.
# - eps of the denoiser (K1, K5, K6; f32 out of a 20-layer chain with bf16 h,
#   held per batch element): measured 3.7e-3 of max|eps| for K1 on an H100;
#   the bound is 1e-2, 2.7x that.
# - eps of the int8 forms (K6): the int8 products are exact on both sides;
#   a bf16 h summed in another order, or a gate whose sigmoid and tanh
#   differ by ulps, can cross a rounding tie of a quantiser, which moves
#   that operand by a whole int8 step (1/127 of its range). The bounds were
#   set at about 2x the readings of a plain version summing its bf16
#   products in f32 (6.7e-3 to 7.3e-3 of max|eps| for int8-w1, 1.27e-2 for
#   "int8", L=20, an H100). Since the plain version sums them in the wgmma
#   tile's order (denoiser_step.wgmma_matmul) the two agree exactly on an
#   H100; the bounds stay.
# - the int8 forms on the stack's first two layers (B=2, the scales 8x
#   apart): there a tie flip is rare, and it reaches the few frames of its
#   conv taps, while a wrong scale or a wrongly rounded conv input moves
#   every frame. So besides the max error at most a quarter of each clip's
#   frames may differ by more than 1e-5 x max|plain| (FRAMES_OFF).
BF16_TOL = (lambda m: 2 * bf16_ulp(m), "2 bf16 ulps of max|plain|")
EPS_TOL = (lambda m: 1e-2 * m, "1e-2 x max|plain|")
INT8_TOL = {
    "int8-w1": (lambda m: 1.5e-2 * m, "1.5e-2 x max|plain|"),
    "int8": (lambda m: 2.5e-2 * m, "2.5e-2 x max|plain|"),
}
FRAMES_OFF = (1e-5, 0.25)  # (error per frame over max|plain|, largest share of frames)
PER_CLIP = (lambda y: y[0], lambda y: y[1])  # a batch of two clips, each held to its own range
# int8-w1's quality gate: the final mel of DDPM-1000 against the bf16 chain's
INT8_W1_MIN_CORR = 0.9999


def compare(name: str, kernel_fn, plain_fn, tol, views=(None,), reps: int = 10,
            frames: bool = False) -> dict:
    """Run kernel and plain once and check max|view(kernel) - view(plain)|
    against tol (a (function of max|view(plain)|, description) pair) for each
    view, and with ``frames`` the share of frames (rows of the view's last
    two axes) off by more than FRAMES_OFF; then time both. Returns
    max_abs_err, ms, plain_ms."""
    import torch

    got = kernel_fn()
    ref = plain_fn()
    torch.cuda.synchronize()
    if got.shape != ref.shape or got.dtype != ref.dtype:
        raise AssertionError(f"{name}: kernel {got.dtype} {tuple(got.shape)} vs plain {ref.dtype} {tuple(ref.shape)}")
    if not torch.isfinite(got.float()).all():
        raise AssertionError(f"{name}: kernel output is not finite")
    tol_of, tol_text = tol
    errs = []
    for view in views:
        g, r = (got.float(), ref.float()) if view is None else (view(got.float()), view(ref.float()))
        err = (g - r).abs().max().item()
        ref_max = r.abs().max().item()
        limit = tol_of(ref_max)
        off = ((g - r).abs().amax(dim=-1) > FRAMES_OFF[0] * ref_max).float().mean().item()
        print(f"  {name}: max_abs_err {err:.3e} (tol {limit:.3e} = {tol_text}, max|plain| {ref_max:.3e}), "
              f"frames off by > {FRAMES_OFF[0]:g} x max|plain|: {off:.4f}")
        if not err <= limit:
            raise AssertionError(f"{name}: max_abs_err {err} > tol {limit}")
        if frames and not off <= FRAMES_OFF[1]:
            raise AssertionError(f"{name}: {off:.4f} of the frames off, more than {FRAMES_OFF[1]}")
        errs.append(err)
    ms = cuda_ms(kernel_fn, reps)
    plain_ms = cuda_ms(plain_fn, reps)
    print(f"  {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    return {"max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms}


def check_k4(g, device) -> dict:
    """K4 at one Whisper-medium layer's shape, [1, 1500, 1024], 16 heads, bf16:
    random q/k/v, then a masked-tail case. There every real key scores about
    -8 against every query, while the zero rows that pad the keys to 1536
    would score 0: an unmasked softmax would put ~99% of its weight on them
    and pull the output from ~1 to ~0.01. ``scaled_dot_product_attention``
    on the same q, k, v is timed as the library's yardstick."""
    import torch
    import torch.nn.functional as F

    from svc_inference_pipeline_tpu_torch.ops.pallas import attention

    bf = torch.bfloat16
    shape = (1, 1500, 1024)
    print("K4 encoder_attention [1, 1500, 1024], 16 heads, bf16")
    q, k, v = (torch.randn(shape, generator=g, device=device).to(bf) for _ in range(3))
    row = compare(
        "K4 attention",
        lambda: attention.encoder_attention(q, k, v, 16),
        lambda: attention.encoder_attention_plain(q, k, v, 16),
        BF16_TOL,
    )
    qm = (1.0 + 0.1 * torch.randn(shape, generator=g, device=device)).to(bf)
    km = (-1.0 - 0.1 * torch.randn(shape, generator=g, device=device)).to(bf)
    vm = (1.0 + 0.5 * torch.randn(shape, generator=g, device=device)).to(bf)
    tail = compare(
        "K4 masked tail",
        lambda: attention.encoder_attention(qm, km, vm, 16),
        lambda: attention.encoder_attention_plain(qm, km, vm, 16),
        BF16_TOL, reps=2,
    )
    qh, kh, vh = (x.view(1, 1500, 16, 64).transpose(1, 2) for x in (q, k, v))
    row["library_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh))
    row["library_ratio"] = row["ms"] / row["library_ms"]
    print(f"  K4 scaled_dot_product_attention: {row['library_ms']:.4f} ms; "
          f"K4 / SDPA = {row['library_ratio']:.3f}")
    print("K4 encoder_attention [2, 1500, 1024], 16 heads, bf16: the batched front-end's two windows")
    q2, k2, v2 = (torch.randn((2,) + shape[1:], generator=g, device=device).to(bf) for _ in range(3))
    b2 = compare("K4 B=2", lambda: attention.encoder_attention(q2, k2, v2, 16),
                 lambda: attention.encoder_attention_plain(q2, k2, v2, 16), BF16_TOL, views=PER_CLIP)
    row["batch2_ms"] = b2["ms"]
    row["max_abs_err"] = max(row["max_abs_err"], tail["max_abs_err"], b2["max_abs_err"])
    row["bound_ms"], row["bound_by"] = bound(4 * q.nbytes, {"bf16": 4 * 1500 * 1500 * 1024})
    return row


def randomize_vectors_(module, generator, scale: float = 0.1) -> None:
    """Random 1-D leaves (biases, snake alpha/beta): the random init zeroes
    them, which would hide a bias or alpha/beta mix-up."""
    import torch

    with torch.no_grad():
        for p in module.parameters():
            if p.dim() == 1:
                p.copy_(scale * torch.randn(p.shape, generator=generator, device=generator.device))


def bidilconv_config(cfg):
    """``cfg`` with its denoiser at Amphion's BiDilConv widths (the benchmark's
    ``amphion-bidil512x40-ddpm1000-bf16``): 512 channels, 40 layers, step
    encoder 512; the conditioner stays at 384."""
    from svc_inference_pipeline_tpu_torch.config import HParams

    d = cfg.to_dict()
    d["mapper"].update(BIDILCONV)
    return HParams(**d)


def random_denoiser(cfg, g, device):
    import torch

    from svc_inference_pipeline_tpu_torch.checkpoints.from_jax import random_init_
    from svc_inference_pipeline_tpu_torch.models.diffsvc import DiffSVCDenoiser

    with torch.device(device):
        den = DiffSVCDenoiser(cfg.mapper, compute_dtype=torch.bfloat16)
    random_init_(den, g)
    randomize_vectors_(den, g)
    return den.to(torch.bfloat16)


def gemm_library_ms(st, b: int, t_len: int, g, device) -> float:
    """K1's yardstick: ``torch.matmul`` on the 2 + 2L GEMM shapes of one
    step (prologue, per layer the gate on its taps materialised as a
    [B*T, 3C] matrix and the residual, the skip and output projections), in
    bf16 into preallocated outputs, epilogues left out. Timed only: the port
    never calls it."""
    import torch

    n_layers, _, c2 = st.w1.shape
    c, m_pad, rows = c2 // 2, st.wmel.shape[0], b * t_len
    ops = [(st.wmel, m_pad)] + [(w, k) for i in range(n_layers)
                                for w, k in ((st.w1[i], 3 * c), (st.wout[i], c))] + [(st.wskip, c), (st.wo, c)]
    operands = [(torch.randn((rows, k), generator=g, device=device).to(torch.bfloat16), w,
                 torch.empty((rows, w.shape[1]), dtype=torch.bfloat16, device=device)) for w, k in ops]

    def run():
        for a, w, out in operands:
            torch.matmul(a, w, out=out)

    return cuda_ms(run)


def int8_library_ms(st, b: int, t_len: int, g, device) -> float:
    """K6's yardstick: ``torch._int_mm`` on the int8 GEMM shapes of one step
    of an int8 stack: the L gate GEMMs [B*T, 3C] x [3C, 2C] on the taps
    materialised, and in "int8" mode the L residual GEMMs [B*T, C] x
    [C, 2C]; int32 results, epilogues and quantisation left out. Timed only:
    the port never calls it."""
    import torch

    n_layers = st.w1.shape[0]
    rows = b * t_len
    ws = [st.w1[i] for i in range(n_layers)]
    if st.wouts is not None:
        ws += [st.wout[i] for i in range(n_layers)]
    operands = [(torch.randint(-127, 128, (rows, w.shape[0]), generator=g, device=device, dtype=torch.int8), w)
                for w in ws]

    def run():
        for a, w in operands:
            torch._int_mm(a, w)

    return cuda_ms(run)


def check_denoiser(cfg, g, device, n_frames: int) -> dict:
    """K1, K5 and K6 at B=1, T=n_frames, C=384, L=20, bf16 compute; K6 also at
    B=2 with the second clip's mel (so its int8 scale) 8x the first's; K8 at
    B=1, T=HARNESS_FRAMES; K1 and K5 on the wide tile at C=512, L=40 (fc 512)
    at WIDE_SHAPES, each clip to its own range, as rows "K1 512x40 B=b T=t"."""
    import torch

    from svc_inference_pipeline_tpu_torch.ops.pallas import denoiser_step as ds
    from svc_inference_pipeline_tpu_torch.ops.pallas import denoiser_v2 as dv2
    from svc_inference_pipeline_tpu_torch.sampling.schedule import DiffusionSchedule
    from svc_inference_pipeline_tpu_torch.utils.observability import Metrics

    bf = torch.bfloat16
    n_mel = cfg.mapper.n_mel
    den = random_denoiser(cfg, g, device)
    sched = DiffusionSchedule.from_config(cfg.mapper)
    t_mid = sched.num_steps // 2
    rows = {}

    def operands(b, quantize, layers=None, t_len=n_frames, net=den):
        """The stack, conditioner blocks and step rows of ``net``; with
        ``layers`` cut to the first ``layers`` layers."""
        cond = torch.randn((b, t_len, cfg.mapper.conditioner_size), generator=g, device=device)
        cond_projs, step_rows = net.precompute(cond, sched.num_steps, bf)
        st = ds.stack_denoiser_params(net, bf, quantize)
        condb, srow = ds.fold_conditioner(net, cond_projs, bf), step_rows[t_mid].contiguous()
        if layers is not None:
            per_layer = ("w1", "wout", "bout", "w1s", "wouts", "w1_kmajor", "wout_kmajor")
            st = st._replace(**{k: getattr(st, k)[:layers].contiguous() for k in per_layer
                                if getattr(st, k) is not None})
            condb, srow = condb[:layers].contiguous(), srow[:layers].contiguous()
        return st, condb, srow

    def mel(b, t_len=n_frames):
        scale = (8.0 ** torch.arange(b, device=device)).view(b, 1, 1)
        return scale * torch.randn((b, t_len, n_mel), generator=g, device=device)

    # a schedule row that gives x' = clamp(eps/16, +-1) * 16 + x/2 + z/2 = eps + x/2 + z/2
    # (|eps| < 16): eps at full weight, and the update's x and z terms in use.
    # A real row scales eps by ~1e-2 or clamps it away; the check holds
    # x' - x/2 - z/2, i.e. eps, against the plain version's.
    probe = (0.0, -1.0 / 16.0, 16.0, 0.5, 0.5)

    def ddpm_form(name, quantize, b=1, t_len=n_frames, net=den):
        st, condb, srow = operands(b, quantize, t_len=t_len, net=net)
        m_pad = st.wmel.shape[0]
        x = torch.nn.functional.pad(mel(b, t_len), (0, m_pad - n_mel)).contiguous()
        z = torch.nn.functional.pad(torch.randn((b, t_len, n_mel), generator=g, device=device),
                                    (0, m_pad - n_mel)).contiguous()
        print(f"{name} ddpm_step [{b}, {t_len}, {m_pad}] f32 carry, C={st.wskip.shape[0]}, L={st.w1.shape[0]}, "
              f"{st.mode} stack")
        row = compare(f"{name} eps probe", lambda: ds.ddpm_step(st, condb, srow, x, z, probe),
                      lambda: ds.ddpm_step_plain(st, condb, srow, x, z, probe),
                      EPS_TOL if quantize is None else INT8_TOL[quantize],
                      views=[lambda y, i=i: (y - 0.5 * x - 0.5 * z)[i] for i in range(b)])
        row["bound_ms"], row["bound_by"] = denoiser_bound(st, condb, b, t_len, 3 * x.nbytes)
        # the gate's cluster sum has a fixed order (f32) or is exact (int32), with no
        # atomics: two calls agree bit for bit
        if not torch.equal(ds.ddpm_step(st, condb, srow, x, z, probe), ds.ddpm_step(st, condb, srow, x, z, probe)):
            raise AssertionError(f"{name}: two calls on the same operands differ")
        if quantize is None:
            row["gemm_library_ms"] = gemm_library_ms(st, b, t_len, g, device)
            print(f"  {name}: torch.matmul on the step's {2 + 2 * st.w1.shape[0]} GEMM shapes "
                  f"(gemm_library_ms) {row['gemm_library_ms']:.4f} ms; {name} / that = "
                  f"{row['ms'] / row['gemm_library_ms']:.3f}")
        else:
            library(name, row, st, 1)
        return row

    def library(name, row, st, b):
        """int8_library_ms of an int8 stack's row (K6's yardstick)."""
        row["int8_library_ms"] = int8_library_ms(st, b, n_frames, g, device)
        n = st.w1.shape[0] * (2 if st.wouts is not None else 1)
        print(f"  {name}: torch._int_mm on the step's {n} int8 GEMM shapes (int8_library_ms) "
              f"{row['int8_library_ms']:.4f} ms; {name} / that = {row['ms'] / row['int8_library_ms']:.3f}")

    def eps_form(name, quantize, b=1, layers=None, t_len=n_frames, net=den):
        st, condb, srow = operands(b, quantize, layers, t_len, net)
        x = mel(b, t_len)
        print(f"{name} denoise [{b}, {t_len}, {n_mel}] f32, C={st.wskip.shape[0]}, L={st.w1.shape[0]}, "
              f"{st.mode} stack")
        views = [lambda y, i=i: y[i] for i in range(b)]
        row = compare(f"{name} eps", lambda: ds.denoise(st, condb, srow, x),
                      lambda: ds.denoise_plain(st, condb, srow, x),
                      EPS_TOL if quantize is None else INT8_TOL[quantize], views=views,
                      frames=layers is not None)
        row["bound_ms"], row["bound_by"] = denoiser_bound(st, condb, b, t_len, 2 * x.nbytes)
        if quantize is not None and layers is None:
            library(name, row, st, b)
        if b > 1:
            # batch independence: each clip's eps in the batch equals the
            # kernel's eps of that clip alone (every row is computed from its
            # own clip's rows and scale, in the same order), exactly
            batched = ds.denoise(st, condb, srow, x)
            solo = torch.cat([ds.denoise(st, condb[:, i:i + 1].contiguous(), srow, x[i:i + 1].contiguous())
                              for i in range(b)])
            diff = (batched - solo).abs().max().item()
            print(f"  {name} eps: batch of {b} vs each clip alone: max_abs_diff {diff:.3e} (must be 0)")
            if diff != 0.0:
                raise AssertionError(f"{name}: a clip's eps depends on the other clips of the batch ({diff})")
        return row

    rows["K1"] = ddpm_form("K1", None)
    rows["K5"] = eps_form("K5", None)
    rows["K6 int8-w1 K5 form"] = eps_form("K6", "int8-w1")
    rows["K6 int8 K5 form"] = eps_form("K6", "int8")
    rows["K6 int8-w1 K1 form"] = ddpm_form("K6", "int8-w1")
    rows["K6 int8 K1 form"] = ddpm_form("K6", "int8")
    # each clip held to the plain version frame by frame on the first two
    # layers, where a correct kernel differs on few frames (FRAMES_OFF)
    for quantize in ("int8-w1", "int8"):
        rows[f"K6 {quantize} 2 layers B=2"] = eps_form("K6 2 layers B=2", quantize, b=2, layers=2)
    # each clip's eps held to its own range and to the kernel's eps of the
    # clip alone: a kernel with one int8 scale over both clips quantises the
    # first 8x too coarsely
    rows["K6 int8-w1 B=2"] = eps_form("K6 B=2", "int8-w1", b=2)

    # K8 at the TPU harness's shape, against its plain version and against K5
    # on the same operands (K5's time there printed beside K8's)
    st, condb, srow = operands(1, None, t_len=HARNESS_FRAMES)
    x = mel(1, HARNESS_FRAMES)
    print(f"K8 denoise_v2 [1, {HARNESS_FRAMES}, {n_mel}] f32, C=384, L=20, bf16 stack")
    k8 = compare("K8 eps", lambda: dv2.denoise_v2(st, condb, srow, x),
                 lambda: ds.denoise_plain(st, condb, srow, x), EPS_TOL)
    k5 = compare("K8 vs K5 eps", lambda: dv2.denoise_v2(st, condb, srow, x),
                 lambda: ds.denoise(st, condb, srow, x), EPS_TOL)
    print(f"  K8 {k5['ms']:.4f} ms in one launch of {dv2.denoise_v2.grid} blocks; "
          f"K5 {k5['plain_ms']:.4f} ms in {2 + 2 * st.w1.shape[0]} launches, T={HARNESS_FRAMES}")
    k8.update(k5_ms=k5["plain_ms"], k5_err=k5["max_abs_err"], grid=dv2.denoise_v2.grid)
    k8["bound_ms"], k8["bound_by"] = denoiser_bound(st, condb, 1, HARNESS_FRAMES, 2 * x.nbytes)
    rows["K8"] = k8

    # the wide tile: every launch of a 512-channel stack but the gate runs on it
    wide = random_denoiser(bidilconv_config(cfg), g, device)
    counters = Metrics.default().counters
    for form, b, t_len in WIDE_SHAPES:
        name = f"{form} 512x40 B={b} T={t_len}"
        before = (counters["denoiser/launches"], counters["denoiser/launches_wide"])
        check = ddpm_form if form == "K1" else eps_form
        rows[name] = check(name, None, b=b, t_len=t_len, net=wide)
        launched = (counters["denoiser/launches"] - before[0], counters["denoiser/launches_wide"] - before[1])
        if launched[0] == 0 or launched[1] != launched[0]:
            raise AssertionError(f"{name}: {launched[1]} of {launched[0]} launches on the wide tile")
        print(f"  {name}: bound {rows[name]['bound_ms']:.4f} ms ({rows[name]['bound_by']}), "
              f"{100 * rows[name]['bound_ms'] / rows[name]['ms']:.1f}% of the kernel's time")
    return rows


def random_vocoder(vcfg, g, device):
    """BigVGAN at full width in bf16 (the pipeline's cast policy: leaves of
    2+ dimensions bf16, 1-D leaves f32 and random), kernel parameters made."""
    import torch

    from svc_inference_pipeline_tpu_torch.checkpoints.from_jax import random_init_
    from svc_inference_pipeline_tpu_torch.models.bigvgan import BigVGANGenerator

    with torch.device(device):
        voc = BigVGANGenerator(vcfg, compute_dtype=torch.bfloat16)
    random_init_(voc, g)
    randomize_vectors_(voc, g)
    with torch.no_grad():
        for p in voc.parameters():
            if p.dim() >= 2:
                p.data = p.data.to(torch.bfloat16)
    voc.prepare_kernel_params()
    return voc


def check_k7(voc, g, device, n_frames: int) -> dict:
    """K7 on every AMPBlock1 pair of the stages with C <= 384 (stages 1-5) at
    the 4 s shapes, one random input per stage; then two clips shorter than
    a pair's two halos (tap boxes in both halos). Times are summed over the
    pairs: the per-block route's K7 time for one 4 s clip, between CUDA
    events per call (``ms``), as device time of its kernels under the
    profiler (``kernel_device_ms``) and as host time to issue the 45 calls
    (``host_issue_ms``); ``F.conv1d`` on the same 90 convs is the
    yardstick (``conv_library_ms``)."""
    import torch

    from svc_inference_pipeline_tpu_torch.ops.pallas import amp_pair

    vcfg = voc.cfg
    ks = tuple(vcfg.resblock_kernel_sizes)
    dils = tuple(tuple(d) for d in vcfg.resblock_dilation_sizes)
    row = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "conv_library_ms": 0.0}
    nbytes, ops = 0, {"bf16": 0, "f32": 0}
    t_len = n_frames
    blocks = {}
    calls = []  # (x, pair, k, d) of every pair
    for i, u in enumerate(vcfg.upsample_rates):
        t_len *= u
        c = vcfg.upsample_initial_channel // 2 ** (i + 1)
        if c > amp_pair.MAX_CHANNELS:
            continue
        xs = (0.5 * torch.randn((1, t_len, c), generator=g, device=device)).to(torch.bfloat16)
        print(f"K7 fused_amp_pair stage {i} [1, {t_len}, {c}] bf16")
        for j in range(len(vcfg.resblock_kernel_sizes)):
            blk = getattr(voc, f"resblock_{i}_{j}")
            blocks.setdefault(c, []).append(blk)
            for pair, d in zip(blk.kernel_pairs, blk.dilations):
                k = blk.kernel_size
                r = compare(f"K7 stage {i} k={k} d={d}",
                            lambda xs=xs, pair=pair, k=k, d=d: amp_pair.fused_amp_pair(xs, pair, k, d),
                            lambda xs=xs, pair=pair, k=k, d=d: amp_pair.amp_pair_plain(xs, pair, k, d),
                            BF16_TOL, reps=3)
                row["max_abs_err"] = max(row["max_abs_err"], r["max_abs_err"])
                row["ms"] += r["ms"]
                row["plain_ms"] += r["plain_ms"]
                calls.append((xs, pair, k, d))
                nbytes += 2 * xs.nbytes + sum(v.nbytes for v in pair)
                ops["bf16"] += 2 * 2 * t_len * c * c * k
                ops["f32"] += 2 * SNAKE_OPS * t_len * c
        row["conv_library_ms"] += conv_library_ms(voc.kernel_stages[i], t_len, c, ks, dils, g, device)
    row["bound_ms"], row["bound_by"] = bound(nbytes, ops)

    def all_pairs():
        for xs, pair, k, d in calls:
            amp_pair.fused_amp_pair(xs, pair, k, d)

    row["kernel_device_ms"] = kernel_device_ms(all_pairs, ("activation1d_kernel", "conv1d_kernel"), reps=5)
    row["host_issue_ms"] = 1e3 * host_issue_s(all_pairs)
    print(f"  K7 {len(calls)} pairs: {row['ms']:.4f} ms (calls between CUDA events, summed), kernels' device time "
          f"{row['kernel_device_ms']:.4f} ms, host issue {row['host_issue_ms']:.4f} ms, bound {row['bound_ms']:.4f} "
          f"ms ({row['bound_by']}); [F.conv1d on their {2 * len(calls)} convs (conv_library_ms) "
          f"{row['conv_library_ms']:.4f} ms]; K7 / that = {row['ms'] / row['conv_library_ms']:.3f}")
    # the widest K7 stage's block with the most taps, the narrowest stage's with the fewest
    widest, narrowest = max(blocks), min(blocks)
    for blk, t_short in ((max(blocks[widest], key=lambda b: b.kernel_size), 50),
                         (min(blocks[narrowest], key=lambda b: b.kernel_size), 7)):
        c, k, pair, d = blk.channels, blk.kernel_size, blk.kernel_pairs[-1], blk.dilations[-1]
        xs = (0.5 * torch.randn((2, t_short, c), generator=g, device=device)).to(torch.bfloat16)
        print(f"K7 fused_amp_pair [2, {t_short}, {c}] k={k} d={d}: T < 2H = {2 * amp_pair.pair_halo(k, d)}")
        r = compare(f"K7 short clip C={c}", lambda: amp_pair.fused_amp_pair(xs, pair, k, d),
                    lambda: amp_pair.amp_pair_plain(xs, pair, k, d), BF16_TOL, reps=2)
        row["max_abs_err"] = max(row["max_abs_err"], r["max_abs_err"])
    return row


def kernel_device_ms(fn, names: tuple, reps: int = 20) -> float:
    """Device milliseconds per call of fn() in the kernels whose name holds
    one of ``names``, under torch.profiler over ``reps`` calls (after one
    warm call)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0)
             for ev in prof.key_averages() if any(name in ev.key for name in names))
    if not us > 0:
        raise AssertionError(f"the profiler saw no device time of {names}")
    return us / 1e3 / reps


def host_issue_s(fn, reps: int = 5) -> float:
    """Median host seconds to issue fn() (perf_counter around the call, the
    card idle before it and synchronised only after the clock stops)."""
    import torch

    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
    return statistics.median(times)


def conv_library_ms(params, t_len: int, c: int, ks, dils, g, device) -> float:
    """K2's yardstick: ``F.conv1d`` (cuDNN, bf16, "same" padding, bias) on one
    stage's conv shapes, conv_d and conv_1 of every pair on [1, C, T]; the
    activations, residuals and block sum left out. Timed only: the port never
    calls it."""
    import torch
    import torch.nn.functional as F

    x = torch.randn((1, c, t_len), generator=g, device=device).to(torch.bfloat16)
    convs = []
    for pairs, k, ds in zip(params, ks, dils):
        for (w1, b1, w2, b2, *_), d in zip(pairs, ds):
            convs.append((w1.permute(2, 1, 0).contiguous(), b1.to(torch.bfloat16), d * (k - 1) // 2, d))
            convs.append((w2.permute(2, 1, 0).contiguous(), b2.to(torch.bfloat16), (k - 1) // 2, 1))

    def run():
        for w, b, pad, d in convs:
            F.conv1d(x, w, b, padding=pad, dilation=d)

    return cuda_ms(run, reps=5)


def check_kernels(cfg, device) -> tuple:
    """Kernel vs plain at the 4 s main-path shapes; returns the per-kernel
    rows and the random full-width vocoder they used."""
    import torch

    from svc_inference_pipeline_tpu_torch.ops.pallas import amp_stage, snake

    g = torch.Generator(device=device).manual_seed(1234)
    bf = torch.bfloat16
    n_frames = 384  # 4 s at hop 256, padded to the 64-frame bucket
    rows = check_denoiser(cfg, g, device, n_frames)
    rows["K4"] = check_k4(g, device)

    # K2: the six stages of BigVGAN-1536 for a 4 s clip; K3: activation_post
    vcfg = cfg.vocoder
    voc = random_vocoder(vcfg, g, device)
    ks = tuple(vcfg.resblock_kernel_sizes)
    dils = tuple(tuple(d) for d in vcfg.resblock_dilation_sizes)
    n_convs = 2 * sum(len(d) for d in dils)
    t_len = n_frames
    k2 = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "conv_library_ms": 0.0, "stages": []}
    k2_bytes, k2_ops = 0, {"bf16": 0, "f32": 0}
    for i, u in enumerate(vcfg.upsample_rates):
        t_len *= u
        c = vcfg.upsample_initial_channel // 2 ** (i + 1)
        xs = (0.5 * torch.randn((1, t_len, c), generator=g, device=device)).to(bf)
        params = voc.kernel_stages[i]
        print(f"K2 fused_amp_stage stage {i} [1, {t_len}, {c}] bf16")
        row = compare(
            f"K2 stage {i}",
            lambda xs=xs, params=params: amp_stage.fused_amp_stage(xs, params, ks, dils),
            lambda xs=xs, params=params: amp_stage.amp_stage_plain(xs, params, ks, dils),
            BF16_TOL, reps=5,
        )
        k2["max_abs_err"] = max(k2["max_abs_err"], row["max_abs_err"])
        k2["ms"] += row["ms"]
        k2["plain_ms"] += row["plain_ms"]
        # each block of kernel k: 2 convs of k taps per dilation; one activation before each conv
        nbytes = 2 * xs.nbytes + sum(p.nbytes for pairs in params for pair in pairs for p in pair)
        ops = {"bf16": sum(2 * len(d) * 2 * t_len * c * c * k for k, d in zip(ks, dils)),
               "f32": n_convs * SNAKE_OPS * t_len * c}
        k2_bytes += nbytes
        k2_ops = {kind: k2_ops[kind] + n for kind, n in ops.items()}
        stage = {"T": t_len, "C": c, "ms": row["ms"], "plain_ms": row["plain_ms"],
                 "host_issue_ms": 1e3 * host_issue_s(lambda: amp_stage.fused_amp_stage(xs, params, ks, dils)),
                 "conv_library_ms": conv_library_ms(params, t_len, c, ks, dils, g, device)}
        stage["bound_ms"], stage["bound_by"] = bound(nbytes, ops)
        print(f"  K2 stage {i}: kernel {stage['ms']:.4f} ms, bound {stage['bound_ms']:.4f} ms "
              f"({stage['bound_by']}, {100 * stage['bound_ms'] / stage['ms']:.1f}%), plain {stage['plain_ms']:.4f} ms, "
              f"host issue {stage['host_issue_ms']:.4f} ms, [F.conv1d on its {n_convs} convs "
              f"(conv_library_ms) {stage['conv_library_ms']:.4f} ms]")
        k2["conv_library_ms"] += stage["conv_library_ms"]
        k2["stages"].append(stage)
    k2["bound_ms"], k2["bound_by"] = bound(k2_bytes, k2_ops)
    print(f"  K2 six stages: {k2['ms']:.4f} ms, bound {k2['bound_ms']:.4f} ms; [conv_library_ms "
          f"{k2['conv_library_ms']:.4f} ms]; K2 / that = {k2['ms'] / k2['conv_library_ms']:.3f}")
    # the batched vocoder: the first and last stage on two clips, each held to its own range
    k2["batch2_ms"] = {}
    for i in (0, len(vcfg.upsample_rates) - 1):
        t_i = n_frames * math.prod(vcfg.upsample_rates[: i + 1])
        c = vcfg.upsample_initial_channel // 2 ** (i + 1)
        xs = (0.5 * torch.randn((2, t_i, c), generator=g, device=device)).to(bf)
        params = voc.kernel_stages[i]
        print(f"K2 fused_amp_stage stage {i} [2, {t_i}, {c}] bf16")
        row = compare(f"K2 stage {i} B=2", lambda xs=xs, params=params: amp_stage.fused_amp_stage(xs, params, ks, dils),
                      lambda xs=xs, params=params: amp_stage.amp_stage_plain(xs, params, ks, dils),
                      BF16_TOL, views=PER_CLIP, reps=3)
        k2["max_abs_err"] = max(k2["max_abs_err"], row["max_abs_err"])
        k2["batch2_ms"][f"stage {i}"] = row["ms"]
    rows["K2"] = k2

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
    rows["K3"]["bound_ms"], rows["K3"]["bound_by"] = bound(2 * xa.nbytes, {"f32": SNAKE_OPS * xa.numel()})
    print(f"K3 fused_activation1d [2, {t_len}, {c_post}] bf16")
    xb = (0.5 * torch.randn((2, t_len, c_post), generator=g, device=device)).to(bf)
    b2 = compare("K3 B=2", lambda: snake.fused_activation1d(xb, alpha, beta, vcfg.activation, vcfg.snake_logscale),
                 lambda: snake.activation1d_plain(xb, a_eff, inv_b), BF16_TOL, views=PER_CLIP)
    rows["K3"]["max_abs_err"] = max(rows["K3"]["max_abs_err"], b2["max_abs_err"])
    rows["K3"]["batch2_ms"] = b2["ms"]
    # ms, as for every kernel, is one wrapper call between CUDA events, which
    # here the host sets (the snake's exp, the checks, the ctypes call);
    # kernel_device_ms is the kernel's own device time under the profiler
    rows["K3"]["kernel_device_ms"] = kernel_device_ms(
        lambda: snake.fused_activation1d(xa, alpha, beta, vcfg.activation, vcfg.snake_logscale),
        ("activation1d_kernel",))
    print(f"  K3 activation: one wrapper call {rows['K3']['ms']:.4f} ms, kernel device time "
          f"{rows['K3']['kernel_device_ms']:.4f} ms")
    rows["K7"] = check_k7(voc, g, device, n_frames)
    rows["K9"] = check_k9(cfg, device)
    return rows, voc


def f0_agreement(ours, ref) -> tuple:
    """(share of frames voiced alike, share of those both voice within F0_CENTS)."""
    import numpy as np

    both = (ours > 0) & (ref > 0)
    cents = 1200 * np.abs(np.log2(ours[both] / ref[both]))
    return float(np.mean((ours > 0) == (ref > 0))), float(np.mean(cents <= F0_CENTS)) if both.any() else 1.0


def check_k9(cfg, device) -> dict:
    """K9 on ``measure.synth_clip`` tones: one call at B=1 on 10 s and at B=2
    on 10 s + 16 s; the batch bit for bit against the plain version (on the
    CPU) and against each clip alone, each clip against the host route
    (numpy ``get_f0_features`` + ``pitch_shift``) by voicing and cents. bound: the direct
    autocorrelation's and the Viterbi's float64 operations and the framing's
    float32 ones at their peaks; plain_ms: the host route on the 10 s clip."""
    import numpy as np
    import torch

    from svc_inference_pipeline_tpu_torch.measure import synth_clip as clip
    from svc_inference_pipeline_tpu_torch.ops import f0
    from svc_inference_pipeline_tpu_torch.pipeline.convert import mel_frame_count
    from svc_inference_pipeline_tpu_torch.utils.artifacts import pitch_shift

    clips = [clip(cfg.fs, s) for s in (10.0, 16.0)]
    n = [len(c) for c in clips]
    m = [mel_frame_count(cfg, k) for k in n]
    padded = -(-max(m) // 64) * 64
    block = torch.zeros((2, max(n)), device=device)
    for i, c in enumerate(clips):
        block[i, : len(c)] = torch.as_tensor(c, device=device)
    solo = [block[i: i + 1, : n[i]].contiguous() for i in range(2)]
    print("K9 praat_f0_device: 10 s at B=1, 10 s + 16 s at B=2")
    got = f0.praat_f0_device(block, n, m, padded, cfg).cpu()
    plain = f0.praat_f0_device(block.cpu(), n, m, padded, cfg)
    row = {"max_abs_err": float((got - plain).abs().max()), "agreement": [], "batch_bits": []}
    for i, c in enumerate(clips):
        alone = f0.praat_f0_device(solo[i], [n[i]], [m[i]], padded, cfg).cpu()[0]
        row["batch_bits"].append(bool(torch.equal(alone, got[i])))
        host = pitch_shift(f0.get_f0_features(c, m[i], cfg)[0], cfg)
        voicing, share = f0_agreement(got[i, : m[i]].numpy(), host)
        row["agreement"].append({"host": (voicing, share)})
        print(f"  K9 clip {n[i] / cfg.fs:g} s: (voicing, cents share) vs host {(voicing, share)}, "
              f"batch equals alone {row['batch_bits'][-1]}")
        if not (voicing >= F0_VOICING and share >= F0_CENTS_SHARE):
            raise AssertionError(f"K9 clip {i} vs host: voicing {voicing}, cents share {share}")
    if row["max_abs_err"] != 0.0:
        raise AssertionError(f"K9 differs from its plain version: max |K9 - plain| {row['max_abs_err']} Hz")
    if not all(row["batch_bits"]):
        raise AssertionError(f"K9: a clip in the batch differs from the clip alone: {row['batch_bits']}")
    row["ms"] = cuda_ms(lambda: f0.praat_f0_device(solo[0], n[:1], m[:1], padded, cfg), reps=20)
    row["batch2_ms"] = cuda_ms(lambda: f0.praat_f0_device(block, n, m, padded, cfg), reps=20)
    host_s = []
    for _ in range(3):
        t0 = time.perf_counter()
        pitch_shift(f0.get_f0_features(clips[0], m[0], cfg)[0], cfg)
        host_s.append(time.perf_counter() - t0)
    row["plain_ms"] = 1e3 * statistics.median(host_s)
    grid = f0.praat_grid(cfg.fs, cfg.hop_length, float(cfg.f0_min), float(cfg.f0_max))
    w, lags = grid.nsamp_window, grid.max_lag + 1

    def ops(k):  # a clip of k samples
        frames = f0.praat_frames(k, grid)[0]
        return frames * (2 * (lags * w - lags * (lags - 1) // 2) + 4 * f0.K * f0.K), frames * 4 * w

    (f64_1, f32_1), (f64_2, f32_2) = ops(n[0]), ops(n[1])
    row["bound_ms"] = 1e3 * (f64_1 / PEAK_OPS["f64"] + f32_1 / PEAK_OPS["f32"])
    row["bound_by"] = "operations"
    row["batch2_bound_ms"] = 1e3 * ((f64_1 + f64_2) / PEAK_OPS["f64"] + (f32_1 + f32_2) / PEAK_OPS["f32"])
    print(f"  K9: B=1 10 s {row['ms']:.4f} ms (bound {row['bound_ms']:.4f}), B=2 {row['batch2_ms']:.4f} ms "
          f"(bound {row['batch2_bound_ms']:.4f}); host numpy tracker + shift on 10 s {row['plain_ms']:.1f} ms; "
          f"max |K9 - plain| {row['max_abs_err']:.3e} Hz")
    return row


def synth_clip(path: str, fs: int, seconds: float) -> int:
    """Write the synthetic clip of ``measure.synth_clip`` (a harmonic tone with
    vibrato, a 0.4 s gap and a little noise) as a WAV; returns its length."""
    from svc_inference_pipeline_tpu_torch.measure import synth_clip as clip
    from svc_inference_pipeline_tpu_torch.utils.audio_io import write_wav

    x = clip(fs, seconds)
    write_wav(path, x, fs)
    return len(x)


class Counters:
    """The kernels' launch counters: K1 and K5 by stack mode, K4, K2, K3, K7, K8, K9."""

    def __init__(self):
        from svc_inference_pipeline_tpu_torch.ops import f0
        from svc_inference_pipeline_tpu_torch.ops.pallas import (
            amp_pair, amp_stage, attention, denoiser_step, denoiser_v2, snake)

        self.by_mode = {"K1": denoiser_step.ddpm_step, "K5": denoiser_step.denoise}
        self.plain = {"K4": attention.encoder_attention, "K2": amp_stage.fused_amp_stage,
                      "K3": snake.fused_activation1d, "K7": amp_pair.fused_amp_pair,
                      "K8": denoiser_v2.denoise_v2, "K9": f0.praat_f0_device}

    def reset(self) -> None:
        for fn in self.by_mode.values():
            fn.launches = 0
            fn.launches_by_mode.update(dict.fromkeys(fn.launches_by_mode, 0))
        for fn in self.plain.values():
            fn.launches = 0

    def read(self) -> dict:
        counts = {f"{k} {mode}": n for k, fn in self.by_mode.items() for mode, n in fn.launches_by_mode.items()}
        counts.update({k: fn.launches for k, fn in self.plain.items()})
        return counts


def check_audio(name: str, audio, n_expected: int) -> None:
    import numpy as np

    if len(audio) != n_expected or not np.isfinite(audio).all() or not np.abs(audio).max() > 0:
        raise AssertionError(f"{name}: {len(audio)} samples (expected {n_expected}), finite "
                             f"{bool(np.isfinite(audio).all())}, peak {float(np.abs(audio).max())}")


def drive(name: str, counters: Counters, run, expected: dict, paths: list) -> None:
    """Run one main path with the counters set to 0 just before it and read
    just after; fail unless the counts are ``expected`` (others 0)."""
    import torch

    counters.reset()
    t0 = time.perf_counter()
    timings = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = counters.read()
    want = dict.fromkeys(counts, 0)
    want.update(expected)
    print(f"path {name}: launches {({k: n for k, n in counts.items() if n})}")
    if "total_s" in timings:
        print(f"  front-end {timings['frontend_s']:.3f}s, sampling {timings['ddpm_s']:.3f}s, vocoder "
              f"{timings['vocoder_s']:.3f}s, conversion {timings['total_s']:.3f}s "
              f"(RTF {timings['total_s'] / CLIP_SECONDS:.4f}), wall {wall:.2f}s")
    else:
        print("  " + ", ".join(f"{k} {v:.4f}" for k, v in timings.items()) + f", wall {wall:.2f}s")
    if counts != want:
        raise AssertionError(f"{name}: launch counts {counts} != expected {want}")
    paths.append({"path": name, "launches": counts, **timings})


def per_block_counts(vcfg) -> dict:
    """Launches of ``forward_per_block``: one K7 per pair of every block up to
    384 channels, two K3 per pair of a wider block, one K3 for
    activation_post."""
    from svc_inference_pipeline_tpu_torch.ops.pallas.amp_pair import MAX_CHANNELS

    pairs = sum(len(rd) for rd in vcfg.resblock_dilation_sizes)
    widths = [vcfg.upsample_initial_channel // 2 ** (i + 1) for i in range(len(vcfg.upsample_rates))]
    return {"K7": pairs * sum(c <= MAX_CHANNELS for c in widths),
            "K3": 2 * pairs * sum(c > MAX_CHANNELS for c in widths) + 1}


def vocoder_paths(cfg, voc, counters, paths, device, audio) -> dict:
    """Path g: the vocoder block by block, then through K2, on the clip's
    log-mel (cut or edge-padded to 384 frames), each timed warm; returns the
    two waveforms' max abs difference and correlation."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from svc_inference_pipeline_tpu_torch.ops.mel import extract_mel_features

    n_frames = 384
    mel, _ = extract_mel_features(torch.as_tensor(audio, device=device), cfg)
    mel = mel[None, :, :n_frames]
    mel = F.pad(mel, (0, n_frames - mel.shape[-1]), mode="replicate").transpose(1, 2).contiguous()
    waves = {}

    def vocode(name, fn):
        def run():
            t0 = time.perf_counter()
            with torch.no_grad():
                waves[name] = fn(mel)
            torch.cuda.synchronize()
            return {"vocoder_s": time.perf_counter() - t0}
        return run

    with torch.no_grad():  # each route once untimed (first use of its conv shapes), so both times are warm
        voc.forward_per_block(mel), voc(mel)
    torch.cuda.synchronize()
    drive("vocoder per block", counters, vocode("block", voc.forward_per_block), per_block_counts(voc.cfg),
          paths)
    drive("vocoder K2 route", counters, vocode("k2", voc), {"K2": len(voc.cfg.upsample_rates), "K3": 1}, paths)
    a, b = (waves[k][0].double().cpu().numpy() for k in ("block", "k2"))
    if not (np.isfinite(a).all() and a.shape == b.shape == (n_frames * 256,)):
        raise AssertionError(f"per-block waveform {a.shape}, finite {bool(np.isfinite(a).all())}")
    out = {"max_abs_diff": float(np.abs(a - b).max()), "corr": float(np.corrcoef(a, b)[0, 1])}
    print(f"vocoder per block vs K2 route: max_abs_diff {out['max_abs_diff']:.4e}, correlation "
          f"{out['corr']:.6f} (gate {VOCODER_MIN_CORR})")
    if not out["corr"] >= VOCODER_MIN_CORR:
        raise AssertionError(f"per-block vs K2 waveform correlation {out['corr']} < {VOCODER_MIN_CORR}")
    return out


def harness_paths(cfg, counters, paths, device) -> dict:
    """Path h: the TPU harness's loop x <- 1e-3 eps + 0.999 x over
    HARNESS_STEPS steps (t = 99 .. 0 of the 1000-step schedule) at
    T = HARNESS_FRAMES, through K8 and then through K5; returns ms per step of
    each and the two final x's max abs difference."""
    import torch

    from svc_inference_pipeline_tpu_torch.ops.pallas.denoiser_step import make_denoise_fn
    from svc_inference_pipeline_tpu_torch.ops.pallas.denoiser_v2 import build_v2_fn

    g = torch.Generator(device=device).manual_seed(4321)
    steps = int(cfg.mapper.noise_schedule_factors[2])
    den = random_denoiser(cfg, g, device)
    cond = torch.randn((1, HARNESS_FRAMES, cfg.mapper.conditioner_size), generator=g, device=device)
    x0 = torch.randn((1, HARNESS_FRAMES, cfg.mapper.n_mel), generator=g, device=device)
    with torch.no_grad():
        fns = {"K8": build_v2_fn(den, cond, steps), "K5": make_denoise_fn(den, cond, steps)}
    finals, out = {}, {}

    def loop(key):
        def run():
            x = x0.clone()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for t in range(HARNESS_STEPS - 1, -1, -1):
                x = 1e-3 * fns[key](x, cond, torch.full((1, 1), t)) + 0.999 * x
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            finals[key] = x
            out[f"{key}_ms_per_step"] = 1e3 * seconds / HARNESS_STEPS
            return {"ms_per_step": out[f"{key}_ms_per_step"]}
        return run

    drive("harness loop K8", counters, loop("K8"), {"K8": HARNESS_STEPS}, paths)
    drive("harness loop K5", counters, loop("K5"), {"K5 bf16": HARNESS_STEPS}, paths)
    out["max_abs_diff"] = (finals["K8"] - finals["K5"]).abs().max().item()
    print(f"harness loop, {HARNESS_STEPS} steps at T={HARNESS_FRAMES}: K8 {out['K8_ms_per_step']:.4f} ms/step, "
          f"K5 {out['K5_ms_per_step']:.4f} ms/step; final x max_abs_diff {out['max_abs_diff']:.3e}")
    if not torch.isfinite(finals["K8"]).all() or not out["max_abs_diff"] <= 1e-2 * finals["K5"].abs().max().item():
        raise AssertionError(f"harness loop: K8 and K5 final x differ by {out['max_abs_diff']}")
    return out


def http_request(port: int, method: str, path: str, body: bytes = None) -> tuple:
    """(status, headers, body) of one request to the server on 127.0.0.1."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        conn.request(method, path, body=body)
        r = conn.getresponse()
        return r.status, r.headers, r.read()
    finally:
        conn.close()


def wav_bytes(path: str, audio, fs: int) -> bytes:
    from svc_inference_pipeline_tpu_torch.utils.audio_io import write_wav

    write_wav(path, audio, fs)
    with open(path, "rb") as f:
        return f.read()


def batch_paths(cfg, counters, paths, device) -> dict:
    """Paths i-m (module docstring, step 4): the batched CLI, batch
    independence, the HTTP server's coalesced burst and a stream, and
    ``convert_multi_singer``; returns their checks' numbers."""
    import threading
    import types

    import numpy as np
    import torch

    from svc_inference_pipeline_tpu_torch import cli, serving
    from svc_inference_pipeline_tpu_torch.measure import synth_clip as clip
    from svc_inference_pipeline_tpu_torch.ops.f0 import praat_f0_device
    from svc_inference_pipeline_tpu_torch.pipeline.convert import mel_frame_count
    from svc_inference_pipeline_tpu_torch.pipeline.streaming import convert_streaming
    from svc_inference_pipeline_tpu_torch.sampling.ddpm import INIT_NOISE_STD
    from svc_inference_pipeline_tpu_torch.utils.audio_io import read_wav

    steps = int(cfg.mapper.noise_schedule_factors[2])
    evals = steps // 10 + 1  # PLMS@10: the warm-up step evaluates twice
    fs, hop, silence = cfg.fs, cfg.hop_length, cfg.fs // 20
    singers = [SINGER, "svcc_CDM1", "svcc_IDF1", "svcc_IDM1"]
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        clips = {s: clip(fs, s) for s in (4.0, 3.0, 2.0)}
        inputs = {s: os.path.join(tmp, f"in_{s:g}s.wav") for s in clips}
        for s, path in inputs.items():
            wav_bytes(path, clips[s], fs)
        built = {}

        # i. two inputs, one batch
        def run_cli_batch():
            outs = [os.path.join(tmp, f"batch_{k}.wav") for k in range(2)]
            timings_path = os.path.join(tmp, "batch.json")
            rc = cli.main(["--input", inputs[4.0], "--input", inputs[3.0], "--singer", singers[0], "--singer",
                           singers[1], "--output", outs[0], "--output", outs[1], "--random-weights",
                           "--whisper-size", WHISPER_SIZE, "--seed", "0", "--device", device.type,
                           "--timings-json", timings_path], built=built)
            if rc != 0:
                raise AssertionError(f"cli.main returned {rc}")
            for path, s in zip(outs, (4.0, 3.0)):
                samples, _ = read_wav(path)
                check_audio(f"cli batch {s:g} s", samples[silence: len(samples) - silence, 0] / 32768.0,
                            mel_frame_count(cfg, len(clips[s])) * hop)
            with open(timings_path) as f:
                return json.load(f)

        drive("cli batch of 2 ddpm bf16", counters, run_cli_batch,
              {"K1 bf16": steps, "K4": 24, "K2": 6, "K3": 1, "K9": 3}, paths)
        pipe = built["pipeline"]

        # j. batch independence: each clip's waveform in the batch against the clip alone
        def run_independence():
            pipe.set_quantize("int8-w1")
            t0 = time.perf_counter()
            clip_pair = [clips[4.0], 0.125 * clips[4.0]]
            batch, n_true = pipe.extract_features_batch(clip_pair, singers[:2])
            padded = batch["melody"].shape[1]
            g = torch.Generator(device=device).manual_seed(0)
            x_t = INIT_NOISE_STD * torch.randn((2, padded, cfg.mapper.n_mel), generator=g, device=device)
            n_true = torch.tensor(n_true, device=device)
            core = dict(sampler="plms", speedup=10)
            both = pipe._convert_core(batch, n_true, padded, noise=x_t, **core).double().cpu().numpy()
            out["batch_independence"] = []
            for i in range(2):
                # K9's melody of this clip in the batch against K9 on the clip alone
                k = int(n_true[i])
                melody = praat_f0_device(torch.as_tensor(clip_pair[i], device=device)[None], [len(clip_pair[i])], [k],
                                         padded, pipe.cfg)
                if not torch.equal(batch["melody"][i], melody[0]):
                    raise AssertionError(f"clip {i}: K9's melody in the batch differs from the clip's alone")
                alone = pipe._convert_core({k: v[i:i + 1] for k, v in batch.items()}, n_true[i:i + 1], padded,
                                           noise=x_t[i:i + 1], **core)[0].double().cpu().numpy()
                n = int(n_true[i]) * hop
                corr = float(np.corrcoef(both[i, :n], alone[:n])[0, 1])
                diff = float(np.abs(both[i] - alone).max())
                out["batch_independence"].append({"corr": corr, "max_abs_diff": diff})
                print(f"  clip {i} in the batch vs alone: correlation {corr:.8f} (gate {INT8_W1_MIN_CORR}), "
                      f"max_abs_diff {diff:.3e}")
                check_audio(f"batch independence clip {i}", both[i, :n], n)
                if not corr >= INT8_W1_MIN_CORR:
                    raise AssertionError(f"clip {i}: batch vs alone correlation {corr} < {INT8_W1_MIN_CORR}")
            return {"seconds": time.perf_counter() - t0}

        drive("batch independence plms@10 int8-w1", counters, run_independence,
              {"K4": 24, "K5 int8-w1": 3 * evals, "K2": 18, "K3": 3, "K9": 9}, paths)

        # k, l. the server in this process
        httpd = serving.serve(pipe.cfg, pipe, "127.0.0.1", 0, coalesce_ms=3000.0)
        port = httpd.server_address[1]
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        try:
            burst = [(4.0, singers[0]), (4.0, singers[1]), (2.0, singers[2]), (2.0, singers[3])]
            bodies = [wav_bytes(os.path.join(tmp, f"req{k}.wav"), clips[s] * (0.5 + 0.25 * k), fs)
                      for k, (s, _) in enumerate(burst)]

            def run_burst():
                pipe.set_quantize(None)
                t0 = time.perf_counter()
                replies = [None] * len(burst)

                def post(k):
                    replies[k] = http_request(port, "POST", f"/convert?singer={burst[k][1]}&sampler=plms&speedup=10",
                                              bodies[k])

                posts = [threading.Thread(target=post, args=(k,)) for k in range(len(burst))]
                for t in posts:
                    t.start()
                for t in posts:
                    t.join(timeout=600)
                seconds = time.perf_counter() - t0
                for (s, singer), (status, _, data) in zip(burst, replies):
                    if status != 200:
                        raise AssertionError(f"POST /convert {s:g} s: HTTP {status} {data[:300]!r}")
                    path = os.path.join(tmp, "reply.wav")
                    with open(path, "wb") as f:
                        f.write(data)
                    samples, _ = read_wav(path)
                    check_audio(f"server {s:g} s {singer}", samples[silence: len(samples) - silence, 0] / 32768.0,
                                mel_frame_count(cfg, len(clips[s])) * hop)
                status, _, data = http_request(port, "GET", "/metrics")
                served = json.loads(data)["serving"]
                print(f"  /metrics serving: {served}")
                if status != 200 or (served["batches"], served["conversions"]) != (2, 4):
                    raise AssertionError(f"the burst did not coalesce into 2 batches of 4 conversions: {served}")
                for route in ("/healthz", "/singers"):
                    status, _, data = http_request(port, "GET", route)
                    if status != 200:
                        raise AssertionError(f"GET {route}: HTTP {status}")
                out["server"] = served
                return {"burst_s": seconds}

            drive("server burst plms@10 bf16", counters, run_burst,
                  {"K5 bf16": 2 * evals, "K4": 48, "K2": 12, "K3": 2, "K9": 6}, paths)

            def run_stream():
                pipe.set_quantize("int8-w1")
                t0 = time.perf_counter()
                status, headers, data = http_request(
                    port, "POST", f"/convert?singer={SINGER}&sampler=plms&speedup=10&stream=1&chunk_seconds=2",
                    wav_bytes(os.path.join(tmp, "stream.wav"), clips[4.0], fs))
                seconds = time.perf_counter() - t0
                if status != 200 or headers["Content-Type"] != "audio/L16":
                    raise AssertionError(f"streamed POST /convert: HTTP {status} {data[:300]!r}")
                # the length convert_streaming gives: a stand-in whose conversion of a
                # segment has the real one's length, n_frames * hop
                lengths = types.SimpleNamespace(
                    cfg=cfg, device=torch.device("cpu"), mel_frame_count=lambda n: mel_frame_count(cfg, n),
                    convert=lambda seg, *a, **kw: np.zeros(mel_frame_count(cfg, len(seg)) * hop, np.float32))
                n_expected = len(convert_streaming(lengths, clips[4.0], SINGER, chunk_seconds=2.0))
                check_audio("stream", np.frombuffer(data, "<i2") / 32768.0, n_expected)
                return {"stream_s": seconds}

            drive("server stream plms@10 int8-w1", counters, run_stream,
                  {"K5 int8-w1": 2 * evals, "K4": 48, "K2": 12, "K3": 2, "K9": 6}, paths)
        finally:
            httpd.shutdown()
            httpd.server_close()
            httpd.svc.close(drain_s=0.0)
            thread.join(timeout=60)
            httpd.svc.worker.join(timeout=60)

        # m. one clip to three singers in one batch
        def run_multi():
            pipe.set_quantize(None)
            pipe.set_sampler("plms", 10)
            try:
                waves = pipe.convert_multi_singer(inputs[4.0], singers[:3],
                                                  generator=torch.Generator(device=device).manual_seed(0))
            finally:
                pipe.set_sampler("ddpm")
            n = mel_frame_count(cfg, len(clips[4.0])) * hop
            for singer, w in zip(singers, waves):
                check_audio(f"multi-singer {singer}", w, n)
            diffs = [float(np.abs(waves[a] - waves[b]).max()) for a, b in ((0, 1), (0, 2), (1, 2))]
            print(f"  multi-singer waveforms' pairwise max_abs_diff {diffs}")
            if not min(diffs) > 0:
                raise AssertionError(f"two singers' waveforms are equal: {diffs}")
            out["multi_singer_diffs"] = diffs
            return dict(pipe.timings)

        drive("multi-singer x3 plms@10 bf16", counters, run_multi,
              {"K4": 24, "K5 bf16": evals, "K2": 6, "K3": 1, "K9": 3}, paths)
    return out


# ---------------------------------------------------------------------------
# Reference-layout checkpoint files (test code: the inverse of
# checkpoints/torch_convert.py, used by paths n and o and by the CPU tests)
# ---------------------------------------------------------------------------

WN_NEW_STYLE = ("parametrizations.weight.original0", "parametrizations.weight.original1")
WN_OLD_STYLE = ("weight_g", "weight_v")


def module_tree(module) -> dict:
    """A port module's parameters as a JAX-layout numpy tree (f32): the
    inverse of the weights bridge, ``checkpoints/from_jax.py``."""
    from torch import nn

    tree = {}
    for name, p in module.named_parameters():
        *path, leaf = name.split(".")
        sub = module.get_submodule(".".join(path))
        v = p.detach().float().cpu().numpy()
        if leaf == "weight":
            if isinstance(sub, nn.Linear):
                leaf, v = "kernel", v.T
            elif isinstance(sub, (nn.Conv1d, nn.ConvTranspose1d)):
                leaf, v = "kernel", v.transpose(2, 1, 0)
            elif isinstance(sub, nn.Embedding):
                leaf = "embedding"
            elif isinstance(sub, (nn.LayerNorm, nn.GroupNorm)):
                leaf = "scale"
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = v
    return tree


def _tensors(sd: dict, prefix: str = "", dtype=None) -> dict:
    import numpy as np
    import torch

    out = {}
    for k, v in sd.items():
        t = torch.from_numpy(np.array(v))
        out[prefix + k] = t.to(dtype) if dtype is not None else t
    return out


def _put_linear(sd: dict, prefix: str, p: dict, conv1x1: bool = False) -> None:
    w = p["kernel"].T
    sd[f"{prefix}.weight"] = w[:, :, None] if conv1x1 else w
    if "bias" in p:
        sd[f"{prefix}.bias"] = p["bias"]


def mapper_checkpoint(enc: dict, den: dict) -> dict:
    """{"state_dict"} of the reference's ModuleList[EncoderFramework, DiffSVC],
    every key behind a DataParallel ``module.`` prefix."""
    sd = {}
    for name, p in enc.items():
        key = f"0.registered_modules_dict.{name}.nn"
        if "kernel" in p:
            _put_linear(sd, key, p)
        else:
            sd[f"{key}.weight"] = p["embedding"]
    _put_linear(sd, "1.mel_preprocess.projection", den["mel_preprocess"], conv1x1=True)
    for k in ("projection1", "projection2"):
        _put_linear(sd, f"1.diffusion_embedding.{k}", den["diffusion_embedding"][k])
    _put_linear(sd, "1.skip_projection", den["skip_projection"], conv1x1=True)
    _put_linear(sd, "1.output_projection", den["output_projection"], conv1x1=True)
    for name, p in den.items():
        if name.startswith("residual_"):
            base = f"1.residual_layers.{name.split('_')[1]}"
            _put_linear(sd, f"{base}.diffusion_projection", p["diffusion_projection"])
            sd[f"{base}.dilated_conv.weight"] = p["dilated_conv"]["kernel"].transpose(2, 1, 0)
            sd[f"{base}.dilated_conv.bias"] = p["dilated_conv"]["bias"]
            _put_linear(sd, f"{base}.conditioner_projection", p["conditioner_projection"], conv1x1=True)
            _put_linear(sd, f"{base}.output_projection", p["output_projection"], conv1x1=True)
    return {"state_dict": _tensors(sd, "module.")}


def vocoder_checkpoint(tree: dict, vcfg, rng) -> dict:
    """{"generator_state_dict"} of the reference's BigVGAN Generator, every
    conv as a weight-norm pair at dim 0 (g [Cout,1,1]; the ``ups`` transposed
    convs g [Cin,1,1]): v is the weight scaled by a random factor in [0.5, 2]
    per slice of dim 0 and g the weight's norm over the other dims, so that
    g v / |v| is the weight again to within float rounding. The convs take
    the old ``weight_g``/``weight_v`` keys and the newer
    ``parametrizations.weight.original0/1`` keys in turn."""
    import numpy as np

    sd = {}
    n_conv = [0]

    def put_wn(prefix, w, bias):  # w in torch layout, weight norm over dim 0
        g = np.sqrt(np.sum(np.asarray(w, np.float64) ** 2, axis=(1, 2), keepdims=True))
        scale = rng.uniform(0.5, 2.0, (w.shape[0], 1, 1))
        gk, vk = (WN_OLD_STYLE, WN_NEW_STYLE)[n_conv[0] % 2]
        n_conv[0] += 1
        sd[f"{prefix}.{gk}"] = g.astype(np.float32)
        sd[f"{prefix}.{vk}"] = (w * scale).astype(np.float32)
        sd[f"{prefix}.bias"] = bias

    def conv(prefix, p):
        put_wn(prefix, p["kernel"].transpose(2, 1, 0), p["bias"])

    def act(prefix, p):
        for k, v in p.items():
            sd[f"{prefix}.act.{k}"] = v

    nk = len(vcfg.resblock_kernel_sizes)
    conv("conv_pre", tree["conv_pre"]["conv"])
    for i in range(len(vcfg.upsample_rates)):
        conv(f"ups.{i}.0", tree[f"up_{i}"])  # [K,Cout,Cin] -> [Cin,Cout,K]
        for j in range(nk):
            base, block = f"resblocks.{i * nk + j}", tree[f"resblock_{i}_{j}"]
            for k in range(len(vcfg.resblock_dilation_sizes[j])):
                if vcfg.resblock == "1":
                    conv(f"{base}.convs1.{k}", block[f"conv1_{k}"]["conv"])
                    conv(f"{base}.convs2.{k}", block[f"conv2_{k}"]["conv"])
                    act(f"{base}.activations.{2 * k}", block[f"act1_{k}"])
                    act(f"{base}.activations.{2 * k + 1}", block[f"act2_{k}"])
                else:
                    conv(f"{base}.convs.{k}", block[f"conv_{k}"]["conv"])
                    act(f"{base}.activations.{k}", block[f"act_{k}"])
    conv("conv_post", tree["conv_post"]["conv"])
    act("activation_post", tree["activation_post"])
    return {"generator_state_dict": _tensors(sd)}


def whisper_checkpoint(dims: dict, enc: dict, rng) -> dict:
    """{"dims", "model_state_dict"} in OpenAI's file layout, fp16: the
    encoder from ``enc`` (a tree with ``block_i`` keys), a random text
    decoder of ``dims``' text sizes."""
    import numpy as np
    import torch

    sd = {}

    def ln(prefix, p):
        sd[f"{prefix}.weight"], sd[f"{prefix}.bias"] = p["scale"], p["bias"]

    def attn(prefix, p):
        for k in ("query", "key", "value", "out"):
            _put_linear(sd, f"{prefix}.{k}", p[k])

    def block(prefix, p):
        attn(f"{prefix}.attn", p["attn"])
        ln(f"{prefix}.attn_ln", p["attn_ln"])
        _put_linear(sd, f"{prefix}.mlp.0", p["mlp_0"])
        _put_linear(sd, f"{prefix}.mlp.2", p["mlp_2"])
        ln(f"{prefix}.mlp_ln", p["mlp_ln"])
        if "cross_attn" in p:
            attn(f"{prefix}.cross_attn", p["cross_attn"])
            ln(f"{prefix}.cross_attn_ln", p["cross_attn_ln"])

    for k in ("conv1", "conv2"):
        sd[f"encoder.{k}.weight"] = enc[k]["kernel"].transpose(2, 1, 0)
        sd[f"encoder.{k}.bias"] = enc[k]["bias"]
    for i in range(dims["n_audio_layer"]):
        block(f"encoder.blocks.{i}", enc[f"block_{i}"])
    ln("encoder.ln_post", enc["ln_post"])

    d = dims["n_text_state"]

    def rand(*shape):
        return (rng.standard_normal(shape, np.float32) / np.sqrt(shape[-1])).astype(np.float32)

    def lin(bias=True, n_in=d, n_out=d):
        p = {"kernel": rand(n_in, n_out)}
        if bias:
            p["bias"] = rand(n_out)
        return p

    def norm():
        return {"scale": 1.0 + rand(d), "bias": rand(d)}

    def attn_tree():
        return {"query": lin(), "key": lin(bias=False), "value": lin(), "out": lin()}

    sd["decoder.token_embedding.weight"] = rand(dims["n_vocab"], d)
    sd["decoder.positional_embedding"] = rand(dims["n_text_ctx"], d)
    for i in range(dims["n_text_layer"]):
        block(f"decoder.blocks.{i}", {"attn": attn_tree(), "attn_ln": norm(), "cross_attn": attn_tree(),
                                      "cross_attn_ln": norm(), "mlp_0": lin(n_out=4 * d),
                                      "mlp_2": lin(n_in=4 * d), "mlp_ln": norm()})
    ln("decoder.ln", norm())
    return {"dims": dict(dims), "model_state_dict": _tensors(sd, dtype=torch.float16)}


def crepe_checkpoint(model: str, rng) -> dict:
    """A torchcrepe state dict of random weights for capacity ``model``:
    Conv2d kernels [out, in, k, 1] and BatchNorm with non-trivial running
    statistics (mean ~ 0.2 N(0, 1), var in [0.5, 1.5]), so that BN after the
    ReLU and its fold into scale/shift are exercised."""
    import numpy as np
    import torch

    from svc_inference_pipeline_tpu_torch.ops.f0_crepe import N_BINS, _capacity

    def t(x):
        return torch.tensor(np.asarray(x, np.float32))

    sd, in_ch = {}, 1
    for i, (f, k) in enumerate(zip(_capacity(model), [512, 64, 64, 64, 64, 64])):
        sd[f"conv{i + 1}.weight"] = t(rng.standard_normal((f, in_ch, k, 1)) / np.sqrt(k * in_ch))
        sd[f"conv{i + 1}.bias"] = t(0.1 * rng.standard_normal(f))
        sd[f"conv{i + 1}_BN.weight"] = t(0.5 + rng.random(f))
        sd[f"conv{i + 1}_BN.bias"] = t(0.2 * rng.standard_normal(f))
        sd[f"conv{i + 1}_BN.running_mean"] = t(0.2 * rng.standard_normal(f))
        sd[f"conv{i + 1}_BN.running_var"] = t(0.5 + rng.random(f))
        in_ch = f
    sd["classifier.weight"] = t(rng.standard_normal((N_BINS, in_ch * 4)) / np.sqrt(in_ch * 4))
    sd["classifier.bias"] = t(0.1 * rng.standard_normal(N_BINS))
    return sd


def hubert_checkpoint(tree: dict, cfg, rng) -> dict:
    """A fairseq HuBERT/ContentVec checkpoint, ``{"args", "model"}``, of a
    JAX-layout ``HubertModel`` tree: ``args`` an ``argparse.Namespace`` as
    fairseq pickles it, ``model`` the state dict with the positional conv as
    a weight-norm pair over dim 2 (g [1, 1, K]; v the weight scaled by a
    random factor in [0.5, 2] per tap, so g v / |v| is the weight again to
    within float rounding)."""
    import argparse

    import numpy as np

    sd = {}

    def ln(prefix, p):
        sd[f"{prefix}.weight"], sd[f"{prefix}.bias"] = p["scale"], p["bias"]

    fe = tree["feature_extractor"]
    for i in range(len(cfg.conv_layers)):
        sd[f"feature_extractor.conv_layers.{i}.0.weight"] = fe[f"conv_{i}"]["kernel"].transpose(2, 1, 0)
    ln("feature_extractor.conv_layers.0.2", fe["group_norm"])
    ln("layer_norm", tree["layer_norm"])
    _put_linear(sd, "post_extract_proj", tree["post_extract_proj"])
    w = tree["pos_conv"]["kernel"].transpose(2, 1, 0)  # [C, C/groups, K]
    sd["encoder.pos_conv.0.weight_g"] = np.sqrt(
        np.sum(np.asarray(w, np.float64) ** 2, axis=(0, 1), keepdims=True)).astype(np.float32)
    sd["encoder.pos_conv.0.weight_v"] = (w * rng.uniform(0.5, 2.0, (1, 1, w.shape[2]))).astype(np.float32)
    sd["encoder.pos_conv.0.bias"] = tree["pos_conv"]["bias"]
    ln("encoder.layer_norm", tree["encoder_layer_norm"])
    for i in range(cfg.encoder_layers):
        base, p = f"encoder.layers.{i}", tree[f"layer_{i}"]
        for k in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _put_linear(sd, f"{base}.self_attn.{k}", p["self_attn"][k])
        ln(f"{base}.self_attn_layer_norm", p["self_attn_layer_norm"])
        _put_linear(sd, f"{base}.fc1", p["fc1"])
        _put_linear(sd, f"{base}.fc2", p["fc2"])
        ln(f"{base}.final_layer_norm", p["final_layer_norm"])
    _put_linear(sd, "final_proj", tree["final_proj"])
    args = argparse.Namespace(arch="hubert", encoder_layers=cfg.encoder_layers, encoder_embed_dim=cfg.encoder_dim,
                              final_dim=cfg.final_dim, conv_pos=cfg.pos_conv_kernel,
                              conv_pos_groups=cfg.pos_conv_groups)
    return {"args": args, "model": _tensors(sd)}


def param_mismatches(loaded, expected, names=None) -> list:
    """Parameters of ``loaded`` (of the names given, default all) that differ
    from ``expected``'s rounded to the loaded parameter's dtype."""
    import torch

    want = dict(expected.named_parameters())
    return [name for name, p in loaded.named_parameters() if (names is None or name in names)
            and not torch.equal(p.detach(), want[name].detach().to(device=p.device, dtype=p.dtype))]


def weight_norm_reference(vocoder_sd: dict, device) -> tuple:
    """(the vocoder state dict with every weight-norm pair replaced by
    g v / |v| evaluated on the card in float64 and rounded to f32, which is
    what the reference's Generator computes at every step; the largest
    distance of the port's folds, ``fold_weight_norm``, from those weights in
    f32 ulps; the same for ``torch._weight_norm(v, g, 0)`` in float64 on the
    card and on the host, printed beside it: its CUDA kernel lands further
    from an exact float64 evaluation than an ulp)."""
    import numpy as np
    import torch

    from svc_inference_pipeline_tpu_torch.checkpoints.torch_convert import fold_weight_norm, strip_ddp_prefix

    sd = strip_ddp_prefix(vocoder_sd)
    folded = fold_weight_norm(sd)
    out = {k: v for k, v in sd.items() if not k.endswith(WN_OLD_STYLE + WN_NEW_STYLE)}
    worst = {"fold": 0.0, "torch._weight_norm": 0.0, "torch._weight_norm cpu": 0.0}
    for key in sd:
        for gk, vk in (WN_OLD_STYLE, WN_NEW_STYLE):
            if key.endswith(vk):
                base = key[: -len(vk)]
                g, v = (torch.from_numpy(sd[base + k]).to(device, torch.float64) for k in (gk, vk))
                ref = (v * (g / torch.linalg.vector_norm(v, dim=(1, 2), keepdim=True))).float().cpu().numpy()
                out[base + "weight"] = ref
                ulp = np.spacing(np.abs(ref))
                for name, w in (("fold", folded[base + "weight"]),
                                ("torch._weight_norm", torch._weight_norm(v, g, 0).float().cpu().numpy()),
                                ("torch._weight_norm cpu", torch._weight_norm(v.cpu(), g.cpu(), 0).float().numpy())):
                    worst[name] = max(worst[name], float(np.max(np.abs(w - ref) / ulp)))
    if len(out) == len(sd):
        raise AssertionError("no weight-norm pair in the vocoder file")
    return out, worst


def checkpoint_paths(cfg, counters, paths, device) -> dict:
    """Paths n and o (module docstring, step 4): the CLI and ``eval --golden``
    from reference-layout checkpoint files and a FLAC clip; returns their
    checks' numbers."""
    import contextlib
    import dataclasses
    import io

    import numpy as np
    import torch

    from svc_inference_pipeline_tpu_torch import cli
    from svc_inference_pipeline_tpu_torch import eval as port_eval
    from svc_inference_pipeline_tpu_torch.checkpoints import torch_convert
    from svc_inference_pipeline_tpu_torch.checkpoints.from_jax import load_jax_params, random_init_
    from svc_inference_pipeline_tpu_torch.measure import synth_clip as clip
    from svc_inference_pipeline_tpu_torch.models.bigvgan import BigVGANGenerator
    from svc_inference_pipeline_tpu_torch.models.whisper import WHISPER_SIZES, WhisperAudioEncoder
    from svc_inference_pipeline_tpu_torch.native import wav_codec
    from svc_inference_pipeline_tpu_torch.ops.pallas.denoiser_step import make_denoise_fn
    from svc_inference_pipeline_tpu_torch.pipeline.content import WhisperPPGExtractor, cast_matmul_weights_
    from svc_inference_pipeline_tpu_torch.pipeline.convert import SVCPipeline, mel_frame_count
    from svc_inference_pipeline_tpu_torch.utils.audio_io import read_wav

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from flac_fixture import write_flac

    steps = int(cfg.mapper.noise_schedule_factors[2])
    expected = {"K1 bf16": steps, "K4": 24, "K2": 6, "K3": 1, "K9": 3}
    cd = torch.bfloat16
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        # the weights: f32 modules at full width on the card, Whisper rounded
        # to fp16 (OpenAI's files are fp16), 1-D leaves random
        g = torch.Generator(device=device).manual_seed(10)
        with torch.device(device):
            cond, den, voc = SVCPipeline._models(cfg, cd)
            enc = WhisperAudioEncoder(WHISPER_SIZES[WHISPER_SIZE])
        for m in (cond, den, voc, enc):
            random_init_(m, g)
            randomize_vectors_(m, g)
        with torch.no_grad():
            for sub in enc.modules():
                if isinstance(sub, torch.nn.LayerNorm):
                    sub.weight.add_(1.0)
            for p in enc.parameters():
                p.copy_(p.half().float())
        rng = np.random.default_rng(10)
        files = {k: os.path.join(tmp, f"{k}.pt") for k in ("mapper", "vocoder", "whisper-medium-synthetic")}
        # the text decoder cut to 2 layers: conversion does not run it, and
        # path q decodes with it
        dims = dataclasses.replace(WHISPER_SIZES[WHISPER_SIZE], n_text_layer=2)
        t0 = time.perf_counter()
        torch.save(mapper_checkpoint(module_tree(cond), module_tree(den)), files["mapper"])
        voc_ckpt = vocoder_checkpoint(module_tree(voc), cfg.vocoder, rng)
        torch.save(voc_ckpt, files["vocoder"])
        whisper_ckpt = whisper_checkpoint(dataclasses.asdict(dims), module_tree(enc), rng)
        torch.save(whisper_ckpt, files["whisper-medium-synthetic"])
        sizes = {k: os.path.getsize(p) for k, p in files.items()}
        print(f"path n: wrote {sum(sizes.values()) / 1e9:.3f} GB of checkpoints in {time.perf_counter() - t0:.1f}s "
              f"({', '.join(f'{k} {v / 1e6:.1f} MB' for k, v in sizes.items())})")
        d = cfg.to_dict()
        d.update(whisper_model=files["whisper-medium-synthetic"], svc_model_path=files["mapper"],
                 vocoder_model_path=files["vocoder"])
        cfg_path = os.path.join(tmp, "config_files.json")
        with open(cfg_path, "w") as f:
            json.dump(d, f)
        fcfg = type(cfg)(**d)

        x = clip(cfg.fs, CLIP_SECONDS)
        flac = os.path.join(tmp, "clip.flac")
        write_flac(flac, np.clip(np.round(x * 32767), -32768, 32767).astype(np.int64), cfg.fs, bits=16)
        n_expected = mel_frame_count(cfg, len(x)) * cfg.hop_length

        # load seconds: each file's torch.load + conversion, then the whole
        # build from the files with the copy to the card
        load = {}
        for name, fn in (("whisper", lambda: torch_convert.load_whisper(files["whisper-medium-synthetic"])),
                         ("mapper", lambda: torch_convert.load_mapper_params(files["mapper"], cfg.mapper)),
                         ("vocoder", lambda: torch_convert.load_vocoder_params(files["vocoder"], cfg.vocoder))):
            t0 = time.perf_counter()
            fn()
            load[f"{name}_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        SVCPipeline.from_config(fcfg, device=device)
        torch.cuda.synchronize()
        load["from_config_s"] = time.perf_counter() - t0

        # n. the CLI from the files and the FLAC clip, no --random-weights
        wav_out = os.path.join(tmp, "files.wav")
        built = {}

        def run_cli():
            timings_path = os.path.join(tmp, "files.json")
            rc = cli.main(["--config", cfg_path, "--input", flac, "--singer", SINGER, "--output", wav_out,
                           "--seed", "0", "--device", device.type, "--timings-json", timings_path], built=built)
            if rc != 0:
                raise AssertionError(f"cli.main returned {rc}")
            samples, sr = read_wav(wav_out)
            silence = cfg.fs // 20
            if sr != cfg.fs:
                raise AssertionError(f"path n: WAV at {sr} Hz")
            check_audio("path n", samples[silence: len(samples) - silence, 0].astype("float64") / 32768.0, n_expected)
            with open(timings_path) as f:
                return json.load(f)

        drive("cli ddpm bf16 from checkpoint files, flac", counters, run_cli, expected, paths)
        pipe = built["pipeline"]
        lib = wav_codec.loaded_library()
        if lib is None or os.path.dirname(lib) != str(wav_codec.BUILD_DIR):
            raise AssertionError(f"native codec library not loaded from {wav_codec.BUILD_DIR}: {lib}")
        on_cpu = [n for m in (pipe.cond_encoder, pipe.denoiser, pipe.vocoder, pipe.whisper.encoder)
                  for n, p in m.named_parameters() if p.device.type != device.type]
        if pipe.device.type != device.type or on_cpu:
            raise AssertionError(f"pipeline on {pipe.device}, parameters off the card: {on_cpu[:5]}")

        # check 1: the loaded parameters against the drawn ones (rounded to the
        # loaded dtype); the vocoder's 2-D weights against the folds, which are
        # held to g v / |v| in float64 on the card
        wn_sd, ulps = weight_norm_reference(voc_ckpt["generator_state_dict"], device)
        with torch.device(device):
            voc_fold, voc_wn = (BigVGANGenerator(cfg.vocoder, compute_dtype=cd) for _ in range(2))
        load_jax_params(voc_fold, torch_convert.load_vocoder_params(files["vocoder"], cfg.vocoder))
        load_jax_params(voc_wn, torch_convert.convert_vocoder_state_dict(wn_sd, cfg.vocoder))
        vectors = {n for n, p in voc.named_parameters() if p.dim() == 1}
        weights = {n for n, _ in voc.named_parameters()} - vectors
        bad = {"cond_encoder": param_mismatches(pipe.cond_encoder, cond),
               "denoiser": param_mismatches(pipe.denoiser, den),
               "whisper": param_mismatches(pipe.whisper.encoder, enc),
               "vocoder 1-D": param_mismatches(pipe.vocoder, voc, vectors),
               "vocoder folded": param_mismatches(pipe.vocoder, voc_fold, weights)}
        n_params = sum(1 for m in (pipe.cond_encoder, pipe.denoiser, pipe.whisper.encoder, pipe.vocoder)
                       for _ in m.parameters())
        bf16_apart = len(param_mismatches(pipe.vocoder, voc_wn, weights))
        print(f"path n: {n_params} loaded parameters equal the files' (folds within {ulps['fold']:.2f} f32 ulp "
              f"of g v / |v| in float64 on the card; torch._weight_norm in float64 within "
              f"{ulps['torch._weight_norm']:.2f} there, {ulps['torch._weight_norm cpu']:.2f} on the host; {bf16_apart} of {len(weights)} bf16 weight tensors apart from "
              f"it); mismatches {({k: v[:3] for k, v in bad.items() if v})}")
        if any(bad.values()) or ulps["fold"] > 1.0:
            raise AssertionError(f"loaded parameters differ from the files: {bad}, fold ulps {ulps}")

        # check 4: against a pipeline holding the drawn weights directly
        gen = torch.Generator(device=device).manual_seed(0)
        t0 = time.perf_counter()
        wave = pipe.convert(flac, SINGER, generator=gen)
        torch.cuda.synchronize()
        second_s = time.perf_counter() - t0
        ref = SVCPipeline(fcfg, cond, den, voc_wn,
                          WhisperPPGExtractor(cast_matmul_weights_(enc.eval(), cd), cfg.fs), device)
        ref_wave = ref.convert(flac, SINGER, generator=torch.Generator(device=device).manual_seed(0))
        feats, mels = [], []
        with torch.no_grad():
            for p in (pipe, ref):
                batch, n_frames = p.extract_features(flac, SINGER)
                cond_t = p.cond_encoder(batch)
                fn = make_denoise_fn(p.denoiser, cond_t, steps, p.compute_dtype, None)
                feats.append(batch)
                mels.append(fn.fused_ddpm(p.schedule, (1, cond_t.shape[1], cfg.mapper.n_mel),
                                          torch.Generator(device=device).manual_seed(0)))
        same_features = all(torch.equal(feats[0][k], feats[1][k]) for k in feats[0])
        same_mel = torch.equal(mels[0], mels[1])
        corr = float(np.corrcoef(wave.astype(np.float64), ref_wave.astype(np.float64))[0, 1])
        print(f"path n: against the weights held directly (the vocoder's g v / |v| in float64): content and F0/loudness/singer equal "
              f"{same_features}, final mel (DDPM-{steps}) equal {same_mel}, waveform correlation {corr:.8f}")
        if not (same_features and same_mel and corr >= FILES_MIN_CORR):
            raise AssertionError(f"path n: features equal {same_features}, mel equal {same_mel}, corr {corr}")
        first_s = paths[-1]["total_s"]
        print(f"path n ({card_line()}): load whisper {load['whisper_s']:.3f}s, mapper {load['mapper_s']:.3f}s, "
              f"vocoder {load['vocoder_s']:.3f}s (torch.load + conversion), from_config {load['from_config_s']:.3f}s "
              f"(with the copy to the card); conversion from the files: first {first_s:.3f}s, second {second_s:.3f}s")
        out["checkpoint_files"] = {"load": load, "first_conversion_s": first_s, "second_conversion_s": second_s,
                                   "fold_max_ulps": ulps["fold"], "torch_weight_norm_max_ulps":
                                   ulps["torch._weight_norm"], "torch_weight_norm_cpu_max_ulps":
                                   ulps["torch._weight_norm cpu"], "waveform_corr": corr, "file_bytes": sizes}
        del pipe, ref, built

        # o. eval --golden on the card, scored against path n's WAV. The F0
        # RMSE is over frames voiced in both waveforms; random weights may
        # give unvoiced noise, and then the metric is NaN by its definition,
        # which the check confirms from both waveforms' F0 tracks
        def run_eval():
            from svc_inference_pipeline_tpu_torch.ops.f0 import get_f0_features
            from svc_inference_pipeline_tpu_torch.utils.audio_io import load_audio

            eval_out = os.path.join(tmp, "eval.wav")
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = port_eval.main(["--golden", "--config", cfg_path, "--mapper", files["mapper"],
                                     "--vocoder", files["vocoder"], "--whisper", files["whisper-medium-synthetic"],
                                     "--input", flac, "--golden-wav", wav_out, "--output", eval_out])
            if rc != 0:
                raise AssertionError(f"eval.main returned {rc}")
            metrics = json.loads(buf.getvalue().strip().splitlines()[-1])
            print("  eval --golden: " + json.dumps(metrics))
            keys = ("mel_mae", "mcd_db", "snr_db", "rtf")
            voiced = []
            for path in (wav_out, eval_out):
                a = load_audio(path, cfg.fs)[0]
                voiced.append(get_f0_features(a, len(a) // cfg.hop_length, cfg)[0] > 0)
            n = min(len(v) for v in voiced)
            both = int(np.sum(voiced[0][:n] & voiced[1][:n]))
            f0_ok = math.isfinite(metrics["f0_rmse_cents"]) or both == 0
            print(f"  voiced frames: golden {int(voiced[0].sum())}, converted {int(voiced[1].sum())}, both {both}")
            if not (all(math.isfinite(metrics[k]) for k in keys) and f0_ok):
                raise AssertionError(f"eval --golden: {metrics}, frames voiced in both {both}")
            return {k: metrics[k] for k in keys + ("f0_rmse_cents", "voicing_agreement", "duration_s")}

        drive("eval --golden from checkpoint files", counters, run_eval, expected, paths)
        out["eval_golden"] = {k: v for k, v in paths[-1].items() if k not in ("path", "launches")}
        out["transcribe_file"] = transcribe_file_path(counters, paths, device, files["whisper-medium-synthetic"],
                                                      whisper_ckpt, enc, tmp)
    return out


# ---------------------------------------------------------------------------
# Paths r-u: the feature extractors
# ---------------------------------------------------------------------------

F0_METHODS = ("parselmouth", "dio", "pyin", "harvest")
# path r: frames of the synthetic clip's tone (0.1-1.7 s and 2.3-3.9 s) that
# each tracker must voice within F0_MAX_CENTS of the true F0
F0_MIN_SHARE, F0_MAX_CENTS = 0.95, 50.0
CREPE_PROB_BOUND = 1e-4  # path s: the net's probabilities on the card vs on the CPU, f32 both
# path t: the per-clip features of the K4 route (bf16 weights and
# activations) against the plain route (f32) on the same draws: measured
# 8.1e-2 on an H100 (max|f32| 3.7); the bound is 2.7x that, as path q's
CONTENT_BF16_BOUND = 0.22
CONTENTVEC_REL_BOUND = 1e-3  # path u: features on the card vs the CPU, of max|cpu|


def f0_paths(cfg, counters, paths) -> dict:
    """Path r: ``get_f0_features(method=m)`` on the synthetic 4 s clip for
    each tracker (host numpy, no launches); each must voice >= F0_MIN_SHARE of
    the tone's frames within F0_MAX_CENTS of the true F0."""
    import numpy as np

    from svc_inference_pipeline_tpu_torch.measure import synth_clip as clip
    from svc_inference_pipeline_tpu_torch.ops.f0 import get_f0_features
    from svc_inference_pipeline_tpu_torch.pipeline.convert import mel_frame_count

    audio = clip(cfg.fs, CLIP_SECONDS)
    mel_len = mel_frame_count(cfg, len(audio))
    t = np.arange(mel_len) * cfg.hop_length / cfg.fs
    true = 220.0 * 2 ** (0.5 / 12 * np.sin(2 * np.pi * 5.5 * t))  # measure.synth_clip's F0
    tone = ((t >= 0.1) & (t <= 1.7)) | ((t >= 2.3) & (t <= 3.9))
    out = {}
    for method in F0_METHODS:
        got = {}

        def run():
            t0 = time.perf_counter()
            got["f0"], _ = get_f0_features(audio, mel_len, cfg, method=method)
            return {"seconds": time.perf_counter() - t0}

        drive(f"f0 {method}", counters, run, {}, paths)
        f0 = got["f0"]
        cents = np.abs(1200 * np.log2(np.maximum(f0, 1e-9) / true))
        share = float(((f0 > 0) & (cents <= F0_MAX_CENTS))[tone].mean())
        voiced = float((f0 > 0).mean())
        out[method] = {"seconds": paths[-1]["seconds"], "tone_share": share, "voiced_share": voiced,
                       "p95_cents": float(np.percentile(cents[tone & (f0 > 0)], 95))}
        print(f"path r {method}: {out[method]['seconds']:.3f}s, {mel_len} frames, voiced {voiced:.3f}, tone frames "
              f"within {F0_MAX_CENTS:g} cents {share:.3f} (gate {F0_MIN_SHARE}), p95 {out[method]['p95_cents']:.1f} cents")
        if f0.shape != (mel_len,) or not share >= F0_MIN_SHARE:
            raise AssertionError(f"path r {method}: shape {f0.shape}, tone share {share}")
    return out


def crepe_path(cfg, counters, paths, device, tmp: str) -> dict:
    """Path s: CREPE at capacity "full" from a torchcrepe-layout file of
    random weights (``crepe_checkpoint``) named by ``SVC_CREPE_WEIGHTS``, the
    chain ``get_f0_features_using_crepe`` with its net on the card (no
    launches); f0 [mel_len] and finite, and the net's probabilities on the
    clip's frames within CREPE_PROB_BOUND of the same module on the CPU."""
    import numpy as np
    import torch

    from svc_inference_pipeline_tpu_torch.measure import synth_clip as clip
    from svc_inference_pipeline_tpu_torch.ops import f0_crepe
    from svc_inference_pipeline_tpu_torch.ops.resample import resample_host
    from svc_inference_pipeline_tpu_torch.pipeline.convert import mel_frame_count

    path = os.path.join(tmp, "full.pth")
    torch.save(crepe_checkpoint("full", np.random.default_rng(12)), path)
    audio = clip(cfg.fs, CLIP_SECONDS)
    mel_len = mel_frame_count(cfg, len(audio))
    got = {}
    old = os.environ.get("SVC_CREPE_WEIGHTS")
    os.environ["SVC_CREPE_WEIGHTS"] = path
    try:
        def run():
            t0 = time.perf_counter()
            got["f0"] = f0_crepe.get_f0_features_using_crepe(audio, mel_len, cfg.fs, cfg.hop_length, 160,
                                                             float(cfg.f0_min), float(cfg.f0_max), device=device)
            return {"call_s": time.perf_counter() - t0}

        drive("crepe full", counters, run, {}, paths)
        f0 = got["f0"]
        if f0.shape != (mel_len,) or not np.isfinite(f0).all():
            raise AssertionError(f"path s: f0 {f0.shape}, finite {bool(np.isfinite(f0).all())}")
        params = f0_crepe._PARAM_CACHE[(path, "full")]
    finally:
        if old is None:
            os.environ.pop("SVC_CREPE_WEIGHTS", None)
        else:
            os.environ["SVC_CREPE_WEIGHTS"] = old
    frames = f0_crepe.frame_audio(resample_host(audio, cfg.fs, f0_crepe.SAMPLE_RATE), 160)
    net = f0_crepe.build_crepe(params, "full", device)
    probs = f0_crepe.crepe_probs(net, frames)
    probs_cpu = f0_crepe.crepe_probs(f0_crepe.build_crepe(params, "full", "cpu"), frames)
    err = float(np.abs(probs - probs_cpu).max())
    frames_dev = torch.as_tensor(frames, device=device)
    with torch.no_grad():
        net_ms = cuda_ms(lambda: net(frames_dev), reps=5)
    row = {"frames": len(frames), "net_ms": net_ms, "call_s": paths[-1]["call_s"], "prob_max_abs": err,
           "voiced_share": float((f0 > 0).mean())}
    print(f"path s ({card_line()}): {len(frames)} frames, net {net_ms:.3f} ms (one call, f32, TF32 off), whole call "
          f"{1e3 * row['call_s']:.1f} ms; probabilities card vs CPU max |d| {err:.3e} (bound {CREPE_PROB_BOUND}); "
          f"voiced {row['voiced_share']:.3f}")
    if not err <= CREPE_PROB_BOUND:
        raise AssertionError(f"path s: probabilities card vs CPU {err} > {CREPE_PROB_BOUND}")
    return row


def content_path(cfg, counters, paths, device) -> dict:
    """Path t: ``WhisperPPGExtractor.extract`` at Whisper-medium width on
    random weights: the 4 s clip (one window, K4 x 24) and a 35 s clip with
    ``chunked=True`` (two windows, encoded as one batch of two: K4 x 24);
    shapes, finite values, and the 4 s features of the K4 route (bf16)
    against the plain route (f32 weights, the plain attention) on the card
    within CONTENT_BF16_BOUND."""
    from unittest import mock

    import numpy as np
    import torch

    from svc_inference_pipeline_tpu_torch.measure import synth_clip as clip
    from svc_inference_pipeline_tpu_torch.ops.pallas import attention
    from svc_inference_pipeline_tpu_torch.pipeline.content import WhisperPPGExtractor
    from svc_inference_pipeline_tpu_torch.pipeline.convert import mel_frame_count

    def build(dtype):
        return WhisperPPGExtractor.random_init(WHISPER_SIZE, torch.Generator(device=device).manual_seed(5), device,
                                               compute_dtype=dtype, fs=cfg.fs)

    ext = build(torch.bfloat16)
    short = clip(cfg.fs, CLIP_SECONDS)
    long = np.concatenate([short] * 9)[: 35 * cfg.fs]
    out = {}
    for name, audio in (("4 s", short), ("35 s chunked", long)):
        mel_len = mel_frame_count(cfg, len(audio))
        got = {}

        def run():
            t0 = time.perf_counter()
            got["feats"] = ext.extract(audio, mel_len, chunked=True)
            return {"call_s": time.perf_counter() - t0}

        drive(f"whisper content {name}", counters, run, {"K4": 24}, paths)
        feats = got["feats"]
        if feats.shape != (mel_len, ext.dims.n_audio_state) or not np.isfinite(feats).all():
            raise AssertionError(f"path t {name}: {feats.shape}, finite {bool(np.isfinite(feats).all())}")
        out[name] = {"call_s": paths[-1]["call_s"], "frames": mel_len}
        if name == "4 s":
            ref = got["feats"]
    plain = build(torch.float32)
    with mock.patch.object(attention, "encoder_attention", attention.encoder_attention_plain):
        f32 = plain.extract(short, len(ref))
    err = float(np.abs(ref - f32).max())
    out["bf16_max_abs"], out["f32_max"] = err, float(np.abs(f32).max())
    print(f"path t ({card_line()}): 4 s {1e3 * out['4 s']['call_s']:.1f} ms, 35 s (two windows) "
          f"{1e3 * out['35 s chunked']['call_s']:.1f} ms; K4 (bf16) vs plain (f32) features max |d| {err:.3e} "
          f"(bound {CONTENT_BF16_BOUND}, max|f32| {out['f32_max']:.3e})")
    if not err <= CONTENT_BF16_BOUND:
        raise AssertionError(f"path t: bf16 vs f32 features {err} > {CONTENT_BF16_BOUND}")
    return out


def contentvec_path(cfg, counters, paths, device, tmp: str) -> dict:
    """Path u: ContentVec at HuBERT-base width (12 layers, 768, output layer
    9, ``final_proj`` 256) from a fairseq-layout file of random weights
    (``hubert_checkpoint``, the positional conv a weight-norm pair), then
    ``extract`` on the card (no launches); the loaded parameters equal the
    file's (the positional conv within one f32 ulp of g v / |v| in float64
    from the file's pair, which the reference computes), the features
    [mel_len, 256], finite and within CONTENTVEC_REL_BOUND x max|cpu| of the
    same file on the CPU."""
    import numpy as np
    import torch

    from svc_inference_pipeline_tpu_torch.checkpoints.from_jax import random_init_
    from svc_inference_pipeline_tpu_torch.measure import synth_clip as clip
    from svc_inference_pipeline_tpu_torch.models.hubert import HubertConfig, HubertModel
    from svc_inference_pipeline_tpu_torch.pipeline.content import ContentVecExtractor
    from svc_inference_pipeline_tpu_torch.pipeline.convert import mel_frame_count

    hcfg = HubertConfig()
    g = torch.Generator().manual_seed(9)
    drawn = random_init_(HubertModel(hcfg), g)
    with torch.no_grad():  # every vector drawn too, so a bias or norm mix-up shows
        for p in drawn.parameters():
            if p.dim() == 1:
                p.add_(0.1 * torch.randn(p.shape, generator=g))
    path = os.path.join(tmp, "contentvec.pt")
    ckpt = hubert_checkpoint(module_tree(drawn), hcfg, np.random.default_rng(9))
    torch.save(ckpt, path)
    audio = clip(cfg.fs, CLIP_SECONDS)
    mel_len = mel_frame_count(cfg, len(audio))
    got = {}

    def run():
        t0 = time.perf_counter()
        got["ext"] = ContentVecExtractor.from_torch_checkpoint(path, device=device, fs=cfg.fs)
        t1 = time.perf_counter()
        got["feats"] = got["ext"].extract(audio, mel_len)
        return {"load_s": t1 - t0, "extract_s": time.perf_counter() - t1}

    drive("contentvec from fairseq file", counters, run, {}, paths)
    feats = got["feats"]
    want = dict(drawn.named_parameters())
    loaded = dict(got["ext"].model.named_parameters())
    g_, v_ = (ckpt["model"][f"encoder.pos_conv.0.weight_{k}"].double().numpy() for k in "gv")
    fold = (g_ * v_ / np.sqrt(np.sum(v_ * v_, axis=(0, 1), keepdims=True))).astype(np.float32)
    bad = []
    for name, p in loaded.items():
        a = p.detach().cpu().numpy()
        if name == "pos_conv.weight":
            ok = (np.abs(a - fold) <= np.spacing(np.abs(fold))).all()
        else:
            ok = np.array_equal(a, want[name].detach().numpy())
        if not ok:
            bad.append(name)
    cpu = ContentVecExtractor.from_torch_checkpoint(path, device="cpu", fs=cfg.fs).extract(audio, mel_len)
    err, scale = float(np.abs(feats - cpu).max()), float(np.abs(cpu).max())
    row = {"load_s": paths[-1]["load_s"], "extract_s": paths[-1]["extract_s"], "max_abs": err, "cpu_max": scale}
    print(f"path u ({card_line()}): load {row['load_s']:.2f}s, extract {1e3 * row['extract_s']:.1f} ms, "
          f"{len(loaded)} parameters equal the file's ({len(bad)} differ), features {feats.shape}, card vs CPU "
          f"max |d| {err:.3e} (bound {CONTENTVEC_REL_BOUND:g} x max|cpu| {scale:.3e})")
    if bad or len(loaded) != len(want):
        raise AssertionError(f"path u: loaded parameters differ from the file's: {bad[:5]}")
    if feats.shape != (mel_len, hcfg.final_dim) or not np.isfinite(feats).all() or not err <= CONTENTVEC_REL_BOUND * scale:
        raise AssertionError(f"path u: features {feats.shape}, card vs CPU {err} (max|cpu| {scale})")
    return row


def feature_paths(cfg, counters, paths, device) -> dict:
    """Paths r-u (the module docstring, step 4)."""
    with tempfile.TemporaryDirectory() as tmp:
        return {"f0": f0_paths(cfg, counters, paths),
                "crepe": crepe_path(cfg, counters, paths, device, tmp),
                "whisper_content": content_path(cfg, counters, paths, device),
                "contentvec": contentvec_path(cfg, counters, paths, device, tmp)}


# ---------------------------------------------------------------------------
# Paths v-x: training, then serving the trained weights
# ---------------------------------------------------------------------------

TRAIN_CLIPS = 8  # path v: the batch, B clips of CLIP_SECONDS in the 512-frame bucket
TRAIN_STEPS = 20
RESUME_AT = 10
# path v: the run resumed from its step-10 checkpoint against the unbroken
# run, relative L2 over every parameter and EMA tensor and relative per
# step's loss (cuDNN's conv backward need not repeat its sums bit for bit)
RESUME_REL_BOUND = 1e-4
# path v: one step's gradients on the card against the CPU's from the same
# weights, batch and draws, relative L2 per parameter (f32, TF32 off; both
# embed the diffusion steps with the host table of timescales)
GRAD_CPU_REL_BOUND = 1e-4
GAN_FRAMES = 32  # path w: segments of 32 frames (8192 samples), B = 2
GAN_STEPS = 3


def peak_gb() -> float:
    import torch

    return torch.cuda.max_memory_allocated() / 1e9


def rel_l2(a, b) -> float:
    import torch

    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    return float(torch.linalg.vector_norm(a - b) / max(float(torch.linalg.vector_norm(b)), 1e-30))


def diffusion_training_path(cfg, counters, paths, device, tmp: str) -> dict:
    """Path v: ``train_diffusion`` at the mapper's full width (20 x 384,
    Whisper-medium content 1024) on batches of TRAIN_CLIPS synthetic clips
    from ``BucketedLoader`` (content from ``WhisperPPGExtractor.extract`` on
    random medium weights, the features cached on the loader's first pass):
    TRAIN_STEPS steps unbroken, and RESUME_AT steps, a checkpoint, and a
    resumed run to TRAIN_STEPS, which must equal the unbroken one within
    RESUME_REL_BOUND; no kernel launches. Then one step on the card against
    the same step on the CPU (gradients per parameter within
    GRAD_CPU_REL_BOUND). Returns the numbers and, for path x, the EMA
    weights, the untrained weights, the Whisper extractor and a clip."""
    import copy

    import numpy as np
    import torch

    from svc_inference_pipeline_tpu_torch.measure import synth_clip as clip
    from svc_inference_pipeline_tpu_torch.models import diffsvc
    from svc_inference_pipeline_tpu_torch.models.whisper import WHISPER_SIZES
    from svc_inference_pipeline_tpu_torch.pipeline.content import WhisperPPGExtractor
    from svc_inference_pipeline_tpu_torch.training.data import BucketedLoader, FeatureExtractor
    from svc_inference_pipeline_tpu_torch.training.diffusion import (
        init_diffusion_train_state, make_diffusion_train_step)
    from svc_inference_pipeline_tpu_torch.training.loop import train_diffusion
    from svc_inference_pipeline_tpu_torch.utils.audio_io import write_wav
    from svc_inference_pipeline_tpu_torch.utils.observability import Metrics

    singers = ("svcc_CDF1", "svcc_CDM1", "svcc_IDF1", "svcc_IDM1")
    base = clip(cfg.fs, CLIP_SECONDS)
    manifest = []
    for i in range(TRAIN_CLIPS):
        path = os.path.join(tmp, f"train{i}.wav")
        write_wav(path, (0.5 + 0.05 * i) * np.roll(base, 2400 * i), cfg.fs)
        manifest.append((path, singers[i % len(singers)]))
    whisper = WhisperPPGExtractor.random_init(WHISPER_SIZE, torch.Generator(device=device).manual_seed(5), device,
                                              compute_dtype=torch.bfloat16, fs=cfg.fs)
    loader = BucketedLoader(manifest, cfg, FeatureExtractor(cfg, whisper, os.path.join(tmp, "features"), device),
                            batch_size=TRAIN_CLIPS, seed=0)
    t0 = time.perf_counter()
    batches = list(loader)  # the first pass extracts and caches every clip's features (K4 x 24 a clip)
    extract_s = time.perf_counter() - t0
    for _ in range(TRAIN_STEPS - 1):  # one batch a pass, reshuffled, read from the cache
        batches += list(loader)
    shapes = {k: tuple(v.shape) for k, v in batches[0].items()}
    if shapes["mel"] != (TRAIN_CLIPS, 512, cfg.mapper.n_mel) or \
            shapes["content_whisper"][2] != WHISPER_SIZES[WHISPER_SIZE].n_audio_state:
        raise AssertionError(f"path v: batch shapes {shapes}")

    runs, step_s, losses = {}, {}, {}
    ckpt = os.path.join(tmp, "ckpt")

    class StepLog(Metrics):
        """Metrics that also keep each step's observations, in order."""

        def __init__(self):
            super().__init__()
            self.values = collections.defaultdict(list)

        def observe(self, key, value):
            super().observe(key, value)
            self.values[key].append(float(value))

    def train(name, data, num_steps, checkpoint_dir=None):
        default, Metrics._default = Metrics._default, StepLog()
        try:
            runs[name] = train_diffusion(cfg, data, num_steps, checkpoint_dir=checkpoint_dir,
                                         checkpoint_every=RESUME_AT, device=device)
            obs = Metrics._default.values
        finally:
            Metrics._default = default
        step_s[name], losses[name] = obs["train/step_s"], obs["train/loss"]

    def run():
        torch.cuda.reset_peak_memory_stats()
        train("whole", batches, TRAIN_STEPS)
        train("first", batches[:RESUME_AT], RESUME_AT, ckpt)
        train("resumed", batches[RESUME_AT:], TRAIN_STEPS, ckpt)
        return {"ms_per_step": 1e3 * statistics.median(step_s["whole"][2:]), "peak_gb": peak_gb()}

    drive("train diffusion", counters, run, {}, paths)
    whole, resumed = runs["whole"], runs["resumed"]
    if whole.step != TRAIN_STEPS or resumed.step != TRAIN_STEPS or len(losses["resumed"]) != TRAIN_STEPS - RESUME_AT:
        raise AssertionError(f"path v: steps {whole.step}, {resumed.step}")
    if not all(np.isfinite(v) for vs in losses.values() for v in vs):
        raise AssertionError(f"path v: losses {losses}")

    def flat(state):
        sd = {f"enc.{n}": p.detach() for n, p in state.encoder.named_parameters()}
        sd.update({f"den.{n}": p.detach() for n, p in state.denoiser.named_parameters()})
        sd.update({f"ema.{k}.{n}": v for k, tree in state.ema.items() for n, v in tree.items()})
        return sd

    a, b = flat(resumed), flat(whole)
    diff = torch.sqrt(sum(((a[k].double() - b[k].double()) ** 2).sum() for k in b))
    norm = torch.sqrt(sum((b[k].double() ** 2).sum() for k in b))
    out = {"extract_s": extract_s, "ms_per_step": paths[-1]["ms_per_step"], "peak_gb": paths[-1]["peak_gb"],
           "resume_rel_l2": float(diff / norm),
           "resume_max_abs": max(float((a[k] - b[k]).abs().max()) for k in b),
           "resume_loss_rel": max(abs(x - y) / abs(y) for x, y in zip(losses["resumed"], losses["whole"][RESUME_AT:])),
           "losses": losses["whole"]}

    # one step on the card and on the CPU from the same weights, batch and draws
    state, opt = init_diffusion_train_state(cfg, torch.Generator(device=device).manual_seed(0), device=device)
    untrained = {"enc": copy.deepcopy(state.encoder.state_dict()), "den": copy.deepcopy(state.denoiser.state_dict())}
    cpu, cpu_opt = init_diffusion_train_state(cfg, torch.Generator().manual_seed(0), device="cpu")
    cpu.encoder.load_state_dict(untrained["enc"])
    cpu.denoiser.load_state_dict(untrained["den"])
    draws = torch.Generator().manual_seed(3)
    t = torch.randint(0, int(cfg.mapper.noise_schedule_factors[2]), (TRAIN_CLIPS,), generator=draws)
    noise = torch.randn(shapes["mel"], generator=draws)
    # Both sides embed the steps with the host table of timescales
    # (diffsvc.step_timescales); the card's own f32 pow would differ from it
    # on some entries, which is counted here
    card_pow = (10.0 ** (torch.arange(64, dtype=torch.float32, device=device) * 4.0 / 63)).cpu()
    pow_differs = int((card_pow != torch.tensor(diffsvc.step_timescales(64))).sum())

    t0 = time.perf_counter()
    _, loss = make_diffusion_train_step(cfg, opt)(state, batches[0], t=t, noise=noise)
    _, cpu_loss = make_diffusion_train_step(cfg, cpu_opt)(cpu, batches[0], t=t, noise=noise)
    cpu_s = time.perf_counter() - t0
    errs = {f"{k}.{n}": rel_l2(p.grad, q.grad)
            for k, (m, c) in {"enc": (state.encoder, cpu.encoder), "den": (state.denoiser, cpu.denoiser)}.items()
            for (n, p), (_, q) in zip(m.named_parameters(), c.named_parameters())}
    worst = max(errs, key=errs.get)
    out.update(grad_cpu_rel_l2=errs[worst], grad_cpu_worst=worst,
               loss_cpu_rel=abs(float(loss) - float(cpu_loss)) / abs(float(cpu_loss)),
               card_pow_differs=pow_differs)
    print(f"path v ({card_line()}): {TRAIN_STEPS} steps at B={TRAIN_CLIPS}, T=512, "
          f"{cfg.mapper.residual_layer_num} x {cfg.mapper.residual_channels}: "
          f"{out['ms_per_step']:.2f} ms a step (warm median), peak {out['peak_gb']:.2f} GB, features of "
          f"{TRAIN_CLIPS} clips {extract_s:.2f}s; loss {losses['whole'][0]:.4f} -> {losses['whole'][-1]:.4f}; "
          f"resumed vs unbroken rel L2 {out['resume_rel_l2']:.3e} (max |d| {out['resume_max_abs']:.3e}, "
          f"losses {out['resume_loss_rel']:.3e}; bound {RESUME_REL_BOUND}); card vs CPU gradients rel L2 "
          f"{errs[worst]:.3e} at {worst}, loss {out['loss_cpu_rel']:.3e} (bound {GRAD_CPU_REL_BOUND}; "
          f"both steps {cpu_s:.1f}s; both embed the steps with the host table of timescales, from which the "
          f"card's own f32 pow differs on {out['card_pow_differs']} of 64)")
    if not (out["resume_rel_l2"] <= RESUME_REL_BOUND and out["resume_loss_rel"] <= RESUME_REL_BOUND):
        raise AssertionError(f"path v: resumed run off the unbroken one: {out}")
    if not (errs[worst] <= GRAD_CPU_REL_BOUND and out["loss_cpu_rel"] <= GRAD_CPU_REL_BOUND):
        raise AssertionError(f"path v: card vs CPU gradients {errs[worst]} at {worst}, loss {out['loss_cpu_rel']}")
    trained = {"enc": dict(whole.ema["enc"]), "den": dict(whole.ema["den"])}
    return out, {"trained": trained, "untrained": untrained, "whisper": whisper, "wav": manifest[0][0],
                 "batch": batches[0]}


def gan_batch(cfg, device) -> dict:
    """Path w's batch: B = 2 segments of GAN_FRAMES frames of the synthetic
    clip and their log-mels."""
    import numpy as np
    import torch

    from svc_inference_pipeline_tpu_torch.measure import synth_clip as clip
    from svc_inference_pipeline_tpu_torch.ops.mel import mel_spectrogram

    n = GAN_FRAMES * cfg.hop_length
    audio = clip(cfg.fs, CLIP_SECONDS)
    wave = torch.as_tensor(np.stack([audio[:n], audio[cfg.fs: cfg.fs + n]]), device=device)
    mel = mel_spectrogram(wave, cfg.n_fft, cfg.n_mels, cfg.fs, cfg.hop_length, cfg.win_length, cfg.fmin,
                          cfg.fmax).transpose(1, 2)
    return {"mel": mel, "wave": wave}


def gan_training_path(cfg, counters, paths, device) -> dict:
    """Path w: the GAN steps at the vocoder's full width (1536, six stages,
    MPD periods [2, 3, 5, 7, 11], the three MRD resolutions) on B = 2
    segments of GAN_FRAMES frames of the synthetic clip and their log-mels:
    GAN_STEPS discriminator and generator step pairs; every loss finite,
    every generator parameter a non-zero gradient (the training route,
    ``use_kernels=False``: no kernel launches)."""
    import numpy as np
    import torch

    from svc_inference_pipeline_tpu_torch.training.gan import init_gan_train_state, make_gan_train_steps

    n = GAN_FRAMES * cfg.hop_length
    batch = gan_batch(cfg, device)
    state, gopt, dopt = init_gan_train_state(cfg, torch.Generator(device=device).manual_seed(9), device=device)
    disc_step, gen_step = make_gan_train_steps(cfg, gopt, dopt)
    times, losses = {"disc": [], "gen": []}, []

    def run():
        nonlocal state
        torch.cuda.reset_peak_memory_stats()
        for _ in range(GAN_STEPS):
            t0 = time.perf_counter()
            state, d_loss = disc_step(state, batch)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            state, g_loss, aux = gen_step(state, batch)
            torch.cuda.synchronize()
            times["disc"].append(t1 - t0)
            times["gen"].append(time.perf_counter() - t1)
            losses.append({"disc": float(d_loss), "gen": float(g_loss), **{k: float(v) for k, v in aux.items()}})
        return {"ms_per_disc_step": 1e3 * statistics.median(times["disc"][1:]),
                "ms_per_gen_step": 1e3 * statistics.median(times["gen"][1:]),
                "ms_per_step": 1e3 * statistics.median([a + b for a, b in zip(times["disc"][1:], times["gen"][1:])]),
                "peak_gb": peak_gb()}

    drive("train gan", counters, run, {}, paths)
    n_params = sum(1 for _ in state.generator.parameters())
    nonfinite = [name for name, p in state.generator.named_parameters()
                 if p.grad is not None and not bool(torch.isfinite(p.grad).all())]
    dead = [name for name, p in state.generator.named_parameters()
            if p.grad is None or not bool(p.grad.abs().max() > 0)]
    finite = all(np.isfinite(v) for row in losses for v in row.values())
    with torch.no_grad():  # tanh saturated to exactly +-1 makes exactly zero MRD bins: NaN gradients
        y_hat = state.generator(batch["mel"])
    out = {k: paths[-1][k] for k in ("ms_per_disc_step", "ms_per_gen_step", "ms_per_step", "peak_gb")}
    out.update(losses=losses, generator_params=n_params, zero_grad_params=len(dead),
               nonfinite_grad_params=len(nonfinite), saturated_share=float((y_hat.abs() == 1).float().mean()),
               max_abs_out=float(y_hat.abs().max()))
    print(f"path w ({card_line()}): {GAN_STEPS} step pairs at B=2, {n} samples, "
          f"{cfg.vocoder.upsample_initial_channel} wide: discriminator step "
          f"{out['ms_per_disc_step']:.2f} ms, generator step {out['ms_per_gen_step']:.2f} ms (warm medians), "
          f"peak {out['peak_gb']:.2f} GB; losses {losses[-1]}; {n_params - len(dead)} of {n_params} generator "
          f"parameters with a non-zero gradient, {len(nonfinite)} with a non-finite one; output after the "
          f"steps max |y| {out['max_abs_out']:.4f}, share at exactly +-1 {out['saturated_share']:.4f}")
    if not finite or dead:
        raise AssertionError(f"path w: losses finite {finite}, parameters without a gradient {dead[:5]} "
                             f"({len(nonfinite)} non-finite)")
    return out


def train_then_serve_path(cfg, counters, paths, device, held: dict) -> dict:
    """Path x: a fresh ``SVCPipeline`` from path v's EMA encoder and
    denoiser (its kernel stacks made from them) converts the 4 s clip with
    PLMS@10 (K5 x 101, K4 x 24, K2 x 6, K3 x 1); its final mel must differ
    from the same conversion's on the untrained weights."""
    import numpy as np
    import torch

    from svc_inference_pipeline_tpu_torch.models.diffsvc import DiffSVCDenoiser
    from svc_inference_pipeline_tpu_torch.models.encoder import ConditionEncoder
    from svc_inference_pipeline_tpu_torch.ops.pallas.denoiser_step import make_denoise_fn
    from svc_inference_pipeline_tpu_torch.pipeline.convert import SVCPipeline, mel_frame_count

    steps = int(cfg.mapper.noise_schedule_factors[2])
    voc = random_vocoder(cfg.vocoder, torch.Generator(device=device).manual_seed(10), device)

    def build(weights):
        with torch.device(device):
            enc, den = ConditionEncoder(cfg.mapper), DiffSVCDenoiser(cfg.mapper, compute_dtype=torch.bfloat16)
        enc.load_state_dict(weights["enc"])
        den.load_state_dict(weights["den"])
        return SVCPipeline(cfg, enc, den, voc, held["whisper"], device)

    def final_mel(pipe):
        with torch.no_grad():
            batch, n_frames = pipe.extract_features(held["wav"], SINGER)
            cond = pipe.cond_encoder(batch)
            fn = make_denoise_fn(pipe.denoiser, cond, steps, pipe.compute_dtype, None, 0, pipe._stacks)
            x = pipe._run_sampler(fn, cond, (1, cond.shape[1], cfg.mapper.n_mel), "plms", 10,
                                  torch.Generator(device=device).manual_seed(0), None)
        return x[0, :n_frames].float().cpu().numpy()

    t0 = time.perf_counter()
    pipe = build(held["trained"])
    build_s = time.perf_counter() - t0
    n_expected = mel_frame_count(cfg, int(CLIP_SECONDS * cfg.fs)) * cfg.hop_length

    def run():
        torch.cuda.reset_peak_memory_stats()
        audio = pipe.convert(held["wav"], SINGER, generator=torch.Generator(device=device).manual_seed(0),
                             sampler="plms", speedup=10)
        check_audio("train then serve", audio, n_expected)
        return {**pipe.timings, "peak_gb": peak_gb()}

    drive("train then serve plms@10", counters, run,
          {"K5 bf16": steps // 10 + 1, "K4": 24, "K2": 6, "K3": 1, "K9": 3}, paths)
    trained, untrained = final_mel(pipe), final_mel(build(held["untrained"]))
    out = {"build_s": build_s, "conversion_s": paths[-1]["total_s"], "peak_gb": paths[-1]["peak_gb"],
           "mel_max_abs_diff": float(np.abs(trained - untrained).max()), "mel_max": float(np.abs(untrained).max())}
    print(f"path x ({card_line()}): pipeline from the trained EMA built in {build_s:.2f}s, PLMS@10 conversion "
          f"{out['conversion_s']:.3f}s, peak {out['peak_gb']:.2f} GB; final mel vs untrained weights max |d| "
          f"{out['mel_max_abs_diff']:.3e} (max|mel| {out['mel_max']:.3f})")
    if not (np.isfinite(trained).all() and out["mel_max_abs_diff"] > 0):
        raise AssertionError(f"path x: trained mel finite {bool(np.isfinite(trained).all())}, {out}")
    return out


def training_paths(cfg, counters, paths, device) -> tuple:
    """Paths v-x (the module docstring, step 4); returns their numbers and
    path v's first batch (the train step on a mesh takes it)."""
    with tempfile.TemporaryDirectory() as tmp:
        diffusion, held = diffusion_training_path(cfg, counters, paths, device, tmp)
        out = {"train_diffusion": diffusion, "train_gan": gan_training_path(cfg, counters, paths, device)}
        out["train_then_serve"] = train_then_serve_path(cfg, counters, paths, device, held)
    return out, held["batch"]


# ---------------------------------------------------------------------------
# Paths p and q: transcription
# ---------------------------------------------------------------------------

# path q: the text decoder's log-probs of a forced token sequence from the
# encoder's K4 route (bf16 weights and activations) against its plain route
# (f32), on the card: measured 1.1e-2 on an H100 (features 8.9e-2 apart,
# log-probs -12.5..-8.9); the bound is 2.7x that
LOGPROB_BF16_BOUND = 0.03


def step_stats(decoder) -> dict:
    """Tokens decoded, decoder steps, the median ms of a token position that
    ran a step (host filters and choice + the step with its logits' copy) and
    the host's share of those positions' time, from ``step_log``."""
    ran = [(h, c) for h, c in decoder.step_log if c > 0]
    host = sum(h for h, _ in ran)
    total = host + sum(c for _, c in ran)
    return {"tokens": len(decoder.step_log), "steps": len(ran), "primes": decoder.primes,
            "ms_per_step": 1e3 * statistics.median(h + c for h, c in ran),
            "ms_per_call": 1e3 * statistics.median(c for _, c in ran), "host_share": host / total}


def check_transcripts(out_dir: str, name: str) -> int:
    """The .txt/.vtt/.srt of one input exist and are well formed; returns
    the segment count of the .srt."""
    base = os.path.join(out_dir, name)
    with open(base + ".vtt", encoding="utf-8") as f:
        vtt = f.read()
    with open(base + ".srt", encoding="utf-8") as f:
        srt = f.read()
    with open(base + ".txt", encoding="utf-8") as f:
        txt = f.read()
    n = srt.count(" --> ")
    if not vtt.startswith("WEBVTT") or vtt.count(" --> ") != n or len(txt.splitlines()) != n:
        raise AssertionError(f"{name}: transcripts disagree ({n} srt segments)")
    return n


def transcribe_paths(counters, paths, device) -> dict:
    """Path p: the transcription CLI on the synthetic 4 s clip at
    Whisper-medium's full width with random weights (K4 x 24 a window)."""
    from svc_inference_pipeline_tpu_torch import transcribe

    with tempfile.TemporaryDirectory() as tmp:
        wav = os.path.join(tmp, "clip.wav")
        synth_clip(wav, 16000, CLIP_SECONDS)
        built, expected = {}, {}

        def run():
            t0 = time.perf_counter()
            rc = transcribe.main([wav, "--model", WHISPER_SIZE, "--random-weights", "--device", device.type,
                                  "--output_format", "all", "-o", tmp], built=built)
            if rc != 0:
                raise AssertionError(f"transcribe.main returned {rc}")
            expected["K4"] = 24 * built["decoder"].windows
            return {"call_s": time.perf_counter() - t0}

        drive("transcribe medium random weights", counters, run, expected, paths)
        segments = check_transcripts(tmp, "clip.wav")
        dec = built["decoder"]
        if "transformers" in sys.modules:
            raise AssertionError("transcribe imported transformers")
        stats = dict(step_stats(dec), segments=segments, windows=dec.windows, call_s=paths[-1]["call_s"])
        print(f"path p ({card_line()}): {dec.windows} window(s), {stats['tokens']} tokens decoded, "
              f"{stats['steps']} decoder steps + {stats['primes']} primes, {stats['ms_per_step']:.2f} ms a step "
              f"(median; the step call alone {stats['ms_per_call']:.2f} ms), host share "
              f"{stats['host_share']:.3f}, {segments} segments, whole call {stats['call_s']:.2f}s")
    return stats


def transcribe_file_path(counters, paths, device, whisper_path: str, ckpt: dict, enc, tmp: str) -> dict:
    """Path q: the transcription CLI from path n's Whisper file (decoder cut
    to 2 layers), no temperature fallback (K4 x 24 a window); then the loaded weights
    against the file's, prime + steps against the full prefix on the card,
    and the log-probs of a forced token sequence from the K4 route's bf16
    features against the plain route's f32 features."""
    from unittest import mock

    import numpy as np
    import torch

    from svc_inference_pipeline_tpu_torch import transcribe
    from svc_inference_pipeline_tpu_torch.checkpoints.from_jax import load_jax_params, unstack_blocks
    from svc_inference_pipeline_tpu_torch.checkpoints.torch_convert import load_whisper
    from svc_inference_pipeline_tpu_torch.measure import synth_clip as clip
    from svc_inference_pipeline_tpu_torch.models.whisper import WhisperAudioEncoder, WhisperDims
    from svc_inference_pipeline_tpu_torch.models.whisper_decoding import get_tokenizer
    from svc_inference_pipeline_tpu_torch.ops.pallas import attention
    from svc_inference_pipeline_tpu_torch.ops.whisper_mel import N_FRAMES, log_mel_spectrogram_frames, pad_or_trim

    wav = os.path.join(tmp, "clip16k.wav")
    synth_clip(wav, 16000, CLIP_SECONDS)
    out_dir = os.path.join(tmp, "transcripts")
    built, expected = {}, {}

    def run():
        t0 = time.perf_counter()
        rc = transcribe.main([wav, "--model", whisper_path, "--device", device.type, "--logprob_threshold=-inf",
                              "--compression_ratio_threshold", "inf", "-o", out_dir], built=built)
        if rc != 0:
            raise AssertionError(f"transcribe.main returned {rc}")
        expected["K4"] = 24 * built["decoder"].windows
        return {"call_s": time.perf_counter() - t0}

    drive("transcribe from path n's whisper file", counters, run, expected, paths)
    segments = check_transcripts(out_dir, "clip16k.wav")
    dec = built["decoder"]
    stats = dict(step_stats(dec), segments=segments, windows=dec.windows, call_s=paths[-1]["call_s"])

    # the loaded weights: the encoder equals the drawn one rounded to bf16,
    # every decoder parameter the file's tensor
    sd = ckpt["model_state_dict"]
    want = {}
    for key, t in sd.items():
        if key.startswith("decoder."):
            name = key[len("decoder."):].replace("blocks.", "block_", 1).replace("mlp.0", "mlp_0").replace(
                "mlp.2", "mlp_2")
            want[name] = t
    got = dict(dec.decoder.named_parameters())
    bad = [n for n, p in got.items() if n not in want or not torch.equal(p.detach().cpu(), want[n].float())]
    bad += param_mismatches(dec.encoder, enc)
    if bad or len(got) != len(want):
        raise AssertionError(f"path q: loaded parameters differ from the file's: {bad[:5]}, {len(got)} vs {len(want)}")

    # prime + one-token steps against the full prefix, on the card
    tok = get_tokenizer(True)
    forced = tok.sot_sequence("en") + tok.encode(" hello singing world, once again") + [
        tok.timestamp_begin + 10, tok.timestamp_begin + 60, 50, 500, 5000, tok.eot]
    tokens = np.asarray([forced], np.int32)
    audio16 = clip(16000, CLIP_SECONDS)
    mel = pad_or_trim(log_mel_spectrogram_frames(audio16, device), N_FRAMES)[None]
    with torch.no_grad():
        feats_bf16 = dec.embed_audio(mel)
        full, _ = dec.decoder(torch.as_tensor(tokens, dtype=torch.long, device=device), feats_bf16)
        full = full.cpu().numpy()
        logits, cache, offset = dec.incremental.prime(tokens[:, :3], feats_bf16)
        inc_err = float(np.abs(logits - full[:, :3]).max())
        for i in range(3, tokens.shape[1]):
            step, cache = dec.incremental.step(tokens[:, i: i + 1], feats_bf16, cache, offset)
            offset += 1
            inc_err = max(inc_err, float(np.abs(step - full[:, i]).max()))

        # the plain route: the encoder in f32 from the file, its attention the
        # plain version
        dims_dict, params = load_whisper(whisper_path)
        dims = WhisperDims(**dims_dict)
        with torch.device(device):
            enc32 = WhisperAudioEncoder(dims)
        load_jax_params(enc32, unstack_blocks(params["encoder"], dims.n_audio_layer))
        with mock.patch.object(attention, "encoder_attention", attention.encoder_attention_plain):
            feats_f32 = enc32.eval()(torch.as_tensor(mel, device=device))
        lp = {}
        for name, feats in (("bf16", feats_bf16), ("f32", feats_f32)):
            out, _ = dec.decoder(torch.as_tensor(tokens, dtype=torch.long, device=device), feats)
            logp = torch.log_softmax(out[0, :-1].double(), dim=-1)
            lp[name] = logp.gather(1, torch.as_tensor(tokens[0, 1:], device=device).long()[:, None])[:, 0].cpu().numpy()
    feat_err = float((feats_bf16 - feats_f32).abs().max())
    lp_err = float(np.abs(lp["bf16"] - lp["f32"]).max())
    print(f"path q ({card_line()}): {dec.windows} window(s), {stats['tokens']} tokens, {stats['steps']} steps, {stats['ms_per_step']:.2f} ms a "
          f"step (median), host share {stats['host_share']:.3f}, {segments} segments, whole call "
          f"{stats['call_s']:.2f}s; {len(got)} decoder parameters equal the file's; prime + steps vs full prefix "
          f"max |d logit| {inc_err:.3e} (bound 2e-4); K4 (bf16) vs plain (f32) features max |d| {feat_err:.3e}, "
          f"log-probs of {len(forced) - 1} forced tokens max |d| {lp_err:.3e} (bound {LOGPROB_BF16_BOUND}), "
          f"log-prob range {lp['f32'].min():.3f}..{lp['f32'].max():.3f}")
    if not inc_err <= 2e-4 or not lp_err <= LOGPROB_BF16_BOUND:
        raise AssertionError(f"path q: incremental vs full {inc_err}, bf16 vs f32 log-probs {lp_err}")
    return dict(stats, incremental_max_abs=inc_err, feature_bf16_max_abs=feat_err, logprob_bf16_max_abs=lp_err)


# ---------------------------------------------------------------------------
# multi-rank paths (y-ab and the train step on a mesh): the machine has one
# card and NCCL refuses two ranks on one GPU, so these run 2 ranks on cuda:0
# over gloo, each computing on the card with its kernels
# ---------------------------------------------------------------------------

GLOO_OPS = ("all_reduce", "broadcast", "all_gather", "all_gather_into_tensor", "batch_isend_irecv")


def _gloo_probe_rank(rank: int, world: int, ops: tuple, out_dir: str) -> None:
    """Each collective in ``ops`` on a CUDA tensor over gloo, in order; rank
    0 writes "ok" (a correct result), "wrong result" or the refusal's first
    line to ``out_dir/<op>`` before the next. gloo may abort the process on
    a device pointer it cannot take: the op left without a file is that one."""
    import torch
    import torch.distributed as dist

    dev = torch.device("cuda", torch.cuda.current_device())
    x = torch.full((8,), float(rank + 1), device=dev)

    def all_reduce():
        y = x.clone()
        dist.all_reduce(y)
        return bool((y == sum(range(1, world + 1))).all())

    def broadcast():
        y = x.clone()
        dist.broadcast(y, 0)
        return bool((y == 1).all())

    def all_gather():
        out = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(out, x)
        return all(bool((o == r + 1).all()) for r, o in enumerate(out))

    def all_gather_into_tensor():
        out = torch.empty(world * 8, device=dev)
        dist.all_gather_into_tensor(out, x)
        return bool((out.view(world, 8) == torch.arange(1, world + 1, device=dev)[:, None]).all())

    def batch_isend_irecv():
        got = torch.empty_like(x)
        ops_ = [dist.P2POp(dist.isend, x, (rank + 1) % world), dist.P2POp(dist.irecv, got, (rank - 1) % world)]
        for w in dist.batch_isend_irecv(ops_):
            w.wait()
        torch.cuda.synchronize()
        return bool((got == (rank - 1) % world + 1).all())

    fns = {f.__name__: f for f in (all_reduce, broadcast, all_gather, all_gather_into_tensor, batch_isend_irecv)}
    for name in ops:
        try:
            res = "ok" if fns[name]() else "wrong result"
        except Exception as e:  # the refusal is the probe's result
            res = f"refused: {str(e).strip().splitlines()[0][:160]}"
        if rank == 0:
            with open(os.path.join(out_dir, name), "w") as f:
                f.write(res)
        dist.barrier()


def gloo_cuda_probe() -> dict:
    """Which of the port's collectives gloo takes on CUDA tensors (2 ranks on
    cuda:0): {op: "ok" | "wrong result" | "refused: ..."}. An op that aborts
    its processes is "refused" with that, and the probe goes on with the
    ops after it in new processes."""
    from svc_inference_pipeline_tpu_torch.parallel.distributed import spawn

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        while len(out) < len(GLOO_OPS):
            rest = tuple(op for op in GLOO_OPS if op not in out)
            try:
                spawn(_gloo_probe_rank, 2, args=(rest, tmp), backend="gloo", device="cuda:0", timeout=30,
                      join_timeout=90)
                aborted = None
            except (RuntimeError, TimeoutError) as e:
                aborted = str(e).strip().splitlines()[-1][:160]
            for op in rest:
                path = os.path.join(tmp, op)
                if os.path.exists(path):
                    with open(path) as f:
                        out[op] = f.read()
                else:
                    out[op] = f"refused: the ranks aborted ({aborted})"
                    break
    return out


MESH_RANKS = 2  # ranks of the multi-rank paths, all on cuda:0 over gloo
DP_CLIPS = 4  # path y: two clips a data rank
TP_MIN_MEL_CORR = 0.999  # path z: final mel, TP (bf16) vs one device (bf16)
WAVE_MIN_SNR_DB, WAVE_MIN_CORR = 12.0, 0.97  # paths z and aa: the bf16 bounds of tests/test_bf16_drift.py:71-72
PP_MIN_MEL_CORR = 0.9999  # path ab: the GPipe final mel (f32) vs one device (f32)
TRAIN_MESH_REL_BOUND = 1e-5  # the train step on a mesh vs one rank: loss and parameters, relative L2
# path ac: the GAN step pair on a mesh vs one rank's, losses, gradients and
# parameters, relative L2; or, if larger, the distance between two
# single-rank runs measured beside it: a repeat (cuDNN's backward need not
# repeat its sums bit for bit) and a run whose input mel is moved by one f32
# ulp, the gradients' sensitivity to a rounding-level change of the
# activations, which the model axis makes in every conv by summing its
# input channels in two halves (the losses' kinks, |.| of the L1 terms and
# the discriminators' leaky ReLUs, turn such a change into whole gradient
# terms). As in tests/test_torch_gan.py, parameters whose
# single-rank gradient is below GAN_SMALL_GRAD are held apart: AdamW's first
# step, lr g / (|g| + eps), turns the rounding of a near-zero gradient into
# a step of up to lr either way, so they are held to 2 lr each
GAN_MESH_REL_BOUND = 1e-5
GAN_SMALL_GRAD = 1e-6
PP_GRAD_REL_BOUND = 1e-4  # path ad: the 2-stage GPipe's gradients vs one device's autograd, relative L2 per leaf
PP_GRAD_FRAMES = 256  # path ad: B = 4 clips of 256 frames in 2 microbatches


def _host64(x):
    """A tensor (on any device) or array as a flat float64 numpy array."""
    import numpy as np

    if hasattr(x, "detach"):
        x = x.detach().double().cpu().numpy()
    return np.ravel(np.asarray(x, np.float64))


def snr_db(ref, got) -> float:
    import numpy as np

    ref, got = _host64(ref), _host64(got)
    return float(10 * np.log10((ref ** 2).sum() / max(((ref - got) ** 2).sum(), 1e-30)))


def correlation(a, b) -> float:
    import numpy as np

    return float(np.corrcoef(_host64(a), _host64(b))[0, 1])


def _timed(counters, fn):
    """(result, wall seconds, launch counts) of fn() with the counters set to 0 just before."""
    import torch

    counters.reset()
    t0 = time.perf_counter()
    out = fn()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0, counters.read()


def _gan_mesh_phase(world: int, cfg, device, counters) -> dict:
    """Path ac on this rank: one discriminator and generator step pair of
    path w's full-width GAN on path w's batch at data 2, then at model 2
    (the generator's channels split), from the same state as one rank's
    pair, run twice beside it: the losses and the parameters (the
    generator's gathered) against the single-rank pair's, relative L2."""
    import torch

    from svc_inference_pipeline_tpu_torch.parallel.mesh import MODEL_AXIS, axis_group, make_mesh
    from svc_inference_pipeline_tpu_torch.parallel.sharding import unshard
    from svc_inference_pipeline_tpu_torch.training import gan

    batch = gan_batch(cfg, device)

    def pair(mesh, data=batch):
        state, gopt, dopt = gan.init_gan_train_state(cfg, torch.Generator(device=device).manual_seed(9), device=device)
        disc_step, gen_step = gan.make_gan_train_steps(cfg, gopt, dopt, mesh=mesh)
        if mesh is not None:
            state = disc_step.shard_state(state)
        with torch.no_grad():  # the generator's output before the steps, the whole batch on every rank
            y_hat = state.generator(data["mel"], axis_group(mesh, MODEL_AXIS)).double()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, d_loss = disc_step(state, data)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, g_loss, aux = gen_step(state, data)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        dead = [n for n, p in state.generator.named_parameters() if p.grad is None or not bool(p.grad.abs().max() > 0)]
        group, specs = axis_group(mesh, MODEL_AXIS), gan.generator_specs(state)
        gen_params = (gan.gathered_generator(state, mesh)["params"] if mesh is not None
                      else {n: p.detach() for n, p in state.generator.named_parameters()})
        params = {f"generator.{n}": v.clone() for n, v in gen_params.items()}
        grads = {f"generator.{n}": (p.grad if specs[n] is None or group is None
                                    else unshard(p.grad, specs[n], group)).clone()
                 for n, p in state.generator.named_parameters()}
        for k in ("mpd", "mrd"):  # the discriminator step's gradients
            for n, p in getattr(state, k).named_parameters():
                params[f"{k}.{n}"], grads[f"{k}.{n}"] = p.detach().clone(), p.grad.clone()
        return {"losses": torch.stack([d_loss, g_loss, *aux.values()]).double().cpu(), "params": params,
                "grads": grads, "y_hat": y_hat, "disc_ms": 1e3 * (t1 - t0), "gen_ms": 1e3 * (t2 - t1), "dead": dead,
                "local_rows": state.generator.conv_pre.conv.weight.shape[0]}

    def distance(a, b) -> dict:
        """Relative L2 of the losses, the gradients, the parameters, and the
        parameters whose gradient in b is at least GAN_SMALL_GRAD; the largest
        change of the others, and their share."""
        sums = dict.fromkeys(("g_num", "g_den", "p_num", "p_den", "l_num", "l_den", "n_small", "n"), 0.0)
        small_max, worst = 0.0, ("", 0.0)
        for k, p in b["params"].items():
            g = b["grads"][k].double()
            dp = (a["params"][k].double() - p.double()) ** 2
            small = g.abs() < GAN_SMALL_GRAD
            dg = float(((a["grads"][k].double() - g) ** 2).sum())
            worst = max(worst, (k, math.sqrt(dg / max(float((g ** 2).sum()), 1e-300))), key=lambda w: w[1])
            sums["g_num"] += dg
            sums["g_den"] += float((g ** 2).sum())
            sums["p_num"] += float(dp.sum())
            sums["p_den"] += float((p.double() ** 2).sum())
            sums["l_num"] += float(dp[~small].sum())
            sums["l_den"] += float((p.double()[~small] ** 2).sum())
            sums["n_small"] += float(small.sum())
            sums["n"] += small.numel()
            if bool(small.any()):
                small_max = max(small_max, float(dp[small].max().sqrt()))
        return {"loss_rel": float((a["losses"] - b["losses"]).norm() / b["losses"].norm()),
                "y_hat_rel_l2": float((a["y_hat"] - b["y_hat"]).norm() / b["y_hat"].norm()),
                "grads_rel_l2": math.sqrt(sums["g_num"] / sums["g_den"]),
                "params_rel_l2": math.sqrt(sums["p_num"] / sums["p_den"]),
                "params_rel_l2_large_grad": math.sqrt(sums["l_num"] / sums["l_den"]),
                "small_grad_max_abs": small_max, "small_grad_share": sums["n_small"] / sums["n"],
                "worst_grad_leaf": worst[0], "worst_grad_leaf_rel_l2": worst[1]}

    ref = pair(None)
    again = pair(None)
    repeat = distance(again, ref)
    nudged = distance(pair(None, dict(batch, mel=batch["mel"] * (1 + 2.0 ** -23))), ref)
    del again
    out = {}
    for data, model in ((world, 1), (1, world)):
        got, wall, counts = _timed(counters, lambda: pair(make_mesh(data=data, model=model)))
        out[f"ac gan data {data} model {model}"] = {
            "launches": counts, "wall_s": wall, **distance(got, ref), **{f"repeat_{k}": v for k, v in repeat.items()},
            **{f"ulp_{k}": v for k, v in nudged.items()},
            "finite": bool(torch.isfinite(got["losses"]).all()), "zero_grad_params": got["dead"][:5],
            "n_zero_grad_params": len(got["dead"]), "local_rows": got["local_rows"],
            "ms_disc_step": got["disc_ms"], "ms_gen_step": got["gen_ms"],
            "single_ms_disc_step": ref["disc_ms"], "single_ms_gen_step": ref["gen_ms"]}
    return out


def _pp_grad_phase(world: int, cfg, device, counters) -> dict:
    """Path ad on this rank: the gradients of mean(eps^2) through the
    full-width denoiser as a ``world``-stage GPipe over gloo (the ring's
    carries sent as host copies), summed over the pipe group, against the
    denoiser's own forward and autograd on one device, f32, relative L2 per
    leaf; each rank's own backward must reach exactly its stage's layers."""
    import torch
    import torch.distributed as dist

    from svc_inference_pipeline_tpu_torch.checkpoints.from_jax import random_init_
    from svc_inference_pipeline_tpu_torch.models.diffsvc import DiffSVCDenoiser
    from svc_inference_pipeline_tpu_torch.parallel.mesh import PIPE_AXIS, mesh_over
    from svc_inference_pipeline_tpu_torch.parallel.pp import pp_denoise_fn

    g = torch.Generator(device=device).manual_seed(7)
    with torch.device(device):
        den = DiffSVCDenoiser(cfg.mapper)
    random_init_(den, g)
    randomize_vectors_(den, g)
    steps = int(cfg.mapper.noise_schedule_factors[2])
    x = torch.randn((4, PP_GRAD_FRAMES, cfg.mapper.n_mel), generator=g, device=device)
    cond = 0.3 * torch.randn((4, PP_GRAD_FRAMES, cfg.mapper.conditioner_size), generator=g, device=device)
    t = torch.tensor([137, 137, 642, 642], device=device)

    def grads():
        out = [p.grad if p.grad is not None else torch.zeros_like(p) for p in den.parameters()]
        den.zero_grad(set_to_none=True)
        return out

    t0 = time.perf_counter()
    eps = torch.cat([den(x[i:i + 2], cond[i:i + 2], t[i:i + 2, None]) for i in (0, 2)])
    single_loss = (eps ** 2).mean()
    single_loss.backward()
    torch.cuda.synchronize()
    single_s = time.perf_counter() - t0
    ref = grads()
    mesh = mesh_over(range(world), (world,), (PIPE_AXIS,))

    def run():
        eps = pp_denoise_fn(den, cond, t, x, mesh, cfg.mapper, steps, n_micro=2)
        loss = (eps ** 2).mean()
        loss.backward()
        return loss

    loss, wall, counts = _timed(counters, run)
    got = grads()
    names = [n for n, _ in den.named_parameters()]
    own = sorted({n.split(".")[0] for n, v in zip(names, got) if n.startswith("residual_") and bool(v.abs().max() > 0)},
                 key=lambda n: int(n.split("_")[1]))
    flat = torch.cat([v.reshape(-1) for v in got])
    dist.all_reduce(flat, group=mesh.get_group(PIPE_AXIS))
    got = [v.view_as(r) for v, r in zip(flat.split([r.numel() for r in ref]), ref)]
    errs = {n: rel_l2(v, r) for n, v, r in zip(names, got, ref)}
    worst = max(errs, key=errs.get)
    per = cfg.mapper.residual_layer_num // world
    rank = dist.get_rank(mesh.get_group(PIPE_AXIS))
    return {"ad pp backward": {
        "launches": counts, "wall_s": wall, "single_s": single_s, "grad_rel_l2": errs[worst], "worst_leaf": worst,
        "loss_rel": abs(float(loss) - float(single_loss)) / abs(float(single_loss)),
        "own_layers_ok": own == [f"residual_{i}" for i in range(rank * per, (rank + 1) * per)],
        "finite": all(bool(torch.isfinite(v).all()) for v in got)}}


def _mesh_rank(rank: int, world: int, cfg, wavs: list, singers: list, batch: dict) -> dict:
    """Paths y, z, SP of ab and the train step on a mesh, on this rank (2
    ranks on cuda:0 over gloo, each computing on the card with its kernels).
    Returns each phase's launches, wall time and numbers; the checks run in
    the parent."""
    import numpy as np
    import torch

    from svc_inference_pipeline_tpu_torch.ops.whisper_mel import N_SAMPLES, log_mel_spectrogram
    from svc_inference_pipeline_tpu_torch.ops.resample import resample_host
    from svc_inference_pipeline_tpu_torch.parallel.mesh import make_mesh
    from svc_inference_pipeline_tpu_torch.parallel.sp_whisper import encode_sequence_parallel
    from svc_inference_pipeline_tpu_torch.pipeline.convert import SVCPipeline

    from svc_inference_pipeline_tpu_torch.parallel.distributed import current_device

    device = current_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    counters = Counters()
    out = {}

    def build(mesh=None):
        return SVCPipeline.from_config(cfg, random_weights=True, whisper_size=WHISPER_SIZE, seed=0, device=device,
                                       mesh=mesh)

    # y: DP over a data axis of 2, against this rank's clips on one device
    dp, alone = build(make_mesh(data=world, model=1)), build()
    mine = np.array_split(np.arange(len(wavs)), world)[rank]
    for name, sampler, quantize in (("ddpm bf16", "ddpm", None), ("plms@10 int8-w1", "plms", "int8-w1")):
        dp.set_quantize(quantize)
        alone.set_quantize(quantize)
        gen = torch.Generator(device=device).manual_seed(0)
        waves, wall, counts = _timed(counters, lambda: dp.convert_batch(wavs, singers, generator=gen,
                                                                        sampler=sampler, speedup=10))
        ref = alone.convert_batch([wavs[i] for i in mine], [singers[i] for i in mine],
                                  generator=dp.rank_generator(gen), sampler=sampler, speedup=10)
        out[f"y {name}"] = {"launches": counts, "wall_s": wall, "timings": dict(dp.timings),
                            "bit_equal": all(np.array_equal(waves[i], r) for i, r in zip(mine, ref)),
                            "clips": [len(w) for w in waves], "finite": all(np.isfinite(w).all() for w in waves)}
    dp.set_quantize(None)
    alone.set_quantize(None)

    # z: TP over a model axis of 2 (K4 on 8 heads a rank, the vocoder in 2 chunks)
    tp = build(make_mesh(data=1, model=world))
    wave, wall, counts = _timed(counters, lambda: tp.convert(
        wavs[0], singers[0], generator=torch.Generator(device=device).manual_seed(0), sampler="plms", speedup=10))
    ref = alone.convert(wavs[0], singers[0], generator=torch.Generator(device=device).manual_seed(0),
                        sampler="plms", speedup=10)
    out["z tp plms@10"] = {"launches": counts, "wall_s": wall, "timings": dict(tp.timings),
                           "mel_corr": correlation(tp.last_mel, alone.last_mel), "wave_snr_db": snr_db(ref, wave),
                           "wave_corr": correlation(ref, wave), "chunks": tp._voc_chunks, "halo": tp._voc_halo,
                           "finite": bool(np.isfinite(wave).all())}
    del tp

    # ab, SP: one 30 s window through the sequence-parallel encoder, against the K4 encoder
    audio16 = resample_host(np.asarray(wavs[0]), cfg.fs, 16000)
    window = np.zeros((1, N_SAMPLES), np.float32)
    window[0, : len(audio16)] = audio16[:N_SAMPLES]
    wmel = log_mel_spectrogram(torch.from_numpy(window).to(device))
    sp_mesh = make_mesh(data=1, model=world)
    enc = alone.whisper.encoder
    with torch.no_grad():
        feats, wall, counts = _timed(counters, lambda: encode_sequence_parallel(
            enc, wmel, sp_mesh, compute_dtype=enc.conv1.weight.dtype))
        full = alone.whisper.embed_audio(wmel)
    out["ab sp whisper"] = {"launches": counts, "wall_s": wall,
                            "rel_l2": float((feats - full).norm() / full.norm()),
                            "max_abs": float((feats - full).abs().max()), "shape": tuple(feats.shape),
                            "finite": bool(torch.isfinite(feats).all())}
    del dp, alone

    # the train step on a mesh (data 2, then model 2) against one rank's step from the same state and draws
    from svc_inference_pipeline_tpu_torch.training.diffusion import (
        gathered_state_dict, init_diffusion_train_state, make_diffusion_train_step)

    draws = torch.Generator(device=device).manual_seed(3)
    t = torch.randint(0, int(cfg.mapper.noise_schedule_factors[2]), (TRAIN_CLIPS,), generator=draws, device=device)
    noise = torch.randn(batch["mel"].shape, generator=draws, device=device)
    ref_state, ref_opt = init_diffusion_train_state(cfg, torch.Generator(device=device).manual_seed(0), device=device)
    _, ref_loss = make_diffusion_train_step(cfg, ref_opt)(ref_state, batch, t=t, noise=noise)
    ref_sd = {f"{k}.{n}": p.detach() for k, m in ref_state.modules().items() for n, p in m.named_parameters()}
    for data, model in ((world, 1), (1, world)):
        mesh = make_mesh(data=data, model=model)
        state, opt = init_diffusion_train_state(cfg, torch.Generator(device=device).manual_seed(0), device=device)
        step = make_diffusion_train_step(cfg, opt, mesh=mesh)
        state = step.shard_state(state)
        (state, loss), wall, counts = _timed(counters, lambda: step(state, batch, t=t, noise=noise))
        sd = gathered_state_dict(state, mesh)
        got = {f"{k}.{n}": sd[k][n] for k in ("enc", "den") for n in sd[k]}
        num = sum(((got[k].double() - v.double()) ** 2).sum() for k, v in ref_sd.items())
        den = sum((v.double() ** 2).sum() for v in ref_sd.values())
        out[f"train mesh data {data} model {model}"] = {
            "launches": counts, "wall_s": wall, "loss_rel": abs(float(loss) - float(ref_loss)) / abs(float(ref_loss)),
            "params_rel_l2": float(torch.sqrt(num / den))}
    del ref_state, ref_opt, state, opt
    out.update(_gan_mesh_phase(world, cfg, device, counters))
    out.update(_pp_grad_phase(world, cfg, device, counters))
    return out


def _pp_rank(rank: int, world: int, cfg, wav) -> dict:
    """Path ab's GPipe route at world size 1 over NCCL (gloo refuses the
    ring's send/recv on CUDA tensors, and NCCL two ranks on one card): a
    PLMS@10 sampling of the clip's conditioning through make_pp_denoise_fn on
    a one-stage pipe axis, f32, against the composed denoiser in f32 on the
    same noise."""
    import torch

    from svc_inference_pipeline_tpu_torch.models.diffsvc import make_composed_denoise_fn
    from svc_inference_pipeline_tpu_torch.parallel.mesh import PIPE_AXIS, mesh_over
    from svc_inference_pipeline_tpu_torch.parallel.pp import make_pp_denoise_fn
    from svc_inference_pipeline_tpu_torch.parallel.distributed import current_device
    from svc_inference_pipeline_tpu_torch.pipeline.convert import SVCPipeline

    device = current_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pipe = SVCPipeline.from_config(cfg, random_weights=True, whisper_size=WHISPER_SIZE, seed=0, device=device)
    mesh = mesh_over([0], (1,), (PIPE_AXIS,))
    steps = pipe.schedule.num_steps
    with torch.no_grad():
        batch, n_frames = pipe.extract_features(wav, SINGER)
        cond = pipe.cond_encoder(batch)
        shape = (1, cond.shape[1], cfg.mapper.n_mel)
        mels = {}
        t0 = time.perf_counter()
        for name, fn in (("pp", make_pp_denoise_fn(pipe.denoiser, cond, steps, cfg.mapper, mesh)),
                         ("single", make_composed_denoise_fn(pipe.denoiser, cond, steps, torch.float32))):
            mels[name] = pipe._run_sampler(fn, cond, shape, "plms", 10, torch.Generator(device=device).manual_seed(0),
                                           None)[0, :n_frames]
            if device.type == "cuda":
                torch.cuda.synchronize()
            if name == "pp":
                wall = time.perf_counter() - t0
    return {"mel_corr": correlation(mels["pp"].cpu(), mels["single"].cpu()), "wall_s": wall,
            "backend": torch.distributed.get_backend(), "finite": bool(torch.isfinite(mels["pp"]).all())}


def chunked_vocoder_path(cfg, counters, paths, pipe) -> dict:
    """Path aa: the last conversion's mel (384 frames) through the vocoder in
    4 overlap-save chunks folded into the batch on one card (K2 x 6 and K3 x
    1 on the batch of 4), against the unchunked generator."""
    import torch

    from svc_inference_pipeline_tpu_torch.parallel.tp_vocoder import chunked_vocoder_apply, vocoder_receptive_radius

    mel = pipe.last_mel[:1]
    halo = vocoder_receptive_radius(cfg.vocoder)
    with torch.no_grad():
        whole = pipe.vocoder(mel)
        out = {}

        def run():
            out["wave"] = chunked_vocoder_apply(pipe.vocoder, mel, 4, halo, cfg.hop_length)
            return {}

        drive("aa chunked vocoder x4", counters, run, {"K2": 6, "K3": 1}, paths)
    a, b = whole.float().cpu().numpy(), out["wave"].float().cpu().numpy()
    res = {"snr_db": snr_db(a, b), "corr": correlation(a, b), "max_abs_err": float(abs(a - b).max()),
           "peak": float(abs(a).max()), "frames": int(mel.shape[1]), "halo": halo}
    print(f"path aa ({card_line()}): 4 chunks of {mel.shape[1] // 4} frames + halo {halo}: SNR "
          f"{res['snr_db']:.2f} dB, corr {res['corr']:.6f}, max abs err {res['max_abs_err']:.3e} (peak "
          f"{res['peak']:.3f}); bounds SNR >= {WAVE_MIN_SNR_DB} dB, corr >= {WAVE_MIN_CORR}")
    if not (res["snr_db"] >= WAVE_MIN_SNR_DB and res["corr"] >= WAVE_MIN_CORR):
        raise AssertionError(f"path aa: chunked vocoder off the whole call: {res}")
    return res


def mesh_paths(cfg, counters, paths, batch) -> dict:
    """Paths y, z and ab and the train step on a mesh (the module docstring,
    step 4): the gloo probe, one spawn of MESH_RANKS ranks on cuda:0 over
    gloo for y, z, SP and the train step, one rank over NCCL for PP; every
    check in the order of the docstring. Each rank's launches are added to
    the paths."""
    import numpy as np

    from svc_inference_pipeline_tpu_torch.measure import synth_clip as clip
    from svc_inference_pipeline_tpu_torch.parallel.distributed import spawn
    from svc_inference_pipeline_tpu_torch.training.gan import LR as GAN_LR

    t0 = time.perf_counter()
    probe = gloo_cuda_probe()
    print(f"gloo on CUDA tensors (2 ranks on cuda:0): {json.dumps(probe)} ({time.perf_counter() - t0:.1f}s)")
    if any(probe[op] != "ok" for op in ("all_reduce", "broadcast", "all_gather")):
        raise AssertionError(f"gloo refused a collective paths y, z and the SP encoder need: {probe}")
    base = clip(cfg.fs, CLIP_SECONDS)
    wavs = [(0.5 + 0.1 * i) * np.roll(base, 2400 * i) for i in range(DP_CLIPS)]
    singers = ["svcc_CDF1", "svcc_CDM1", "svcc_IDF1", "svcc_IDM1"][:DP_CLIPS]
    batch = {k: np.asarray(v) for k, v in batch.items()}
    t0 = time.perf_counter()
    ranks = spawn(_mesh_rank, MESH_RANKS, args=(cfg, wavs, singers, batch), backend="gloo", device="cuda:0",
                  timeout=120, join_timeout=600)
    mesh_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pp = spawn(_pp_rank, 1, args=(cfg, wavs[0]), backend="nccl", device="cuda:0", timeout=120, join_timeout=300)[0]
    pp_s = time.perf_counter() - t0
    steps = int(cfg.mapper.noise_schedule_factors[2])
    want = {"y ddpm bf16": {"K1 bf16": steps, "K4": 24, "K2": 6, "K3": 1, "K9": 3},
            "y plms@10 int8-w1": {"K5 int8-w1": steps // 10 + 1, "K4": 24, "K2": 6, "K3": 1, "K9": 3},
            "z tp plms@10": {"K4": 24, "K2": 6, "K3": 1, "K9": 3}, "ab sp whisper": {},
            f"train mesh data {MESH_RANKS} model 1": {}, f"train mesh data 1 model {MESH_RANKS}": {},
            f"ac gan data {MESH_RANKS} model 1": {}, f"ac gan data 1 model {MESH_RANKS}": {}, "ad pp backward": {}}
    card = card_line()
    print(f"multi-rank paths ({card}): one spawn of {MESH_RANKS} ranks {mesh_s:.1f}s, the PP rank {pp_s:.1f}s")
    failures = []
    for name, expected in want.items():
        for r, res in enumerate(ranks):
            got = res[name]
            counts = {k: n for k, n in got["launches"].items() if n}
            print(f"path {name} rank {r}: launches {counts}, wall {got['wall_s']:.3f}s, "
                  + ", ".join(f"{k} {v}" for k, v in got.items() if k not in ("launches", "wall_s", "timings")))
            if counts != expected:
                failures.append(f"{name} rank {r}: launches {counts} != {expected}")
            paths.append({"path": f"{name} rank {r}", "launches": got["launches"], "wall_s": got["wall_s"]})
            if name.startswith("y") and not (got["bit_equal"] and got["finite"]):
                failures.append(f"{name} rank {r}: the rank's waves differ from its clips converted alone")
            if name.startswith("z") and not (got["mel_corr"] >= TP_MIN_MEL_CORR and got["finite"] and
                                              got["wave_snr_db"] >= WAVE_MIN_SNR_DB and
                                              got["wave_corr"] >= WAVE_MIN_CORR and got["chunks"] == MESH_RANKS):
                failures.append(f"{name} rank {r}: {got}")
            if name.startswith("ab") and not (got["finite"] and got["max_abs"] <= CONTENT_BF16_BOUND):
                failures.append(f"{name} rank {r}: {got}")
            if name.startswith("train") and not (got["loss_rel"] <= TRAIN_MESH_REL_BOUND and
                                                 got["params_rel_l2"] <= TRAIN_MESH_REL_BOUND):
                failures.append(f"{name} rank {r}: {got}")
            if name.startswith("ac") and not (
                    got["finite"] and got["n_zero_grad_params"] == 0
                    and all(got[k] <= max(GAN_MESH_REL_BOUND, got[f"repeat_{k}"], got[f"ulp_{k}"])
                            for k in ("loss_rel", "grads_rel_l2", "params_rel_l2_large_grad"))
                    and got["small_grad_max_abs"] <= 2 * GAN_LR):
                failures.append(f"{name} rank {r}: {got}")
            if name.startswith("ad") and not (got["finite"] and got["own_layers_ok"]
                                              and got["grad_rel_l2"] <= PP_GRAD_REL_BOUND
                                              and got["loss_rel"] <= PP_GRAD_REL_BOUND):
                failures.append(f"{name} rank {r}: {got}")
    print(f"path ab pp (world size 1, {pp['backend']}): PLMS@10 final mel corr {pp['mel_corr']:.7f} with one "
          f"device f32 (bound {PP_MIN_MEL_CORR}), sampling {pp['wall_s']:.3f}s; the 2-stage ring ran in path ad, "
          f"over gloo")
    if not (pp["finite"] and pp["mel_corr"] >= PP_MIN_MEL_CORR):
        failures.append(f"path ab pp: {pp}")
    if failures:
        raise AssertionError("multi-rank paths: " + "; ".join(failures))
    return {"gloo_cuda": probe, "mesh_spawn_s": mesh_s, "pp_spawn_s": pp_s, "ranks": ranks, "pp": pp}


ELASTIC_STEPS, ELASTIC_CKPT_EVERY, ELASTIC_DIE_AT = 4, 2, 3  # path ae: the drill's steps, checkpoints, fault


def elastic_worker(argv: list) -> int:
    """One worker of path ae's gang (``chip_smoke.py --elastic-worker
    CKPT_DIR BATCH.npz``): joins the gang from the supervisor's
    environment over gloo on its card and runs ``train_diffusion`` on a
    data-2 mesh over the batch, resuming from CKPT_DIR."""
    import numpy as np
    import torch
    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    from svc_inference_pipeline_tpu_torch.config import load_config
    from svc_inference_pipeline_tpu_torch.parallel import distributed
    from svc_inference_pipeline_tpu_torch.parallel.mesh import make_mesh
    from svc_inference_pipeline_tpu_torch.training.loop import train_diffusion

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ckpt_dir, batch_path = argv
    if not distributed.ensure_initialized(backend="gloo"):
        raise RuntimeError("elastic worker: no gang in the environment")
    cfg = load_config(os.path.join(ROOT, "config", "config.json"))
    with np.load(batch_path) as f:
        batch = {k: f[k] for k in f.files}
    t0 = time.perf_counter()
    state = train_diffusion(cfg, [batch], ELASTIC_STEPS, checkpoint_dir=ckpt_dir, checkpoint_every=ELASTIC_CKPT_EVERY,
                            mesh=make_mesh(data=dist.get_world_size()), seed=4)
    print(f"ELASTIC_OK {dist.get_rank()} step {state.step} on {distributed.current_device()} "
          f"{time.perf_counter() - t0:.2f}s", flush=True)
    dist.destroy_process_group()
    return 0


def elastic_path(cfg, counters, paths, batch: dict) -> dict:
    """Path ae: the elastic supervisor over a real gang on the card.
    ``run_elastic`` launches 2 workers (:func:`elastic_worker`, both on
    cuda:0 over gloo) training on path v's batch on a data-2 mesh for
    ELASTIC_STEPS steps with a checkpoint every ELASTIC_CKPT_EVERY; worker
    1 dies at step ELASTIC_DIE_AT on attempt 0. Requires one restart, exit
    code 13 in attempt 0, both workers of attempt 1 resumed from the last
    checkpoint and exiting 0, and the final checkpoint within
    RESUME_REL_BOUND of an unbroken 2-worker run's."""
    import numpy as np
    import torch

    from svc_inference_pipeline_tpu_torch.checkpoints.native_io import load_checkpoint
    from svc_inference_pipeline_tpu_torch.training.elastic import run_elastic

    torch.cuda.empty_cache()  # the workers need the card's memory
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        batch_path = os.path.join(tmp, "batch.npz")
        np.savez(batch_path, **{k: np.asarray(v) for k, v in batch.items()})

        def gang(name, **kw):
            res[name] = run_elastic([sys.executable, os.path.join(ROOT, "chip_smoke.py"), "--elastic-worker",
                                     os.path.join(tmp, name), batch_path], num_workers=2,
                                    log_dir=os.path.join(tmp, f"logs_{name}"), grace_period=10.0, **kw)

        def run():
            gang("drill", max_restarts=1, extra_env={"SVC_FAULT_INJECT": f"die@{ELASTIC_DIE_AT}:p1:a0"})
            gang("whole", max_restarts=0)
            return {}

        try:
            drive("ae elastic drill", counters, run, {}, paths)
        except Exception as e:
            raise AssertionError(f"path ae: {e}\n{_logs(tmp)}") from e
        drill, whole = res["drill"], res["whole"]
        logs = {name: open(os.path.join(tmp, "logs_drill", name)).read()
                for name in ("worker0_a1.log", "worker1_a1.log")}
        resumed_at = ELASTIC_DIE_AT // ELASTIC_CKPT_EVERY * ELASTIC_CKPT_EVERY
        a, b = (load_checkpoint(os.path.join(tmp, name, "latest")) for name in ("drill", "whole"))
        keys = [(k, n) for k in ("enc", "den") for n in b[k]] + [("ema", k, n) for k in b["ema"] for n in b["ema"][k]]

        def get(ckpt, key):
            for part in key:
                ckpt = ckpt[part]
            return torch.as_tensor(ckpt).double()

        num = sum(((get(a, k) - get(b, k)) ** 2).sum() for k in keys)
        den = sum((get(b, k) ** 2).sum() for k in keys)
        out = {"restarts": drill.restarts, "attempts": drill.attempts, "whole_attempts": whole.attempts,
               "steps": (int(a["step"]), int(b["step"])), "resumed_at": resumed_at,
               "resumed": all(f"resumed from step {resumed_at}" in log for log in logs.values()),
               "ok_lines": all(f"ELASTIC_OK {w} step {ELASTIC_STEPS}" in logs[f"worker{w}_a1.log"] for w in range(2)),
               "final_rel_l2": float(torch.sqrt(num / den))}
        print(f"path ae ({card_line()}): drill attempts "
              + ", ".join(f"{x['attempt']}: exit {x['exit_codes']} in {x['duration_s']:.2f}s" for x in drill.attempts)
              + f"; unbroken run {whole.attempts[0]['duration_s']:.2f}s; resumed from step {resumed_at} "
              f"{out['resumed']}, final checkpoint vs unbroken rel L2 {out['final_rel_l2']:.3e} "
              f"(bound {RESUME_REL_BOUND})")
        if not (drill.restarts == 1 and 13 in drill.attempts[0]["exit_codes"]
                and drill.attempts[1]["exit_codes"] == [0, 0] and whole.restarts == 0
                and out["steps"] == (ELASTIC_STEPS, ELASTIC_STEPS) and out["resumed"] and out["ok_lines"]
                and out["final_rel_l2"] <= RESUME_REL_BOUND):
            raise AssertionError(f"path ae: {out}\n{_logs(tmp)}")
    return out


def _logs(tmp: str) -> str:
    """The ends of path ae's worker logs, for a failure's message."""
    parts = []
    for d in sorted(os.listdir(tmp)):
        if d.startswith("logs_"):
            for name in sorted(os.listdir(os.path.join(tmp, d))):
                with open(os.path.join(tmp, d, name)) as f:
                    parts.append(f"--- {d}/{name}\n{f.read()[-1500:]}")
    return "\n".join(parts)


CAPTURE_FRAMES = 384  # path af: the 4 s clip's padded length


def capture_path(cfg, counters, paths, device) -> dict:
    """Path af: ``capture_intermediates`` on the full-width denoiser's own
    forward (20 x 384, f32, the module route: no launches) at the 4 s
    clip's length: every sown and module entry present (each block's
    ``noise_step_condition`` and ``__call__``, the step encoder's
    ``step_embedding``, ``step_encoder_output`` and ``__call__``, the
    output), finite, and the output equal, bit for bit, to an uncaptured
    call's; prints both calls' ms."""
    import torch

    from svc_inference_pipeline_tpu_torch.checkpoints.from_jax import random_init_
    from svc_inference_pipeline_tpu_torch.models.diffsvc import DiffSVCDenoiser
    from svc_inference_pipeline_tpu_torch.utils.observability import capture_intermediates

    g = torch.Generator(device=device).manual_seed(11)
    with torch.device(device):
        den = DiffSVCDenoiser(cfg.mapper)
    random_init_(den, g)
    randomize_vectors_(den, g)
    m = cfg.mapper
    x = torch.randn((1, CAPTURE_FRAMES, m.n_mel), generator=g, device=device)
    cond = torch.randn((1, CAPTURE_FRAMES, m.conditioner_size), generator=g, device=device)
    t = torch.tensor([[500]], device=device)
    got = {}
    with torch.no_grad():
        plain = den(x, cond, t)

        def run():
            got["out"], got["tree"] = capture_intermediates(den, x, cond, t)
            return {}

        drive("af capture_intermediates", counters, run, {}, paths)
        plain_ms = cuda_ms(lambda: den(x, cond, t))
        capture_ms = cuda_ms(lambda: capture_intermediates(den, x, cond, t))
    tree = got["tree"]
    want = {"__call__": None, "diffusion_embedding": {"step_embedding", "step_encoder_output", "__call__"},
            **{f"residual_{i}": {"noise_step_condition", "__call__"} for i in range(m.residual_layer_num)}}
    keys_ok = set(tree) == set(want) and all(set(tree[k]) == v for k, v in want.items() if v)
    leaves = [v for k, entry in tree.items() for vals in (entry.values() if isinstance(entry, dict) else [entry])
              for item in vals for v in (item if isinstance(item, tuple) else (item,))]
    out = {"keys_ok": keys_ok, "entries": sum(len(v) if isinstance(v, dict) else 1 for v in tree.values()),
           "bit_equal": bool(torch.equal(got["out"], plain)), "finite": all(bool(torch.isfinite(v).all()) for v in leaves),
           "plain_ms": plain_ms, "capture_ms": capture_ms}
    print(f"path af ({card_line()}): {out['entries']} entries over {m.residual_layer_num} blocks, keys complete "
          f"{keys_ok}, output bit-equal {out['bit_equal']}; forward {plain_ms:.3f} ms, captured {capture_ms:.3f} ms")
    if not (keys_ok and out["bit_equal"] and out["finite"]):
        raise AssertionError(f"path af: {out}, keys {sorted(tree)}")
    return out


def main_paths(cfg, device, voc) -> tuple:
    """The main paths (module docstring, step 4); returns their records and
    the checks' numbers (int8-w1 mel correlation, per-block vocoder, harness)."""
    import numpy as np
    import torch

    from svc_inference_pipeline_tpu_torch import cli
    from svc_inference_pipeline_tpu_torch.measure import synth_clip as clip
    from svc_inference_pipeline_tpu_torch.ops.pallas.denoiser_step import launches_per_call, make_denoise_fn
    from svc_inference_pipeline_tpu_torch.pipeline.convert import mel_frame_count
    from svc_inference_pipeline_tpu_torch.utils.audio_io import read_wav
    from svc_inference_pipeline_tpu_torch.utils.observability import Metrics

    counters = Counters()
    paths = []
    steps = int(cfg.mapper.noise_schedule_factors[2])
    common = {"K4": 24, "K2": 6, "K3": 1, "K9": 3}
    with tempfile.TemporaryDirectory() as tmp:
        wav_in = os.path.join(tmp, "clip.wav")
        n_samples = synth_clip(wav_in, cfg.fs, CLIP_SECONDS)
        n_expected = mel_frame_count(cfg, n_samples) * cfg.hop_length
        built = {}

        def run_cli(tag, *flags, keep=None):
            wav_out = os.path.join(tmp, f"{tag}.wav")
            timings_path = os.path.join(tmp, f"{tag}.json")
            rc = cli.main(["--input", wav_in, "--singer", SINGER, "--output", wav_out, "--random-weights",
                           "--whisper-size", WHISPER_SIZE, "--seed", "0", "--device", device.type,
                           "--timings-json", timings_path, *flags], built=keep)
            if rc != 0:
                raise AssertionError(f"cli.main returned {rc}")
            samples, sr = read_wav(wav_out)
            # the WAV: n_frames * hop samples between save_audio's 50 ms silences
            silence = cfg.fs // 20
            if sr != cfg.fs:
                raise AssertionError(f"{tag}: WAV at {sr} Hz")
            check_audio(tag, samples[silence: len(samples) - silence, 0].astype("float64") / 32768.0, n_expected)
            with open(timings_path) as f:
                return json.load(f)

        torch.cuda.reset_peak_memory_stats()
        drive("cli ddpm bf16", counters, lambda: run_cli("ddpm"), {"K1 bf16": steps, **common}, paths)
        paths[-1]["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        drive("cli plms@10 int8-w1", counters,
              lambda: run_cli("plms", "--sampler", "plms", "--speedup", "10", "--quantize", "int8-w1", keep=built),
              {"K5 int8-w1": steps // 10 + 1, **common}, paths)
        pipe = built["pipeline"]

        def convert(sampler, quantize, tail=0, target=None):
            target = pipe if target is None else target
            target.set_quantize(quantize, tail)
            gen = torch.Generator(device=device).manual_seed(0)
            audio = target.convert(wav_in, SINGER, generator=gen, sampler=sampler)
            check_audio(f"{sampler} {quantize}", audio, n_expected)
            return dict(target.timings)

        drive("ddim@10 bf16", counters, lambda: convert("ddim", None), {"K5 bf16": steps // 10, **common}, paths)
        drive("dpmpp@10 int8", counters, lambda: convert("dpmpp", "int8"), {"K5 int8": steps // 10 + 1, **common},
              paths)
        drive("ddpm int8 tail 50", counters, lambda: convert("ddpm", "int8", 50),
              {"K1 int8": steps - 50, "K1 bf16": 50, **common}, paths)

        # int8-w1 against bf16, DDPM-1000, same conditioning and noise
        batch, n_frames = pipe.extract_features(wav_in, SINGER)
        with torch.no_grad():
            cond = pipe.cond_encoder(batch)
            shape = (1, cond.shape[1], cfg.mapper.n_mel)
            mels = {}
            for quantize in (None, "int8-w1"):
                fn = make_denoise_fn(pipe.denoiser, cond, steps, pipe.compute_dtype, quantize)
                gen = torch.Generator(device=device).manual_seed(0)
                mels[quantize] = fn.fused_ddpm(pipe.schedule, shape, gen)[0, :n_frames].double().cpu().numpy()
        corr = float(np.corrcoef(mels[None].ravel(), mels["int8-w1"].ravel())[0, 1])
        print(f"int8-w1 vs bf16 DDPM-{steps} final mel ({n_frames} frames): correlation {corr:.6f} "
              f"(gate {INT8_W1_MIN_CORR})")
        if not corr >= INT8_W1_MIN_CORR:
            raise AssertionError(f"int8-w1 final mel correlation {corr} < {INT8_W1_MIN_CORR}")
        chunked = chunked_vocoder_path(cfg, counters, paths, pipe)

        # f. resblock "2": the generator's block route (AMPBlock2, K3 + conv per dilation)
        d = cfg.to_dict()
        d["vocoder"].update(resblock="2", resblock_dilation_sizes=[[1, 3]] * 3)
        cfg2 = os.path.join(tmp, "config_resblock2.json")
        with open(cfg2, "w") as f:
            json.dump(d, f)
        n_act = sum(len(rd) for rd in d["vocoder"]["resblock_dilation_sizes"])
        drive("cli plms@10 bf16 resblock 2", counters,
              lambda: run_cli("plms_rb2", "--config", cfg2, "--sampler", "plms", "--speedup", "10"),
              {"K5 bf16": steps // 10 + 1, "K4": 24, "K3": len(cfg.vocoder.upsample_rates) * n_act + 1, "K9": 3},
              paths)

        # the denoiser at Amphion's BiDilConv widths: K1 and K5 on the wide tile
        cfg_wide = os.path.join(tmp, "config_bidilconv.json")
        with open(cfg_wide, "w") as f:
            json.dump(bidilconv_config(cfg).to_dict(), f)
        wide = {}
        per_step = launches_per_call(BIDILCONV["residual_layer_num"])

        def on_wide_tile(run, calls):
            """run(), failing unless its ``calls`` K1/K5 calls launched all
            their kernels on the wide tile."""
            metrics = Metrics.default().counters
            before = (metrics["denoiser/launches"], metrics["denoiser/launches_wide"])
            timings = run()
            got = (metrics["denoiser/launches"] - before[0], metrics["denoiser/launches_wide"] - before[1])
            if got != (calls * per_step,) * 2:
                raise AssertionError(f"launches, on the wide tile: {got} != {calls * per_step}")
            return timings

        drive(f"cli ddpm bf16 {WIDE_TAG}", counters,
              lambda: on_wide_tile(lambda: run_cli("ddpm_wide", "--config", cfg_wide, keep=wide), steps),
              {"K1 bf16": steps, **common}, paths)
        drive(f"plms@10 bf16 {WIDE_TAG}", counters,
              lambda: on_wide_tile(lambda: convert("plms", None, target=wide["pipeline"]), steps // 10 + 1),
              {"K5 bf16": steps // 10 + 1, **common}, paths)
    checks = {"int8_w1_mel_corr": corr, "chunked_vocoder": chunked,
              "vocoder_per_block": vocoder_paths(cfg, voc, counters, paths, device, clip(cfg.fs, CLIP_SECONDS)),
              "harness": harness_paths(cfg, counters, paths, device)}
    checks.update(batch_paths(cfg, counters, paths, device))
    checks.update(checkpoint_paths(cfg, counters, paths, device))
    checks.update(feature_paths(cfg, counters, paths, device))
    training, batch = training_paths(cfg, counters, paths, device)
    checks.update(training)
    checks["capture"] = capture_path(cfg, counters, paths, device)
    checks["mesh"] = mesh_paths(cfg, counters, paths, batch)
    checks["elastic"] = elastic_path(cfg, counters, paths, batch)
    checks["transcribe"] = transcribe_paths(counters, paths, device)
    return paths, checks


def main() -> int:
    if sys.argv[1:2] == ["--elastic-worker"]:
        return elastic_worker(sys.argv[2:])
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

    from svc_inference_pipeline_tpu_torch.config import load_config
    from svc_inference_pipeline_tpu_torch.ops.pallas import _build

    t0 = time.perf_counter()
    info = _build.build_info()
    print(f"kernels built in {info['build_seconds']:.1f}s ({time.perf_counter() - t0:.1f}s with load): {info['path']}")
    for line in info["build_log"].splitlines():
        if "spill" in line and " 0 bytes spill stores, 0 bytes spill loads" not in line:
            print("  ptxas:", line.strip())

    cfg = load_config(os.path.join(ROOT, "config", "config.json"))
    device = torch.device("cuda")
    with torch.no_grad():
        rows, voc = check_kernels(cfg, device)
    torch.cuda.synchronize()
    paths, checks = main_paths(cfg, device, voc)
    total = {}
    for p in paths:
        for k, n in p["launches"].items():
            total[k] = total.get(k, 0) + n

    k6_rows = [v for k, v in rows.items() if k.startswith("K6")]
    rows["K6"] = dict(rows["K6 int8-w1 K5 form"], max_abs_err=max(r["max_abs_err"] for r in k6_rows))
    wide_launches = {k: sum(p["launches"][f"{k} bf16"] for p in paths if p["path"].endswith(WIDE_TAG))
                     for k in ("K1", "K5")}
    launches = {
        "K1": total["K1 bf16"], "K5": total["K5 bf16"], "K4": total["K4"], "K2": total["K2"], "K3": total["K3"],
        "K6": sum(total[f"{k} {m}"] for k in ("K1", "K5") for m in ("int8", "int8-w1")),
        "K7": total["K7"], "K8": total["K8"], "K9": total["K9"],
    }
    sources = {
        "K1": ("ddpm_step", "denoiser_step.cu", f"{TPU_KERNELS}/denoiser_step.py:376"),
        "K4": ("encoder_attention", "attention.cu", f"{TPU_KERNELS}/attention.py:57"),
        "K2": ("fused_amp_stage", "amp_stage.cu", f"{TPU_KERNELS}/amp_stage.py:432"),
        "K3": ("fused_activation1d", "snake.cu", f"{TPU_KERNELS}/snake.py:131"),
        "K5": ("denoise", "denoiser_step.cu", f"{TPU_KERNELS}/denoiser_step.py:284"),
        "K6": ("ddpm_step/denoise on an int8 stack", "denoiser_step.cu", f"{TPU_KERNELS}/denoiser_step.py:204"),
        "K7": ("fused_amp_pair", "amp_stage.cu", f"{TPU_KERNELS}/amp_pair.py:156"),  # entry point svc_amp_pair
        "K8": ("denoise_v2", "denoiser_v2.cu", "perf_kernel3.py:170"),
        # no Pallas counterpart: the JAX package runs this tracker on the host
        "K9": ("praat_f0_device", "f0.cu", "none (svc_inference_pipeline_tpu/ops/f0.py:86 praat_pitch_ac, host)"),
    }
    kernels = []
    for key, (name, source, replaces) in sources.items():
        r = rows[key]
        kernels.append({"name": name, "route": "cuda", "source": f"{PKG}/csrc/{source}",
                        "replaces": replaces, "launches": launches[key],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
                        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": r.get("library_ms"),
                        **{k: r[k] for k in ("library_ratio", "gemm_library_ms", "int8_library_ms",
                                             "conv_library_ms", "stages", "kernel_device_ms", "host_issue_ms",
                                             "batch2_ms", "batch2_bound_ms", "agreement", "batch_bits")
                           if k in r}})
        if key in wide_launches:
            # the wide tile's share of the launches, and its checks at WIDE_SHAPES
            kernels[-1]["wide_launches"] = wide_launches[key]
            kernels[-1]["wide"] = {k[len(key) + 1:]: {f: v[f] for f in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                                                          "bound_by", "gemm_library_ms") if f in v}
                                   for k, v in rows.items() if k.startswith(f"{key} {WIDE_TAG}")}
    for key, r in rows.items():
        print(f"summary {key}: err {r['max_abs_err']:.3e}, {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}), "
              f"bound {r['bound_ms']:.4f} ms by {r['bound_by']}")
    print(json.dumps({"paths": paths, **checks}))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
