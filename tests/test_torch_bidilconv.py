"""Amphion's DiffWaveNetSVC decoder (BiDilConv 512 x 40, step encoder 512)
at its published widths on the CPU, against the benchmark's plain reference
(``portbench/reference``) on weights drawn in the reference's checkpoint
layout by ``portbench/weights.py``: the port's denoiser module, the plain
K1/K5 arithmetic of its 512-channel stack, and ``convert_batch`` of two
clips with a tiny Whisper and vocoder around this denoiser. Imports no JAX.
"""

import json
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from portbench.reference import nets  # noqa: E402
from portbench.reference.pipeline import Reference, mel_frames  # noqa: E402
from portbench.weights import make_weights  # noqa: E402
from svc_inference_pipeline_tpu_torch.checkpoints.from_jax import load_jax_params  # noqa: E402
from svc_inference_pipeline_tpu_torch.checkpoints.torch_convert import (  # noqa: E402
    convert_mapper_state_dict, convert_vocoder_state_dict, convert_whisper_state_dict)
from svc_inference_pipeline_tpu_torch.config import HParams  # noqa: E402
from svc_inference_pipeline_tpu_torch.models.diffsvc import DiffSVCDenoiser  # noqa: E402
from svc_inference_pipeline_tpu_torch.models.whisper import WhisperDims  # noqa: E402
from svc_inference_pipeline_tpu_torch.ops.pallas import denoiser_step  # noqa: E402
from svc_inference_pipeline_tpu_torch.pipeline.convert import SVCPipeline  # noqa: E402

CONFIG = ROOT / "portbench" / "configs" / "amphion-bidil512x40-ddpm1000-bf16.json"
SEED = 2**31 + 2020
B, T = 2, 64


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """Two intra-op threads while this module runs: the suite runs in several
    worker processes at once, and PyTorch's thread pools, each as wide as the
    machine, slow one another down many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def small_around(cfg: dict) -> dict:
    """The configuration with its denoiser as published and the rest cut for
    the CPU: Whisper at "tiny" width, a 64-channel vocoder, 4 DDPM steps."""
    cfg = json.loads(json.dumps(cfg))
    cfg["whisper_dims"] = {"n_mels": 80, "n_audio_ctx": 1500, "n_audio_state": 384, "n_audio_head": 6,
                           "n_audio_layer": 4}
    cfg["mapper"]["input_content_dim"]["whisper"] = 384
    cfg["mapper"]["noise_schedule_factors"] = [0.0001, 0.02, 4]
    cfg["vocoder"]["upsample_initial_channel"] = 64
    for k in ("singer_file", "min_mel_file", "max_mel_file", "target_f0_file"):
        cfg[k] = str(ROOT / cfg[k].lstrip("./"))
    return cfg


@pytest.fixture(scope="module")
def cfg():
    cfg = small_around(json.loads(CONFIG.read_text()))
    m = cfg["mapper"]
    assert (m["residual_channels"], m["residual_layer_num"], m["diffusion_fc_size"]) == (512, 40, 512)
    assert (m["conditioner_size"], m["dilation_cycle_length"], m["residual_kernel_size"]) == (384, 4, 3)
    return cfg


@pytest.fixture(scope="module")
def weights(cfg):
    return make_weights(cfg, SEED, "cpu")


@pytest.fixture(scope="module")
def den(cfg, weights):
    """The port's denoiser in f32, loaded through the checkpoint converter."""
    hp = HParams(**cfg)
    _, den_tree = convert_mapper_state_dict(weights["mapper"], hp.mapper)
    module = DiffSVCDenoiser(hp.mapper, compute_dtype=torch.float32)
    load_jax_params(module, den_tree)
    return module.eval()


@pytest.fixture(scope="module")
def operands(cfg):
    g = torch.Generator().manual_seed(7)
    cond = torch.randn((B, T, cfg["mapper"]["conditioner_size"]), generator=g)
    x = torch.randn((B, T, cfg["mapper"]["n_mel"]), generator=g).clamp(-1.0, 1.0)
    z = torch.randn((B, T, cfg["mapper"]["n_mel"]), generator=g)
    return cond, x, z


@pytest.mark.parametrize("t_step", [0, 517, 999])
def test_denoiser_matches_the_plain_reference(cfg, weights, den, operands, t_step):
    """eps of every clip within 1e-5 of max|eps|: both sides are float32 over
    the same weights, and differ only in the order of their sums (the port's
    conv, projections and hoisted step rows against the reference's
    convolutions over one clip at a time) through 40 layers, which lands
    6e-7-8e-7 apart; the reference with its products' operands in fp8 lands
    8e-2 away."""
    cond, x, _ = operands
    with torch.no_grad():
        got = den(x, cond, torch.full((B, 1), t_step))
        for i in range(B):
            ref = nets.Denoiser(weights["mapper"], cond[i], cfg["mapper"], nets.Precision("f32"))
            want = ref(x[i].T.contiguous(), t_step).T
            err = (got[i] - want).abs().max().item()
            assert err <= 1e-5 * want.abs().max().item(), (i, err)


@pytest.fixture(scope="module")
def stacked(den, operands):
    """The bf16 stack of the kernels, its folded conditioner and step rows
    (10 steps), and the module with its weights rounded to bf16 as the stack
    holds them (computing in f32)."""
    cond, _, _ = operands
    with torch.no_grad():
        den_bf = DiffSVCDenoiser(den.cfg, compute_dtype=torch.float32)
        den_bf.load_state_dict({k: v.to(torch.bfloat16).float() for k, v in den.state_dict().items()})
        cond_projs, rows = den_bf.precompute(cond, 10, torch.bfloat16)
        st = denoiser_step.stack_denoiser_params(den_bf, torch.bfloat16)
        condb = denoiser_step.fold_conditioner(den_bf, cond_projs, torch.bfloat16)
    return st, condb, rows, den_bf, cond_projs


def test_plain_k1_k5_of_the_512_stack_match_the_module(stacked, operands):
    """The kernels' arithmetic on the 512 x 40 stack (bf16 operands, the bf16
    products summed in the tile's order by ``wgmma_matmul``, f32 gates and
    skip, h rounded to bf16 each layer) against the module in f32 on the
    same bf16 weights: eps within 1e-2 of max|eps| (it lands 3.7e-3 away).
    That is the rounding of h, the conv input, g and s1 to bf16 (2^-9
    relative each) carried through 40 layers, as the wide tile computes
    them. K1's update: the step with the clamp on, every element within
    1e-2 x c1 x c2 x max|eps| of the module's step; and the plain K5 form
    equal to the plain K1 form's eps."""
    st, condb, rows, den_bf, cond_projs = stacked
    _, x, z = operands
    assert st.w1.shape == (40, 1536, 1024)
    k = 3
    xp = torch.nn.functional.pad(x, (0, 28))
    with torch.no_grad():
        want = den_bf.layers(x, rows[k].float(), list(cond_projs.float()), torch.float32)
    got = denoiser_step.forward_plain(st, condb, rows[k], xp, kernel_order=True)[..., :100]
    m = want.abs().max().item()
    assert (got - want).abs().max().item() <= 1e-2 * m
    assert torch.equal(denoiser_step.denoise_plain(st, condb, rows[k], x),
                       denoiser_step.forward_plain(st, condb, rows[k], xp)[..., :100])
    srow = (1.2, 0.3, 0.5, 0.4, 0.1)
    zp = torch.nn.functional.pad(z, (0, 28))
    step = denoiser_step.ddpm_step_plain(st, condb, rows[k], xp, zp, srow)[..., :100]
    x0 = torch.clamp(srow[0] * x - srow[1] * want, -1.0, 1.0)
    want_step = srow[2] * x0 + srow[3] * x + srow[4] * z
    assert (step - want_step).abs().max().item() <= 1e-2 * srow[1] * srow[2] * m + 1e-6


def _pipeline(cfg, weights):
    """The program as the benchmark's harness builds it: the checkpoint
    converters, then ``SVCPipeline.from_jax_params``, on the CPU."""
    hp = HParams(**cfg)
    enc, den = convert_mapper_state_dict(weights["mapper"], hp.mapper)
    voc = convert_vocoder_state_dict(weights["vocoder"], hp.vocoder)
    wtree = convert_whisper_state_dict(weights["whisper"], encoder_only=True)
    dims = WhisperDims(**{**WhisperDims().__dict__, **cfg["whisper_dims"]})
    return SVCPipeline.from_jax_params(hp, enc, den, voc, dims, wtree, device="cpu")


def _clip(seconds, f0, fs, seed):
    t = np.arange(int(seconds * fs)) / fs
    rng = np.random.default_rng(seed)
    return (0.3 * np.sin(2 * np.pi * f0 * t) + 0.01 * rng.standard_normal(t.shape)).astype(np.float32)


def test_convert_batch_matches_the_reference_pipeline(cfg, weights):
    """Two clips (1.2 s and 0.5 s, two singers) in one ``convert_batch``
    with 4 DDPM steps on the 512 x 40 denoiser, against
    ``Reference.convert_call`` replaying the call from the same generator
    seed: each clip's mel, in the sampler's [-1, 1] space, within 3e-3
    relative L2 of the reference's, and its waveform within 1.5e-2. The
    program computes in bf16 (weights, activations and the K1 plain
    version's roundings) and the reference in f32: 6.5e-4 and 5.1e-3 apart;
    the tiny vocoder's and Whisper's own bf16 roundings add to the
    waveform's distance. The reference with its products' operands in fp8
    lands 1.1e-2 and 2.3-2.7e-2 from the f32 one, past both limits."""
    pipe = _pipeline(cfg, weights)
    fs = int(cfg["fs"])
    clips = [_clip(1.2, 220.0, fs, 1), _clip(0.5, 330.0, fs, 2)]
    with open(cfg["singer_file"]) as f:
        singers = sorted(json.load(f))[:2]
    gseed = 12345
    with torch.no_grad():
        waves = pipe.convert_batch(clips, singers, generator=torch.Generator().manual_seed(gseed))
    mel = pipe.last_mel.float()
    ref = Reference(cfg, weights, "cpu")
    outs = ref.convert_call(clips, singers, gseed, "ddpm", 1, [0, 1])
    lo, hi = ref.mel_min.numpy(), ref.mel_max.numpy()

    def norm(m):
        return (m - lo) / (hi - lo + 1e-12) * 2.0 - 1.0

    for i, out in enumerate(outs):
        n = mel_frames(len(clips[i]), cfg)
        got = norm(mel[i, :n].numpy())
        want = norm(out["mel"])
        assert np.linalg.norm(got - want) <= 3e-3 * np.linalg.norm(want), i
        w_got, w_want = np.asarray(waves[i], np.float64), out["wave"].astype(np.float64)
        assert w_got.shape == w_want.shape
        assert np.linalg.norm(w_got - w_want) <= 1.5e-2 * np.linalg.norm(w_want), i
    assert math.isfinite(float(mel.sum()))
