"""The port's hand-written CUDA kernels against their plain PyTorch versions
on the card (bf16, the operands of both sides identical).

Every test here needs an NVIDIA GPU with nvcc and skips without one. This
file imports neither JAX nor the JAX package, so it runs on a machine that
has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels.py
"""

import hashlib
import json
import math
import os

import numpy as np
import pytest
import torch

from svc_inference_pipeline_tpu_torch.config import HParams, load_config
from svc_inference_pipeline_tpu_torch.measure import synth_clip
from svc_inference_pipeline_tpu_torch.models.diffsvc import DiffSVCDenoiser
from svc_inference_pipeline_tpu_torch.ops.pallas import (
    _build, amp_pair, amp_stage, attention, denoiser_step, denoiser_v2, snake)
from svc_inference_pipeline_tpu_torch.pipeline.convert import SVCPipeline, mel_frame_count

pytestmark = pytest.mark.cuda
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BF = torch.bfloat16
KS = (3, 7, 11)
DILS = ((1, 3, 5),) * 3


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card with pytest -m cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _bf16_tol(m):
    """2 bf16 ulps at magnitude m: kernel and plain version round the same f32
    values to bf16 after summing them in another order."""
    return 2 * 2.0 ** (math.floor(math.log2(m)) - 7)


def _close(got, ref, tol=_bf16_tol, view=None):
    """max|view(got) - view(ref)| <= tol(max|view(ref)|)."""
    assert got.shape == ref.shape and got.dtype == ref.dtype
    got, ref = got.float(), ref.float()
    if view is not None:
        got, ref = view(got), view(ref)
    err = (got - ref).abs().max().item()
    assert err <= tol(ref.abs().max().item()), err


def test_library_builds_and_binds(dev):
    path, _, _ = _build.build()
    assert path.exists()
    lib = _build.lib()
    for name in ("svc_ddpm_step", "svc_denoise", "svc_encoder_attention", "svc_activation1d", "svc_amp_stage",
                 "svc_amp_pair", "svc_denoise_v2"):
        assert getattr(lib, name).restype is not None


@pytest.mark.parametrize("b,t_len,c,layers", [(1, 64, 128, 4), (2, 100, 128, 5)])
def test_k1_ddpm_step(dev, b, t_len, c, layers):
    """Row counts not a multiple of the 64-row tile, two clips, dilation wrap."""
    g = torch.Generator(device=dev).manual_seed(0)
    cfg = HParams(residual_channels=c, residual_layer_num=layers, n_mel=100, conditioner_size=c,
                  diffusion_fc_size=128, dilation_cycle_length=4, residual_kernel_size=3)
    with torch.device(dev):
        den = DiffSVCDenoiser(cfg, BF)
    with torch.no_grad():
        for p in den.parameters():
            p.copy_(torch.randn(p.shape, generator=g, device=dev) / (p.shape[-1] ** 0.5 if p.dim() > 1 else 10))
        den = den.to(BF)
        cp, rows = den.precompute(torch.randn((b, t_len, c), generator=g, device=dev), 10, BF)
        st = denoiser_step.stack_denoiser_params(den, BF)
        condb = denoiser_step.fold_conditioner(den, cp, BF)
        x = torch.zeros((b, t_len, 128), device=dev)
        x[..., :100] = torch.randn((b, t_len, 100), generator=g, device=dev)
        z = torch.zeros_like(x)
        z[..., :100] = torch.randn((b, t_len, 100), generator=g, device=dev)
        # the first row gives x' = eps + x/2 + z/2; each is held on
        # x' - s3 x - s4 z, the part that carries eps, to 1e-2 of its range
        for srow in ((0.0, -1 / 16, 16.0, 0.5, 0.5), (1.2, 0.3, 0.5, 0.4, 0.1)):
            got = denoiser_step.ddpm_step(st, condb, rows[3], x, z, srow)
            _close(got, denoiser_step.ddpm_step_plain(st, condb, rows[3], x, z, srow),
                   tol=lambda m: 1e-2 * m, view=lambda y, s=srow: y - s[3] * x - s[4] * z)
            assert torch.all(got[..., 100:] == 0)


def _denoiser_operands(dev, b, t_len, c, layers, quantize, seed=0, conv_fan_in=False, n_true=None, fc=128,
                       growth=8.0):
    """A random denoiser stacked for the kernels (bf16, or int8 with
    ``quantize``), its conditioner and step rows, and x [b, t_len, 100] f32
    whose element i is scaled by 8^i, so that a second element's int8 scale
    is ~8x the first's. Weights are N(0, 1/n) with n the last axis; with
    ``conv_fan_in`` the dilated convs' n is their fan-in 3C, as the random
    init draws them (with n = 3 a deep stack is chaotic: bf16 rounding
    differences double from layer to layer). With ``n_true`` the condition
    of element i is 0 past its n_true[i] frames, as a batch's masked
    features leave it. ``fc``: the step encoder's width; ``growth``: the
    factor between two elements' scales of x."""
    g = torch.Generator(device=dev).manual_seed(seed)
    cfg = HParams(residual_channels=c, residual_layer_num=layers, n_mel=100, conditioner_size=c,
                  diffusion_fc_size=fc, dilation_cycle_length=4, residual_kernel_size=3)
    with torch.device(dev):
        den = DiffSVCDenoiser(cfg, BF)
    with torch.no_grad():
        for p in den.parameters():
            n = p.shape[1] * p.shape[2] if conv_fan_in and p.dim() == 3 else p.shape[-1]
            p.copy_(torch.randn(p.shape, generator=g, device=dev) / (n ** 0.5 if p.dim() > 1 else 10))
        den = den.to(BF)
        cond = torch.randn((b, t_len, c), generator=g, device=dev)
        for i, n in enumerate(n_true or ()):
            cond[i, n:] = 0.0
        cp, rows = den.precompute(cond, 10, BF)
        st = denoiser_step.stack_denoiser_params(den, BF, quantize)
        condb = denoiser_step.fold_conditioner(den, cp, BF)
    scale = (growth ** torch.arange(b, device=dev)).view(b, 1, 1)
    x = scale * torch.randn((b, t_len, 100), generator=g, device=dev)
    return st, condb, rows, x, g


_SHAPES = [(1, 64, 128, 4), (2, 100, 128, 5), (2, 37, 192, 5)]


@pytest.mark.parametrize("quantize", [None, "int8-w1", "int8"])
@pytest.mark.parametrize("b,t_len,c,layers", _SHAPES)
def test_k5_k6_denoise(dev, quantize, b, t_len, c, layers):
    """K5 (bf16) and K6 in its K5 form: eps of each batch element to 1e-2 of
    that element's range; the elements' int8 scales differ by ~8x. K5 is held
    to the float64 evaluation of its function: on these stacks (conv weights
    at fan-in 3, chaotic) an f32 evaluation in another summation order, the
    plain version's, may itself land 1e-2 from it. K6's int8 products are
    exact on both sides, so K6 is held to the plain version."""
    st, condb, rows, x, _ = _denoiser_operands(dev, b, t_len, c, layers, quantize)
    before = dict(denoiser_step.denoise.launches_by_mode)
    got = denoiser_step.denoise(st, condb, rows[3], x)
    if quantize is None:
        got_ref, ref = got.double(), denoise_float64(st, condb, rows[3], x)
    else:
        got_ref, ref = got, denoiser_step.denoise_plain(st, condb, rows[3], x)
    assert got.shape == x.shape and got.dtype == torch.float32
    for i in range(b):
        _close(got_ref, ref, tol=lambda m: 1e-2 * m, view=lambda y, i=i: y[i])
        # each clip's eps is the kernel's eps of that clip alone, exactly
        alone = denoiser_step.denoise(st, condb[:, i:i + 1].contiguous(), rows[3], x[i:i + 1].contiguous())
        assert torch.equal(got[i:i + 1], alone)
    assert denoiser_step.denoise.launches_by_mode[st.mode] == before[st.mode] + 1 + b


def denoise_float64(st, condb, step_rows_t, x):
    """``denoise_plain``'s function evaluated in float64 (same bf16 rounding
    points): x [B, T, n_mel] -> eps [B, T, n_mel] float64, bf16 stacks."""
    ds = denoiser_step

    def r(a):
        return a.to(st.wmel.dtype).double()

    n_layers, c = st.w1.shape[0], st.wskip.shape[0]
    xp = torch.nn.functional.pad(x, (0, st.wmel.shape[0] - x.shape[-1])).double()
    h = r(torch.relu(r(xp) @ st.wmel.double() + st.bmel.double()))
    skip = torch.zeros(xp.shape[:-1] + (c,), dtype=torch.float64, device=x.device)
    for i in range(n_layers):
        acc = ds._taps(r(h + step_rows_t[i].double()), 2 ** (i % st.cycle)) @ st.w1[i].double()
        acc = acc + condb[i].double()
        g = torch.sigmoid(acc[..., :c]) * torch.tanh(acc[..., c:])
        yo = r(g) @ st.wout[i].double() + st.bout[i].double()
        h = r((h + yo[..., :c]) * ds.INV_SQRT2)
        skip = skip + yo[..., c:]
    inv_sqrt_l = float(torch.tensor(1.0 / math.sqrt(n_layers), dtype=torch.float32))  # as denoise_plain
    s1 = torch.relu(r(skip * inv_sqrt_l) @ st.wskip.double() + st.bskip.double())
    return (r(s1) @ st.wo.double() + st.bo.double())[..., :x.shape[-1]]


@pytest.mark.parametrize("b,t_len,c,layers", _SHAPES)
def test_k5_chaotic_stack_against_float64(dev, b, t_len, c, layers, record_property):
    """K5 on the bf16 stack of ``test_k5_k6_denoise`` (conv weights at fan-in
    3, where bf16 rounding differences grow from layer to layer), held per
    clip to 1e-2 of max|eps| of the float64 evaluation of the same function.
    Recorded per clip (junit properties), over max|plain|: the kernel's,
    the plain version's and, a second f32 evaluation in another summation
    order, the plain version's on the CPU distance from that evaluation."""
    st, condb, rows, x, _ = _denoiser_operands(dev, b, t_len, c, layers, None)
    got = denoiser_step.denoise(st, condb, rows[3], x)
    plain = denoiser_step.denoise_plain(st, condb, rows[3], x)
    st_cpu = type(st)(*(v.cpu() if torch.is_tensor(v) else v for v in st))
    on_cpu = denoiser_step.denoise_plain(st_cpu, condb.cpu(), rows[3].cpu(), x.cpu())
    ref = denoise_float64(st, condb, rows[3], x)
    for i in range(b):
        m = plain[i].abs().max().item()
        for name, y in (("kernel", got), ("plain", plain), ("plain_cpu", on_cpu)):
            record_property(f"clip{i}_{name}_vs_f64", (y[i].double().to(ref.device) - ref[i]).abs().max().item() / m)
        record_property(f"clip{i}_kernel_vs_plain", (got[i] - plain[i]).abs().max().item() / m)
        _close(got.double(), ref, tol=lambda m: 1e-2 * m, view=lambda y, i=i: y[i])


@pytest.mark.parametrize("quantize", ["int8-w1", "int8"])
@pytest.mark.parametrize("b,t_len,c,layers", _SHAPES)
def test_k6_ddpm_step(dev, quantize, b, t_len, c, layers):
    """K6 in its K1 form, held on x' - x/2 - z/2 (= eps) per batch element."""
    st, condb, rows, x, g = _denoiser_operands(dev, b, t_len, c, layers, quantize)
    xp = torch.nn.functional.pad(x, (0, 28)).contiguous()
    z = torch.nn.functional.pad(torch.randn(x.shape, generator=g, device=dev), (0, 28)).contiguous()
    srow = (0.0, -1 / 16, 16.0, 0.5, 0.5)
    got = denoiser_step.ddpm_step(st, condb, rows[3], xp, z, srow)
    ref = denoiser_step.ddpm_step_plain(st, condb, rows[3], xp, z, srow)
    for i in range(b):
        _close(got, ref, tol=lambda m: 1e-2 * m, view=lambda y, i=i: (y - 0.5 * xp - 0.5 * z)[i])
    assert torch.all(got[..., 100:] == 0)


@pytest.mark.parametrize("t_len,c,layers", [(944, 384, 20), (100, 128, 5), (37, 192, 6)])
def test_k8_denoise_v2(dev, t_len, c, layers):
    """K8 (one cooperative launch, every phase on the wgmma tile) against the
    plain version and against K5 on the same operands, each to 1e-2 of
    max|eps|; T = 944 and 100 are not multiples of the 64-row tile, L = 5 and
    6 wrap the dilation cycle."""
    st, condb, rows, x, _ = _denoiser_operands(dev, 1, t_len, c, layers, None, conv_fan_in=True)
    before = denoiser_v2.denoise_v2.launches
    got = denoiser_v2.denoise_v2(st, condb, rows[3], x)
    assert denoiser_v2.denoise_v2.launches == before + 1 and denoiser_v2.denoise_v2.grid > 0
    assert got.shape == x.shape and got.dtype == torch.float32
    _close(got, denoiser_step.denoise_plain(st, condb, rows[3], x), tol=lambda m: 1e-2 * m)
    _close(got, denoiser_step.denoise(st, condb, rows[3], x), tol=lambda m: 1e-2 * m)
    assert torch.equal(got, denoiser_v2.denoise_v2(st, condb, rows[3], x))  # no atomics: deterministic


@pytest.mark.parametrize("c", [128, 384])
@pytest.mark.parametrize("t_len", [9, 100])
def test_k1_k5_tiles_and_halos_at_clip_boundaries(dev, t_len, c):
    """B = 2 clips of T = 9 (one partial 64-row tile) and 100 (a full and a
    partial one), L = 5 (dilations 1, 2, 4, 8, 1 against a halo of 8): the
    gate's row boxes reach into the halo rows of each clip and tiles end at
    each clip's last row. K1 (on x' - x/2 - z/2 = eps) and K5 per clip to
    1e-2 of its range, and each clip's result equal to that clip alone."""
    st, condb, rows, x, g = _denoiser_operands(dev, 2, t_len, c, 5, None, conv_fan_in=True)
    eps = denoiser_step.denoise(st, condb, rows[3], x)
    ref = denoiser_step.denoise_plain(st, condb, rows[3], x)
    xp = torch.nn.functional.pad(x, (0, 28)).contiguous()
    z = torch.nn.functional.pad(torch.randn(x.shape, generator=g, device=dev), (0, 28)).contiguous()
    srow = (0.0, -1 / 16, 16.0, 0.5, 0.5)
    got = denoiser_step.ddpm_step(st, condb, rows[3], xp, z, srow)
    want = denoiser_step.ddpm_step_plain(st, condb, rows[3], xp, z, srow)
    for i in range(2):
        _close(eps, ref, tol=lambda m: 1e-2 * m, view=lambda y, i=i: y[i])
        _close(got, want, tol=lambda m: 1e-2 * m, view=lambda y, i=i: (y - 0.5 * xp - 0.5 * z)[i])
        one = (condb[:, i:i + 1].contiguous(), rows[3])
        assert torch.equal(eps[i:i + 1], denoiser_step.denoise(st, *one, x[i:i + 1].contiguous()))
        assert torch.equal(got[i:i + 1], denoiser_step.ddpm_step(st, *one, xp[i:i + 1].contiguous(),
                                                                  z[i:i + 1].contiguous(), srow))
    assert torch.all(got[..., 100:] == 0)


@pytest.mark.parametrize("quantize", [None, "int8-w1", "int8"])
def test_k1_k5_k6_batch_of_masked_clips(dev, quantize):
    """B = 4 clips padded to T = 384 whose true lengths are 384, 200, 97 and
    1 frames (their conditions 0 past them, as ``convert_batch`` masks the
    features), C = 384: eps (K5, or K6 on an int8 stack, whose per-clip
    scales then see the masked frames) and, for bf16, K1 per clip against
    the plain version, and each clip's result equal to that clip alone."""
    st, condb, rows, x, g = _denoiser_operands(dev, 4, 384, 384, 5, quantize, conv_fan_in=True,
                                               n_true=(384, 200, 97, 1))
    tol = (lambda m: 1e-2 * m) if quantize is None else (lambda m, q=quantize: INT8_TOL[q] * m)
    eps = denoiser_step.denoise(st, condb, rows[3], x)
    ref = denoiser_step.denoise_plain(st, condb, rows[3], x)
    xp = torch.nn.functional.pad(x, (0, 28)).contiguous()
    z = torch.nn.functional.pad(torch.randn(x.shape, generator=g, device=dev), (0, 28)).contiguous()
    srow = (0.0, -1 / 16, 16.0, 0.5, 0.5)
    step = denoiser_step.ddpm_step(st, condb, rows[3], xp, z, srow) if quantize is None else None
    for i in range(4):
        _close(eps, ref, tol=tol, view=lambda y, i=i: y[i])
        one = (condb[:, i:i + 1].contiguous(), rows[3])
        assert torch.equal(eps[i:i + 1], denoiser_step.denoise(st, *one, x[i:i + 1].contiguous()))
        if step is not None:
            _close(step, denoiser_step.ddpm_step_plain(st, condb, rows[3], xp, z, srow), tol=tol,
                   view=lambda y, i=i: (y - 0.5 * xp - 0.5 * z)[i])
            assert torch.equal(step[i:i + 1], denoiser_step.ddpm_step(st, *one, xp[i:i + 1].contiguous(),
                                                                       z[i:i + 1].contiguous(), srow))


# chip_smoke.py's limits for the int8 forms, per mode (a tie of a quantiser
# flipped by a bf16 h summed in another order moves one operand a whole
# step; the plain version sums in the kernel's order, and they agree exactly)
INT8_TOL = {"int8-w1": 1.5e-2, "int8": 2.5e-2}


@pytest.mark.parametrize("quantize", ["int8-w1", "int8"])
@pytest.mark.parametrize("c", [128, 384])
@pytest.mark.parametrize("t_len", [9, 100])
def test_k6_tiles_and_halos_at_clip_boundaries(dev, t_len, c, quantize):
    """K6 (the wgmma s8 tile, the gate split over its taps) on B = 2 clips of
    T = 9 and 100 with L = 5 (dilations 1, 2, 4, 8, 1): tap boxes reach past
    each clip's rows, where the quantised input is 0, and the clips' int8
    scales differ ~8x. eps per clip against the plain version, two calls bit
    for bit (the tap partials are summed in int32), and each clip's eps equal
    to that clip alone."""
    st, condb, rows, x, _ = _denoiser_operands(dev, 2, t_len, c, 5, quantize)
    eps = denoiser_step.denoise(st, condb, rows[3], x)
    ref = denoiser_step.denoise_plain(st, condb, rows[3], x)
    for i in range(2):
        _close(eps, ref, tol=lambda m: INT8_TOL[quantize] * m, view=lambda y, i=i: y[i])
        one = denoiser_step.denoise(st, condb[:, i:i + 1].contiguous(), rows[3], x[i:i + 1].contiguous())
        assert torch.equal(eps[i:i + 1], one)
    assert torch.equal(eps, denoiser_step.denoise(st, condb, rows[3], x))


@pytest.mark.parametrize("quantize", ["int8-w1", "int8"])
@pytest.mark.parametrize("b,t_len,c,layers", [(2, 100, 384, 5), (1, 384, 384, 20)])
def test_k6_equals_its_plain_version_bit_for_bit(dev, quantize, b, t_len, c, layers):
    """The int8 plain version sums its bf16 products in the wgmma tile's
    order (``denoiser_step.wgmma_matmul``), so K6 and it agree bit for bit,
    on the clip-boundary operands above and at the main path's depth."""
    st, condb, rows, x, _ = _denoiser_operands(dev, b, t_len, c, layers, quantize)
    assert torch.equal(denoiser_step.denoise(st, condb, rows[3], x),
                       denoiser_step.denoise_plain(st, condb, rows[3], x))


def test_k1_is_deterministic(dev):
    """The gate's three tap sums are added in a fixed order and g's chunks
    cross the cluster through distributed shared memory, with no atomics:
    two K1 calls on the same operands agree bit for bit (T = 384, C = 384,
    the main path's widths)."""
    st, condb, rows, x, g = _denoiser_operands(dev, 1, 384, 384, 4, None, conv_fan_in=True)
    xp = torch.nn.functional.pad(x, (0, 28)).contiguous()
    z = torch.nn.functional.pad(torch.randn(x.shape, generator=g, device=dev), (0, 28)).contiguous()
    srow = (1.2, 0.3, 0.5, 0.4, 0.1)
    first = denoiser_step.ddpm_step(st, condb, rows[3], xp, z, srow)
    assert all(torch.equal(first, denoiser_step.ddpm_step(st, condb, rows[3], xp, z, srow)) for _ in range(3))


@pytest.mark.parametrize("b,t_len", [(2, 100), (1, 960)])
@pytest.mark.parametrize("quantize,tail", [(None, 0), ("int8-w1", 4)])
def test_fused_sampler_equals_k1_step_by_step(dev, quantize, tail, b, t_len):
    """``ddpm_sample_fused`` checks its operands and allocates its scratch
    once per stack and alternates two carries: over 10 steps (the last
    ``tail`` on the bf16 stack of an int8 one) it equals ``ddpm_step``
    called step by step on the same draws, bit for bit, at 4 row tiles and
    at the offline cell's 15. Its counters, as the C entry points report
    them: 10 K1 calls, L + 3 launches and L fused layers a bf16 call, 2L + 3
    launches and no fused layer an int8 one."""
    from svc_inference_pipeline_tpu_torch.sampling.schedule import DiffusionSchedule
    from svc_inference_pipeline_tpu_torch.utils.observability import Metrics

    st, condb, rows, x, g = _denoiser_operands(dev, b, t_len, 128, 5, quantize, conv_fan_in=True)
    # the same draws stacked in bf16: the unquantised stack of the same denoiser
    st_fp = _denoiser_operands(dev, b, t_len, 128, 5, None, conv_fan_in=True)[0] if tail else None
    sched = DiffusionSchedule.from_factors([1e-4, 0.02, 10])
    x_t = torch.randn(x.shape, generator=g, device=dev)
    z = torch.randn((10,) + x.shape, generator=g, device=dev)
    counters = Metrics.default().counters
    keys = ("denoiser/launches", "denoiser/fused_layers")
    before = (denoiser_step.ddpm_step.launches, *(counters[k] for k in keys))
    got = denoiser_step.ddpm_sample_fused(st, condb, rows, sched, x.shape, noise=(x_t, z), st_fp=st_fp, tail=tail)
    after = (denoiser_step.ddpm_step.launches, *(counters[k] for k in keys))
    bf16_calls = 10 if quantize is None else tail
    launches = bf16_calls * (5 + 3) + (10 - bf16_calls) * (2 * 5 + 3)
    assert tuple(a - b for a, b in zip(after, before)) == (10, launches, bf16_calls * 5)
    pad = (0, 28)
    want = torch.nn.functional.pad(x_t, pad).contiguous()
    srows = denoiser_step.schedule_rows(sched)
    for i in range(10):
        stack = st if i < 10 - tail else st_fp
        zi = torch.nn.functional.pad(z[i], pad).contiguous()
        want = denoiser_step.ddpm_step(stack, condb, rows[9 - i], want, zi, srows[i])
    assert torch.equal(got, want[..., :100])


# K1/K5 operands drawn on the card from a fixed seed: (B, T, true lengths or
# None, L, C). The first two are the C = 384 benchmark cells' shapes (a 10 s
# clip, 960 frames; two clips of a served batch padded to 1536 frames); the
# c512 cases are the same shapes on the wide tile (C = 512, L = 40), whose
# digests its first build on an H100 wrote.
DIGEST_CASES = {
    "b1_t960": (1, 960, None, 20, 384),
    "b2_t1536_masked": (2, 1536, (1500, 200), 20, 384),
    "b2_t9": (2, 9, None, 5, 384),
    "b2_t100": (2, 100, None, 5, 384),
    "c512_b1_t960": (1, 960, None, 40, 512),
    "c512_b2_t1536_masked": (2, 1536, (1500, 200), 40, 512),
    "c512_b2_t100": (2, 100, None, 5, 512),
}
DIGEST_SEED = 19
DIGESTS = os.path.join(REPO, "tests", "data", "k1_k5_sha256.json")
# the schedule rows of K1: the first gives x' - x/2 - z/2 = eps, the second an update as sampling has
SROWS = ((0.0, -1 / 16, 16.0, 0.5, 0.5), (1.2, 0.3, 0.5, 0.4, 0.1))


def _sha256(*tensors):
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _digest_operands(dev, case):
    """(st, condb, step row, x [B, T, 100], xp and z [B, T, 128]) of a
    DIGEST_CASES case; with true lengths the conditions are 0 past them."""
    b, t_len, n_true, layers, c = DIGEST_CASES[case]
    st, condb, rows, x, g = _denoiser_operands(dev, b, t_len, c, layers, None, seed=DIGEST_SEED,
                                               conv_fan_in=True, n_true=n_true)
    xp = torch.nn.functional.pad(x, (0, 28)).contiguous()
    z = torch.nn.functional.pad(torch.randn(x.shape, generator=g, device=dev), (0, 28)).contiguous()
    return st, condb, rows[3], x, xp, z


def k1_k5_digests(dev, case):
    """sha256 of a case's operands and of K1's (both SROWS) and K5's outputs."""
    st, condb, row, x, xp, z = _digest_operands(dev, case)
    out = {"operands": _sha256(*(v for v in st if torch.is_tensor(v)), condb, row, x, xp, z)}
    for k, srow in enumerate(SROWS):
        out[f"k1_row{k}"] = _sha256(denoiser_step.ddpm_step(st, condb, row, xp, z, srow))
    out["k5"] = _sha256(denoiser_step.denoise(st, condb, row, x))
    return out


@pytest.mark.parametrize("case", list(DIGEST_CASES))
def test_k1_k5_equal_the_recorded_outputs_bit_for_bit(dev, case):
    """K1 and K5 give the very bits that the kernels before the prefetching
    tile gave (``tests/data/k1_k5_sha256.json``, written by their build on
    an H100): the redesigns (the prefetching tile, the one-launch layer)
    changed where operands are loaded and how the tiles are kept, not any
    element's arithmetic. At C = 512 the digests are
    the wide tile's own. The operands' own digest is checked first: a
    PyTorch whose generator or GEMMs draw other operands fails there, not on
    the kernels."""
    with open(DIGESTS) as f:
        want = json.load(f)[case]
    got = k1_k5_digests(dev, case)
    assert got["operands"] == want["operands"], "the operands differ from those the digests were made from"
    assert got == want


@pytest.mark.parametrize("case", ["b1_t960", "b2_t1536_masked"])
def test_k1_k5_at_the_cells_shapes(dev, case):
    """The benchmark cells' shapes at full depth (C = 384, L = 20): one 10 s
    clip (T = 960), and two clips padded to T = 1536 whose true lengths are
    1500 and 200 frames. K1 (on x' - x/2 - z/2 = eps) and K5 per clip to
    1e-2 of its range against the plain version, each clip's result equal
    to that clip alone, and two calls equal bit for bit."""
    st, condb, row, x, xp, z = _digest_operands(dev, case)
    srow = SROWS[0]
    eps = denoiser_step.denoise(st, condb, row, x)
    step = denoiser_step.ddpm_step(st, condb, row, xp, z, srow)
    ref_eps = denoiser_step.denoise_plain(st, condb, row, x)
    ref_step = denoiser_step.ddpm_step_plain(st, condb, row, xp, z, srow)
    for i in range(x.shape[0]):
        _close(eps, ref_eps, tol=lambda m: 1e-2 * m, view=lambda y, i=i: y[i])
        _close(step, ref_step, tol=lambda m: 1e-2 * m, view=lambda y, i=i: (y - 0.5 * xp - 0.5 * z)[i])
        one = (condb[:, i:i + 1].contiguous(), row)
        assert torch.equal(eps[i:i + 1], denoiser_step.denoise(st, *one, x[i:i + 1].contiguous()))
        assert torch.equal(step[i:i + 1], denoiser_step.ddpm_step(st, *one, xp[i:i + 1].contiguous(),
                                                                   z[i:i + 1].contiguous(), srow))
    assert torch.equal(eps, denoiser_step.denoise(st, condb, row, x))
    assert torch.equal(step, denoiser_step.ddpm_step(st, condb, row, xp, z, srow))
    assert torch.all(step[..., 100:] == 0)


# Amphion's BiDilConv at its published widths (C = 512, L = 40, step encoder
# 512) on the wide tile: every 64-row tile whole at T in {64, 384, 960,
# 1024}, and partial tiles at T = 9 and 1000
_WIDE_SHAPES = [(b, t) for t in (64, 384, 960, 1024) for b in (1, 2, 8)] + [(2, 9), (2, 1000), (8, 1000)]


@pytest.mark.parametrize("b,t_len", _WIDE_SHAPES)
def test_k1_k5_at_the_bidilconv_widths(dev, b, t_len):
    """K1 (on x' - x/2 - z/2 = eps) and K5 at C = 512, L = 40 against their
    plain versions, each clip to 1e-2 of its range: the kernel and the plain
    version round the same f32 sums to bf16 after summing them in another
    order, and 40 layers carry those ulps on through h (as the 20-layer
    cells' 1e-2 allows for). The second clip's result equals that clip alone
    (its tiles and halos are its own). As the C entry points report their
    launches, every ``step_pf_kernel`` in the K1 and K5 calls is on the wide
    tile, ``PfShape<8>``: 3 a call beside 40 of the fused layer."""
    st, condb, rows, x, g = _denoiser_operands(dev, b, t_len, 512, 40, None, conv_fan_in=True, fc=512,
                                               growth=2.0)
    xp = torch.nn.functional.pad(x, (0, 28)).contiguous()
    z = torch.nn.functional.pad(torch.randn(x.shape, generator=g, device=dev), (0, 28)).contiguous()
    srow = SROWS[0]

    def k5_k1():
        return denoiser_step.denoise(st, condb, rows[3], x), denoiser_step.ddpm_step(st, condb, rows[3], xp, z, srow)

    (eps, step), tiles = denoiser_step.launched_tiles(k5_k1)
    assert tiles == {"PfShape<8>": 2 * 3, "layer": 2 * 40}
    ref_eps = denoiser_step.denoise_plain(st, condb, rows[3], x)
    for i in range(b):
        _close(eps, ref_eps, tol=lambda m: 1e-2 * m, view=lambda y, i=i: y[i])
    ref_step = denoiser_step.ddpm_step_plain(st, condb, rows[3], xp, z, srow)
    for i in range(b):
        _close(step, ref_step, tol=lambda m: 1e-2 * m, view=lambda y, i=i: (y - 0.5 * xp - 0.5 * z)[i])
    assert torch.all(step[..., 100:] == 0)
    if b > 1:
        one = (condb[:, 1:2].contiguous(), rows[3])
        assert torch.equal(eps[1:2], denoiser_step.denoise(st, *one, x[1:2].contiguous()))


# the fused layer's chain: (B, T, true lengths or None, C, L). T = 1536 at B = 2
# is more row tiles (48) than clusters of 6 the card holds at once; T = 1000
# ends each clip in a partial tile, and the masked second clip's halo rows
# meet its neighbours' zero rows; 1 to 4 row tiles are the short solo clips
# of a served cell
_LAYER_CASES = {
    "b1_t960_c384": (1, 960, None, 384, 20),
    "b2_t1536_c384": (2, 1536, None, 384, 20),
    "b2_t1024_c512": (2, 1024, None, 512, 40),
    "b3_t1000_ragged_c384": (3, 1000, (1000, 137, 9), 384, 20),
    "b1_t320_c384": (1, 320, None, 384, 20),
    "b3_t200_c128": (3, 200, None, 128, 5),  # clusters of 2
    "b2_t300_ragged_c192": (2, 300, (300, 7), 192, 5),  # clusters of 3
    "b5_t64_c64": (5, 64, None, 64, 3),  # clusters of 1
    "b1_t128_c384": (1, 128, None, 384, 20),
    "b1_t256_c384": (1, 256, None, 384, 20),
    "b2_t100_c384": (2, 100, None, 384, 20),
    "b1_t40_c512": (1, 40, None, 512, 40),  # one partial row tile
}


@pytest.mark.parametrize("case", list(_LAYER_CASES))
def test_fused_layer_chain_against_the_plain_versions(dev, case):
    """K1 (on x' - x/2 - z/2 = eps) and K5, each residual layer one launch of
    ``step_layer_kernel``, against their plain versions per clip to 1e-2 of
    its range (bf16 sums in another order, carried on through h; the cells'
    limit). Each clip's result equals that clip alone, and two calls agree bit
    for bit (the gate's tap sums and g's exchange have a fixed order). As the
    C entry points report their launches, a call is 3 of ``step_pf_kernel``
    and L of the fused layer, and ``denoiser/launches`` and
    ``denoiser/fused_layers`` grow by L + 3 and L a call."""
    from svc_inference_pipeline_tpu_torch.utils.observability import Metrics

    b, t_len, n_true, c, layers = _LAYER_CASES[case]
    st, condb, rows, x, g = _denoiser_operands(dev, b, t_len, c, layers, None, conv_fan_in=True, n_true=n_true,
                                               fc=512 if c == 512 else 128, growth=2.0)
    xp = torch.nn.functional.pad(x, (0, 28)).contiguous()
    z = torch.nn.functional.pad(torch.randn(x.shape, generator=g, device=dev), (0, 28)).contiguous()
    srow = SROWS[0]

    def k5_k1():
        return denoiser_step.denoise(st, condb, rows[3], x), denoiser_step.ddpm_step(st, condb, rows[3], xp, z, srow)

    counters = Metrics.default().counters
    before = (counters["denoiser/launches"], counters["denoiser/fused_layers"])
    (eps, step), tiles = denoiser_step.launched_tiles(k5_k1)
    assert (counters["denoiser/launches"] - before[0], counters["denoiser/fused_layers"] - before[1]) == (
        2 * (layers + 3), 2 * layers)
    assert tiles == {"PfShape<8>" if c > 384 else "PfShape<6>": 2 * 3, "layer": 2 * layers}
    ref_eps = denoiser_step.denoise_plain(st, condb, rows[3], x)
    ref_step = denoiser_step.ddpm_step_plain(st, condb, rows[3], xp, z, srow)
    for i in range(b):
        _close(eps, ref_eps, tol=lambda m: 1e-2 * m, view=lambda y, i=i: y[i])
        _close(step, ref_step, tol=lambda m: 1e-2 * m, view=lambda y, i=i: (y - 0.5 * xp - 0.5 * z)[i])
        one = (condb[:, i:i + 1].contiguous(), rows[3])
        assert torch.equal(eps[i:i + 1], denoiser_step.denoise(st, *one, x[i:i + 1].contiguous()))
    assert torch.all(step[..., 100:] == 0)
    assert torch.equal(eps, denoiser_step.denoise(st, condb, rows[3], x))
    assert torch.equal(step, denoiser_step.ddpm_step(st, condb, rows[3], xp, z, srow))


@pytest.mark.parametrize("quantize", ["int8-w1", "int8"])
def test_k6_keeps_its_split_launches_at_the_cells_shape(dev, quantize):
    """K6 does not run the fused layer: at T = 960, C = 384, L = 20 its K5
    form launches neither ``step_layer_kernel`` nor ``step_pf_kernel`` (its
    ring and s8 tiles), counts 2L + 3 launches and no fused layer, and equals
    its plain version bit for bit."""
    from svc_inference_pipeline_tpu_torch.utils.observability import Metrics

    st, condb, rows, x, _ = _denoiser_operands(dev, 1, 960, 384, 20, quantize)
    counters = Metrics.default().counters
    before = (counters["denoiser/launches"], counters["denoiser/fused_layers"])
    eps, tiles = denoiser_step.launched_tiles(lambda: denoiser_step.denoise(st, condb, rows[3], x))
    assert tiles == {}
    assert (counters["denoiser/launches"] - before[0], counters["denoiser/fused_layers"] - before[1]) == (43, 0)
    assert torch.equal(eps, denoiser_step.denoise_plain(st, condb, rows[3], x))


def test_denoiser_wrappers_refuse_what_the_kernels_do_not_take(dev):
    st, condb, rows, x, _ = _denoiser_operands(dev, 1, 64, 128, 4, "int8")
    with pytest.raises(ValueError, match="x must be contiguous f32"):
        denoiser_step.denoise(st, condb, rows[3], x.to(BF))
    with pytest.raises(ValueError, match="condb must be"):
        denoiser_step.denoise(st, condb[:, :, :32].contiguous(), rows[3], x)
    with pytest.raises(ValueError, match="w1 must be contiguous torch.int8"):
        denoiser_step.denoise(st._replace(w1=st.w1.to(BF)), condb, rows[3], x)
    with pytest.raises(ValueError, match="is on cpu"):
        denoiser_step.denoise(st._replace(w1s=st.w1s.cpu()), condb, rows[3], x)
    with pytest.raises(ValueError, match="is on cpu"):
        denoiser_step.ddpm_step(st, condb, rows[3].cpu(), x, x, (0.0,) * 5)
    with pytest.raises(ValueError, match="bf16 stacks only"):
        denoiser_v2.denoise_v2(st, condb, rows[3], x)
    st, condb, rows, x, _ = _denoiser_operands(dev, 2, 64, 128, 4, None)
    with pytest.raises(ValueError, match="one clip only"):
        denoiser_v2.denoise_v2(st, condb, rows[3], x)


@pytest.mark.parametrize("b,t_len,heads,masked_tail", [
    (1, 1500, 16, False), (2, 300, 2, False), (1, 70, 1, False), (1, 1500, 16, True), (2, 300, 2, True),
    (2, 1, 2, False), (2, 63, 2, False), (2, 65, 2, False), (2, 129, 2, False), (2, 65, 2, True)])
def test_k4_attention(dev, b, t_len, heads, masked_tail):
    """Random q/k/v; or a masked tail: every real key scores about -8 and the
    zero rows padding the last key tile would score 0, so without the mask the
    output falls from ~1 to near 0."""
    g = torch.Generator(device=dev).manual_seed(3)
    shape = (b, t_len, heads * 64)
    q, k, v = (torch.randn(shape, generator=g, device=dev) for _ in range(3))
    if masked_tail:
        q, k, v = 1.0 + 0.1 * q, -1.0 - 0.1 * k, 1.0 + 0.5 * v
    q, k, v = q.to(BF), k.to(BF), v.to(BF)
    _close(attention.encoder_attention(q, k, v, heads), attention.encoder_attention_plain(q, k, v, heads))


def _stage_params(c, g, dev):
    def vec(scale):
        return scale * torch.randn(c, generator=g, device=dev)

    def pair(k):
        w1, w2 = (torch.randn((k, c, c), generator=g, device=dev) / (k * c) ** 0.5 for _ in range(2))
        return (w1, vec(0.05), w2, vec(0.05), vec(0.2), vec(0.2), vec(0.2), vec(0.2))

    return amp_stage.kernel_params(tuple(tuple(pair(k) for _ in d) for k, d in zip(KS, DILS)))


@pytest.mark.parametrize("b,t_len,c", [(1, 1536, 768), (1, 3000, 96), (1, 6001, 24), (1, 50, 8),
                                       (2, 333, 48), (2, 1001, 96), (2, 19, 48)])
def test_k2_amp_stage(dev, b, t_len, c):
    """One host call per stage against the plain version: odd T, two clips
    (tiles and activation runs never straddle them), and T = 19 < H = 25 (every
    tap box reaches into the zero halo rows)."""
    g = torch.Generator(device=dev).manual_seed(1)
    params = _stage_params(c, g, dev)
    x = (0.5 * torch.randn((b, t_len, c), generator=g, device=dev)).to(BF)
    before = amp_stage.fused_amp_stage.launches
    got = amp_stage.fused_amp_stage(x, params, KS, DILS)
    assert amp_stage.fused_amp_stage.launches == before + 1
    _close(got, amp_stage.amp_stage_plain(x, params, KS, DILS))
    # the launch table made on the first call is reused, and gives the same bits
    assert torch.equal(amp_stage.fused_amp_stage(x, params, KS, DILS), got)


def _pair(c, k, g, dev):
    w1, w2 = (torch.randn((k, c, c), generator=g, device=dev) / (k * c) ** 0.5 for _ in range(2))
    vec = [s * torch.randn(c, generator=g, device=dev) for s in (0.05, 0.05, 0.2, 0.2, 0.2, 0.2)]
    return amp_stage.kernel_params((((w1, vec[0], w2, vec[1], *vec[2:]),),))[0][0]


@pytest.mark.parametrize("k,d", [(3, 1), (7, 3), (11, 5)])
@pytest.mark.parametrize("b,t_len,c", [(1, 1001, 384), (2, 333, 96), (1, 4099, 24), (2, 37, 48)])
def test_k7_amp_pair(dev, k, d, b, t_len, c):
    """One host call per pair (four dependent launches) against the plain
    version: odd T, two clips, C = 24 and 48 (64-column tiles partly empty),
    and T = 37 < 2H at k = 11, d = 5 (tap boxes in both halos)."""
    g = torch.Generator(device=dev).manual_seed(4)
    pair = _pair(c, k, g, dev)
    x = (0.5 * torch.randn((b, t_len, c), generator=g, device=dev)).to(BF)
    before = amp_pair.fused_amp_pair.launches
    got = amp_pair.fused_amp_pair(x, pair, k, d)
    assert amp_pair.fused_amp_pair.launches == before + 1
    _close(got, amp_pair.amp_pair_plain(x, pair, k, d))
    # no atomics and fresh scratch each call: a second call gives the same bits
    assert torch.equal(amp_pair.fused_amp_pair(x, pair, k, d), got)


@pytest.mark.parametrize("shape", [(1, 98304, 24), (2, 77, 40), (1, 5, 8), (2, 333, 24), (2, 1001, 384)])
def test_k3_activation(dev, shape):
    g = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn(shape, generator=g, device=dev).to(BF)
    alpha, beta = (0.3 * torch.randn(shape[-1], generator=g, device=dev) for _ in range(2))
    before = snake.fused_activation1d.launches
    got = snake.fused_activation1d(x, alpha, beta)
    assert snake.fused_activation1d.launches == before + 1
    _close(got, snake.activation1d_plain(x, *snake.effective_params(alpha, beta)))
    f32 = snake.fused_activation1d(x.float(), alpha, beta)
    _close(f32, snake.activation1d_plain(x.float(), *snake.effective_params(alpha, beta)),
           tol=lambda m: 1e-5 * m)


@pytest.mark.parametrize("dtype", [BF, torch.float32])
@pytest.mark.parametrize("b,t_len,c,halo", [(2, 333, 24, 25), (1, 7, 384, 25), (2, 100, 48, 3)])
def test_k3_activation_into_the_conv_buffer(dev, dtype, b, t_len, c, halo):
    """K2's form (what ``svc_amp_stage`` launches, here through the module's
    launch): bf16(act(x)) in rows [halo, halo + T) of a buffer filled with
    NaN beforehand, and zeros in its halo rows, against the plain version
    placed the same way."""
    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn((b, t_len, c), generator=g, device=dev).to(dtype)
    alpha, beta = (0.3 * torch.randn(c, generator=g, device=dev) for _ in range(2))
    a_eff, inv_b = snake.effective_params(alpha, beta)
    buf = torch.full((b, t_len + 2 * halo, c), math.nan, dtype=BF, device=dev)
    snake.launch_activation1d(x, buf, a_eff, inv_b, halo)
    ref = torch.zeros_like(buf)
    ref[:, halo:halo + t_len] = snake.activation1d_plain(x, a_eff, inv_b).to(BF)
    assert torch.all(buf[:, :halo] == 0) and torch.all(buf[:, halo + t_len:] == 0)
    _close(buf, ref)


@pytest.mark.parametrize("kernel", ["K2", "K3", "K4"])
@pytest.mark.parametrize("b", [2, 3])
def test_batches_against_plain_and_each_clip_alone(dev, kernel, b):
    """K2 (one stage, C = 96), K3 and K4 (a Whisper-medium layer's 16 heads)
    on B = 2 and 3 clips of an odd T, clip i scaled by 4^i: against the
    plain version, and each clip's rows equal to the kernel's on that clip
    alone (tiles never straddle clips)."""
    g = torch.Generator(device=dev).manual_seed(6)
    scale = (4.0 ** torch.arange(b, device=dev)).view(b, 1, 1)
    if kernel == "K4":
        operands = tuple((scale.sqrt() * torch.randn((b, 301, 1024), generator=g, device=dev)).to(BF)
                         for _ in range(3))

        def run(q, k, v):
            return attention.encoder_attention(q, k, v, 16)

        plain = attention.encoder_attention_plain(*operands, 16)
    elif kernel == "K2":
        params = _stage_params(96, g, dev)
        operands = ((0.5 * scale * torch.randn((b, 1001, 96), generator=g, device=dev)).to(BF),)

        def run(x):
            return amp_stage.fused_amp_stage(x, params, KS, DILS)

        plain = amp_stage.amp_stage_plain(*operands, params, KS, DILS)
    else:
        alpha, beta = (0.3 * torch.randn(24, generator=g, device=dev) for _ in range(2))
        operands = ((scale * torch.randn((b, 3001, 24), generator=g, device=dev)).to(BF),)

        def run(x):
            return snake.fused_activation1d(x, alpha, beta)

        plain = snake.activation1d_plain(*operands, *snake.effective_params(alpha, beta))
    got = run(*operands)
    for i in range(b):
        _close(got, plain, view=lambda y, i=i: y[i])
        assert torch.equal(got[i:i + 1], run(*(t[i:i + 1].contiguous() for t in operands)))


def test_convert_batch_at_a_bucket_of_100_frames(dev):
    """A bucket that is not a multiple of 64 (``--bucket 100``): every kernel
    takes T = 100 (K1-K6 tile each clip's rows and mask its last tile, K2 and
    K3 take any T, K4 always sees Whisper's 1500 frames), so convert_batch
    runs. A narrow config: Whisper-tiny, DiffSVC 2 x 128, BigVGAN 512 (24
    channels after the six stages, a multiple of K2's 8)."""
    d = load_config(os.path.join(REPO, "config", "config.json")).to_dict()
    for key in ("singer_file", "min_mel_file", "max_mel_file", "target_f0_file"):
        d[key] = os.path.join(REPO, d[key].lstrip("./"))
    d["mapper"].update(residual_layer_num=2, residual_channels=128)
    d["vocoder"]["upsample_initial_channel"] = 512
    pipe = SVCPipeline.from_config(HParams(**d), random_weights=True, device="cuda", bucket=100)
    clips = [synth_clip(24000, 1.0), 0.5 * synth_clip(24000, 0.6)]
    wrappers = (denoiser_step.denoise, attention.encoder_attention, amp_stage.fused_amp_stage,
                snake.fused_activation1d)
    before = [w.launches for w in wrappers]
    waves = pipe.convert_batch(clips, ["svcc_CDF1", "svcc_CDM1"], sampler="plms", speedup=100)
    # PLMS over 1000 steps at stride 100: 11 evaluations; Whisper-tiny's 4 layers; 6 stages; 1 activation
    assert [w.launches - n for w, n in zip(wrappers, before)] == [11, 4, 6, 1]
    for w, c in zip(waves, clips):
        assert w.shape == (mel_frame_count(pipe.cfg, len(c)) * 256,) and np.isfinite(w).all()
        assert np.abs(w).max() > 0


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    x = torch.randn((1, 64, 128), device=dev)
    with pytest.raises(ValueError, match="bf16"):
        attention.encoder_attention(x, x, x, 2)
    with pytest.raises(ValueError, match="multiple of 8"):
        amp_stage.fused_amp_stage(x[..., :12].to(BF).contiguous(), (), (), ())
    g = torch.Generator(device=dev).manual_seed(5)
    pair = _pair(128, 3, g, dev)
    with pytest.raises(ValueError, match="contiguous bf16"):
        amp_pair.fused_amp_pair(x, pair, 3, 1)
    with pytest.raises(ValueError, match="conv weight"):
        amp_pair.fused_amp_pair(x.to(BF), pair, 5, 1)
    with pytest.raises(ValueError, match="C <= 384"):
        amp_pair.fused_amp_pair(torch.zeros((1, 8, 392), dtype=BF, device=dev), pair, 3, 1)


def test_wrappers_refuse_autograd(dev):
    """Every kernel wrapper raises on the card when autograd would record
    its call (grad mode on and an input that requires grad): the kernels
    write through ctypes, so their outputs would carry no gradient. Under
    no_grad the same call runs. No refused call is counted as a launch. The
    vocoder's kernel route refuses a training forward; its training route
    (use_kernels=False) runs and reaches every parameter."""
    from svc_inference_pipeline_tpu_torch.checkpoints.from_jax import random_init_
    from svc_inference_pipeline_tpu_torch.models.bigvgan import BigVGANGenerator

    g = torch.Generator(device=dev).manual_seed(7)
    x3 = torch.randn((1, 64, 24), generator=g, device=dev).to(BF)
    alpha, beta = (0.3 * torch.randn(24, generator=g, device=dev) for _ in range(2))
    q = torch.randn((1, 64, 128), generator=g, device=dev).to(BF)
    stage = _stage_params(48, g, dev)
    x2 = (0.5 * torch.randn((1, 100, 48), generator=g, device=dev)).to(BF)
    pair = _pair(48, 3, g, dev)
    st, condb, rows, x, _ = _denoiser_operands(dev, 1, 64, 128, 4, None)
    xp = torch.nn.functional.pad(x, (0, 28)).contiguous()
    srow = (1.2, 0.3, 0.5, 0.4, 0.1)
    calls = {
        "fused_activation1d": (snake.fused_activation1d, lambda a: (a, alpha, beta), x3),
        "fused_amp_stage": (amp_stage.fused_amp_stage, lambda a: (a, stage, KS, DILS), x2),
        "fused_amp_pair": (amp_pair.fused_amp_pair, lambda a: (a, pair, 3, 1), x2),
        "encoder_attention": (attention.encoder_attention, lambda a: (a, q, q, 2), q),
        "ddpm_step": (denoiser_step.ddpm_step, lambda a: (st, condb, rows[3], a, xp, srow), xp),
        "denoise": (denoiser_step.denoise, lambda a: (st, condb, rows[3], a), x),
        "denoise_v2": (denoiser_v2.denoise_v2, lambda a: (st, condb, rows[3], a), x),
    }
    for name, (fn, args, a) in calls.items():
        before = fn.launches
        with pytest.raises(RuntimeError, match="use_kernels=False"):
            fn(*args(a.detach().requires_grad_()))
        assert fn.launches == before, name
        with torch.no_grad():
            fn(*args(a.detach().requires_grad_()))
        with torch.inference_mode():
            fn(*args(a))
        assert fn.launches == before + 2, name
    with pytest.raises(RuntimeError, match="use_kernels=False"):  # a parameter that requires grad
        snake.fused_activation1d(x3, alpha.requires_grad_(), beta)

    vcfg = load_config(os.path.join(REPO, "config", "config.json")).vocoder
    vcfg = HParams(**dict(vcfg.to_dict(), upsample_initial_channel=64, upsample_rates=[4, 4],
                          upsample_kernel_sizes=[8, 8]))
    mel = torch.randn((1, 16, 100), generator=g, device=dev)
    with torch.device(dev):
        serve, train = BigVGANGenerator(vcfg, BF), BigVGANGenerator(vcfg, use_kernels=False)
    for m in (serve, train):
        random_init_(m, torch.Generator(device=dev).manual_seed(8))
    serve.prepare_kernel_params()
    with pytest.raises(RuntimeError, match="use_kernels=False"):
        serve(mel)
    train(mel).square().mean().backward()
    assert all(p.grad is not None and bool(p.grad.abs().max() > 0) for p in train.parameters())


def test_whisper_decoder_incremental_equals_full_prefix_at_medium_width(dev):
    """The text decoder at Whisper-medium's width (24 layers, 1024, 16 heads,
    vocabulary 51865) on random weights: prime + one-token steps over the
    KV buffers equal the full-prefix logits within 2e-4, also after a beam
    reorder of identical rows."""
    from svc_inference_pipeline_tpu_torch.checkpoints.from_jax import random_init_
    from svc_inference_pipeline_tpu_torch.models.whisper import WHISPER_SIZES, WhisperTextDecoder
    from svc_inference_pipeline_tpu_torch.models.whisper_decoding import IncrementalDecoder

    dims = WHISPER_SIZES["medium"]
    g = torch.Generator(device=dev).manual_seed(11)
    with torch.device(dev):
        dec = WhisperTextDecoder(dims)
    random_init_(dec, g)
    feats = torch.randn((1, dims.n_audio_ctx, dims.n_text_state), generator=g, device=dev).repeat(2, 1, 1)
    tokens = np.asarray([[50258, 50259, 50359, 50364, 400, 5000, 23, 50400, 7, 1000]] * 2, np.int32)
    with torch.no_grad():
        full, _ = dec(torch.as_tensor(tokens, dtype=torch.long, device=dev), feats)
    full = full.cpu().numpy()
    inc = IncrementalDecoder(dims, dec)
    logits, cache, offset = inc.prime(tokens[:, :3], feats)
    np.testing.assert_allclose(logits, full[:, :3], rtol=0, atol=2e-4)
    for i in range(3, tokens.shape[1]):
        cache = inc.reorder(cache, [1, 0])
        step, cache = inc.step(tokens[:, i: i + 1], feats, cache, offset)
        offset += 1
        np.testing.assert_allclose(step, full[:, i], rtol=0, atol=2e-4)


@pytest.mark.parametrize("model,n_frames", [("tiny", 1), ("tiny", 1025), ("full", 3)])
def test_crepe_net_on_the_card_equals_the_cpu(dev, model, n_frames):
    """CREPE's net (f32, TF32 off) on the card against the same module on the
    CPU within 1e-4, across the chunks of 512 frames that ``crepe_probs``
    runs (1025 frames: three chunks, the last of one frame)."""
    from svc_inference_pipeline_tpu_torch.ops import f0_crepe

    net = f0_crepe.build_crepe(None, model, "cpu", generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        for p in net.parameters():  # every vector drawn too, BN affine included
            if p.dim() == 1:
                p.add_(0.1 * torch.randn(p.shape, generator=torch.Generator().manual_seed(p.numel())))
    audio = synth_clip(16000, max(n_frames - 1, 1) * 160 / 16000 + 0.01)
    frames = f0_crepe.frame_audio(audio, 160)[:n_frames]
    want = f0_crepe.crepe_probs(net, frames)
    got = f0_crepe.crepe_probs(net.to(dev), frames)
    assert got.shape == want.shape == (n_frames, f0_crepe.N_BINS)
    assert np.abs(got - want).max() <= 1e-4


@pytest.mark.parametrize("n_samples", [16000, 24011])
def test_hubert_on_the_card_equals_the_cpu(dev, n_samples):
    """ContentVec's HuBERT (f32, TF32 off) at a reduced width, 3 layers, on
    the card against the same module on the CPU within 1e-4 of max|cpu|, on
    an even and an odd clip length (the conv stack's floors, the positional
    conv's trimmed frame)."""
    from svc_inference_pipeline_tpu_torch.checkpoints.from_jax import random_init_
    from svc_inference_pipeline_tpu_torch.models.hubert import HubertConfig
    from svc_inference_pipeline_tpu_torch.pipeline.content import ContentVecExtractor

    cfg = HubertConfig(conv_layers=((64, 10, 5),) + ((64, 3, 2),) * 4 + ((64, 2, 2),) * 2, encoder_dim=192,
                       encoder_layers=3, encoder_heads=4, encoder_ffn_dim=384, final_dim=64)
    cpu = ContentVecExtractor.random_init(cfg, generator=torch.Generator().manual_seed(1), device="cpu",
                                          output_layer=3)
    with torch.no_grad():
        for p in cpu.model.parameters():
            if p.dim() == 1:
                p.add_(0.1 * torch.randn(p.shape, generator=torch.Generator().manual_seed(p.numel())))
    audio = synth_clip(24000, n_samples / 24000)
    mel_len = len(audio) // 256
    want = cpu.extract(audio, mel_len)
    card = ContentVecExtractor(cpu.model.to(dev), output_layer=3)
    got = card.extract(audio, mel_len)
    assert got.shape == want.shape == (mel_len, 64)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
