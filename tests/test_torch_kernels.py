"""The port's hand-written CUDA kernels against their plain PyTorch versions
on the card (bf16, the operands of both sides identical).

Every test here needs an NVIDIA GPU with nvcc and skips without one. This
file imports neither JAX nor the JAX package, so it runs on a machine that
has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels.py
"""

import math

import pytest
import torch

from svc_inference_pipeline_tpu_torch.config import HParams
from svc_inference_pipeline_tpu_torch.models.diffsvc import DiffSVCDenoiser
from svc_inference_pipeline_tpu_torch.ops.pallas import _build, amp_stage, attention, denoiser_step, snake

pytestmark = pytest.mark.cuda

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
    for name in ("svc_ddpm_step", "svc_encoder_attention", "svc_activation1d", "svc_conv1d"):
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


@pytest.mark.parametrize("b,t_len,heads,masked_tail", [
    (1, 1500, 16, False), (2, 300, 2, False), (1, 70, 1, False), (1, 1500, 16, True), (2, 300, 2, True)])
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


@pytest.mark.parametrize("t_len,c", [(1536, 768), (3000, 96), (6001, 24), (50, 8)])
def test_k2_amp_stage(dev, t_len, c):
    g = torch.Generator(device=dev).manual_seed(1)
    params = _stage_params(c, g, dev)
    x = (0.5 * torch.randn((1, t_len, c), generator=g, device=dev)).to(BF)
    _close(amp_stage.fused_amp_stage(x, params, KS, DILS), amp_stage.amp_stage_plain(x, params, KS, DILS))


@pytest.mark.parametrize("shape", [(1, 98304, 24), (2, 77, 40), (1, 5, 8)])
def test_k3_activation(dev, shape):
    g = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn(shape, generator=g, device=dev).to(BF)
    alpha, beta = (0.3 * torch.randn(shape[-1], generator=g, device=dev) for _ in range(2))
    got = snake.fused_activation1d(x, alpha, beta)
    _close(got, snake.activation1d_plain(x, *snake.effective_params(alpha, beta)))
    f32 = snake.fused_activation1d(x.float(), alpha, beta)
    _close(f32, snake.activation1d_plain(x.float(), *snake.effective_params(alpha, beta)),
           tol=lambda m: 1e-5 * m)


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    x = torch.randn((1, 64, 128), device=dev)
    with pytest.raises(ValueError, match="bf16"):
        attention.encoder_attention(x, x, x, 2)
    with pytest.raises(ValueError, match="multiple of 8"):
        amp_stage.fused_amp_stage(x[..., :12].to(BF).contiguous(), (), (), ())
