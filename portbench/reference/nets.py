"""The networks of the plain reference, read straight from checkpoint-layout
weights (the keys of the reference system's own ``.pt`` files): the Whisper
encoder (OpenAI's layout), the condition encoder and DiffSVC denoiser
(Amphion's ``ModuleList[EncoderFramework, DiffSVC]``) and the BigVGAN
generator (resblock "1", SnakeBeta with log-scale parameters, the
alias-free 2x up / 2x down activation).

Every matrix product and convolution goes through :class:`Precision`:
float32 with TF32 off for the reference, or operands rounded to float8
e4m3 (a scale per tensor) for the control that has to fail the check.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

FP8_MAX = 448.0


class Precision:
    """``"f32"``: operands as they are; ``"fp8"``: each operand of a product
    rounded to float8 e4m3 after scaling its abs max to 448."""

    def __init__(self, kind: str = "f32"):
        if kind not in ("f32", "fp8"):
            raise ValueError(f"precision {kind!r}")
        self.kind = kind

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        if self.kind == "f32":
            return t
        s = t.abs().amax().clamp(min=1e-30) / FP8_MAX
        return (t / s).to(torch.float8_e4m3fn).float() * s

    def linear(self, x, w, b=None):
        return F.linear(self(x), self(w), b)

    def conv1d(self, x, w, b=None, **kw):
        return F.conv1d(self(x), self(w), b, **kw)

    def conv_transpose1d(self, x, w, b=None, **kw):
        return F.conv_transpose1d(self(x), self(w), b, **kw)

    def matmul(self, a, b):
        return self(a) @ self(b)


# ---------------------------------------------------------------------------
# Whisper encoder
# ---------------------------------------------------------------------------


def _sinusoids(length: int, channels: int) -> torch.Tensor:
    inc = math.log(10000.0) / (channels // 2 - 1)
    inv = np.exp(-inc * np.arange(channels // 2))
    t = np.arange(length)[:, None] * inv[None, :]
    return torch.tensor(np.concatenate([np.sin(t), np.cos(t)], axis=1), dtype=torch.float32)


def whisper_encode(sd: dict, mel: torch.Tensor, n_head: int, p: Precision) -> torch.Tensor:
    """[80, 3000] log-mel -> [1500, d] features."""
    def ln(x, k):
        return F.layer_norm(x, x.shape[-1:], sd[k + ".weight"], sd[k + ".bias"], 1e-5)

    x = F.gelu(p.conv1d(mel[None], sd["encoder.conv1.weight"], sd["encoder.conv1.bias"], padding=1))
    x = F.gelu(p.conv1d(x, sd["encoder.conv2.weight"], sd["encoder.conv2.bias"], stride=2, padding=1))[0].T
    x = x + _sinusoids(x.shape[0], x.shape[1]).to(x.device)
    n, d = x.shape
    hd = d // n_head
    i = 0
    while f"encoder.blocks.{i}.attn.query.weight" in sd:
        k = f"encoder.blocks.{i}"
        h = ln(x, k + ".attn_ln")
        q = p.linear(h, sd[k + ".attn.query.weight"], sd[k + ".attn.query.bias"]).reshape(n, n_head, hd)
        kk = p.linear(h, sd[k + ".attn.key.weight"]).reshape(n, n_head, hd)
        v = p.linear(h, sd[k + ".attn.value.weight"], sd[k + ".attn.value.bias"]).reshape(n, n_head, hd)
        scores = p.matmul(q.transpose(0, 1), kk.permute(1, 2, 0)) / math.sqrt(hd)
        o = p.matmul(torch.softmax(scores, dim=-1), v.transpose(0, 1)).transpose(0, 1).reshape(n, d)
        x = x + p.linear(o, sd[k + ".attn.out.weight"], sd[k + ".attn.out.bias"])
        h = ln(x, k + ".mlp_ln")
        h = F.gelu(p.linear(h, sd[k + ".mlp.0.weight"], sd[k + ".mlp.0.bias"]))
        x = x + p.linear(h, sd[k + ".mlp.2.weight"], sd[k + ".mlp.2.bias"])
        i += 1
    return ln(x, "encoder.ln_post")


# ---------------------------------------------------------------------------
# Condition encoder + DiffSVC denoiser (Amphion layout: "0." / "1." prefixes)
# ---------------------------------------------------------------------------

C1_HZ = 440.0 * 2.0 ** ((24 - 69) / 12.0)
C7_HZ = 440.0 * 2.0 ** ((96 - 69) / 12.0)


def condition(sd: dict, content: torch.Tensor, f0: torch.Tensor, energy: torch.Tensor, singer: int,
              mcfg: dict, p: Precision) -> torch.Tensor:
    """Conditioner [T, D]: content projection + melody, loudness and singer
    embeddings, each bucketised over n_bins-1 log-spaced boundaries
    (melody (C1 - 0.1 Hz, C7], loudness [1e-30, 1.5]), summed."""
    pre = "0.registered_modules_dict."
    dev = content.device
    mel_b = torch.tensor(np.exp(np.linspace(np.log(C1_HZ - 0.1), np.log(C7_HZ), mcfg["n_bins_melody"] - 1))
                         .astype(np.float32), device=dev)
    loud_b = torch.tensor(np.exp(np.linspace(np.log(1e-30), np.log(1.5), mcfg["n_bins_loudness"] - 1))
                          .astype(np.float32), device=dev)
    out = p.linear(content, sd[pre + "content_whisper.nn.weight"], sd[pre + "content_whisper.nn.bias"])
    out = out + sd[pre + "melody.nn.weight"][torch.searchsorted(mel_b, f0)]
    out = out + sd[pre + "loudness.nn.weight"][torch.searchsorted(loud_b, energy)]
    return out + sd[pre + "singer.nn.weight"][singer][None, :]


def step_embedding(t: int, dim: int, device) -> torch.Tensor:
    """DiffWave's sinusoidal step embedding: t * 10^(4i/(half-1)), sin || cos,
    the timescales rounded to float32 from a float64 power."""
    half = dim // 2
    scales = (10.0 ** (np.arange(half, dtype=np.float32) * 4.0 / (half - 1)).astype(np.float64)).astype(np.float32)
    args = torch.tensor(float(t), dtype=torch.float32, device=device) * torch.tensor(scales, device=device)
    return torch.cat([torch.sin(args), torch.cos(args)])


class Denoiser:
    """eps(x_t, t) over one clip's conditioner: x [M, T] -> eps [M, T]."""

    def __init__(self, sd: dict, cond: torch.Tensor, mcfg: dict, p: Precision):
        self.sd, self.p, self.mcfg = sd, p, mcfg
        self.n_layers = mcfg["residual_layer_num"]
        self.cycle = mcfg["dilation_cycle_length"]
        c = cond.T[None]  # [1, D, T]
        self.cond_proj = [p.conv1d(c, sd[f"1.residual_layers.{i}.conditioner_projection.weight"],
                                   sd[f"1.residual_layers.{i}.conditioner_projection.bias"])
                          for i in range(self.n_layers)]

    def __call__(self, x: torch.Tensor, t: int) -> torch.Tensor:
        sd, p = self.sd, self.p
        h = F.relu(p.conv1d(x[None], sd["1.mel_preprocess.projection.weight"],
                            sd["1.mel_preprocess.projection.bias"]))
        e = step_embedding(t, 128, x.device)
        e = F.silu(p.linear(e, sd["1.diffusion_embedding.projection1.weight"],
                            sd["1.diffusion_embedding.projection1.bias"]))
        e = F.silu(p.linear(e, sd["1.diffusion_embedding.projection2.weight"],
                            sd["1.diffusion_embedding.projection2.bias"]))
        skip = 0.0
        for i in range(self.n_layers):
            k = f"1.residual_layers.{i}"
            d = 2 ** (i % self.cycle)
            y = h + p.linear(e, sd[k + ".diffusion_projection.weight"], sd[k + ".diffusion_projection.bias"])[None, :, None]
            y = p.conv1d(y, sd[k + ".dilated_conv.weight"], sd[k + ".dilated_conv.bias"], padding=d, dilation=d)
            y = y + self.cond_proj[i]
            gate, filt = y.chunk(2, dim=1)
            y = p.conv1d(torch.sigmoid(gate) * torch.tanh(filt), sd[k + ".output_projection.weight"],
                         sd[k + ".output_projection.bias"])
            residual, s = y.chunk(2, dim=1)
            h = (h + residual) / math.sqrt(2.0)
            skip = skip + s
        x = skip / math.sqrt(self.n_layers)
        x = F.relu(p.conv1d(x, sd["1.skip_projection.weight"], sd["1.skip_projection.bias"]))
        return p.conv1d(x, sd["1.output_projection.weight"], sd["1.output_projection.bias"])[0]


# ---------------------------------------------------------------------------
# BigVGAN generator
# ---------------------------------------------------------------------------


def kaiser_sinc(cutoff: float, half_width: float, kernel_size: int) -> np.ndarray:
    """BigVGAN's kaiser_sinc_filter1d, sum-normalised (float64 -> float32)."""
    half = kernel_size // 2
    a = 2.285 * (half - 1) * math.pi * 4.0 * half_width + 7.95
    beta = 0.1102 * (a - 8.7) if a > 50.0 else (0.5842 * (a - 21) ** 0.4 + 0.07886 * (a - 21) if a >= 21 else 0.0)
    k = np.arange(kernel_size, dtype=np.float64)
    xk = 2.0 * k / (kernel_size - 1) - 1.0
    window = np.i0(beta * np.sqrt(np.maximum(0.0, 1.0 - xk * xk))) / np.i0(beta)
    time = (np.arange(-half, half) + 0.5) if kernel_size % 2 == 0 else (np.arange(kernel_size) - half)
    filt = 2.0 * cutoff * window * np.sinc(2.0 * cutoff * time)
    return (filt / filt.sum()).astype(np.float32)


_FIR = kaiser_sinc(0.25, 0.3, 12)


def snake_activation(x: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """Activation1d(SnakeBeta, log scale): 2x up (kernel 12), x + sin^2(a x)/b,
    2x down (kernel 12), on [1, C, T]."""
    c = x.shape[1]
    filt = torch.as_tensor(_FIR, device=x.device).view(1, 1, -1).expand(c, 1, -1)
    y = 2 * F.conv_transpose1d(F.pad(x, (5, 5), mode="replicate"), filt, stride=2, groups=c)
    y = y[..., 15:-15]
    a, b = torch.exp(alpha)[None, :, None], torch.exp(beta)[None, :, None]
    y = y + (1.0 / (b + 1e-9)) * torch.sin(y * a) ** 2
    return F.conv1d(F.pad(y, (5, 6), mode="replicate"), filt, stride=2, groups=c)


def vocode(sd: dict, mel: torch.Tensor, vcfg: dict, p: Precision) -> torch.Tensor:
    """mel [M, T] -> waveform [T * prod(upsample_rates)]."""
    def conv(x, k, dilation=1):
        w = sd[k + ".weight"]
        return p.conv1d(x, w, sd[k + ".bias"], dilation=dilation, padding=dilation * (w.shape[-1] - 1) // 2)

    def act(x, k):
        return snake_activation(x, sd[k + ".act.alpha"], sd[k + ".act.beta"])

    x = conv(mel[None], "conv_pre")
    nk = len(vcfg["resblock_kernel_sizes"])
    for i, (u, k) in enumerate(zip(vcfg["upsample_rates"], vcfg["upsample_kernel_sizes"])):
        x = p.conv_transpose1d(x, sd[f"ups.{i}.0.weight"], sd[f"ups.{i}.0.bias"], stride=u, padding=(k - u) // 2)
        acc = 0.0
        for j, dils in enumerate(vcfg["resblock_dilation_sizes"]):
            base, y = f"resblocks.{i * nk + j}", x
            for m, d in enumerate(dils):
                xt = conv(act(y, f"{base}.activations.{2 * m}"), f"{base}.convs1.{m}", d)
                y = conv(act(xt, f"{base}.activations.{2 * m + 1}"), f"{base}.convs2.{m}") + y
            acc = acc + y
        x = acc / nk
    x = conv(act(x, "activation_post"), "conv_post")
    return torch.tanh(x)[0, 0]
