"""Random weights in the reference system's checkpoint layout, drawn from
the run's seed on the device.

Three state dicts, keyed as the reference's own files are: the mapper
(``ModuleList[EncoderFramework, DiffSVC]``: ``0.registered_modules_dict.*``
and ``1.*``), the BigVGAN generator (plain ``weight`` keys, no weight-norm
pair) and the Whisper encoder (OpenAI's ``encoder.*``). Both sides get the
same tensors: the program through its checkpoint converters, the plain
reference directly.

Scales follow the program's random initialisation: every weight of two or
more dimensions N(0, 1/fan_in) with fan_in counted as the program counts
it, the up-convs N(0, 0.01) as the trained model's initialisation draws
them (at 1/fan_in the output saturates tanh), and the 1-D leaves at their
initial value (LayerNorm scales 1, the rest 0) plus N(0, 0.02), so that a
bias or a snake parameter that is read wrongly shows. Weights of two or
more dimensions are rounded to bfloat16, the type they are served in, so
the program's cast loses nothing and the reference sees the same values.
Each model is one draw of a flat buffer, cut into its leaves.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

VEC_STD = 0.02
UP_STD = 0.01

Leaf = Tuple[str, Tuple[int, ...], str]  # key, shape, kind: "w" | "up" | "one" | "vec"


def _linear(key: str, n_in: int, n_out: int, bias: bool = True) -> List[Leaf]:
    return [(f"{key}.weight", (n_out, n_in), "w")] + ([(f"{key}.bias", (n_out,), "vec")] if bias else [])


def _conv(key: str, c_in: int, c_out: int, k: int) -> List[Leaf]:
    return [(f"{key}.weight", (c_out, c_in, k), "w"), (f"{key}.bias", (c_out,), "vec")]


def _ln(key: str, d: int) -> List[Leaf]:
    return [(f"{key}.weight", (d,), "one"), (f"{key}.bias", (d,), "vec")]


def mapper_leaves(mcfg: dict, content_dim: int) -> List[Leaf]:
    pre = "0.registered_modules_dict."
    c, d = mcfg["residual_channels"], mcfg["conditioner_size"]
    fc = mcfg["diffusion_fc_size"]
    leaves = _linear(pre + "content_whisper.nn", content_dim, mcfg["encoder_content_dim"])
    leaves += [(pre + "melody.nn.weight", (mcfg["n_bins_melody"], mcfg["encoder_melody_dim"]), "w"),
               (pre + "loudness.nn.weight", (mcfg["n_bins_loudness"], mcfg["encoder_loudness_dim"]), "w"),
               (pre + "singer.nn.weight", (mcfg["singer_table_size"], mcfg["encoder_singer_dim"]), "w")]
    leaves += _conv("1.mel_preprocess.projection", mcfg["n_mel"], c, 1)
    leaves += _linear("1.diffusion_embedding.projection1", 128, fc)
    leaves += _linear("1.diffusion_embedding.projection2", fc, fc)
    for i in range(mcfg["residual_layer_num"]):
        k = f"1.residual_layers.{i}"
        leaves += _linear(k + ".diffusion_projection", fc, c)
        leaves += _conv(k + ".dilated_conv", c, 2 * c, mcfg["residual_kernel_size"])
        leaves += _conv(k + ".conditioner_projection", d, 2 * c, 1)
        leaves += _conv(k + ".output_projection", c, 2 * c, 1)
    leaves += _conv("1.skip_projection", c, c, 1)
    leaves += _conv("1.output_projection", c, mcfg["n_mel"], 1)
    return leaves


def vocoder_leaves(vcfg: dict) -> List[Leaf]:
    ch = vcfg["upsample_initial_channel"]
    leaves = _conv("conv_pre", vcfg["input_dim"], ch, 7)
    nk = len(vcfg["resblock_kernel_sizes"])
    for i, (u, k) in enumerate(zip(vcfg["upsample_rates"], vcfg["upsample_kernel_sizes"])):
        c_in, ch = ch, ch // 2
        leaves += [(f"ups.{i}.0.weight", (c_in, ch, k), "up"), (f"ups.{i}.0.bias", (ch,), "vec")]
        for j, (rk, dils) in enumerate(zip(vcfg["resblock_kernel_sizes"], vcfg["resblock_dilation_sizes"])):
            base = f"resblocks.{i * nk + j}"
            for m in range(len(dils)):
                leaves += _conv(f"{base}.convs1.{m}", ch, ch, rk) + _conv(f"{base}.convs2.{m}", ch, ch, rk)
            for a in range(2 * len(dils)):
                leaves += [(f"{base}.activations.{a}.act.alpha", (ch,), "vec"),
                           (f"{base}.activations.{a}.act.beta", (ch,), "vec")]
    leaves += [("activation_post.act.alpha", (ch,), "vec"), ("activation_post.act.beta", (ch,), "vec")]
    return leaves + _conv("conv_post", ch, 1, 7)


def whisper_leaves(dims: dict) -> List[Leaf]:
    d = dims["n_audio_state"]
    leaves = _conv("encoder.conv1", dims["n_mels"], d, 3) + _conv("encoder.conv2", d, d, 3)
    for i in range(dims["n_audio_layer"]):
        k = f"encoder.blocks.{i}"
        leaves += (_linear(k + ".attn.query", d, d) + _linear(k + ".attn.key", d, d, bias=False)
                   + _linear(k + ".attn.value", d, d) + _linear(k + ".attn.out", d, d) + _ln(k + ".attn_ln", d)
                   + _linear(k + ".mlp.0", d, 4 * d) + _linear(k + ".mlp.2", 4 * d, d) + _ln(k + ".mlp_ln", d))
    return leaves + _ln("encoder.ln_post", d)


def _draw(leaves: List[Leaf], g: torch.Generator, embeddings: frozenset) -> Dict[str, torch.Tensor]:
    total = sum(math.prod(s) for _, s, _ in leaves)
    flat = torch.randn(total, generator=g, device=g.device)
    out, at = {}, 0
    for key, shape, kind in leaves:
        n = math.prod(shape)
        v = flat[at:at + n].view(shape)
        at += n
        if kind == "w":
            # fan-in as the program counts it: rows of an embedding table,
            # in-features of a Linear, C_in * k of a conv
            fan = shape[0] if key in embeddings else (shape[1] * shape[2] if len(shape) == 3 else shape[1])
            v = (v / math.sqrt(fan)).to(torch.bfloat16).float()
        elif kind == "up":
            v = (v * UP_STD).to(torch.bfloat16).float()
        else:
            v = v * VEC_STD + (1.0 if kind == "one" else 0.0)
        out[key] = v
    return out


def make_weights(cfg: dict, seed: int, device) -> Dict[str, Dict[str, torch.Tensor]]:
    """{"mapper", "vocoder", "whisper"} state dicts of float32 tensors on
    ``device``, the same for the same ``seed``."""
    dims = cfg["whisper_dims"]
    parts = {"mapper": mapper_leaves(cfg["mapper"], dims["n_audio_state"]),
             "vocoder": vocoder_leaves(cfg["vocoder"]),
             "whisper": whisper_leaves(dims)}
    embeddings = frozenset(f"0.registered_modules_dict.{n}.nn.weight" for n in ("melody", "loudness", "singer"))
    out = {}
    for tag, (name, leaves) in enumerate(parts.items()):
        state = np.random.SeedSequence([int(seed), 0x5EED, tag]).generate_state(2, dtype=np.uint32)
        g = torch.Generator(device=torch.device(device)).manual_seed(int(state[0]) << 32 | int(state[1]))
        out[name] = _draw(leaves, g, embeddings)
    return out
