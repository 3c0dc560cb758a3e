"""Reference PyTorch checkpoints -> parameter trees in the JAX layout (numpy).

Counterpart of ``svc_inference_pipeline_tpu/checkpoints/torch_convert.py``,
returning the same numpy trees, which the port then loads through its
weights bridge (``checkpoints/from_jax.py::load_jax_params``, strict):

* ``module.`` DDP-prefix stripping (the reference's utils/load_models.py).
  Each converter reads the keys it names: a missing key raises ``KeyError``,
  and the bridge rejects a parameter of the wrong shape. Nothing is filtered
  by shape;
* weight-norm folding: the reference keeps the g·v/‖v‖ parametrisation live
  at every step (its Generator never calls remove_weight_norm); it is folded
  into plain weights once, in float64;
* torch layout -> channels-last layout (Conv1d [Cout,Cin,K] -> [K,Cin,Cout];
  ConvTranspose1d [Cin,Cout,K] -> [K,Cout,Cin]; Linear [Dout,Din] ->
  [Din,Dout]).

Checkpoint key schemas converted:
* mapper ``state_dict``: ModuleList[EncoderFramework, DiffSVC],
* vocoder ``generator_state_dict``: the BigVGAN Generator,
* Whisper ``model_state_dict`` + ``dims`` (OpenAI's file layout).
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Mapping, Tuple

import numpy as np

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# Generic helpers
# ---------------------------------------------------------------------------


def _to_numpy(t) -> np.ndarray:
    if isinstance(t, np.ndarray):
        return t
    return t.detach().cpu().numpy()


def strip_ddp_prefix(state_dict: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """Strip a leading ``module.`` (a DataParallel wrapper's prefix)."""
    return {k.split("module.")[-1]: _to_numpy(v) for k, v in state_dict.items()}


def fold_weight_norm(state_dict: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Fold ``weight_g``/``weight_v`` pairs into plain ``weight`` entries.

    torch's weight_norm(dim=d): w = g · v / ‖v‖ with the norm over all dims
    except d. The dim is inferred from g's shape (size 1 everywhere except
    d): BigVGAN uses the default dim=0, HuBERT's pos_conv dim=2. New-style
    ``parametrizations.weight.original0/1`` keys are renamed to
    weight_g/weight_v first.
    """
    renamed = {}
    for k, v in state_dict.items():
        nk = k.replace("parametrizations.weight.original0", "weight_g")
        nk = nk.replace("parametrizations.weight.original1", "weight_v")
        renamed[nk] = v

    out: Dict[str, np.ndarray] = {}
    for key, value in renamed.items():
        if key.endswith("weight_v"):
            base = key[: -len("weight_v")]
            g = np.asarray(renamed[base + "weight_g"], dtype=np.float64)
            v = np.asarray(value, dtype=np.float64)
            non_unit = [d for d in range(g.ndim) if g.shape[d] != 1]
            dim = non_unit[0] if non_unit else 0
            axes = tuple(d for d in range(v.ndim) if d != dim)
            norm = np.sqrt(np.sum(v * v, axis=axes, keepdims=True))
            out[base + "weight"] = (g * v / norm).astype(np.float32)
        elif key.endswith("weight_g"):
            continue
        else:
            out[key] = np.asarray(value)
    return out


def _linear(sd: Mapping[str, np.ndarray], prefix: str) -> Params:
    p: Params = {"kernel": sd[f"{prefix}.weight"].T}
    if f"{prefix}.bias" in sd:
        p["bias"] = sd[f"{prefix}.bias"]
    return p


def _conv1x1_as_dense(sd: Mapping[str, np.ndarray], prefix: str) -> Params:
    w = sd[f"{prefix}.weight"]  # [Cout, Cin, 1]
    p: Params = {"kernel": w[:, :, 0].T}
    if f"{prefix}.bias" in sd:
        p["bias"] = sd[f"{prefix}.bias"]
    return p


def _conv1d(sd: Mapping[str, np.ndarray], prefix: str) -> Params:
    w = sd[f"{prefix}.weight"]  # [Cout, Cin, K]
    p: Params = {"kernel": w.transpose(2, 1, 0)}
    if f"{prefix}.bias" in sd:
        p["bias"] = sd[f"{prefix}.bias"]
    return p


def _conv_transpose1d(sd: Mapping[str, np.ndarray], prefix: str) -> Params:
    w = sd[f"{prefix}.weight"]  # [Cin, Cout, K]
    p: Params = {"kernel": w.transpose(2, 1, 0)}
    if f"{prefix}.bias" in sd:
        p["bias"] = sd[f"{prefix}.bias"]
    return p


# ---------------------------------------------------------------------------
# Mapper: EncoderFramework (index 0) + DiffSVC (index 1)
# ---------------------------------------------------------------------------


def convert_mapper_state_dict(state_dict: Mapping[str, Any], cfg) -> Tuple[Params, Params]:
    """torch ModuleList state_dict -> (cond_encoder_params, denoiser_params).

    ``cfg`` is the mapper config subtree.
    """
    sd = strip_ddp_prefix(state_dict)

    enc: Params = {}
    for content_type in cfg.content_feature:
        key = f"0.registered_modules_dict.content_{content_type}.nn"
        if f"{key}.weight" in sd:
            enc[f"content_{content_type}"] = _linear(sd, key)
    for name in ("melody", "loudness", "singer"):
        key = f"0.registered_modules_dict.{name}.nn.weight"
        if key in sd:
            enc[name] = {"embedding": sd[key]}

    den: Params = {
        "mel_preprocess": _conv1x1_as_dense(sd, "1.mel_preprocess.projection"),
        "diffusion_embedding": {
            "projection1": _linear(sd, "1.diffusion_embedding.projection1"),
            "projection2": _linear(sd, "1.diffusion_embedding.projection2"),
        },
        "skip_projection": _conv1x1_as_dense(sd, "1.skip_projection"),
        "output_projection": _conv1x1_as_dense(sd, "1.output_projection"),
    }
    for i in range(cfg.residual_layer_num):
        base = f"1.residual_layers.{i}"
        den[f"residual_{i}"] = {
            "diffusion_projection": _linear(sd, f"{base}.diffusion_projection"),
            "dilated_conv": _conv1d(sd, f"{base}.dilated_conv"),
            "conditioner_projection": _conv1x1_as_dense(sd, f"{base}.conditioner_projection"),
            "output_projection": _conv1x1_as_dense(sd, f"{base}.output_projection"),
        }
    return enc, den


# ---------------------------------------------------------------------------
# Vocoder: BigVGAN Generator
# ---------------------------------------------------------------------------


def convert_vocoder_state_dict(state_dict: Mapping[str, Any], cfg) -> Params:
    """torch Generator state_dict -> BigVGANGenerator params (weight norm
    folded). ``cfg`` is the vocoder config subtree."""
    sd = fold_weight_norm(strip_ddp_prefix(state_dict))
    num_kernels = len(cfg.resblock_kernel_sizes)

    params: Params = {
        "conv_pre": {"conv": _conv1d(sd, "conv_pre")},
        "conv_post": {"conv": _conv1d(sd, "conv_post")},
    }
    for i in range(len(cfg.upsample_rates)):
        params[f"up_{i}"] = _conv_transpose1d(sd, f"ups.{i}.0")

    amp1 = cfg.resblock == "1"
    for i in range(len(cfg.upsample_rates)):
        for j in range(num_kernels):
            base = f"resblocks.{i * num_kernels + j}"
            block: Params = {}
            for k in range(len(cfg.resblock_dilation_sizes[j])):
                if amp1:
                    block[f"conv1_{k}"] = {"conv": _conv1d(sd, f"{base}.convs1.{k}")}
                    block[f"conv2_{k}"] = {"conv": _conv1d(sd, f"{base}.convs2.{k}")}
                    block[f"act1_{k}"] = _act_params(sd, f"{base}.activations.{2 * k}")
                    block[f"act2_{k}"] = _act_params(sd, f"{base}.activations.{2 * k + 1}")
                else:
                    block[f"conv_{k}"] = {"conv": _conv1d(sd, f"{base}.convs.{k}")}
                    block[f"act_{k}"] = _act_params(sd, f"{base}.activations.{k}")
            params[f"resblock_{i}_{j}"] = block

    params["activation_post"] = _act_params(sd, "activation_post")
    return params


def _act_params(sd: Mapping[str, np.ndarray], prefix: str) -> Params:
    p: Params = {"alpha": sd[f"{prefix}.act.alpha"]}
    if f"{prefix}.act.beta" in sd:
        p["beta"] = sd[f"{prefix}.act.beta"]
    return p


# ---------------------------------------------------------------------------
# Whisper
# ---------------------------------------------------------------------------


def convert_whisper_state_dict(state_dict: Mapping[str, Any], encoder_only: bool = True) -> Params:
    """Whisper ``model_state_dict`` -> the encoder tree, or with
    ``encoder_only=False`` ``{"encoder": ..., "decoder": ...}``."""
    sd = strip_ddp_prefix(state_dict)

    def ln(prefix):
        return {"scale": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"]}

    def attn(prefix):
        return {
            "query": _linear(sd, f"{prefix}.query"),
            "key": {"kernel": sd[f"{prefix}.key.weight"].T},
            "value": _linear(sd, f"{prefix}.value"),
            "out": _linear(sd, f"{prefix}.out"),
        }

    def block(prefix, cross: bool):
        p = {
            "attn": attn(f"{prefix}.attn"),
            "attn_ln": ln(f"{prefix}.attn_ln"),
            "mlp_0": _linear(sd, f"{prefix}.mlp.0"),
            "mlp_2": _linear(sd, f"{prefix}.mlp.2"),
            "mlp_ln": ln(f"{prefix}.mlp_ln"),
        }
        if cross:
            p["cross_attn"] = attn(f"{prefix}.cross_attn")
            p["cross_attn_ln"] = ln(f"{prefix}.cross_attn_ln")
        return p

    def n_blocks(stack):
        return max(int(m.group(1)) + 1 for k in sd if (m := re.match(rf"{stack}\.blocks\.(\d+)\.", k)))

    enc: Params = {
        "conv1": _conv1d(sd, "encoder.conv1"),
        "conv2": _conv1d(sd, "encoder.conv2"),
        "ln_post": ln("encoder.ln_post"),
    }
    for i in range(n_blocks("encoder")):
        enc[f"block_{i}"] = block(f"encoder.blocks.{i}", cross=False)
    if encoder_only:
        return enc

    dec: Params = {
        "token_embedding": {"embedding": sd["decoder.token_embedding.weight"]},
        "positional_embedding": sd["decoder.positional_embedding"],
        "ln": ln("decoder.ln"),
    }
    for i in range(n_blocks("decoder")):
        dec[f"block_{i}"] = block(f"decoder.blocks.{i}", cross=True)
    return {"encoder": enc, "decoder": dec}


# ---------------------------------------------------------------------------
# File-level loaders
# ---------------------------------------------------------------------------


def _torch_load(path: str) -> Dict[str, Any]:
    import torch

    return torch.load(path, map_location="cpu", weights_only=False)


# Digests of OpenAI's published Whisper checkpoints: the sha256 components of
# the reference's download-URL registry. A local file that claims to be one
# of these models must match its digest.
WHISPER_SHA256: Dict[str, str] = {
    "tiny.en": "d3dd57d32accea0b295c96e26691aa14d8822fac7d9d27d5dc00b4ca2826dd03",
    "tiny": "65147644a518d12f04e32d6f3b26facc3f8dd46e5390956a9424a650c0ce22b9",
    "base.en": "25a8566e1d0c1e2231d1c762132cd20e0f96a85d16145c3a00adf5d1ac670ead",
    "base": "ed3a0b6b1c0edf879ad9b11b1af5a0e6ab5db9205f891f668f8b0e6c6326e34e",
    "small.en": "f953ad0fd29cacd07d5a9eda5624af0f6bcf2258be67c92b79389873d91e0872",
    "small": "9ecf779972d90ba49c06d968637d720dd632c55bbf19d441fb42bf17a411e794",
    "medium.en": "d7440d1dc186f76616474e0ff0b3b6b879abc9d1a4926b7adfa41db2d497ab4f",
    "medium": "345ae4da62f9b3d59415adc60127b97c714f32e89e936602e85993674d08dcb1",
    "large-v1": "e4b87e7e0bf463eb8e6956e646f1e277e901512310def2c24bf0e11bd3c28e9a",
    "large-v2": "81f7c96c852ee8fc832187b0132e569d6c3065a3252ed18e56effd0b6a73e524",
    "large": "81f7c96c852ee8fc832187b0132e569d6c3065a3252ed18e56effd0b6a73e524",
}


def file_sha256(path: str) -> str:
    import hashlib

    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def verify_sha256(path: str, expected: str) -> None:
    """Raise RuntimeError when ``path`` does not hash to ``expected`` (the
    reference's post-download integrity rule, applied to a local file)."""
    actual = file_sha256(path)
    if actual != expected.lower():
        raise RuntimeError(
            f"{path}: SHA256 checksum does not match (expected {expected}, "
            f"got {actual}); the checkpoint is corrupt or mislabelled"
        )


def load_mapper_params(path: str, cfg, expected_sha256: str | None = None) -> Tuple[Params, Params]:
    """Load and convert a mapper ``.pt`` checkpoint (key ``state_dict``)."""
    if expected_sha256:
        verify_sha256(path, expected_sha256)
    ckpt = _torch_load(path)
    return convert_mapper_state_dict(ckpt["state_dict"], cfg)


def load_vocoder_params(path: str, cfg, expected_sha256: str | None = None) -> Params:
    """Load and convert a vocoder ``.pt`` checkpoint (``generator_state_dict``)."""
    if expected_sha256:
        verify_sha256(path, expected_sha256)
    ckpt = _torch_load(path)
    return convert_vocoder_state_dict(ckpt["generator_state_dict"], cfg)


def load_whisper(
    path_or_name: str,
    download_root: str | None = None,
    expected_sha256: str | None = None,
    verify: bool = True,
):
    """Load a Whisper checkpoint -> (dims dict, {"encoder", "decoder"} trees).

    Takes a file path (registry names resolve through
    ``checkpoints/fetch.py``). An explicit ``expected_sha256`` is always
    checked; a file named after an official model (``medium.pt``, ...) is
    checked against WHISPER_SHA256 unless ``verify=False``. Official files
    hold fp16 tensors, which stay fp16 in the returned trees.
    """
    expected = expected_sha256
    if expected is None and verify:
        stem = os.path.splitext(os.path.basename(path_or_name))[0]
        expected = WHISPER_SHA256.get(stem)
    if expected:
        verify_sha256(path_or_name, expected)
    ckpt = _torch_load(path_or_name)
    return ckpt["dims"], convert_whisper_state_dict(ckpt["model_state_dict"], encoder_only=False)
