"""fairseq HuBERT/ContentVec checkpoints -> parameter trees in the JAX layout
(numpy).

Counterpart of ``svc_inference_pipeline_tpu/checkpoints/hubert_convert.py``,
returning the same trees, which ``pipeline/content.py`` loads into the port's
``HubertModel`` through the weights bridge (``checkpoints/from_jax.py``).
The fairseq ``model`` state dict is converted directly, without fairseq:
``module.`` prefixes stripped, the positional conv's weight-norm pair
(``weight_g``/``weight_v``, dim 2) folded in float64 by
``torch_convert.fold_weight_norm``, torch layouts to channels-last. A
``transformers`` HubertModel state dict is renamed into the fairseq layout
first by :func:`transformers_to_fairseq_keys` (the tests' source of
weights); ``transformers`` itself is not imported.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

from svc_inference_pipeline_tpu_torch.checkpoints.torch_convert import (
    _linear,
    fold_weight_norm,
    strip_ddp_prefix,
)
from svc_inference_pipeline_tpu_torch.models.hubert import HubertConfig

Params = Dict[str, Any]


def _ln(sd, prefix):
    return {"scale": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"]}


def convert_hubert_state_dict(state_dict: Mapping[str, Any], cfg: HubertConfig = HubertConfig()) -> Params:
    """fairseq HubertModel state dict -> ``models/hubert.py``'s tree."""
    sd = fold_weight_norm(strip_ddp_prefix(state_dict))

    fe: Params = {}
    for i in range(len(cfg.conv_layers)):
        w = sd[f"feature_extractor.conv_layers.{i}.0.weight"]  # [Cout, Cin, K]
        fe[f"conv_{i}"] = {"kernel": w.transpose(2, 1, 0)}
    # the group norm after conv 0 (index 2 in fairseq's layer Sequential)
    fe["group_norm"] = {
        "scale": sd["feature_extractor.conv_layers.0.2.weight"],
        "bias": sd["feature_extractor.conv_layers.0.2.bias"],
    }

    params: Params = {
        "feature_extractor": fe,
        "layer_norm": _ln(sd, "layer_norm"),
        "post_extract_proj": _linear(sd, "post_extract_proj"),
        "pos_conv": {
            "kernel": sd["encoder.pos_conv.0.weight"].transpose(2, 1, 0),  # [C, C/groups, K] -> [K, C/groups, C]
            "bias": sd["encoder.pos_conv.0.bias"],
        },
        "encoder_layer_norm": _ln(sd, "encoder.layer_norm"),
    }
    if "final_proj.weight" in sd:
        params["final_proj"] = _linear(sd, "final_proj")

    for i in range(cfg.encoder_layers):
        base = f"encoder.layers.{i}"
        params[f"layer_{i}"] = {
            "self_attn": {k: _linear(sd, f"{base}.self_attn.{k}") for k in ("q_proj", "k_proj", "v_proj", "out_proj")},
            "self_attn_layer_norm": _ln(sd, f"{base}.self_attn_layer_norm"),
            "fc1": _linear(sd, f"{base}.fc1"),
            "fc2": _linear(sd, f"{base}.fc2"),
            "final_layer_norm": _ln(sd, f"{base}.final_layer_norm"),
        }
    return params


def transformers_to_fairseq_keys(state_dict: Mapping[str, Any]) -> Dict[str, Any]:
    """Rename a transformers HubertModel state dict into the fairseq layout
    (the keys :func:`convert_hubert_state_dict` reads); parametrized
    weight-norm keys (``parametrizations.weight.original0/1``) become
    ``weight_g``/``weight_v``."""
    out: Dict[str, Any] = {}
    for k, v in state_dict.items():
        nk = k
        # conv layers: transformers' .conv / .layer_norm -> fairseq's .0 / .2
        if ".conv.weight" in nk and "conv_layers" in nk:
            nk = nk.replace(".conv.weight", ".0.weight")
        if "conv_layers.0.layer_norm" in nk:
            nk = nk.replace(".layer_norm.", ".2.")
        if nk.startswith("feature_projection.layer_norm"):
            nk = nk.replace("feature_projection.layer_norm", "layer_norm")
        if nk.startswith("feature_projection.projection"):
            nk = nk.replace("feature_projection.projection", "post_extract_proj")
        if nk.startswith("encoder.pos_conv_embed.conv"):
            nk = nk.replace("encoder.pos_conv_embed.conv", "encoder.pos_conv.0")
            nk = nk.replace("parametrizations.weight.original0", "weight_g")
            nk = nk.replace("parametrizations.weight.original1", "weight_v")
        if ".attention." in nk:
            nk = nk.replace(".attention.", ".self_attn.")
        if ".feed_forward.intermediate_dense" in nk:
            nk = nk.replace(".feed_forward.intermediate_dense", ".fc1")
        if ".feed_forward.output_dense" in nk:
            nk = nk.replace(".feed_forward.output_dense", ".fc2")
        if (".layer_norm." in nk and "encoder.layers" in nk and "self_attn_layer_norm" not in nk
                and "final_layer_norm" not in nk):
            nk = nk.replace(".layer_norm.", ".self_attn_layer_norm.")
        out[nk] = v
    return out


def load_hubert(path: str) -> Tuple[HubertConfig, Params]:
    """A fairseq ``.pt`` checkpoint -> (HuBERT-base config, tree). Only the
    ``model`` entry is read (or ``state_dict``, or the file itself when it
    is a bare state dict); fairseq pickles ``args``/``cfg`` objects beside
    it, so the file is unpickled in full (``weights_only=False``): load only
    files you trust."""
    import torch

    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("model", ckpt.get("state_dict", ckpt))
    cfg = HubertConfig()
    return cfg, convert_hubert_state_dict(sd, cfg)
