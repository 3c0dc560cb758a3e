"""Weights bridge: JAX parameter trees (as numpy) -> the port's modules, and
the port's own random initialisation.

The port names its submodules after the JAX modules (``residual_3``,
``block_7``, ``resblock_2_1/conv1_0/conv``, ...), so a JAX leaf path
``a/b/.../leaf`` addresses the submodule ``a.b....`` and the leaf name with
that submodule's type decides the layout change:

====================  ==========  ====================================
submodule             JAX leaf    PyTorch parameter
====================  ==========  ====================================
nn.Linear             kernel      weight = kernel.T  ([in,out] -> [out,in])
nn.Conv1d             kernel      weight = [k,Cin,Cout] -> [Cout,Cin,k]
nn.ConvTranspose1d    kernel      weight = [K,Cout,Cin] -> [Cin,Cout,K]
nn.Embedding          embedding   weight
nn.LayerNorm          scale       weight
nn.GroupNorm          scale       weight
any                   bias        bias
Activation1d          alpha/beta  alpha/beta
any                   its own     the parameter of that name on the
                      parameter   module itself (the Whisper decoder's
                                  ``positional_embedding``)
====================  ==========  ====================================

Grouped ``nn.Conv1d`` kernels take the same rule: JAX's [k, Cin/g, Cout]
is PyTorch's [Cout, Cin/g, k] (HuBERT's ``pos_conv``). CREPE's conv blocks
are ``nn.Conv1d`` with their own ``scale`` and ``shift``.

Whisper encoders with a scanned layout (``blocks/block/...`` with a
leading layer axis) are unstacked to ``block_i`` first.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch
from torch import nn


def _leaves(tree: Any, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    if isinstance(tree, dict) or hasattr(tree, "items"):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (str(k),))
    else:
        yield prefix, np.asarray(tree)


def unstack_blocks(params: Dict[str, Any], n_layers: int) -> Dict[str, Any]:
    """Scanned ``blocks/block/...`` (leading layer axis) -> ``block_i/...``."""
    if "blocks" not in params:
        return params

    def take(tree, i):
        if hasattr(tree, "items"):
            return {k: take(v, i) for k, v in tree.items()}
        return np.asarray(tree)[i]

    out = {k: v for k, v in params.items() if k != "blocks"}
    for i in range(n_layers):
        out[f"block_{i}"] = take(params["blocks"]["block"], i)
    return out


def _convert(module: nn.Module, leaf: str, value: np.ndarray) -> Tuple[str, np.ndarray]:
    if leaf == "bias":
        return "bias", value
    if isinstance(module, nn.Linear) and leaf == "kernel":
        return "weight", value.T
    if isinstance(module, (nn.Conv1d, nn.ConvTranspose1d)) and leaf == "kernel":
        return "weight", np.transpose(value, (2, 1, 0))
    if isinstance(module, nn.Embedding) and leaf == "embedding":
        return "weight", value
    if isinstance(module, (nn.LayerNorm, nn.GroupNorm)) and leaf == "scale":
        return "weight", value
    if leaf in ("alpha", "beta") or leaf in module._parameters:
        return leaf, value
    raise KeyError(f"no bridge rule for leaf {leaf!r} of {type(module).__name__}")


def load_jax_params(module: nn.Module, params: Dict[str, Any]) -> nn.Module:
    """Copy a JAX parameter tree into ``module`` (in place, strict: every
    parameter of the module must be covered, with matching shapes)."""
    state = {}
    for path, value in _leaves(params):
        sub = module.get_submodule(".".join(path[:-1]))
        name, value = _convert(sub, path[-1], value)
        key = ".".join(path[:-1] + (name,))
        state[key] = torch.tensor(np.asarray(value, dtype=np.float32))
    own = dict(module.named_parameters())
    missing = sorted(set(own) - set(state))
    unknown = sorted(set(state) - set(own))
    if missing or unknown:
        raise KeyError(f"parameter tree mismatch: missing {missing[:5]}, unknown {unknown[:5]}")
    with torch.no_grad():
        for key, value in state.items():
            if own[key].shape != value.shape:
                raise ValueError(f"{key}: shape {tuple(value.shape)} != {tuple(own[key].shape)}")
            own[key].copy_(value)
    return module


def _fan_in(module: nn.Module, p: torch.Tensor) -> int:
    """Fan-in of a weight as the JAX random init counts it: the product of
    all but the last axis of the JAX layout."""
    if isinstance(module, nn.Linear):
        return p.shape[1]
    if isinstance(module, (nn.Conv1d, nn.ConvTranspose1d)):
        return p.shape[1] * p.shape[2]  # [Cout,Cin,k] / [Cin,Cout,K]
    return p.shape[0]  # Embedding [n, d]


def random_init_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random weights in place, the JAX smoke-run scheme: every weight of 2+
    dimensions ~ N(0, 1/fan_in), LayerNorm and GroupNorm scales and
    parameters named ``scale`` (CREPE's folded BatchNorm) 1, as flax's and
    JAX's inits give them, other 1-D leaves (biases, shifts, log-scale snake
    alpha/beta) 0. Draws come from ``generator``, on its device."""
    with torch.no_grad():
        for sub in module.modules():
            for name, p in sub.named_parameters(recurse=False):
                if p.dim() >= 2:
                    draw = torch.randn(p.shape, generator=generator, device=generator.device)
                    p.copy_(draw / math.sqrt(max(_fan_in(sub, p), 1)))
                elif (isinstance(sub, (nn.LayerNorm, nn.GroupNorm)) and name == "weight") or name == "scale":
                    p.fill_(1.0)
                else:
                    p.zero_()
    return module
