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
nn.Conv2d             kernel      weight = [kh,kw,Cin,Cout] -> [Cout,Cin,kh,kw]
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

:func:`train_state_from_jax` carries a JAX training state (diffusion or
GAN) into the port's: parameters, the EMA, and optax's Adam moments and
count as AdamW's ``exp_avg``/``exp_avg_sq``/``step``.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Iterator, Optional, Tuple

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


def _layout(module: nn.Module, leaf: str) -> Tuple[str, Optional[Tuple[int, ...]]]:
    """(PyTorch parameter name, axis permutation from the JAX layout or None
    for none) of the JAX ``leaf`` of ``module``: the table above."""
    if leaf == "bias":
        return "bias", None
    if isinstance(module, nn.Linear) and leaf == "kernel":
        return "weight", (1, 0)
    if isinstance(module, (nn.Conv1d, nn.ConvTranspose1d)) and leaf == "kernel":
        return "weight", (2, 1, 0)
    if isinstance(module, nn.Conv2d) and leaf == "kernel":
        return "weight", (3, 2, 0, 1)
    if isinstance(module, nn.Embedding) and leaf == "embedding":
        return "weight", None
    if isinstance(module, (nn.LayerNorm, nn.GroupNorm)) and leaf == "scale":
        return "weight", None
    if leaf in ("alpha", "beta") or leaf in module._parameters:
        return leaf, None
    raise KeyError(f"no bridge rule for leaf {leaf!r} of {type(module).__name__}")


def _convert(module: nn.Module, leaf: str, value: np.ndarray) -> Tuple[str, np.ndarray]:
    name, perm = _layout(module, leaf)
    return name, (value if perm is None else np.transpose(value, perm))


def jax_path_of(module: nn.Module, name: str) -> Tuple[str, Optional[Tuple[int, ...]]]:
    """The bridge read backwards: a parameter ``name`` of ``module``
    (``a.b.weight``) -> (its JAX leaf path ``a/b/kernel``, the permutation
    whose axis i is the JAX axis of PyTorch axis i, or None)."""
    *parts, leaf = name.split(".")
    sub = module.get_submodule(".".join(parts))
    for cand in {"weight": ("kernel", "embedding", "scale")}.get(leaf, (leaf,)):
        try:
            got, perm = _layout(sub, cand)
        except KeyError:
            continue
        if got == leaf:
            return "/".join(parts + [cand]), perm
    raise KeyError(f"no bridge rule gives {name!r} ({type(sub).__name__})")


def jax_tree_to_torch(module: nn.Module, tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A tree shaped like ``module``'s JAX parameters (the parameters, or
    optax moments of them) -> {parameter name: f32 CPU tensor in the
    module's layout}. Strict: every parameter of the module must be covered,
    with matching shapes."""
    state = {}
    for path, value in _leaves(tree):
        sub = module.get_submodule(".".join(path[:-1]))
        name, value = _convert(sub, path[-1], value)
        key = ".".join(path[:-1] + (name,))
        state[key] = torch.tensor(np.asarray(value, dtype=np.float32))
    own = dict(module.named_parameters())
    missing = sorted(set(own) - set(state))
    unknown = sorted(set(state) - set(own))
    if missing or unknown:
        raise KeyError(f"parameter tree mismatch: missing {missing[:5]}, unknown {unknown[:5]}")
    for key, value in state.items():
        if own[key].shape != value.shape:
            raise ValueError(f"{key}: shape {tuple(value.shape)} != {tuple(own[key].shape)}")
    return state


def load_jax_params(module: nn.Module, params: Dict[str, Any]) -> nn.Module:
    """Copy a JAX parameter tree into ``module`` (in place, strict: every
    parameter of the module must be covered, with matching shapes)."""
    own = dict(module.named_parameters())
    with torch.no_grad():
        for key, value in jax_tree_to_torch(module, params).items():
            own[key].copy_(value)
    return module


def _adam_state(opt_state) -> Any:
    """optax's ScaleByAdamState (count, mu, nu) inside an adamw chain state."""
    for part in opt_state if isinstance(opt_state, (tuple, list)) else (opt_state,):
        if all(hasattr(part, k) for k in ("count", "mu", "nu")):
            return part
    raise ValueError(f"no Adam state (count, mu, nu) in {type(opt_state).__name__}")


def _load_adam(optimizer: torch.optim.Optimizer, opt_state, modules: Dict[Optional[str], nn.Module]) -> None:
    """AdamW's per-parameter state from optax's: ``modules`` maps the keys of
    the moment trees (None: the whole tree) to the modules whose parameters
    the optimizer holds."""
    adam = _adam_state(opt_state)
    step = float(np.asarray(adam.count))
    for key, module in modules.items():
        mu, nu = ((adam.mu, adam.nu) if key is None else (adam.mu[key], adam.nu[key]))
        mu, nu = jax_tree_to_torch(module, mu), jax_tree_to_torch(module, nu)
        for name, p in module.named_parameters():
            optimizer.state[p] = {"step": torch.tensor(step, dtype=torch.float32),
                                  "exp_avg": mu[name].to(p.device), "exp_avg_sq": nu[name].to(p.device)}


def train_state_from_jax(jax_state: Any, state: Any) -> Any:
    """Carry a JAX ``DiffusionTrainState`` or ``GANTrainState`` (its leaves
    as numpy, ``jax.device_get``) into the port's ``state`` of the same kind
    and config, in place: step, parameters, the diffusion EMA (seeded from
    the parameters where the JAX state has none), and optax's Adam ``mu``,
    ``nu`` and ``count`` as AdamW's ``exp_avg``, ``exp_avg_sq`` and
    ``step``. A JAX state after step k then takes step k + 1 in the port."""
    state.step = int(np.asarray(jax_state.step))
    if hasattr(jax_state, "den_params"):
        modules = {"enc": state.encoder, "den": state.denoiser}
        load_jax_params(state.encoder, jax_state.enc_params)
        load_jax_params(state.denoiser, jax_state.den_params)
        _load_adam(state.optimizer, jax_state.opt_state, modules)
        ema = jax_state.ema_params or {"enc": jax_state.enc_params, "den": jax_state.den_params}
        state.ema = {key: {name: v.to(next(m.parameters()).device) for name, v in
                           jax_tree_to_torch(m, ema[key]).items()} for key, m in modules.items()}
        return state
    load_jax_params(state.generator, jax_state.gen_params)
    load_jax_params(state.mpd, jax_state.mpd_params)
    load_jax_params(state.mrd, jax_state.mrd_params)
    _load_adam(state.gen_optimizer, jax_state.gen_opt, {None: state.generator})
    _load_adam(state.disc_optimizer, jax_state.disc_opt, {"mpd": state.mpd, "mrd": state.mrd})
    return state


def _fan_in(module: nn.Module, p: torch.Tensor) -> int:
    """Fan-in of a weight as the JAX random init counts it: the product of
    all but the last axis of the JAX layout."""
    if isinstance(module, nn.Linear):
        return p.shape[1]
    if isinstance(module, (nn.Conv1d, nn.ConvTranspose1d)):
        return p.shape[1] * p.shape[2]  # [Cout,Cin,k] / [Cin,Cout,K]
    if isinstance(module, nn.Conv2d):
        return p.shape[1] * p.shape[2] * p.shape[3]  # [Cout,Cin,kh,kw]
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
