"""Saving and loading converted parameter trees.

Counterpart of ``svc_inference_pipeline_tpu/checkpoints/native_io.py``: a
path ending in ``.npz`` holds the tree flat, its keys the tree's path joined
by ``|``, the same format as the JAX package's, so a file written by either
package loads in the other. Any other path is one ``torch.save`` of the
nested dict (where the JAX package writes an Orbax directory).
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np


def save_checkpoint(path: str, pytree: Any) -> None:
    """Save a parameter tree: ``.npz`` -> flat npz; else ``torch.save``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if path.endswith(".npz"):
        np.savez(path, **{k: np.asarray(v) for k, v in _flatten(pytree).items()})
        return
    import torch

    torch.save(pytree, path)


def load_checkpoint(path: str, target: Any = None) -> Any:
    """Load a checkpoint saved by :func:`save_checkpoint`. ``target`` is
    accepted for the JAX signature; the saved tree carries its own layout."""
    if path.endswith(".npz"):
        with np.load(path) as f:
            return _unflatten({k: f[k] for k in f.files})
    import torch

    return torch.load(path, map_location="cpu", weights_only=False)


_SEP = "|"


def _flatten(tree: Any) -> dict:
    flat = {}

    def rec(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                rec(f"{prefix}{_SEP}{k}" if prefix else str(k), v)
        else:
            flat[prefix] = node

    rec("", tree)
    return flat


def _unflatten(flat: dict) -> dict:
    tree: dict = {}
    for key, value in flat.items():
        parts = key.split(_SEP)
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return tree
