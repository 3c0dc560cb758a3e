"""Device names of the config and CLI -> torch devices.

Every builder of the port takes ``device=None`` and resolves it here, so a
caller that names no device runs on the GPU; the CPU is used only when asked
for (as the tests do).
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(name: Optional[Union[str, torch.device]]) -> torch.device:
    """Config/CLI device name -> torch device: None, "tpu", "cuda" and "gpu"
    all name the GPU (the JAX config's default is "tpu")."""
    if isinstance(name, torch.device):
        return name
    name = (name or "cuda").lower()
    if name in ("tpu", "cuda", "gpu"):
        return torch.device("cuda")
    if name.startswith("cuda:") or name == "cpu":
        return torch.device(name)
    raise ValueError(f"unknown device {name!r} (use cuda, tpu or cpu)")
