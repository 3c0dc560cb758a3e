"""Singer name -> id lookup (``config/singers.json``)."""

from __future__ import annotations

import json
from functools import lru_cache
from typing import Dict

import numpy as np


@lru_cache(maxsize=None)
def load_singer_lut(singer_file: str) -> Dict[str, int]:
    with open(singer_file, "r") as f:
        return json.load(f)


def get_singer_id(cfg, singer_name: str) -> np.ndarray:
    """The singer id as an int32 array of shape (1,)."""
    lut = load_singer_lut(cfg.singer_file)
    if singer_name not in lut:
        raise KeyError(f"Unknown singer {singer_name!r}; available: {sorted(lut)}")
    return np.array([lut[singer_name]], dtype=np.int32)
