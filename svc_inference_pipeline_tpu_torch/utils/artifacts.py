"""Dataset statistics artifacts: per-channel mel min/max and target-singer F0.

Counterpart of ``svc_inference_pipeline_tpu/utils/artifacts.py`` (npz, or
the reference's pickles).
"""

from __future__ import annotations

import pickle
from functools import lru_cache
from typing import Tuple

import numpy as np


def _load_array(path: str, npz_key: str) -> np.ndarray:
    if path.endswith(".npz"):
        with np.load(path) as f:
            return np.asarray(f[npz_key])
    with open(path, "rb") as f:
        return np.asarray(pickle.load(f))


@lru_cache(maxsize=None)
def load_mel_min_max(min_mel_file: str, max_mel_file: str) -> Tuple[np.ndarray, np.ndarray]:
    """Per-channel mel min/max, each float32 of shape (n_mels,)."""
    return (_load_array(min_mel_file, "mel_min").astype(np.float32),
            _load_array(max_mel_file, "mel_max").astype(np.float32))


@lru_cache(maxsize=None)
def get_target_f0_median(target_f0_file: str) -> float:
    """Median F0 over the target singer's voiced frames."""
    if target_f0_file.endswith(".npz"):
        with np.load(target_f0_file) as f:
            if "voiced_median" in f:
                return float(f["voiced_median"])
            total = np.asarray(f["voiced_f0"])
    else:
        with open(target_f0_file, "rb") as f:
            f0s = pickle.load(f)
        total = np.concatenate([np.asarray(x).ravel() for x in f0s])
    voiced = total[total != 0]
    return float(np.median(voiced))


def pitch_shift(raw_f0: np.ndarray, cfg) -> np.ndarray:
    """Median-align source F0 to the target singer's: multiply by
    target_median / source_voiced_median."""
    voiced = raw_f0[raw_f0 != 0]
    if voiced.size == 0:
        return raw_f0
    return raw_f0 * (get_target_f0_median(cfg.target_f0_file) / float(np.median(voiced)))
