"""Config system: the JAX package's json5 schema and loader semantics.

Counterpart of ``svc_inference_pipeline_tpu/config.py`` (kept as a copy:
that package's ``__init__`` imports JAX). json5 (comments, trailing commas)
is parsed with the ``json5`` package when installed, else by stripping
comments and trailing commas and using :mod:`json`. ``basic_config``
inheritance resolves against ``WORD_DIR`` / ``WORK_DIR`` or the file's
directory.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict


class HParams:
    """Recursive attribute-access view over a nested dict."""

    def __init__(self, **kwargs: Any) -> None:
        for k, v in kwargs.items():
            if isinstance(v, dict):
                v = HParams(**v)
            self[k] = v

    def keys(self):
        return self.__dict__.keys()

    def items(self):
        return self.__dict__.items()

    def values(self):
        return self.__dict__.values()

    def get(self, key: str, default: Any = None) -> Any:
        return self.__dict__.get(key, default)

    def __len__(self) -> int:
        return len(self.__dict__)

    def __getitem__(self, key: str) -> Any:
        return getattr(self, key)

    def __setitem__(self, key: str, value: Any) -> None:
        setattr(self, key, value)

    def __contains__(self, key: str) -> bool:
        return key in self.__dict__

    def __repr__(self) -> str:
        return f"HParams({self.__dict__!r})"

    def __eq__(self, other: object) -> bool:
        if isinstance(other, HParams):
            return self.__dict__ == other.__dict__
        return NotImplemented

    def to_dict(self) -> Dict[str, Any]:
        return {k: v.to_dict() if isinstance(v, HParams) else v for k, v in self.__dict__.items()}

    def replace(self, **updates: Any) -> "HParams":
        """Copy with top-level keys replaced."""
        d = self.to_dict()
        d.update(updates)
        return HParams(**d)


def override_config(base: Dict[str, Any], new: Dict[str, Any]) -> Dict[str, Any]:
    """Deep-merge ``new`` into ``base``."""
    for k, v in new.items():
        if isinstance(v, dict):
            base.setdefault(k, {})
            base[k] = override_config(base[k], v)
        else:
            base[k] = v
    return base


_JSON5_TOKEN = re.compile(r'"(?:\\.|[^"\\])*"|//[^\n]*|/\*.*?\*/', re.S)
_TRAILING_COMMA = re.compile(r",(\s*[}\]])")


def _loads_json5(text: str) -> Dict[str, Any]:
    try:
        import json5
    except ImportError:
        # drop comments outside strings, then trailing commas
        text = _JSON5_TOKEN.sub(lambda m: m.group(0) if m.group(0).startswith('"') else "", text)
        return json.loads(_TRAILING_COMMA.sub(r"\1", text))
    return json5.loads(text)


def _load_config_dict(path: str) -> Dict[str, Any]:
    with open(path, "r") as f:
        cfg = _loads_json5(f.read())
    if "basic_config" in cfg:
        root = os.getenv("WORD_DIR") or os.getenv("WORK_DIR") or os.path.dirname(path)
        cfg = override_config(_load_config_dict(os.path.join(root, cfg["basic_config"])), cfg)
    return cfg


def load_config(path: str) -> HParams:
    """Load a json5 config file into an :class:`HParams` tree."""
    return HParams(**_load_config_dict(path))


DEFAULT_CONFIG = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "config", "config.json"
)
