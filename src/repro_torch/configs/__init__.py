"""Architecture registry: the configurations ported so far.

The counterpart of ``repro.configs``; only internlm2-1.8b is ported, and
``reduce_for_smoke`` waits for the config/data slice (ROADMAP queue A).
"""

from __future__ import annotations

from ..models.config import ModelConfig
from . import internlm2_1p8b

ARCHS = {
    "internlm2-1.8b": internlm2_1p8b.config,
}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]()


__all__ = ["ARCHS", "get_config", "ModelConfig"]
