"""Architecture registry: the configurations ported so far.

The counterpart of ``repro.configs``; internlm2-1.8b (dense),
mamba2-2.7b (SSM) and recurrentgemma-2b (RG-LRU + local attention) are
ported.
"""

from __future__ import annotations

from ..models.config import ModelConfig
from . import internlm2_1p8b, mamba2_2p7b, recurrentgemma_2b
from .base import (SHAPES, Shape, batch_specs, cache_len_for, decode_specs,
                   reduce_for_smoke, shape_applicable)

ARCHS = {
    "internlm2-1.8b": internlm2_1p8b.config,
    "mamba2-2.7b": mamba2_2p7b.config,
    "recurrentgemma-2b": recurrentgemma_2b.config,
}


def get_config(name: str, *, smoke: bool = False) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    cfg = ARCHS[name]()
    return reduce_for_smoke(cfg) if smoke else cfg


__all__ = ["ARCHS", "get_config", "ModelConfig", "reduce_for_smoke", "SHAPES",
           "Shape", "batch_specs", "cache_len_for", "decode_specs",
           "shape_applicable"]
