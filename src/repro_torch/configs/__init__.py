"""Architecture registry: the configurations ported so far.

The counterpart of ``repro.configs``: all ten of its configurations, the
dense family (internlm2-1.8b and -20b, gemma-7b, qwen2-72b), the MoE
family (deepseek-v2-236b with MLA, llama4-maverick), mamba2-2.7b (SSM),
recurrentgemma-2b (RG-LRU + local attention) and the two frontends,
llava-next-mistral-7b (projected patch embeddings before the text) and
whisper-base (encoder-decoder over frame embeddings).
"""

from __future__ import annotations

from ..models.config import ModelConfig
from . import (deepseek_v2_236b, gemma_7b, internlm2_1p8b, internlm2_20b,
               llama4_maverick_400b, llava_next_mistral_7b, mamba2_2p7b,
               qwen2_72b, recurrentgemma_2b, whisper_base)
from .base import (SHAPES, Shape, batch_specs, cache_len_for, decode_specs,
                   reduce_for_smoke, shape_applicable)

ARCHS = {
    "mamba2-2.7b": mamba2_2p7b.config,
    "deepseek-v2-236b": deepseek_v2_236b.config,
    "llama4-maverick-400b-a17b": llama4_maverick_400b.config,
    "gemma-7b": gemma_7b.config,
    "internlm2-20b": internlm2_20b.config,
    "internlm2-1.8b": internlm2_1p8b.config,
    "qwen2-72b": qwen2_72b.config,
    "llava-next-mistral-7b": llava_next_mistral_7b.config,
    "whisper-base": whisper_base.config,
    "recurrentgemma-2b": recurrentgemma_2b.config,
}

# archs whose optimizer state is offloaded into storage windows (the paper's
# out-of-core technique): full Adam moments do not fit device memory
OFFLOAD_ARCHS = ("deepseek-v2-236b", "llama4-maverick-400b-a17b")


def get_config(name: str, *, smoke: bool = False) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    cfg = ARCHS[name]()
    return reduce_for_smoke(cfg) if smoke else cfg


__all__ = ["ARCHS", "OFFLOAD_ARCHS", "get_config", "ModelConfig", "reduce_for_smoke", "SHAPES",
           "Shape", "batch_specs", "cache_len_for", "decode_specs",
           "shape_applicable"]
