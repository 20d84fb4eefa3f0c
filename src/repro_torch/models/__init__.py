"""Model configuration, parameter specs and the language model.

Every decoder-only family of the reference: dense GQA ``attn`` blocks
(internlm2, gemma-7b, qwen2-72b with QKV bias), MoE blocks with GQA or
MLA attention (llama4-maverick, deepseek-v2), Mamba-2 ``ssm`` blocks and
the RG-LRU hybrid (``rglru`` and ``local_attn`` blocks): parameter and
cache specs, initialization, the loss, and the prefill and decode
forwards.  The encoder-decoder and VLM frontends are a later slice
(ROADMAP queue A item 12).
"""

from .config import ModelConfig
from .lm import (MOE_AUX_WEIGHT, cast_params, init_cache_specs,
                 make_decode_fn, make_loss_fn, make_prefill_fn, param_specs)
from .spec import ParamSpec, add_prefix, init_params, sub

__all__ = ["ModelConfig", "ParamSpec", "param_specs", "init_cache_specs",
           "init_params", "cast_params", "make_loss_fn", "make_prefill_fn",
           "make_decode_fn", "MOE_AUX_WEIGHT", "sub", "add_prefix"]
