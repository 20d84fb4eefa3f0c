"""Model configuration, parameter specs and the language model.

Every family of the reference: dense GQA ``attn`` blocks (internlm2,
gemma-7b, qwen2-72b with QKV bias), MoE blocks with GQA or MLA attention
(llama4-maverick, deepseek-v2), Mamba-2 ``ssm`` blocks, the RG-LRU hybrid
(``rglru`` and ``local_attn`` blocks), LLaVA's projected patch prefix and
Whisper's encoder (``enc_attn`` blocks) and cross-attending decoder
(``xattn`` blocks): parameter and cache specs, initialization, the loss,
and the prefill and decode forwards.
"""

from .config import ModelConfig
from .lm import (MOE_AUX_WEIGHT, cast_params, init_cache_specs,
                 make_decode_fn, make_loss_fn, make_prefill_fn, merge_tail,
                 param_specs)
from .spec import ParamSpec, add_prefix, init_params, sub

__all__ = ["ModelConfig", "ParamSpec", "param_specs", "init_cache_specs",
           "init_params", "cast_params", "make_loss_fn", "make_prefill_fn",
           "make_decode_fn", "merge_tail", "MOE_AUX_WEIGHT", "sub",
           "add_prefix"]
