"""Model configuration, parameter specs and the language model.

The dense family (GQA ``attn`` blocks, e.g. internlm2-1.8b), the SSM
family (Mamba-2 ``ssm`` blocks, mamba2-2.7b) and the RG-LRU hybrid
(``rglru`` and ``local_attn`` blocks, recurrentgemma-2b): parameter and
cache specs, initialization, the loss of the dense family, and the prefill
and decode forwards.  Training of the other families, and the other
families, are later slices (ROADMAP queue A).
"""

from .config import ModelConfig
from .lm import (cast_params, init_cache_specs, make_decode_fn,
                 make_loss_fn, make_prefill_fn, param_specs)
from .spec import ParamSpec, add_prefix, init_params, sub

__all__ = ["ModelConfig", "ParamSpec", "param_specs", "init_cache_specs",
           "init_params", "cast_params", "make_loss_fn", "make_prefill_fn",
           "make_decode_fn",
           "sub", "add_prefix"]
