"""Config helpers: the smoke-test reduction.

The counterpart of ``repro.configs.base``, trimmed to
:func:`reduce_for_smoke`; the cell shapes (``SHAPES``, ``batch_specs``,
...) wait for the config/data item of ROADMAP queue A.
"""

from __future__ import annotations

import dataclasses

from ..models.config import ModelConfig

__all__ = ["reduce_for_smoke"]


def reduce_for_smoke(cfg: ModelConfig) -> ModelConfig:
    """Family-preserving tiny config: same block kinds, small dims (the
    reference's reduction, field for field)."""
    n_layers = max(2, len(cfg.pattern)) if cfg.pattern else 2
    if cfg.first_k_dense:
        n_layers = cfg.first_k_dense + 2
    kw = dict(
        name=cfg.name + "-smoke",
        n_layers=n_layers,
        d_model=64,
        n_heads=4,
        n_kv_heads=min(4, max(1, cfg.n_kv_heads)),
        head_dim=16,
        d_ff=0 if cfg.d_ff == 0 else 128,
        vocab=512,
        remat="none",
        decode_tail=8,
    )
    if cfg.attn_kind == "mla":
        kw.update(kv_lora_rank=16, q_lora_rank=32, rope_head_dim=8,
                  nope_head_dim=16, v_head_dim=16)
    if cfg.n_experts:
        kw.update(n_experts=8, top_k=min(cfg.top_k, 2),
                  n_shared_experts=min(cfg.n_shared_experts, 1), d_ff_expert=32)
    if cfg.family == "ssm":
        kw.update(ssm_state=16, ssm_head_dim=8, ssm_chunk=16)
    if cfg.pattern:
        kw.update(lru_width=64, window=32)
    if cfg.is_encdec:
        kw.update(enc_layers=2, enc_seq=16)
    if cfg.frontend == "vlm_stub":
        kw.update(img_tokens=8)
    return dataclasses.replace(cfg, **kw)
