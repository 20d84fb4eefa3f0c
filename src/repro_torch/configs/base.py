"""Config helpers: smoke-test reduction + batch/cache shape specs per cell.

The counterpart of ``repro.configs.base``, field for field.
"""

from __future__ import annotations

import dataclasses

from ..models.config import ModelConfig
from ..models.spec import ParamSpec

__all__ = ["reduce_for_smoke", "Shape", "SHAPES", "shape_applicable",
           "batch_specs", "decode_specs", "cache_len_for"]


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


@dataclasses.dataclass(frozen=True)
class Shape:
    name: str
    kind: str       # train | prefill | decode
    seq: int
    batch: int


SHAPES: dict[str, Shape] = {
    "train_4k": Shape("train_4k", "train", 4096, 256),
    "prefill_32k": Shape("prefill_32k", "prefill", 32768, 32),
    "decode_32k": Shape("decode_32k", "decode", 32768, 128),
    "long_500k": Shape("long_500k", "decode", 524288, 1),
}

# long_500k requires sub-quadratic decode state: SSM and the RG-LRU hybrid
# qualify (O(1)/bounded state); pure full-attention archs are skipped.
_SUBQUADRATIC_FAMILIES = ("ssm", "hybrid")


def shape_applicable(cfg: ModelConfig, shape: Shape) -> tuple[bool, str]:
    if shape.name == "long_500k" and cfg.family not in _SUBQUADRATIC_FAMILIES:
        return False, "full-attention arch: 500k decode cache/attn infeasible (skip per assignment)"
    return True, ""


def _text_len(cfg: ModelConfig, seq: int) -> int:
    return seq - cfg.img_tokens if cfg.frontend == "vlm_stub" else seq


def batch_specs(cfg: ModelConfig, shape: Shape) -> dict[str, ParamSpec]:
    """Train/prefill input specs (ShapeDtypeStruct-ready, with logical axes)."""
    B, S = shape.batch, shape.seq
    St = _text_len(cfg, S)
    specs = {
        "inputs": ParamSpec((B, St), "int32", ("batch", None)),
        "targets": ParamSpec((B, St), "int32", ("batch", None)),
    }
    if cfg.frontend == "vlm_stub":
        specs["patches"] = ParamSpec((B, cfg.img_tokens, cfg.d_model), "bfloat16",
                                     ("batch", None, None))
    if cfg.is_encdec:
        if shape.kind == "prefill":
            # prefill = encode the long audio; short decoder start prompt
            specs["frames"] = ParamSpec((B, S, cfg.d_model), "bfloat16",
                                        ("batch", None, None))
            for k in ("inputs", "targets"):
                specs[k] = ParamSpec((B, 8), "int32", ("batch", None))
        else:
            specs["frames"] = ParamSpec((B, S, cfg.d_model), "bfloat16",
                                        ("batch", None, None))
    if shape.kind == "prefill":
        specs.pop("targets", None)
    return specs


def decode_specs(cfg: ModelConfig, shape: Shape) -> dict[str, ParamSpec]:
    B = shape.batch
    return {
        "tokens": ParamSpec((B, 1), "int32", ("batch", None)),
        "pos": ParamSpec((), "int32", ()),
    }


def cache_len_for(cfg: ModelConfig, shape: Shape) -> tuple[int, int]:
    """(decoder cache length, encoder context length) for a cell."""
    if cfg.is_encdec:
        if shape.kind == "prefill":
            return 8, shape.seq
        return shape.seq, cfg.enc_seq
    return shape.seq, 0
