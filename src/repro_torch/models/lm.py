"""Parameter specs of the language models (dense family).

The counterpart of ``repro.models.lm``, trimmed to ``param_specs`` and the
helpers the dense family uses (``lm.py:64-111, 166-211`` of the reference):
names, shapes, dtypes, logical axes and init kinds are the reference's.
The forward, loss, prefill and decode functions, and the MoE, MLA, SSM,
RG-LRU, encoder-decoder and VLM specs, wait for later slices (ROADMAP queue
A); asking for one of those families raises ``NotImplementedError``.

Conventions: params are flat dicts ``g{gi}/p{pj}/<name>`` with a leading
"layers" axis of length ``reps`` (scanned).
"""

from __future__ import annotations

from .config import ModelConfig
from .spec import ParamSpec

__all__ = ["param_specs"]


def _norm(d: int) -> ParamSpec:
    return ParamSpec((d,), "float32", (None,), init="zeros")


def _attn_specs(cfg: ModelConfig, prefix: str = "") -> dict[str, ParamSpec]:
    D, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    dt = cfg.param_dtype
    s = {
        f"{prefix}wq": ParamSpec((D, H * hd), dt, ("fsdp", "qkv")),
        f"{prefix}wk": ParamSpec((D, K * hd), dt, ("fsdp", "qkv")),
        f"{prefix}wv": ParamSpec((D, K * hd), dt, ("fsdp", "qkv")),
        f"{prefix}wo": ParamSpec((H * hd, D), dt, ("qkv", "fsdp")),
    }
    if cfg.qkv_bias:
        s[f"{prefix}bq"] = ParamSpec((H * hd,), dt, ("qkv",), init="zeros")
        s[f"{prefix}bk"] = ParamSpec((K * hd,), dt, ("qkv",), init="zeros")
        s[f"{prefix}bv"] = ParamSpec((K * hd,), dt, ("qkv",), init="zeros")
    return s


def _mlp_specs(cfg: ModelConfig, d_ff: int | None = None,
               prefix: str = "mlp_") -> dict[str, ParamSpec]:
    D = cfg.d_model
    F = d_ff if d_ff is not None else cfg.d_ff
    dt = cfg.param_dtype
    s = {
        f"{prefix}wi": ParamSpec((D, F), dt, ("fsdp", "ff")),
        f"{prefix}wo": ParamSpec((F, D), dt, ("ff", "fsdp")),
    }
    if cfg.is_gated_mlp:
        s[f"{prefix}wg"] = ParamSpec((D, F), dt, ("fsdp", "ff"))
    return s


def _block_specs(cfg: ModelConfig, kind: str) -> dict[str, ParamSpec]:
    if kind not in ("attn", "local_attn") or cfg.attn_kind != "gqa":
        raise NotImplementedError(
            f"{kind!r} blocks ({cfg.attn_kind} attention) are not ported to "
            "repro_torch yet: see ROADMAP.md queue A")
    D = cfg.d_model
    s: dict[str, ParamSpec] = {"norm1": _norm(D)}
    s.update(_attn_specs(cfg))
    s["norm2"] = _norm(D)
    s.update(_mlp_specs(cfg))
    return s


def param_specs(cfg: ModelConfig) -> dict[str, ParamSpec]:
    """Full parameter spec dict for a dense (GQA) architecture."""
    if cfg.frontend != "none" or cfg.is_encdec:
        raise NotImplementedError(
            f"the {cfg.frontend!r} frontend / encoder-decoder specs are not "
            "ported to repro_torch yet: see ROADMAP.md queue A")
    D, V = cfg.d_model, cfg.vocab
    out: dict[str, ParamSpec] = {
        "embed/tok": ParamSpec((V, D), cfg.param_dtype, ("vocab", "fsdp"),
                               init="embed"),
        "final_norm": _norm(D),
    }
    if not cfg.tie_embeddings:
        out["lm_head"] = ParamSpec((D, V), cfg.param_dtype, ("fsdp", "vocab"))
    for gi, (reps, pattern) in enumerate(cfg.groups()):
        for pj, kind in enumerate(pattern):
            for name, spec in _block_specs(cfg, kind).items():
                out[f"g{gi}/p{pj}/{name}"] = spec.stack(reps)
    return out
