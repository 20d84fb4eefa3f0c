"""Language model assembly for every decoder-only family: specs, loss,
prefill, decode.

The counterpart of ``repro.models.lm`` for dense GQA ``attn`` blocks (with
or without QKV bias), DeepSeek-V2's MLA attention, ``moe`` blocks (GQA or
MLA attention and a routed MLP with shared experts), Mamba-2 ``ssm`` blocks
and RecurrentGemma's ``rglru`` and ``local_attn`` blocks:
``param_specs``, ``init_cache_specs``, the prefill and decode forwards and
their factories; names, shapes, dtypes, logical axes and init kinds are the
reference's.  ``make_loss_fn`` (training) covers every ported kind with the
reference's differentiable paths, which autograd differentiates:
:func:`~.attention.blockwise_attention` for ``attn``, ``moe`` and
(windowed) ``local_attn`` blocks and MLA, :func:`~.moe.moe_mlp` for the
routed MLP (with the load-balance loss, weighted ``MOE_AUX_WEIGHT``),
:func:`~.ssm.ssd_chunked` for ``ssm`` blocks and
:func:`~.griffin.linear_scan` for ``rglru`` blocks; no kernel of the
package runs in it (none has a backward).  The encoder-decoder and VLM
frontends wait for a later slice (ROADMAP queue A item 12); asking for one
raises ``NotImplementedError`` naming it.

Conventions: params and caches are flat dicts ``g{gi}/p{pj}/<name>`` with
a leading "layers" axis of length ``reps``; the reference's scan over that
axis is a Python loop here.  Activations run in ``cfg.dtype`` (bf16),
norms, RoPE and softmax in float32.  Unlike the reference's pure
functions, prefill and decode write the cache they are given in place (a
KV cache is the largest tensor of a serving run; copying it per step would
double it).

Two-tier KV cache: ``k``/``v`` (main, length ``cache_len``) and
``tk``/``tv`` (tail, ``decode_tail`` slots; position p at slot p % Tt);
an MLA block's is the latent ``ckv``/``kr`` (main) and ``tckv``/``tkr``
(tail), the same way.  Decode writes the tail; the engine merges a full
tail into main before the step at a multiple of Tt.  Prefill leaves the
state that decoding the prompt one token at a time would leave: the tail
holds the prompt's last ``(S - 1) % Tt + 1`` positions, so a prompt whose
length is a multiple of Tt ends with a full tail, which the first step's
merge writes exactly.  (The reference puts all S positions in main in that
case, and its first merge then writes the empty tail over them: ROADMAP
queue C.)

SSM cache: ``h`` (B,H,N,P) float32, the SSD state after the last position,
and ``conv`` (B,K-1,conv_dim) bf16, the last K-1 conv inputs.  Prefill
writes both from the scan kernel's final state and the conv's carry;
decode overwrites both every step.  An ``rglru`` block's cache is the same
pair for the RG-LRU: ``h`` (B,W) float32 and ``conv`` (B,K-1,W) bf16.

Ring cache (``local_attn``): ``k``/``v`` of W = min(cache_len, window)
slots, position p at slot p % W.  Prefill keeps the prompt's last W
positions; decode writes slot pos % W and attends to the min(pos + 1, W)
slots that are filled, every one of them inside the window by
construction.  Keys carry RoPE at their absolute positions, so the slot
order does not matter to the softmax.
"""

from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from .attention import (blockwise_attention, decode_attention,
                        decode_attention_two_tier, prefill_attention)
from .config import ModelConfig
from .griffin import griffin_decode_step, griffin_forward
from .layers import mlp, rms_norm, rope
from .mla import mla_attention, mla_decode_two_tier
from .moe import moe_mlp
from .spec import ParamSpec, sub
from .ssm import mamba2_decode_step, mamba2_forward

__all__ = ["param_specs", "init_cache_specs", "cast_params", "make_loss_fn",
           "make_prefill_fn", "make_decode_fn", "MOE_AUX_WEIGHT"]

MOE_AUX_WEIGHT = 0.01

# parameters kept in f32 inside the (bf16) forward pass
_KEEP_F32 = {"A_log", "dt_bias", "D", "lam", "b_i", "b_r", "router"}

# the block kinds of the frontends, planned for ROADMAP queue A item 12
_UNPORTED = {"xattn", "enc_attn"}
_FRONTENDS = "item 12 (frontends)"


def _unported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to repro_torch yet: "
                               f"see ROADMAP.md queue A {item}")


def _check_ported(cfg: ModelConfig) -> None:
    """Raise for what the forward does not cover: the encoder-decoder and
    VLM frontends (their blocks too), and attention kinds that no
    configuration of the reference pairs with a block kind."""
    kinds = {kind for _, pattern in cfg.groups() for kind in pattern}
    if cfg.frontend != "none" or cfg.is_encdec or kinds & _UNPORTED:
        raise _unported(f"the {cfg.frontend!r} frontend / encoder-decoder",
                        _FRONTENDS)
    if ("local_attn" in kinds and cfg.attn_kind != "gqa") or (
            kinds & {"attn", "moe"} and cfg.attn_kind not in ("gqa", "mla")):
        raise ValueError(f"{cfg.attn_kind} attention in {sorted(kinds)} "
                         "blocks: not a configuration of the reference")


def cast_params(cfg: ModelConfig, params):
    """Cast matmul weights to the compute dtype (norms/gates stay f32); the
    reference's ``_cast_params``.  The prefill and decode factories take
    parameters cast by this, once, by their caller (``Engine`` does it at
    construction); the loss casts inside, out of place, so autograd sees
    the cast and the gradients come back in the parameters' dtype."""
    dt = getattr(torch, cfg.dtype)

    def cast(name, a):
        leaf = name.split("/")[-1]
        if leaf in _KEEP_F32 or "norm" in leaf:
            return a
        return a.to(dt)

    return {k: cast(k, v) for k, v in params.items()}


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


def _mla_specs(cfg: ModelConfig) -> dict[str, ParamSpec]:
    D, H = cfg.d_model, cfg.n_heads
    dn, dr, dv, r, qr = (cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim,
                         cfg.kv_lora_rank, cfg.q_lora_rank)
    dt = cfg.param_dtype
    return {
        "wq_a": ParamSpec((D, qr), dt, ("fsdp", None)),
        "q_norm": _norm(qr),
        "wq_b": ParamSpec((qr, H * (dn + dr)), dt, ("fsdp", "qkv")),
        "wkv_a": ParamSpec((D, r + dr), dt, ("fsdp", None)),
        "kv_norm": _norm(r),
        "wkv_b": ParamSpec((r, H * (dn + dv)), dt, ("fsdp", "qkv")),
        "wo": ParamSpec((H * dv, D), dt, ("qkv", "fsdp")),
    }


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


def _moe_specs(cfg: ModelConfig) -> dict[str, ParamSpec]:
    D, E, Fe = cfg.d_model, cfg.n_experts, cfg.d_ff_expert
    dt = cfg.param_dtype
    s = {
        "router": ParamSpec((D, E), "float32", ("fsdp", "experts")),
        "we_up": ParamSpec((E, D, Fe), dt, ("experts", "fsdp", None)),
        "we_down": ParamSpec((E, Fe, D), dt, ("experts", None, "fsdp")),
    }
    if cfg.is_gated_mlp:
        s["we_gate"] = ParamSpec((E, D, Fe), dt, ("experts", "fsdp", None))
    if cfg.n_shared_experts:
        Fs = cfg.n_shared_experts * Fe
        s["ws_up"] = ParamSpec((D, Fs), dt, ("fsdp", "ff"))
        s["ws_down"] = ParamSpec((Fs, D), dt, ("ff", "fsdp"))
        if cfg.is_gated_mlp:
            s["ws_gate"] = ParamSpec((D, Fs), dt, ("fsdp", "ff"))
    return s


def _ssm_specs(cfg: ModelConfig) -> dict[str, ParamSpec]:
    D = cfg.d_model
    d_in, N, Gr, H = cfg.d_inner, cfg.ssm_state, cfg.ssm_groups, cfg.ssm_heads
    conv_dim = d_in + 2 * Gr * N
    zxbcdt = 2 * d_in + 2 * Gr * N + H
    dt = cfg.param_dtype
    return {
        "in_proj": ParamSpec((D, zxbcdt), dt, ("fsdp", "ff")),
        "conv_w": ParamSpec((cfg.ssm_conv, conv_dim), dt, ("conv", None)),
        "A_log": ParamSpec((H,), "float32", (None,), init="zeros"),
        "D": ParamSpec((H,), "float32", (None,), init="ones"),
        "dt_bias": ParamSpec((H,), "float32", (None,), init="zeros"),
        "norm": _norm(d_in),
        "out_proj": ParamSpec((d_in, D), dt, ("ff", "fsdp")),
    }


def _rglru_specs(cfg: ModelConfig) -> dict[str, ParamSpec]:
    D, W = cfg.d_model, cfg.lru
    dt = cfg.param_dtype
    return {
        "wx": ParamSpec((D, W), dt, ("fsdp", "state")),
        "wy": ParamSpec((D, W), dt, ("fsdp", "state")),
        "conv_w": ParamSpec((cfg.ssm_conv, W), dt, ("conv", None)),
        "w_i": ParamSpec((W, W), dt, ("fsdp", "state")),
        "b_i": ParamSpec((W,), "float32", (None,), init="zeros"),
        "w_r": ParamSpec((W, W), dt, ("fsdp", "state")),
        "b_r": ParamSpec((W,), "float32", (None,), init="zeros"),
        "lam": ParamSpec((W,), "float32", (None,), init="ones"),
        "wo": ParamSpec((W, D), dt, ("state", "fsdp")),
    }


def _block_specs(cfg: ModelConfig, kind: str) -> dict[str, ParamSpec]:
    D = cfg.d_model
    if kind == "ssm":
        return {"norm1": _norm(D), **_ssm_specs(cfg)}
    if kind == "rglru":
        return {"norm1": _norm(D), **_rglru_specs(cfg), "norm2": _norm(D),
                **_mlp_specs(cfg)}
    if kind not in ("attn", "local_attn", "moe"):
        raise _unported(f"{kind!r} blocks", _FRONTENDS)
    s: dict[str, ParamSpec] = {"norm1": _norm(D)}
    s.update(_mla_specs(cfg) if cfg.attn_kind == "mla" else _attn_specs(cfg))
    s["norm2"] = _norm(D)
    s.update(_moe_specs(cfg) if kind == "moe" else _mlp_specs(cfg))
    return s


def param_specs(cfg: ModelConfig) -> dict[str, ParamSpec]:
    """Full parameter spec dict for a decoder-only architecture."""
    if cfg.frontend != "none" or cfg.is_encdec:
        raise _unported(f"the {cfg.frontend!r} frontend / encoder-decoder "
                        "specs", _FRONTENDS)
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


# ---------------------------------------------------------------------------
# Cache specs
# ---------------------------------------------------------------------------

def _block_cache_specs(cfg: ModelConfig, kind: str, B: int,
                       T: int) -> dict[str, ParamSpec]:
    if kind == "ssm":
        conv_dim = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
        return {
            "h": ParamSpec((B, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim),
                           "float32", ("batch", "heads", None, None)),
            "conv": ParamSpec((B, cfg.ssm_conv - 1, conv_dim), "bfloat16",
                              ("batch", "conv", None)),
        }
    if kind == "rglru":
        return {
            "h": ParamSpec((B, cfg.lru), "float32", ("batch", "state")),
            "conv": ParamSpec((B, cfg.ssm_conv - 1, cfg.lru), "bfloat16",
                              ("batch", "conv", "state")),
        }
    if kind not in ("attn", "local_attn", "moe"):
        raise _unported(f"the cache of {kind!r} blocks", _FRONTENDS)
    Tt = min(cfg.decode_tail, max(1, T))
    if cfg.attn_kind == "mla":
        r, dr = cfg.kv_lora_rank, cfg.rope_head_dim
        return {
            "ckv": ParamSpec((B, T, r), "bfloat16",
                             ("batch", "cache_seq", None)),
            "kr": ParamSpec((B, T, dr), "bfloat16",
                            ("batch", "cache_seq", None)),
            # two-tier append buffer (replicated): O(1) per-token writes
            "tckv": ParamSpec((B, Tt, r), "bfloat16", ("batch", None, None)),
            "tkr": ParamSpec((B, Tt, dr), "bfloat16", ("batch", None, None)),
        }
    K, hd = cfg.n_kv_heads, cfg.hd
    if kind == "local_attn":
        W = min(T, cfg.window or T)
        return {
            "k": ParamSpec((B, W, K, hd), "bfloat16",
                           ("batch", "cache_seq", "kv_heads", None)),
            "v": ParamSpec((B, W, K, hd), "bfloat16",
                           ("batch", "cache_seq", "kv_heads", None)),
        }
    return {
        "k": ParamSpec((B, T, K, hd), "bfloat16",
                       ("batch", "cache_seq", "kv_heads", None)),
        "v": ParamSpec((B, T, K, hd), "bfloat16",
                       ("batch", "cache_seq", "kv_heads", None)),
        "tk": ParamSpec((B, Tt, K, hd), "bfloat16",
                        ("batch", None, None, None)),
        "tv": ParamSpec((B, Tt, K, hd), "bfloat16",
                        ("batch", None, None, None)),
    }


def init_cache_specs(cfg: ModelConfig, batch: int,
                     cache_len: int) -> dict[str, ParamSpec]:
    if cfg.frontend != "none" or cfg.is_encdec:
        raise _unported(f"the {cfg.frontend!r} frontend / encoder-decoder "
                        "cache", _FRONTENDS)
    out: dict[str, ParamSpec] = {}
    for gi, (reps, pattern) in enumerate(cfg.groups()):
        for pj, kind in enumerate(pattern):
            for name, spec in _block_cache_specs(cfg, kind, batch,
                                                 cache_len).items():
                out[f"g{gi}/p{pj}/{name}"] = spec.stack(reps)
    return out


# ---------------------------------------------------------------------------
# Block forwards (one layer; ``p`` and ``cache`` without the layers axis)
# ---------------------------------------------------------------------------

def _qkv(cfg, p, h, positions):
    B, S, _ = h.shape
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = h @ p["wq"]
    k = h @ p["wk"]
    v = h @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, S, H, hd)
    k = k.reshape(B, S, K, hd)
    v = v.reshape(B, S, K, hd)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def _attn_block(cfg, p, x, positions, window=None):
    """Causal self-attention of a whole prompt (within ``window``, if
    given); returns (x, (k, v)), or for MLA (x, (c_kv, k_rope))."""
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    if cfg.attn_kind == "mla":
        o, cache = mla_attention(cfg, p, h, positions)
        return x + o, cache
    q, k, v = _qkv(cfg, p, h, positions)
    B, S = x.shape[:2]
    o = prefill_attention(q, k, v, causal=True, window=window)
    return x + o.reshape(B, S, -1) @ p["wo"], (k, v)


def _mlp_res(cfg, p, x):
    h = rms_norm(x, p["norm2"], cfg.norm_eps)
    pp = {k[4:]: v for k, v in p.items() if k.startswith("mlp_")}
    return x + mlp(pp, h, cfg.act)


def _ffn_res(cfg, kind, p, x):
    """The block's feed-forward half: the routed MLP of a ``moe`` block
    (returns its aux loss too), the dense MLP otherwise (aux None)."""
    if kind == "moe":
        y, aux = moe_mlp(cfg, p, rms_norm(x, p["norm2"], cfg.norm_eps))
        return x + y, aux
    return _mlp_res(cfg, p, x), None


def _block_prefill(cfg, kind, p, x, positions, cache):
    """The prompt through one block; fills ``cache`` in place."""
    if kind == "ssm":
        h = rms_norm(x, p["norm1"], cfg.norm_eps)
        o, (hs, conv) = mamba2_forward(cfg, p, h, return_state=True)
        cache["h"].copy_(hs)
        cache["conv"].copy_(conv)
        return x + o
    if kind == "rglru":
        h = rms_norm(x, p["norm1"], cfg.norm_eps)
        o, (hs, conv) = griffin_forward(cfg, p, h, return_state=True)
        cache["h"].copy_(hs)
        cache["conv"].copy_(conv)
        return _mlp_res(cfg, p, x + o)
    if kind == "local_attn":
        x, (k, v) = _attn_block(cfg, p, x, positions, window=cfg.window)
        # ring buffer: keep the last W positions, slot = absolute pos % W
        W = cache["k"].shape[1]
        S = k.shape[1]
        take = torch.arange(max(0, S - W), S, device=k.device)
        cache["k"][:, take % W] = k[:, take].to(cache["k"].dtype)
        cache["v"][:, take % W] = v[:, take].to(cache["v"].dtype)
        return _mlp_res(cfg, p, x)
    x, kv = _attn_block(cfg, p, x, positions)
    names = (("ckv", "tckv"), ("kr", "tkr")) if cfg.attn_kind == "mla" \
        else (("k", "tk"), ("v", "tv"))
    S = x.shape[1]
    Tt = cache[names[0][1]].shape[1]
    base = S - ((S - 1) % Tt + 1)  # the tail keeps 1..Tt positions
    for (main, tail), t in zip(names, kv):
        cache[main][:, :base] = t[:, :base]
        cache[tail][:, :S - base] = t[:, base:]
    return _ffn_res(cfg, kind, p, x)[0]


def _block_decode(cfg, kind, p, x, pos: int, positions, cache):
    """One token (x: (B,1,D)) at absolute position ``pos`` through one
    block.  ``attn`` and ``moe``: an O(1) write into the tail (MLA: the
    latent's); main is read only.  ``local_attn``: a write into ring slot
    pos % W.  ``ssm`` and ``rglru``: the state and the conv carry are
    overwritten."""
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    if kind == "ssm":
        o, hs, conv = mamba2_decode_step(cfg, p, h, cache["h"], cache["conv"])
        cache["h"].copy_(hs)
        cache["conv"].copy_(conv)
        return x + o
    if kind == "rglru":
        o, hs, conv = griffin_decode_step(cfg, p, h, cache["h"],
                                          cache["conv"])
        cache["h"].copy_(hs)
        cache["conv"].copy_(conv)
        return _mlp_res(cfg, p, x + o)
    if cfg.attn_kind == "mla":
        o, _, _ = mla_decode_two_tier(cfg, p, h, pos, cache["ckv"],
                                      cache["kr"], cache["tckv"],
                                      cache["tkr"])
        return _ffn_res(cfg, kind, p, x + o)[0]
    q, k, v = _qkv(cfg, p, h, positions)
    if kind == "local_attn":
        W = cache["k"].shape[1]
        cache["k"][:, pos % W] = k[:, 0]
        cache["v"][:, pos % W] = v[:, 0]
        # every resident slot is within the window by construction
        o = decode_attention(q, cache["k"], cache["v"], min(pos + 1, W))
        x = x + o.reshape(x.shape[0], 1, -1) @ p["wo"]
        return _mlp_res(cfg, p, x)
    slot = pos % cache["tk"].shape[1]
    cache["tk"][:, slot] = k[:, 0]
    cache["tv"][:, slot] = v[:, 0]
    o = decode_attention_two_tier(q, cache["k"], cache["v"], cache["tk"],
                                  cache["tv"], pos)
    x = x + o.reshape(x.shape[0], 1, -1) @ p["wo"]
    return _ffn_res(cfg, kind, p, x)[0]


def _layers(cfg, params, cache):
    """(kind, layer params, layer cache) of every block, in stack order: the
    reference's scan over the stacked "layers" axis as a loop of views."""
    for gi, (reps, pattern) in enumerate(cfg.groups()):
        gp = {k: t.unbind(0) for k, t in sub(params, f"g{gi}").items()}
        gc = {k: t.unbind(0) for k, t in sub(cache, f"g{gi}").items()}
        for layer in range(reps):
            for pj, kind in enumerate(pattern):
                yield (kind,
                       {k: t[layer] for k, t in sub(gp, f"p{pj}").items()},
                       {k: t[layer] for k, t in sub(gc, f"p{pj}").items()})


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------

def _embed(cfg, params, tokens):
    # index_select: its backward is deterministic on the card under
    # torch.use_deterministic_algorithms (indexing's need not be)
    x = params["embed/tok"].index_select(0, tokens.reshape(-1)).reshape(
        *tokens.shape, -1).to(getattr(torch, cfg.dtype))
    if cfg.scale_embeddings:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    return x


def _logits(cfg, params, x):
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = (params["embed/tok"].T if cfg.tie_embeddings
            else params["lm_head"])
    logits = x @ head.to(x.dtype)
    if cfg.logit_softcap > 0:
        c = cfg.logit_softcap
        logits = torch.tanh(logits / c) * c
    return logits


# ---------------------------------------------------------------------------
# Training forward (every ported kind)
# ---------------------------------------------------------------------------

def _block_train(cfg, kind, p, x, positions, aux):
    """Full-sequence block application (train): the reference's
    ``_block_train`` for the ported kinds; a ``moe`` block adds its
    load-balance loss to ``aux``.  Returns (x, aux).  Only differentiable
    plain paths: never a kernel of ``ops``."""
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    if kind == "ssm":
        return x + mamba2_forward(cfg, p, h, train=True), aux
    if kind == "rglru":
        return _mlp_res(cfg, p, x + griffin_forward(cfg, p, h,
                                                    train=True)), aux
    if cfg.attn_kind == "mla":
        x = x + mla_attention(cfg, p, h, positions, train=True)[0]
    else:
        q, k, v = _qkv(cfg, p, h, positions)
        B, S = x.shape[:2]
        window = cfg.window if kind == "local_attn" else None
        o = blockwise_attention(q, k, v, causal=True, window=window)
        x = x + o.reshape(B, S, -1) @ p["wo"]
    x, a = _ffn_res(cfg, kind, p, x)
    return x, aux if a is None else aux + a


# the products that remat="dots" keeps (the reference's
# checkpoint_dots_with_no_batch_dims): plain matrix products; the batched
# ones of attention are recomputed with everything else
_DOTS = {torch.ops.aten.mm.default, torch.ops.aten.addmm.default}


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(cfg: ModelConfig, fn):
    """The reference's ``_remat``: ``"full"`` recomputes the layer in the
    backward, ``"dots"`` saves its plain matrix products and recomputes the
    rest, ``"none"`` saves everything."""
    if cfg.remat == "none":
        return fn
    if cfg.remat == "dots":
        ctx = functools.partial(create_selective_checkpoint_contexts,
                                _save_dots)
        return lambda *a: checkpoint(fn, *a, use_reentrant=False,
                                     context_fn=ctx)
    return lambda *a: checkpoint(fn, *a, use_reentrant=False)  # "full"


def _scan_group_train(cfg, params, gi, reps, pattern, x, positions, aux):
    """The reference's scan over a group's stacked layers, as a loop; each
    layer is one remat unit.  Returns (x, aux)."""
    gp = sub(params, f"g{gi}")

    def body(x, aux, layer_params):
        for pj, kind in enumerate(pattern):
            x, aux = _block_train(cfg, kind, sub(layer_params, f"p{pj}"), x,
                                  positions, aux)
        return x, aux

    body = _remat(cfg, body)
    for layer in range(reps):
        x, aux = body(x, aux, {k: t[layer] for k, t in gp.items()})
    return x, aux


def make_loss_fn(cfg: ModelConfig):
    """Returns loss(params, batch) -> (loss, metrics).

    ``params``: the parameter tree as :func:`param_specs` gives it (not
    cast).  batch: inputs (B,S) and targets (B,S) integer tensors on the
    parameters' device (-1 = masked).  Masked next-token cross-entropy in
    float32 through ``logsumexp``, plus ``MOE_AUX_WEIGHT`` times the
    summed load-balance loss of the ``moe`` blocks; metrics ``ce``, ``aux``
    (0 without MoE blocks) and ``ntok``.
    """
    _check_ported(cfg)

    def loss_fn(params, batch):
        params = cast_params(cfg, params)
        x = _embed(cfg, params, batch["inputs"])
        positions = torch.arange(x.shape[1], device=x.device)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for gi, (reps, pattern) in enumerate(cfg.groups()):
            x, aux = _scan_group_train(cfg, params, gi, reps, pattern, x,
                                       positions, aux)
        logits = _logits(cfg, params, x)
        targets = batch["targets"]
        mask = (targets >= 0).float()
        tgt = torch.clamp(targets, min=0).long()
        lse = torch.logsumexp(logits.float(), dim=-1)
        tl = torch.gather(logits, -1, tgt[..., None])[..., 0]
        ce = (lse - tl.float()) * mask
        ntok = torch.clamp(mask.sum(), min=1.0)
        loss = ce.sum() / ntok
        if cfg.n_experts:
            loss = loss + MOE_AUX_WEIGHT * aux
        return loss, {"ce": ce.sum() / ntok, "aux": aux, "ntok": ntok}

    return loss_fn


# ---------------------------------------------------------------------------
# Public factories
# ---------------------------------------------------------------------------

def make_prefill_fn(cfg: ModelConfig):
    """Returns prefill(params, batch, cache0) -> (last_logits, cache0).

    ``params`` are cast by :func:`cast_params`.  ``batch["inputs"]``: (B, S) token ids on the parameters' device.
    ``cache0`` (zeros, sized by :func:`init_cache_specs`) is filled in
    place and returned.
    """
    _check_ported(cfg)

    @torch.no_grad()
    def prefill_fn(params, batch, cache0):
        x = _embed(cfg, params, batch["inputs"])
        positions = torch.arange(x.shape[1], device=x.device)
        for kind, p, c in _layers(cfg, params, cache0):
            x = _block_prefill(cfg, kind, p, x, positions, c)
        return _logits(cfg, params, x[:, -1:]), cache0

    return prefill_fn


def make_decode_fn(cfg: ModelConfig):
    """Returns decode(params, cache, tokens (B,1), pos) -> (logits, cache).

    ``params`` are cast by :func:`cast_params`; ``pos`` is the absolute position of ``tokens`` (a Python int); the
    cache is written in place and returned.
    """
    _check_ported(cfg)

    @torch.no_grad()
    def decode_fn(params, cache, tokens, pos: int):
        x = _embed(cfg, params, tokens)
        positions = torch.full((1,), pos, device=x.device)
        for kind, p, c in _layers(cfg, params, cache):
            x = _block_decode(cfg, kind, p, x, pos, positions, c)
        return _logits(cfg, params, x), cache

    return decode_fn
