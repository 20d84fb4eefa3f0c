"""Language model assembly for every family: specs, loss, prefill, decode.

The counterpart of ``repro.models.lm`` for dense GQA ``attn`` blocks (with
or without QKV bias), DeepSeek-V2's MLA attention, ``moe`` blocks (GQA or
MLA attention and a routed MLP with shared experts), Mamba-2 ``ssm`` blocks,
RecurrentGemma's ``rglru`` and ``local_attn`` blocks, and the two
frontends: LLaVA's projected patch embeddings (``mm_proj``) before the
text, and Whisper's encoder (``enc_attn`` blocks, full attention over the
frame embeddings, ``enc_norm``) under a decoder of ``xattn`` blocks (causal
self-attention, then cross-attention to the encoder's output), both
stacks with sinusoidal positions and no RoPE.  ``param_specs``,
``init_cache_specs``, the prefill and decode forwards and their
factories; names, shapes, dtypes, logical axes and init kinds are the
reference's.  ``make_loss_fn`` (training) covers every kind with the
reference's differentiable paths, which autograd differentiates:
:func:`~.attention.blockwise_attention` for ``attn``, ``moe``,
(windowed) ``local_attn``, ``enc_attn`` and both halves of ``xattn``
blocks and MLA, :func:`~.moe.moe_mlp` for the routed MLP (with the
load-balance loss, weighted ``MOE_AUX_WEIGHT``), :func:`~.ssm.ssd_chunked`
for ``ssm`` blocks and :func:`~.griffin.linear_scan` for ``rglru``
blocks; no kernel of the package runs in it (none has a backward).  In
prefill every whole-sequence attention goes to the kernel through
:func:`~.attention.prefill_attention`: causal self-attention, the
encoder's full attention over the frames, and the decoder's
cross-attention from the prompt to the frames (queries fewer than keys).

Conventions: params and caches are flat dicts ``g{gi}/p{pj}/<name>`` with
a leading "layers" axis of length ``reps``; the reference's scan over that
axis is a Python loop here.  Activations run in ``cfg.dtype`` (bf16),
norms, RoPE and softmax in float32.  Unlike the reference's pure
functions, prefill and decode write the cache they are given in place (a
KV cache is the largest tensor of a serving run; copying it per step would
double it).

Under the training rules on a mesh (:func:`~repro_torch.runtime.sharding
.use_rules`) the loss runs on each rank's blocks: every layer's parameters
are gathered over their FSDP axes inside its remat unit, the top-level
ones once (:func:`~repro_torch.runtime.partition.gather_block`); with
tensor parallelism attention runs on this model rank's heads (q/k/v
column-parallel, ``wo`` row-parallel; a rank whose heads need kv heads it
does not hold, or whose query columns split a head, gathers the
projections over "model" and takes what it needs), the embedding looks
up this rank's vocabulary rows and sums over "model", and the
cross-entropy is vocab-parallel: its logsumexp from an all-reduced max
and sum, the target logit from a masked sum.  Where the training rules
map the activations' "seq" (``train_rules(seq_shard=True)``, multi-pod
``tp=False``), the decoder's stream and the encoder's are split along
their positions over "model" (:func:`_prepare_inputs`): each rank
embeds, carries and computes its block of positions (global positions
for RoPE and Whisper's sinusoids; a VLM's patches are the first blocks'
rows).  With tensor parallelism each region gathers the positions at its
entry and reduce-scatters at its exit (the embedding's sum too, the
head's entry gathers every position for the vocab-parallel CE); without
it attention gathers the keys and values over the positions and each
rank's queries attend from their offset, and the CE of the rank's text
rows is summed over "model".  A Mamba-2 or RG-LRU scan outside a region
and the MoE's dispatch run on the gathered sequence.  Under the serving rules
prefill and decode run the same regions on each rank's blocks (the
``/wsharded`` rules' FSDP blocks gathered a layer at a time), the cache
being the rank's block too: its kv heads (``serve_rules(kv_shard=
"heads")``) or its positions (``"seq"``; the decode attends them with
every query head and the ranks' partials are combined), the append tail
replicated, an SSM state the rank's heads, an RG-LRU state and conv carry
its channels; the logits returned are the rank's block of the
vocabulary.  The values are the reference's.

Positions: LLaVA's patches take positions 0 .. img_tokens - 1 and the
text follows, so its decode positions count the patches; the loss drops
the patch positions before the head.

Two-tier KV cache: ``k``/``v`` (main, length ``cache_len``) and
``tk``/``tv`` (tail, ``decode_tail`` slots; position p at slot p % Tt);
an MLA block's is the latent ``ckv``/``kr`` (main) and ``tckv``/``tkr``
(tail), the same way, and so is an ``xattn`` block's self half.  Decode
writes the tail; :func:`merge_tail` (the engine calls it) merges a full
tail into main before the step at a multiple of Tt.  Prefill leaves the
state that decoding the prompt one token at a time would leave: the tail
holds the prompt's last ``(S - 1) % Tt + 1`` positions, so a prompt whose
length is a multiple of Tt ends with a full tail, which the first step's
merge writes exactly.  (The reference puts all S positions in main in that
case, and its first merge then writes the empty tail over them: ROADMAP
queue C.)

Cross-attention cache (``xattn``): ``xk``/``xv`` (B, enc_len, K, hd), the
encoder output's keys and values, written by prefill from slot 0 and read
by every decode step, which attends all ``enc_len`` slots (as the
reference's does); the engine takes frames of exactly ``enc_len``.

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

import dataclasses
import functools
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..perf.op_analysis import loop_mark
from ..runtime.collectives import axis_groups, flash_decode_psum, psum
from ..runtime.partition import (UNIT, all_reduce_max, block_plans,
                                 cache_seq_block, enter, gather,
                                 gather_block, leave, model_axis,
                                 seq_gather, seq_param, seq_scatter,
                                 sequence_parallel, stream_axis, tp_axis,
                                 whole)
from ..runtime.sharding import (batch_axes, current_mesh, current_rules,
                                is_train_rules, mesh_shape, note, use_rules)
from .attention import (blockwise_attention, decode_attention,
                        decode_attention_two_tier, prefill_attention)
from .config import ModelConfig
from .griffin import griffin_decode_step, griffin_forward
from .layers import mlp, rms_norm, rope, sinusoidal_positions
from .mla import mla_attention, mla_decode_two_tier
from .moe import moe_mlp
from .spec import ParamSpec, sub
from .ssm import mamba2_decode_step, mamba2_forward

__all__ = ["param_specs", "init_cache_specs", "cast_params", "make_loss_fn",
           "make_prefill_fn", "make_decode_fn", "merge_tail",
           "TAIL_TO_MAIN", "MOE_AUX_WEIGHT"]

MOE_AUX_WEIGHT = 0.01

# parameters kept in f32 inside the (bf16) forward pass
_KEEP_F32 = {"A_log", "dt_bias", "D", "lam", "b_i", "b_r", "router"}


def _check_ported(cfg: ModelConfig) -> None:
    """Raise for attention kinds that no configuration of the reference
    pairs with a block kind: MLA serves ``attn`` and ``moe`` blocks only."""
    kinds = {kind for _, pattern in cfg.groups() for kind in pattern}
    if cfg.is_encdec:
        kinds.add("enc_attn")
    if (kinds & {"local_attn", "xattn", "enc_attn"}
            and cfg.attn_kind != "gqa") or (
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
    if kind not in ("attn", "local_attn", "moe", "xattn", "enc_attn"):
        raise ValueError(f"unknown block kind {kind!r}")
    s: dict[str, ParamSpec] = {"norm1": _norm(D)}
    s.update(_mla_specs(cfg) if cfg.attn_kind == "mla" else _attn_specs(cfg))
    s["norm2"] = _norm(D)
    if kind == "xattn":  # whisper decoder: + cross attention
        s["normx"] = _norm(D)
        s.update(_attn_specs(cfg, prefix="x_"))
    s.update(_moe_specs(cfg) if kind == "moe" else _mlp_specs(cfg))
    return s


def param_specs(cfg: ModelConfig) -> dict[str, ParamSpec]:
    """Full parameter spec dict for an architecture."""
    D, V = cfg.d_model, cfg.vocab
    out: dict[str, ParamSpec] = {
        "embed/tok": ParamSpec((V, D), cfg.param_dtype, ("vocab", "fsdp"),
                               init="embed"),
        "final_norm": _norm(D),
    }
    if not cfg.tie_embeddings:
        out["lm_head"] = ParamSpec((D, V), cfg.param_dtype, ("fsdp", "vocab"))
    if cfg.frontend == "vlm_stub":
        out["mm_proj"] = ParamSpec((D, D), cfg.param_dtype, ("fsdp", None))
    if cfg.is_encdec:
        for name, spec in _block_specs(cfg, "enc_attn").items():
            out[f"enc/g0/p0/{name}"] = spec.stack(cfg.enc_layers)
        out["enc_norm"] = _norm(D)
    for gi, (reps, pattern) in enumerate(cfg.groups()):
        for pj, kind in enumerate(pattern):
            for name, spec in _block_specs(cfg, kind).items():
                out[f"g{gi}/p{pj}/{name}"] = spec.stack(reps)
    return out


# ---------------------------------------------------------------------------
# Cache specs
# ---------------------------------------------------------------------------

def _block_cache_specs(cfg: ModelConfig, kind: str, B: int, T: int,
                       enc_T: int = 0) -> dict[str, ParamSpec]:
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
    if kind not in ("attn", "local_attn", "moe", "xattn"):
        raise ValueError(f"no decoder cache for {kind!r} blocks")
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
    s = {
        "k": ParamSpec((B, T, K, hd), "bfloat16",
                       ("batch", "cache_seq", "kv_heads", None)),
        "v": ParamSpec((B, T, K, hd), "bfloat16",
                       ("batch", "cache_seq", "kv_heads", None)),
        "tk": ParamSpec((B, Tt, K, hd), "bfloat16",
                        ("batch", None, None, None)),
        "tv": ParamSpec((B, Tt, K, hd), "bfloat16",
                        ("batch", None, None, None)),
    }
    if kind == "xattn":  # the encoder output's keys and values
        s["xk"] = ParamSpec((B, enc_T, K, hd), "bfloat16",
                            ("batch", "cache_seq", "kv_heads", None))
        s["xv"] = ParamSpec((B, enc_T, K, hd), "bfloat16",
                            ("batch", "cache_seq", "kv_heads", None))
    return s


def init_cache_specs(cfg: ModelConfig, batch: int, cache_len: int,
                     enc_len: int = 0) -> dict[str, ParamSpec]:
    """The decode state of every block; ``enc_len``: the encoder context
    of an encoder-decoder model (its ``xattn`` blocks' ``xk``/``xv``)."""
    out: dict[str, ParamSpec] = {}
    for gi, (reps, pattern) in enumerate(cfg.groups()):
        for pj, kind in enumerate(pattern):
            for name, spec in _block_cache_specs(cfg, kind, batch, cache_len,
                                                 enc_len).items():
                out[f"g{gi}/p{pj}/{name}"] = spec.stack(reps)
    return out


# ---------------------------------------------------------------------------
# Block forwards (one layer; ``p`` and ``cache`` without the layers axis)
# ---------------------------------------------------------------------------

def _use_rope(cfg: ModelConfig) -> bool:
    """Whisper (the audio family) has sinusoidal positions, not RoPE."""
    return cfg.family != "audio"


def _attend(q, k, v, *, causal: bool, window=None, train: bool = False,
            q_offset: int = 0):
    """Attention of a whole sequence from position 0: the differentiable
    online-softmax scan in training (``q_offset``: the position of the
    first query, where they are a rank's block of them), the prefill
    kernel otherwise."""
    if train:
        return blockwise_attention(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset)
    return prefill_attention(q, k, v, causal=causal, window=window)


def _note_every_position(what: str, sq) -> None:
    note(what, f"the stream gathered over 'model' along its positions "
         f"(model={sq.n}): every position computed on each rank")


def _on_every_position(fn, h, sq, what: str):
    """``fn(h_all, positions)`` on the whole sequence of ``h``, this rank's
    block of a stream split over ``sq`` along its positions, and this
    rank's block of the result: a module that reads every position (a
    scan, the MoE's dispatch; under sequence parallelism one whose weights
    are whole).  Recorded once under ``what``."""
    _note_every_position(what, sq)
    h = seq_gather(h, sq)
    return seq_scatter(fn(h, torch.arange(h.shape[1], device=h.device)),
                       sq)


def _attn_block(cfg, p, x, positions, *, causal=True, window=None,
                train=False, sq=UNIT):
    """Self-attention of a whole sequence (causal but in the encoder;
    within ``window``, if given); returns (x, (k, v)), or for MLA (x,
    (c_kv, k_rope)).  ``sq``: the axis ``x`` is split over along its
    positions (training; ``positions`` are the rank's)."""
    h = rms_norm(x, seq_param(p["norm1"], sq), cfg.norm_eps)
    if cfg.attn_kind == "mla":
        full = cfg.n_heads * (cfg.nope_head_dim + cfg.rope_head_dim)
        if sequence_parallel(sq) \
                and tp_axis(p["wq_b"].shape[-1], full).n == 1:
            return x + _on_every_position(lambda hh, pos: mla_attention(
                cfg, p, hh, pos, train=train)[0], h, sq,
                "attention/mla"), None
        o, cache = mla_attention(cfg, p, h, positions, train=train, sq=sq)
        return x + o, cache
    ax = tp_axis(p["wq"].shape[-1], cfg.n_heads * cfg.hd, sq)
    if ax.n == 1 and sequence_parallel(sq):
        return x + _on_every_position(lambda hh, pos: _heads(
            cfg, p, hh, hh, pos, ax, causal=causal, window=window,
            train=train, rope_on=_use_rope(cfg))[0], h, sq,
            "attention/self"), None
    o, kv = _heads(cfg, p, h, h, positions, ax, causal=causal,
                   window=window, train=train, rope_on=_use_rope(cfg),
                   sq=sq)
    return x + o, kv


def _proj(x, p, name, bias, full: int, ax):
    """``x @ p[name]`` (+ ``p[bias]``) inside a region over ``ax``: (this
    rank's block of the ``full`` columns, True), or for a weight held
    whole under tensor parallelism (every column, False)."""
    w = p[name]
    b = p[bias] if bias else None
    if ax.split(w.shape[-1], full):
        y = x @ w
        return (y if b is None else y + b), True
    y = x @ whole(w, ax)
    return (y if b is None else y + whole(b, ax)), False


def _kv_for(t, a: int, b: int, H: int, K: int, klo: int = 0):
    """The kv heads that query heads [a, b) use, from ``t`` (B, T, Kt, d),
    which holds kv heads [klo, klo + Kt): a slice where each of them
    serves as many of the queries (``t`` itself where that is all of
    them), else one kv head per query."""
    G = H // K
    lo, hi = a // G, (b - 1) // G + 1
    per = (b - a) // (hi - lo)
    if all((i - a) // per == i // G - lo for i in range(a, b)) \
            and per * (hi - lo) == b - a:
        if (lo - klo, hi - klo) == (0, t.shape[2]):
            return t
        return t[:, :, lo - klo:hi - klo]
    idx = torch.tensor([i // G - klo for i in range(a, b)], device=t.device)
    return t.index_select(2, idx)


def _wo(p, o, ax, prefix=""):
    """The attention output ``o`` (B, S, heads, dv) of this rank's query
    heads through ``wo``'s rows, summed over "model"; where every head is
    here (its columns split a head), ``wo``'s rows take their columns."""
    B, S = o.shape[:2]
    o = o.reshape(B, S, -1)
    wo = p[prefix + "wo"]
    if o.shape[-1] != wo.shape[0]:
        lo_c, hi_c = ax.block(o.shape[-1])
        o = o[..., lo_c:hi_c]
    return leave(o @ wo, ax)


def _heads(cfg, p, h, src, positions, ax, *, prefix="", causal, window,
           train, rope_on, sq=UNIT, src_sq=None):
    """Attention of a whole sequence on this model rank's query heads (on
    :data:`~repro_torch.runtime.partition.UNIT`, every head: the plain
    computation): queries from ``h``, keys and values from ``src`` (``h``
    itself for self-attention), q/k/v column-parallel and ``wo``
    row-parallel, the result summed over "model".  Where this rank's kv
    columns split a kv
    head, or hold kv heads its queries do not use, k and v are gathered
    over "model" and the heads its queries use taken; where its query
    columns split a head, q is gathered too and every head computed, and
    ``wo``'s rows take their columns of the result.  Returns (out, (k,
    v)): the keys and values for the cache (RoPE applied; outside
    training), every kv head or, where this rank's kv columns are its
    block of whole kv heads, that block.

    ``sq`` and ``src_sq`` (by default ``sq``): the axes ``h`` and ``src``
    are split over along their positions (``positions``: ``h``'s).  In a
    region (sequence parallelism) its entry gathers the positions; without
    one (token parallelism) the rank's queries attend every position's
    keys and values, gathered over the positions."""
    src_sq = sq if src_sq is None else src_sq
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    bias = cfg.qkv_bias and not prefix
    hq = enter(h, ax)
    hk = hq if src is h else enter(src, dataclasses.replace(
        ax, seq=src_sq.n > 1) if ax.n > 1 else ax)
    B, S, _ = hq.shape
    T = hk.shape[1]
    q_offset = 0
    if ax.seq:  # every position, gathered at the region's entry
        positions = torch.arange(S, device=hq.device)
    elif sq.n > 1:
        q_offset = sq.block(S * sq.n)[0]
    q, _ = _proj(hq, p, prefix + "wq", bias and "bq", H * hd, ax)
    k, k_split = _proj(hk, p, prefix + "wk", bias and "bk", K * hd, ax)
    v, v_split = _proj(hk, p, prefix + "wv", bias and "bv", K * hd, ax)
    ctx = f"attention/{prefix or 'self'}"
    if H % ax.n:  # this rank's query columns split a head
        note(ctx, f"{H} query heads on model={ax.n}: q, k and v gathered "
             "over 'model', every head computed on each rank")
        q = gather(q, -1, ax)
        a, b = 0, H
    else:
        a, b = ax.block(H)
    if k_split and K % ax.n == 0 and H % ax.n == 0:
        k = k.reshape(B, T, K // ax.n, hd)
        v = v.reshape(B, T, K // ax.n, hd)
        if rope_on:
            k = rope(k, positions, cfg.rope_theta)
        kv = k, v
    else:
        if k_split or v_split:
            note(ctx, f"{K} kv heads on model={ax.n}: k and v gathered over "
                 "'model', each rank takes the kv heads of its queries")
        kc = (gather(k, -1, ax) if k_split else k).reshape(B, T, K, hd)
        vc = (gather(v, -1, ax) if v_split else v).reshape(B, T, K, hd)
        k, v = _kv_for(kc, a, b, H, K), _kv_for(vc, a, b, H, K)
        if rope_on:  # after the selection, in the order training takes
            # its gradients in; the cache's every kv head apart
            kr = rope(k, positions, cfg.rope_theta)
            kc = kr if k is kc else (
                kc if train else rope(kc, positions, cfg.rope_theta))
            k = kr
        kv = kc, vc
    if ax.n == 1 and src_sq.n > 1:  # token parallelism: every key
        note(ctx, f"k and v gathered over 'model' along the positions "
             f"(model={src_sq.n}): each rank's queries attend every key")
        k, v = gather(k, 1, src_sq), gather(v, 1, src_sq)
    q = q.reshape(B, S, b - a, hd)
    if rope_on:
        q = rope(q, positions, cfg.rope_theta)
    o = _attend(q, k, v, causal=causal, window=window, train=train,
                q_offset=q_offset)
    return _wo(p, o, ax, prefix), kv


def _decode_q(cfg, p, h, ax, prefix=""):
    """The one token's queries (B, 1, b - a, hd) of this rank's heads [a,
    b) (every head where its columns split one), no RoPE, and (a, b)."""
    B = h.shape[0]
    H, hd = cfg.n_heads, cfg.hd
    bias = cfg.qkv_bias and not prefix and "bq"
    q, _ = _proj(enter(h, ax), p, prefix + "wq", bias, H * hd, ax)
    if H % ax.n:
        note(f"attention/{prefix or 'self'}", f"{H} query heads on model="
             f"{ax.n}: q, k and v gathered over 'model', every head "
             "computed on each rank")
        q = gather(q, -1, ax)
        a, b = 0, H
    else:
        a, b = ax.block(H)
    return q.reshape(B, 1, b - a, hd), (a, b)


def _decode_kv(cfg, p, h, ax):
    """The one token's k and v (B, 1, K, hd) over every kv head (gathered
    over "model" where this rank holds a block of the columns: the tail
    and a seq-split cache hold every kv head), no RoPE."""
    B = h.shape[0]
    K, hd = cfg.n_kv_heads, cfg.hd
    hk = enter(h, ax)
    out = []
    for name in ("k", "v"):
        t, split = _proj(hk, p, "w" + name, cfg.qkv_bias and "b" + name,
                         K * hd, ax)
        out.append((gather(t, -1, ax) if split else t).reshape(B, 1, K, hd))
    return out


def _kv_heads(t, want: int, K: int):
    """``t`` (B, T, Kt, hd), every kv head or this model rank's block of
    them, as the ``want`` heads a cache block holds (every one, or the
    rank's block)."""
    if t.shape[2] == want:
        return t
    ax = model_axis()
    if want == K:
        return gather(t, 2, ax)
    lo, hi = ax.block(K)
    return t[:, :, lo:hi]


def _kv_lo(t, K: int) -> int:
    """The first kv head a cache block ``t`` (B, T, Kt, hd) holds."""
    return 0 if t.shape[2] == K else model_axis().block(K)[0]


def _seq_layout(t, full: int | None):
    """(lo, n, split) of a cache block ``t``'s positions (dimension 1):
    the first global position it holds, the cache's length and whether
    the positions are split over "model"."""
    lo, hi = cache_seq_block(t.shape[1], full)
    n = full if full is not None else t.shape[1]
    return lo, n, hi - lo < n


def _put(block, lo: int, start: int, t, dim: int = 1) -> None:
    """Write ``t``'s positions ``start ..`` (along ``dim``) into ``block``,
    a cache's positions ``lo .. lo + block.shape[dim] - 1``: those of them
    it holds."""
    a = max(start, lo)
    b = min(start + t.shape[dim], lo + block.shape[dim])
    if a < b:
        block.narrow(dim, a - lo, b - a).copy_(t.narrow(dim, a - start,
                                                        b - a))


def _combined(q, H: int, ab, ax, partial):
    """Decode attention over a cache split over "model" along its
    positions: every query head (``q``, this rank's heads ``ab``, gathered
    over "model" where that is a block of them), each rank's online-softmax
    partial over its positions (``partial(q)``), combined by
    ``flash_decode_psum``; returns this rank's heads of the result."""
    a, b = ab
    if b - a < H:
        q = gather(q, 2, ax)
    num, den, m = partial(q)
    return flash_decode_psum(num, den, m, "model").to(q.dtype)[:, :, a:b]


def _ring_len(cfg, cache_len: int | None) -> int | None:
    """A ``local_attn`` ring's slots for a cache of ``cache_len``."""
    if cache_len is None:
        return None
    return min(cache_len, cfg.window or cache_len)


def _xattn_cross(cfg, p, x, *, enc_out=None, cached_kv=None, enc_len=None,
                 train=False, sq=UNIT, enc_sq=UNIT):
    """Cross-attention sub-block of an ``xattn`` block: queries from x,
    keys and values from the encoder's output ``enc_out`` (full attention
    of the whole sequence, queries fewer than keys) or from the cache
    (``cached_kv``: one decode step over every cached slot, of
    ``enc_len``; split over "model" along its positions, a partial each
    rank combines).  Returns (x, (k, v)).  ``sq`` and ``enc_sq``: the
    axes ``x`` and ``enc_out`` are split over along their positions
    (training)."""
    H, hd = cfg.n_heads, cfg.hd
    h = rms_norm(x, seq_param(p["normx"], sq), cfg.norm_eps)
    ax = tp_axis(p["x_wq"].shape[-1], H * hd, sq)
    if cached_kv is None:
        if ax.n == 1 and sequence_parallel(sq):
            enc = seq_gather(enc_out, enc_sq)
            return x + _on_every_position(lambda hh, _: _heads(
                cfg, p, hh, enc, None, ax, prefix="x_", causal=False,
                window=None, train=train, rope_on=False)[0], h, sq,
                "attention/x_"), None
        o, kv = _heads(cfg, p, h, enc_out, None, ax, prefix="x_",
                       causal=False, window=None, train=train, rope_on=False,
                       sq=sq, src_sq=enc_sq)
        return x + o, kv
    q, ab = _decode_q(cfg, p, h, ax, prefix="x_")
    k, v = cached_kv
    lo, n, split = _seq_layout(k, enc_len)
    if split:
        o = _combined(q, H, ab, ax, lambda qa: decode_attention(
            qa, k, v, n, offset=lo))
    else:
        klo = _kv_lo(k, cfg.n_kv_heads)
        o = decode_attention(q, _kv_for(k, *ab, H, cfg.n_kv_heads, klo),
                             _kv_for(v, *ab, H, cfg.n_kv_heads, klo),
                             k.shape[1])
    return x + _wo(p, o, ax, "x_"), (k, v)


def _mlp_res(cfg, p, x, sq=UNIT):
    h = rms_norm(x, seq_param(p["norm2"], sq), cfg.norm_eps)
    pp = {k[4:]: v for k, v in p.items() if k.startswith("mlp_")}
    return x + mlp(pp, h, cfg.act, d_ff=cfg.d_ff, sq=sq)


def _ffn_res(cfg, kind, p, x, sq=UNIT):
    """The block's feed-forward half: the routed MLP of a ``moe`` block
    (returns its aux loss too; on every position of a stream split over
    ``sq``, as the reference's dispatch reads the data shard's tokens),
    the dense MLP otherwise (aux None)."""
    if kind == "moe":
        h = rms_norm(x, seq_param(p["norm2"], sq), cfg.norm_eps)
        if sq.n == 1:
            y, aux = moe_mlp(cfg, p, h)
            return x + y, aux
        _note_every_position("moe/dispatch", sq)
        y, aux = moe_mlp(cfg, p, seq_gather(h, sq))
        return x + seq_scatter(y, sq), aux
    return _mlp_res(cfg, p, x, sq), None


def _block_prefill(cfg, kind, p, x, positions, cache, enc_out=None,
                   lens=(None, None)):
    """The prompt through one block; fills ``cache`` in place (an
    ``xattn`` block's ``xk``/``xv`` from ``enc_out``): the positions and
    kv heads its blocks hold, under a mesh (``lens``: the cache's and the
    encoder context's lengths, for a cache split along its positions)."""
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
    K = cfg.n_kv_heads
    if kind == "local_attn":
        x, kv = _attn_block(cfg, p, x, positions, window=cfg.window)
        # ring buffer: keep the last W positions, slot = absolute pos % W
        lo, W, _ = _seq_layout(cache["k"], _ring_len(cfg, lens[0]))
        S = kv[0].shape[1]
        first = max(0, S - W)
        s0 = first % W
        n1 = min(S - first, W - s0)  # up to the ring's end, then from 0
        for name, t in zip("kv", kv):
            c = cache[name]
            t = _kv_heads(t, c.shape[2], K)
            _put(c, lo, s0, t[:, first:first + n1])
            _put(c, lo, 0, t[:, first + n1:])
        return _mlp_res(cfg, p, x)
    x, kv = _attn_block(cfg, p, x, positions)
    names = (("ckv", "tckv"), ("kr", "tkr")) if cfg.attn_kind == "mla" \
        else (("k", "tk"), ("v", "tv"))
    S = x.shape[1]
    Tt = cache[names[0][1]].shape[1]
    base = S - ((S - 1) % Tt + 1)  # the tail keeps 1..Tt positions
    for (main, tail), t in zip(names, kv):
        m = cache[main]
        t_main = t_tail = t
        if cfg.attn_kind != "mla":  # the tail holds every kv head
            t_main, t_tail = _kv_heads(t, m.shape[2], K), _kv_heads(t, K, K)
        _put(m, _seq_layout(m, lens[0])[0], 0, t_main[:, :base])
        cache[tail][:, :S - base] = t_tail[:, base:]
    if kind == "xattn":
        x, kv = _xattn_cross(cfg, p, x, enc_out=enc_out)
        n = lens[1] if lens[1] is not None else enc_out.shape[1]
        for name, t in zip(("xk", "xv"), kv):
            c = cache[name]
            _put(c, _seq_layout(c, n)[0], 0, _kv_heads(t, c.shape[2], K))
    return _ffn_res(cfg, kind, p, x)[0]


def _block_decode(cfg, kind, p, x, pos: int, positions, cache,
                  lens=(None, None)):
    """One token (x: (B,1,D)) at absolute position ``pos`` through one
    block.  ``attn``, ``moe`` and ``xattn``: an O(1) write into the tail
    (MLA: the latent's); main is read only; an ``xattn`` block then
    attends the cached encoder output.  ``local_attn``: a write into ring
    slot pos % W.  ``ssm`` and ``rglru``: the state and the conv carry are
    overwritten.  Under a mesh on this rank's heads and cache blocks: the
    new token's k and v are gathered to every kv head for the replicated
    tail, and a cache split along its positions (``lens``: its and the
    encoder context's lengths) is attended by every query head, each
    rank's partial combined (the tail counted on model rank 0)."""
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
        lo, _, split = _seq_layout(cache["ckv"], lens[0])
        o, _, _ = mla_decode_two_tier(cfg, p, h, pos, cache["ckv"],
                                      cache["kr"], cache["tckv"],
                                      cache["tkr"],
                                      offset=lo if split else None)
        return _ffn_res(cfg, kind, p, x + o)[0]
    H, K = cfg.n_heads, cfg.n_kv_heads
    ax = tp_axis(p["wq"].shape[-1], H * cfg.hd)
    q, ab = _decode_q(cfg, p, h, ax)
    k, v = _decode_kv(cfg, p, h, ax)
    if _use_rope(cfg):
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    if kind == "local_attn":
        ck, cv = cache["k"], cache["v"]
        lo, W, split = _seq_layout(ck, _ring_len(cfg, lens[0]))
        _put(ck, lo, pos % W, _kv_heads(k, ck.shape[2], K))
        _put(cv, lo, pos % W, _kv_heads(v, cv.shape[2], K))
        # every resident slot is within the window by construction
        n = min(pos + 1, W)
        if split:
            o = _combined(q, H, ab, ax, lambda qa: decode_attention(
                qa, ck, cv, n, offset=lo))
        else:
            klo = _kv_lo(ck, K)
            o = decode_attention(q, _kv_for(ck, *ab, H, K, klo),
                                 _kv_for(cv, *ab, H, K, klo), n)
        return _mlp_res(cfg, p, x + _wo(p, o, ax))
    tk, tv, mk, mv = (cache[n] for n in ("tk", "tv", "k", "v"))
    slot = pos % tk.shape[1]
    tk[:, slot] = k[:, 0]
    tv[:, slot] = v[:, 0]
    lo, _, split = _seq_layout(mk, lens[0])
    if split:
        o = _combined(q, H, ab, ax, lambda qa: decode_attention_two_tier(
            qa, mk, mv, tk, tv, pos, offset=lo,
            with_tail=model_axis().j == 0))
    else:
        klo = _kv_lo(mk, K)
        o = decode_attention_two_tier(
            q, _kv_for(mk, *ab, H, K, klo), _kv_for(mv, *ab, H, K, klo),
            _kv_for(tk, *ab, H, K), _kv_for(tv, *ab, H, K), pos)
    x = x + _wo(p, o, ax)
    if kind == "xattn":
        x = _xattn_cross(cfg, p, x, cached_kv=(cache["xk"], cache["xv"]),
                         enc_len=lens[1])[0]
    return _ffn_res(cfg, kind, p, x)[0]


def merge_tail(cache: dict, pos: int, *, cache_len: int | None = None
               ) -> None:
    """Before the decode step at ``pos``, a multiple of the tail's length
    Tt: the full tail of every two-tier cache (``tk``/``tv``, MLA's
    ``tckv``/``tkr``) is written into main at positions ``pos - Tt ..
    pos - 1``, in place.  Under a mesh each rank writes what its block of
    main holds of the replicated tail: its positions where the rules split
    main along them (``cache_len``: main's length; they may straddle two
    ranks' blocks), its kv heads where they split those."""
    for k, t in cache.items():
        leaf = k.split("/")[-1]
        main_leaf = TAIL_TO_MAIN.get(leaf)
        if main_leaf is None:
            continue
        tt = t.shape[2]  # (reps, B, Tt, ...)
        if not (pos > 0 and pos % tt == 0):
            return
        main = cache[k[: -len(leaf)] + main_leaf]
        if t.ndim == 5 and main.shape[3] != t.shape[3]:  # kv heads split
            t = t[:, :, :, slice(*model_axis().block(t.shape[3]))]
        lo, _ = cache_seq_block(main.shape[2], cache_len)
        _put(main, lo, pos - tt, t, dim=2)


# a two-tier cache's tail -> its main (an SSM or RG-LRU state is
# overwritten every step and a local attention ring is written in place:
# neither has a tail)
TAIL_TO_MAIN = {"tk": "k", "tv": "v", "tckv": "ckv", "tkr": "kr"}


def _layer(gp, prefix: str, layer: int, plans=None):
    """Layer ``layer``'s parameters of the unbound stack ``gp`` (name ->
    layers), under ``prefix``; with ``plans`` (under a mesh) each block
    gathered by its plan first (FSDP, the router's experts)."""
    p = {k: t[layer] for k, t in sub(gp, prefix).items()}
    if plans:
        p = {k: gather_block(t, plans[f"{prefix}/{k}"], current_mesh(),
                             offset=1) for k, t in p.items()}
    return p


def _layers(cfg, params, cache, plans=None):
    """(kind, layer params, layer cache) of every block, in stack order: the
    reference's scan over the stacked "layers" axis as a loop of views
    (``plans``: :func:`_layer`'s)."""
    for gi, (reps, pattern) in enumerate(cfg.groups()):
        gp = {k: t.unbind(0) for k, t in sub(params, f"g{gi}").items()}
        gc = {k: t.unbind(0) for k, t in sub(cache, f"g{gi}").items()}
        gp = {f"g{gi}/{k}": t for k, t in gp.items()}
        for layer in range(reps):
            loop_mark(f"g{gi}", layer, reps)  # for a cost counter, if any
            for pj, kind in enumerate(pattern):
                yield (kind, _layer(gp, f"g{gi}/p{pj}", layer, plans),
                       {k: t[layer] for k, t in sub(gc, f"p{pj}").items()})
        loop_mark(f"g{gi}", reps, reps)


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------

def _embed(cfg, params, tokens, *, sq=UNIT, lead: int = 0):
    """Token embeddings in the compute dtype.  Where ``embed/tok`` holds
    this model rank's rows of the vocabulary (under tensor parallelism),
    each rank looks up the ids it holds, zeros the rest, and
    the lookups are summed over "model".

    ``sq``: the axis the stream is split over along its positions, whose
    first ``lead`` positions are not text (a VLM's patches): the
    embeddings of the text rows of this rank's block of positions.  Under
    sequence parallelism the rank's vocabulary rows are looked up for
    every text position and the sum over "model" is reduce-scattered to
    the rank's positions."""
    emb = params["embed/tok"]
    ax = tp_axis(emb.shape[0], cfg.vocab, sq)
    lo, hi = sq.block(lead + tokens.shape[1])
    if sq.n > 1 and not ax.seq:  # the text rows of this rank's positions
        a = max(lo, lead) - lead
        tokens = tokens[:, a:max(a, hi - lead)]
        emb = seq_param(emb, sq)
    ids = tokens.reshape(-1)
    if ax.n > 1:
        vlo, vhi = ax.block(cfg.vocab)
        ok = (ids >= vlo) & (ids < vhi)
        # index_select: its backward is deterministic on the card
        x = emb.index_select(0, torch.where(ok, ids - vlo, 0))
        x = torch.where(ok[:, None], x, torch.zeros(
            (), dtype=x.dtype, device=x.device))
        if ax.seq:  # every text position's, reduce-scattered to the rank's
            x = F.pad(x.reshape(*tokens.shape, -1), (0, 0, lead, 0))
            x = leave(x, ax)[:, max(lead - lo, 0):]
        else:
            x = leave(x, ax).reshape(*tokens.shape, x.shape[-1])
    else:
        # index_select: its backward is deterministic on the card under
        # torch.use_deterministic_algorithms (indexing's need not be)
        x = emb.index_select(0, ids).reshape(*tokens.shape, emb.shape[-1])
    x = x.to(getattr(torch, cfg.dtype))
    if cfg.scale_embeddings:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    return x


def _head(cfg, params, sq=UNIT):
    """The output head (the tied embedding's transpose, or ``lm_head``)
    and the axis its region runs over (``sq``: the stream's)."""
    head = (params["embed/tok"].T if cfg.tie_embeddings
            else params["lm_head"])
    return head, tp_axis(head.shape[-1], cfg.vocab, sq)


def _logits(cfg, params, x, *, sq=UNIT, lead: int = 0):
    """Logits of the final-normed ``x`` past its first ``lead`` positions
    (a VLM's patches): over this model rank's block of the vocabulary
    where the head holds one (``x`` enters a region).  ``sq``: the axis
    ``x`` is split over along its positions (``x`` the rank's block):
    under sequence parallelism the region's entry gathers them, and the
    logits are every text position's; otherwise the rank's text rows'."""
    head, ax = _head(cfg, params, sq)
    norm = seq_param(params["final_norm"], sq)
    if ax.seq:  # normed on the rank's positions, gathered at the entry
        x = enter(rms_norm(x, norm, cfg.norm_eps), ax)[:, lead:]
    else:
        lo = sq.block(x.shape[1] * sq.n)[0]
        x = enter(rms_norm(x[:, max(lead - lo, 0):], norm, cfg.norm_eps),
                  ax)
        head = seq_param(head, sq)
    logits = x @ head.to(x.dtype)
    if cfg.logit_softcap > 0:
        c = cfg.logit_softcap
        logits = torch.tanh(logits / c) * c
    return logits


def _ce_terms(cfg, logits, tgt):
    """(logsumexp over the vocabulary in float32, the target's logit) of
    every position.  Vocab-parallel where ``logits`` are this model rank's
    block of more than one (the max and the sum of exponentials
    all-reduced, the target's logit a masked sum over "model")."""
    ax = tp_axis(logits.shape[-1], cfg.vocab)
    if ax.n == 1:
        lse = torch.logsumexp(logits.float(), dim=-1)
        return lse, torch.gather(logits, -1, tgt[..., None])[..., 0]
    lo, hi = ax.block(cfg.vocab)
    lf = logits.float()
    m = all_reduce_max(lf.amax(dim=-1), ax)
    lse = torch.log(leave(torch.exp(lf - m[..., None]).sum(dim=-1), ax)) + m
    ok = (tgt >= lo) & (tgt < hi)
    tl = torch.gather(logits, -1, torch.where(ok, tgt - lo, 0)[..., None])
    tl = torch.where(ok, tl[..., 0], torch.zeros((), dtype=tl.dtype,
                                                 device=tl.device))
    return lse, leave(tl, ax)


def _encode(cfg, params, frames, *, train: bool = False, plans=None,
            sq=UNIT):
    """Whisper's encoder over the stubbed frame embeddings (B, S_enc, D):
    sinusoidal positions, ``enc_layers`` blocks of full self-attention
    and MLP, then ``enc_norm``.  ``train``: the differentiable path, each
    layer a remat unit (``plans``: the blocks' gathers, under a mesh;
    ``sq``: the axis the frames' positions are split over, the output
    then the rank's block of them); otherwise the attention kernel."""
    lo, hi = sq.block(frames.shape[1])
    x = frames[:, lo:hi].to(getattr(torch, cfg.dtype))
    positions = torch.arange(lo, hi, device=x.device)
    x = x + sinusoidal_positions(positions, cfg.d_model)[None].to(x.dtype)
    if train:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        x, _ = _scan_group_train(cfg, params, "enc/g0", cfg.enc_layers,
                                 ("enc_attn",), x, positions, aux,
                                 plans=plans, sq=sq)
    else:
        gp = {f"enc/g0/p0/{k}": t.unbind(0)
              for k, t in sub(params, "enc/g0/p0").items()}
        for layer in range(cfg.enc_layers):
            loop_mark("enc/g0", layer, cfg.enc_layers)
            p = _layer(gp, "enc/g0/p0", layer, plans)
            x = _mlp_res(cfg, p, _attn_block(cfg, p, x, positions,
                                             causal=False)[0])
        loop_mark("enc/g0", cfg.enc_layers, cfg.enc_layers)
    return rms_norm(x, seq_param(params["enc_norm"], sq), cfg.norm_eps)


def _prepare_inputs(cfg, params, batch, *, train: bool = False,
                    plans=None):
    """The decoder's input sequence: (x, positions, enc_out, img, sq,
    enc_sq).  A VLM puts the projected patches (``batch["patches"]``, (B,
    img, D)) before the text and returns their count ``img`` (0
    otherwise); an encoder-decoder model encodes ``batch["frames"]``
    (``enc_out``, None otherwise) and adds sinusoidal positions to the
    text.  In training, where the rules map the activations' "seq"
    (:func:`~repro_torch.runtime.partition.stream_axis`), the decoder's
    stream and the encoder's are split over ``sq`` and ``enc_sq`` along
    their positions: ``x``, ``positions`` and ``enc_out`` are this rank's
    blocks of them (the patches' rows, the text's and the frames' of its
    positions); otherwise both are :data:`UNIT`."""
    tokens = batch["inputs"]
    img = batch["patches"].shape[1] if cfg.frontend == "vlm_stub" else 0
    n = img + tokens.shape[1]
    sq = stream_axis(n) if train else UNIT
    lo, hi = sq.block(n)
    x = _embed(cfg, params, tokens, sq=sq, lead=img)
    if img:
        patches = batch["patches"][:, lo:max(lo, min(hi, img))]
        patches = patches.to(x.dtype) @ seq_param(
            params["mm_proj"], sq).to(x.dtype)
        x = torch.cat([patches, x], dim=1)
    positions = torch.arange(lo, hi, device=x.device)
    enc_out, enc_sq = None, UNIT
    if cfg.is_encdec:
        frames = batch["frames"]
        if train:
            enc_sq = stream_axis(frames.shape[1], "activations/encoder")
        enc_out = _encode(cfg, params, frames, train=train, plans=plans,
                          sq=enc_sq)
        x = x + sinusoidal_positions(positions, cfg.d_model)[None].to(x.dtype)
    return x, positions, enc_out, img, sq, enc_sq


def _planner(specs):
    """``plans(rules, mesh)``: :func:`~repro_torch.runtime.partition
    .block_plans` of ``specs``, kept for the last (rules, mesh)."""
    last: list = [None, None, None]

    def plans(rules, mesh):
        if last[0] is not rules or last[1] is not mesh:
            last[:] = [rules, mesh, block_plans(specs, rules, mesh)]
        return last[2]
    return plans


def _gather_top(specs, params, plans, mesh):
    """The parameters outside the layer stacks gathered by their plans
    (the stacks are gathered a layer at a time)."""
    return {k: v if specs[k].axes[:1] == ("layers",) else
            gather_block(v, plans[k], mesh) for k, v in params.items()}


# ---------------------------------------------------------------------------
# Training forward (every kind)
# ---------------------------------------------------------------------------

def _block_train(cfg, kind, p, x, positions, aux, enc_out=None, sq=UNIT,
                 enc_sq=UNIT):
    """Full-sequence block application in training (the encoder's blocks
    too): the reference's ``_block_train``; a ``moe`` block adds its
    load-balance loss to ``aux``.  Returns (x, aux).  Only differentiable
    plain paths: never a kernel of ``ops``.  ``sq`` and ``enc_sq``: the
    axes ``x`` and ``enc_out`` are split over along their positions
    (``positions``: ``x``'s): each module runs on the rank's positions,
    in a sequence-parallel region where its weights hold the rank's
    block, and an SSM or RG-LRU scan without one on the whole sequence
    (the recurrence carries its state from the first position)."""
    if kind in ("ssm", "rglru"):
        h = rms_norm(x, seq_param(p["norm1"], sq), cfg.norm_eps)
        fn, ax = ((mamba2_forward, tp_axis(p["out_proj"].shape[0],
                                           cfg.d_inner))
                  if kind == "ssm" else
                  (griffin_forward, tp_axis(p["wx"].shape[-1], cfg.lru)))
        if sq.n > 1 and ax.n == 1:
            o = _on_every_position(lambda hh, _: fn(cfg, p, hh, train=True),
                                   h, sq, f"{kind}/scan")
        else:
            o = fn(cfg, p, h, train=True, sq=sq)
        return (x + o if kind == "ssm" else _mlp_res(cfg, p, x + o, sq)), aux
    window = cfg.window if kind == "local_attn" else None
    x = _attn_block(cfg, p, x, positions, causal=kind != "enc_attn",
                    window=window, train=True, sq=sq)[0]
    if kind == "xattn":
        x = _xattn_cross(cfg, p, x, enc_out=enc_out, train=True, sq=sq,
                         enc_sq=enc_sq)[0]
    x, a = _ffn_res(cfg, kind, p, x, sq)
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


def _scan_group_train(cfg, params, group, reps, pattern, x, positions, aux,
                      enc_out=None, plans=None, sq=UNIT, enc_sq=UNIT):
    """The reference's scan over the stacked layers of ``group`` (``g{gi}``,
    or the encoder's ``enc/g0``), as a loop; each layer is one remat unit,
    which first gathers its parameters' blocks by ``plans`` (name ->
    :func:`~repro_torch.runtime.partition.gather_plan`; under a mesh), so
    the backward gathers them again (``sq``, ``enc_sq``: as
    :func:`_block_train`'s).  Returns (x, aux)."""
    # each stacked tensor unbound once: its gradient is one stack of the
    # layers' gradients, where indexing would add a zero-padded copy of the
    # whole stack per layer (a cost quadratic in the depth)
    gp = {k: t.unbind(0) for k, t in sub(params, group).items()}
    # a remat unit recomputes in the backward, on the autograd engine's
    # thread on the card: it runs under the caller's rules and mesh
    rules, mesh = current_rules(), current_mesh()
    plans = sub(plans, group) if plans else None

    def body(x, aux, layer_params, enc_out):
        with use_rules(rules, mesh):
            if plans:
                layer_params = {k: gather_block(t, plans[k], mesh, offset=1)
                                for k, t in layer_params.items()}
            for pj, kind in enumerate(pattern):
                x, aux = _block_train(cfg, kind, sub(layer_params, f"p{pj}"),
                                      x, positions, aux, enc_out, sq, enc_sq)
        return x, aux

    body = _remat(cfg, body)
    for layer in range(reps):
        loop_mark(group, layer, reps, x)  # for a cost counter, if one runs
        x, aux = body(x, aux, {k: t[layer] for k, t in gp.items()}, enc_out)
    loop_mark(group, reps, reps, x)
    return x, aux


def make_loss_fn(cfg: ModelConfig):
    """Returns loss(params, batch) -> (loss, metrics).

    ``params``: the parameter tree as :func:`param_specs` gives it (not
    cast).  batch: inputs (B,S) and targets (B,S) integer tensors on the
    parameters' device (-1 = masked), and ``patches`` (B, img_tokens, D)
    for a VLM or ``frames`` (B, S_enc, D) for an encoder-decoder model.
    Masked next-token cross-entropy in float32 through ``logsumexp`` over
    the text positions (a VLM's patch positions are dropped before the
    head), plus ``MOE_AUX_WEIGHT`` times the summed load-balance loss of
    the ``moe`` blocks; metrics ``ce``, ``aux`` (0 without MoE blocks) and
    ``ntok``.

    Under a mesh (:func:`~repro_torch.runtime.sharding.use_rules`) the
    parameters are this rank's blocks (gathered before use, see the module
    docstring), the batch is its shard over the batch axes, and the
    cross-entropy
    is the reference's global one, ``sum ce / sum ntok`` over every shard
    (a mean of the shards' means differs whenever they mask different
    numbers of targets); ``aux`` is the expert-parallel MoE's, a mean over
    the data axes.  The loss's value is the global loss on every rank; its
    gradient on a rank is that rank's share times the data-parallel size,
    so the trainer's mean over the data axes is the global gradient.
    """
    _check_ported(cfg)
    specs = param_specs(cfg)
    plans_for = _planner(specs)

    def loss_fn(params, batch):
        params = cast_params(cfg, params)
        rules, mesh = current_rules(), current_mesh()
        plans = None
        if mesh is not None and is_train_rules(rules):
            plans = plans_for(rules, mesh)
            params = _gather_top(specs, params, plans, mesh)
        x, positions, enc_out, img, sq, enc_sq = _prepare_inputs(
            cfg, params, batch, train=True, plans=plans)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for gi, (reps, pattern) in enumerate(cfg.groups()):
            x, aux = _scan_group_train(cfg, params, f"g{gi}", reps, pattern,
                                       x, positions, aux, enc_out, plans, sq,
                                       enc_sq)
        logits = _logits(cfg, params, x, sq=sq, lead=img)
        targets = batch["targets"]
        # the CE's rows: every text position, or the rank's where the
        # stream is split and the head's region does not gather it
        split = sq.n > 1 and not _head(cfg, params, sq)[1].seq
        if split:
            lo, hi = sq.block(img + targets.shape[1])
            a = max(lo, img) - img
            targets = targets[:, a:max(a, hi - img)]
        mask = (targets >= 0).float()
        tgt = torch.clamp(targets, min=0).long()
        lse, tl = _ce_terms(cfg, logits, tgt)
        ce = (lse - tl.float()) * mask
        ce_sum, ntok = ce.sum(), mask.sum()
        mesh = current_mesh()
        if mesh is not None:
            axes = batch_axes(mesh)
            groups = axis_groups(mesh, axes)
            scale = math.prod(mesh_shape(mesh)[a] for a in axes)
            if split:  # summed over the positions' axis too
                groups.append(sq.group)
                scale *= 1 if sequence_parallel(sq) else sq.n
            ce_sum = psum(ce_sum, groups, grad_scale=scale)
            ntok = psum(ntok, groups)
        ntok = torch.clamp(ntok, min=1.0)
        loss = ce_sum / ntok
        if cfg.n_experts:
            loss = loss + MOE_AUX_WEIGHT * aux
        return loss, {"ce": ce_sum / ntok, "aux": aux, "ntok": ntok}

    return loss_fn


# ---------------------------------------------------------------------------
# Public factories
# ---------------------------------------------------------------------------

def _serving(specs, plans_for, params):
    """Under a mesh and rules: ``(params with the top-level blocks
    gathered, plans)``; otherwise ``(params, None)``."""
    rules, mesh = current_rules(), current_mesh()
    if mesh is None or rules is None:
        return params, None
    plans = plans_for(rules, mesh)
    return _gather_top(specs, params, plans, mesh), plans


def make_prefill_fn(cfg: ModelConfig, *, cache_len: int | None = None,
                    enc_len: int | None = None):
    """Returns prefill(params, batch, cache0) -> (last_logits, cache0).

    ``params`` are cast by :func:`cast_params`.  ``batch["inputs"]``:
    (B, S) token ids on the parameters' device; a VLM's ``patches`` (B,
    img_tokens, D) take positions 0 .. img_tokens - 1 before them, and an
    encoder-decoder model's ``frames`` (B, S_enc, D) are encoded and
    cached for cross-attention.  ``cache0`` (zeros, sized by
    :func:`init_cache_specs`) is filled in place and returned.

    Under ``use_rules(rules, mesh)`` (the serving rules) the parameters,
    the batch and the cache are this rank's blocks (``explicit_spec``):
    each layer's blocks are gathered by their plans (the ``/wsharded``
    rules' FSDP, the router), attention, the MLPs, the SSM and RG-LRU
    blocks run on this rank's heads and channels (the kernels on the
    rank's shapes), and the logits returned are the rank's block of the
    vocabulary.  ``cache_len`` and ``enc_len``, the cache's and the
    encoder context's lengths, place a cache that the rules split along
    its positions (the encoder's is the frames' by default).
    """
    _check_ported(cfg)
    specs = param_specs(cfg)
    plans_for = _planner(specs)

    @torch.no_grad()
    def prefill_fn(params, batch, cache0):
        params, plans = _serving(specs, plans_for, params)
        x, positions, enc_out, *_ = _prepare_inputs(cfg, params, batch,
                                                    plans=plans)
        lens = (cache_len, enc_len)
        for kind, p, c in _layers(cfg, params, cache0, plans):
            x = _block_prefill(cfg, kind, p, x, positions, c, enc_out, lens)
        return _logits(cfg, params, x[:, -1:]), cache0

    return prefill_fn


def make_decode_fn(cfg: ModelConfig, *, cache_len: int | None = None,
                   enc_len: int | None = None):
    """Returns decode(params, cache, tokens (B,1), pos) -> (logits, cache).

    ``params`` are cast by :func:`cast_params`; ``pos`` is the absolute
    position of ``tokens`` (a Python int; a VLM's counts its patches); the
    cache is written in place and returned.  A full tail is merged into
    main by :func:`merge_tail` before the step, by the caller.  Under a
    mesh, as :func:`make_prefill_fn`: this rank's blocks in and out.
    """
    _check_ported(cfg)
    specs = param_specs(cfg)
    plans_for = _planner(specs)

    @torch.no_grad()
    def decode_fn(params, cache, tokens, pos: int):
        params, plans = _serving(specs, plans_for, params)
        x = _embed(cfg, params, tokens)
        positions = torch.full((1,), pos, device=x.device)
        if cfg.is_encdec:
            x = x + sinusoidal_positions(positions, cfg.d_model)[None].to(
                x.dtype)
        lens = (cache_len, enc_len)
        for kind, p, c in _layers(cfg, params, cache, plans):
            x = _block_decode(cfg, kind, p, x, pos, positions, c, lens)
        return _logits(cfg, params, x), cache

    return decode_fn
