"""Multi-head Latent Attention (DeepSeek-V2).

The counterpart of ``repro.models.mla``.  Prefill and training run the
factored attention with full K/V up-projected from the latent: the
prefill through :func:`~.attention.prefill_attention` (the attention
kernel, with a query/key head dimension of dn + dr and a value head
dimension of dv), training through the differentiable
:func:`~.attention.blockwise_attention`.  Decode uses the *absorbed* form:
the KV up-projection is folded into the query and output projections, so
the per-token cache is only the compressed latent ``c_kv`` (kv_lora_rank)
plus the shared rope key.  The reference's ``mxu_einsum`` becomes
:func:`~.layers.f32_einsum` (float32 operands and result, as the reference
runs off the TPU).  Decode writes the cache it is given in place.

Under the training rules with tensor parallelism, :func:`mla_attention`
splits ``wq_b``, ``wkv_b`` and ``wo`` by whole heads over "model" (the
down-projections, norms and the shared rope key stay whole); where a
rank's columns split a head, the up-projections are gathered over "model"
and every head computed, ``wo``'s rows taking their columns.  Serving
under a mesh, prefill does the same, and the absorbed decode runs on the
rank's heads (:func:`mla_decode_two_tier`), over a latent cache split
along its positions a partial each rank combines.  In training on a
stream split along its positions :func:`mla_attention` computes the
latent on the rank's positions and gathers it (into a region, or, without
tensor parallelism, for the rank's queries to attend every key).

Params:
    wq_a (D, q_lora)        q_norm (q_lora,)        wq_b (q_lora, H*(dn+dr))
    wkv_a (D, kv_lora+dr)   kv_norm (kv_lora,)      wkv_b (kv_lora, H*(dn+dv))
    wo (H*dv, D)
"""

from __future__ import annotations

import torch

from ..runtime.collectives import flash_decode_psum
from ..runtime.partition import (UNIT, enter, gather, leave, model_axis,
                                 seq_param, tp_axis, whole)
from ..runtime.sharding import note
from .attention import (blockwise_attention, prefill_attention,
                        softmax_partial)
from .layers import f32_einsum, rms_norm, rope

__all__ = ["mla_project_qkv", "mla_attention", "mla_decode",
           "mla_decode_two_tier"]

_NEG = -1e30


def _split_q(cfg, q):
    """(B,S,H*(dn+dr)) -> nope (B,S,H,dn), rope (B,S,H,dr)."""
    B, S, _ = q.shape
    q = q.reshape(B, S, cfg.n_heads, cfg.nope_head_dim + cfg.rope_head_dim)
    return q[..., :cfg.nope_head_dim], q[..., cfg.nope_head_dim:]


def _scale(cfg) -> float:
    return (cfg.nope_head_dim + cfg.rope_head_dim) ** -0.5


def _latent(cfg, p, x, positions):
    """The query's normed down-projection cq (B,S,q_lora), the latent
    c_kv (B,S,r) and the shared rope key k_rope (B,S,dr)."""
    cq = rms_norm(x @ p["wq_a"], p["q_norm"], cfg.norm_eps)
    ckv_full = x @ p["wkv_a"]  # (B,S,r+dr)
    r = cfg.kv_lora_rank
    c_kv = rms_norm(ckv_full[..., :r], p["kv_norm"], cfg.norm_eps)
    k_r = rope(ckv_full[..., r:][..., None, :], positions,
               cfg.rope_theta)[..., 0, :]  # (B,S,dr): one shared head
    return cq, c_kv, k_r


def mla_project_qkv(cfg, p, x, positions):
    """Returns q (B,S,H,dn+dr), latent c_kv (B,S,r), k_rope (B,S,dr)."""
    cq, c_kv, k_r = _latent(cfg, p, x, positions)
    qn, qr = _split_q(cfg, cq @ p["wq_b"])
    qr = rope(qr, positions, cfg.rope_theta)
    return torch.cat([qn, qr], dim=-1), c_kv, k_r


# the parameters of the latent, the query's down-projection and the rope key
_LATENT = ("wq_a", "q_norm", "wkv_a", "kv_norm")


def mla_attention(cfg, p, x, positions, *, train: bool = False, sq=UNIT):
    """Causal attention of a whole sequence from position 0.  Returns
    (out (B,S,D), (c_kv, k_rope)) for the cache write.  ``train``: the
    differentiable :func:`blockwise_attention`; otherwise the kernel.

    A region over this model rank's heads where ``wq_b`` holds its block
    (under tensor parallelism; on ``UNIT`` otherwise, every head): the
    latent, the query's down-projection and the rope key computed whole,
    ``wq_b``/``wkv_b`` column-parallel and ``wo`` row-parallel.

    ``sq``: the axis ``x`` is split over along its positions (training;
    ``positions`` are the rank's).  The latent, the query's
    down-projection and the rope key are computed on the rank's positions
    (their parameters' gradients summed over the ranks under sequence
    parallelism); the region's entry gathers them over the positions, or,
    without tensor parallelism, the latent and the rope key are gathered
    and the rank's queries attend every position."""
    H, dn, dr, dv = (cfg.n_heads, cfg.nope_head_dim, cfg.rope_head_dim,
                     cfg.v_head_dim)
    ax = tp_axis(p["wq_b"].shape[-1], H * (dn + dr), sq)
    if sq.n > 1:
        p = {**p, **{k: seq_param(p[k], sq) for k in _LATENT}}
    cq, c_kv, k_r = _latent(cfg, p, x, positions)
    q_offset = 0
    if ax.seq:  # every position, gathered at the region's entry
        positions = torch.arange(x.shape[1] * ax.n, device=x.device)
    elif sq.n > 1:  # token parallelism: the rank's queries, every key
        note("attention/mla", f"the latent and the rope key gathered over "
             f"'model' along the positions (model={sq.n})")
        q_offset = sq.block(x.shape[1] * sq.n)[0]
        c_kv, k_r = gather(c_kv, 1, sq), gather(k_r, 1, sq)
    cq, c_kv, k_r = enter(cq, ax), enter(c_kv, ax), enter(k_r, ax)
    B, S, T = cq.shape[0], cq.shape[1], c_kv.shape[1]
    q = cq @ p["wq_b"]
    w = p["wkv_b"]
    kv_split = ax.split(w.shape[-1], H * (dn + dv))
    kv = c_kv @ (w if kv_split else whole(w, ax))
    if H % ax.n:  # this rank's columns split a head: every head here
        note("attention/mla", f"{H} heads on model={ax.n}: the "
             "up-projections gathered over 'model', every head computed on "
             "each rank")
        q = gather(q, -1, ax)
        kv = gather(kv, -1, ax) if kv_split else kv
        a, b = 0, H
    else:
        a, b = ax.block(H)
        if not kv_split:
            kv = kv[..., a * (dn + dv):b * (dn + dv)]
    Hl = b - a
    q = q.reshape(B, S, Hl, dn + dr)
    q = torch.cat([q[..., :dn], rope(q[..., dn:], positions,
                                     cfg.rope_theta)], dim=-1)
    kv = kv.reshape(B, T, Hl, dn + dv)
    kn, v = kv[..., :dn], kv[..., dn:]
    k_full = torch.cat([kn, k_r[:, :, None, :].expand(B, T, Hl, dr)],
                       dim=-1)
    if train:
        out = blockwise_attention(q, k_full, v, causal=True,
                                  scale=_scale(cfg), q_offset=q_offset)
    else:
        out = prefill_attention(q, k_full, v, causal=True, scale=_scale(cfg))
    out = out.reshape(B, S, Hl * dv)
    wo = p["wo"]
    if out.shape[-1] != wo.shape[0]:  # every head here: wo's columns
        lo, hi = ax.block(H * dv)
        out = out[..., lo:hi]
    return leave(out @ wo, ax), (c_kv, k_r)


def _absorbed(cfg, p, qn):
    """The query absorbed into the latent space, q_lat[h, r] = qn[h, dn] .
    w_uk[r, h, dn] (B,1,H,r) float32, and the value up-projection w_uv
    (r, H, dv)."""
    H, dn, dv, r = (cfg.n_heads, cfg.nope_head_dim, cfg.v_head_dim,
                    cfg.kv_lora_rank)
    w = p["wkv_b"].reshape(r, H, dn + dv)
    return f32_einsum("bshn,rhn->bshr", qn, w[..., :dn]), w[..., dn:]


def mla_decode(cfg, p, x, pos: int, cache_ckv, cache_kr, length: int):
    """Absorbed decode over a single-tier cache.

    x: (B,1,D); caches: (B,T,r) and (B,T,dr), written at ``pos`` in place.
    Attends to the first ``length`` positions.  Returns (out, cache_ckv,
    cache_kr).
    """
    B = x.shape[0]
    H, dn, dv = cfg.n_heads, cfg.nope_head_dim, cfg.v_head_dim
    positions = torch.full((1,), pos, device=x.device)
    q, c_kv_new, k_r_new = mla_project_qkv(cfg, p, x, positions)
    qn, qr = q[..., :dn], q[..., dn:]
    cache_ckv[:, pos] = c_kv_new[:, 0]
    cache_kr[:, pos] = k_r_new[:, 0]
    q_lat, w_uv = _absorbed(cfg, p, qn)
    s = (f32_einsum("bshr,btr->bhst", q_lat.to(cache_ckv.dtype), cache_ckv)
         + f32_einsum("bshd,btd->bhst", qr.to(cache_kr.dtype),
                      cache_kr)) * _scale(cfg)
    idx = torch.arange(cache_ckv.shape[1], device=x.device)
    s = torch.where(idx < length, s, _NEG)
    p_attn = torch.softmax(s, dim=-1)
    o_lat = f32_einsum("bhst,btr->bshr", p_attn.to(cache_ckv.dtype),
                       cache_ckv)
    o = f32_einsum("bshr,rhv->bshv", o_lat.to(w_uv.dtype), w_uv)
    out = o.reshape(B, 1, H * dv).to(x.dtype) @ p["wo"]
    return out, cache_ckv, cache_kr


def _decode_heads(cfg, p, cq, positions, ax):
    """The one token's query heads [a, b) of this model rank (every head
    where its columns split one): the absorbed query q_lat (B,1,Hl,r)
    float32, the rope query (B,1,Hl,dr), the heads' value up-projection
    w_uv (r,Hl,dv) and (a, b).  ``wq_b`` and ``wkv_b`` hold the rank's
    columns (or are whole) as in :func:`mla_attention`."""
    H, dn, dr, dv, r = (cfg.n_heads, cfg.nope_head_dim, cfg.rope_head_dim,
                        cfg.v_head_dim, cfg.kv_lora_rank)
    B = cq.shape[0]
    q = enter(cq, ax) @ p["wq_b"]
    w = p["wkv_b"]
    kv_split = ax.split(w.shape[-1], H * (dn + dv))
    w = w if kv_split else whole(w, ax)
    if H % ax.n:  # this rank's columns split a head: every head here
        note("attention/mla", f"{H} heads on model={ax.n}: the "
             "up-projections gathered over 'model', every head computed on "
             "each rank")
        q = gather(q, -1, ax)
        w = gather(w, -1, ax) if kv_split else w
        a, b = 0, H
    else:
        a, b = ax.block(H)
        if not kv_split:
            w = w[..., a * (dn + dv):b * (dn + dv)]
    q = q.reshape(B, 1, b - a, dn + dr)
    qn, qr = q[..., :dn], rope(q[..., dn:], positions, cfg.rope_theta)
    w = w.reshape(r, b - a, dn + dv)
    return (f32_einsum("bshn,rhn->bshr", qn, w[..., :dn]), qr, w[..., dn:],
            (a, b))


def mla_decode_two_tier(cfg, p, x, pos: int, main_ckv, main_kr, tckv, tkr,
                        *, offset: int | None = None):
    """Absorbed MLA decode over a two-tier latent cache.

    main_* (B,Tm,·) is read only; t* (B,Tt,·) is the append buffer, written
    in place at slot pos % Tt.  Invariant: positions [0, pos - pos % Tt) in
    main, the rest in the tail.  Returns (out, tckv, tkr).

    On this model rank's heads where ``wq_b`` holds its block (serving
    under a mesh; on ``UNIT`` otherwise, every head): the latent and the
    rope key whole (the tail is replicated), the absorbed query, the value
    up-projection and ``wo``'s rows on the rank's heads, the output summed
    over "model".  With ``offset``, main is this rank's block of positions
    ``offset ..`` of a latent cache split over "model": the absorbed and
    rope queries are gathered to every head, each rank's online-softmax
    partial over its positions (the tail counted on model rank 0) is
    combined by ``flash_decode_psum``, and the rank keeps its heads.
    """
    B = x.shape[0]
    H, dv = cfg.n_heads, cfg.v_head_dim
    Tm, Tt = main_ckv.shape[1], tckv.shape[1]
    n_tail = pos % Tt
    main_len = pos - n_tail
    positions = torch.full((1,), pos, device=x.device)
    ax = tp_axis(p["wq_b"].shape[-1], H * (cfg.nope_head_dim
                                         + cfg.rope_head_dim))
    cq, c_kv_new, k_r_new = _latent(cfg, p, x, positions)
    q_lat, qr, w_uv, (a, b) = _decode_heads(cfg, p, cq, positions, ax)
    tckv[:, n_tail] = c_kv_new[:, 0]
    tkr[:, n_tail] = k_r_new[:, 0]
    q_lat = q_lat.to(main_ckv.dtype)
    qr_l = qr.to(main_kr.dtype)

    def scores(q_lat, qr_l, ckv, kr):
        return (f32_einsum("bshr,btr->bhst", q_lat, ckv)
                + f32_einsum("bshd,btd->bhst", qr_l, kr)) * _scale(cfg)

    dev = x.device
    if offset is not None:
        if b - a < H:
            q_lat, qr_l = gather(q_lat, 2, ax), gather(qr_l, 2, ax)
        parts = [(main_ckv, main_kr, torch.arange(
            offset, offset + Tm, device=dev) < main_len)]
        if model_axis().j == 0:  # the replicated tail, counted once
            parts.append((tckv, tkr, torch.arange(Tt, device=dev) <= n_tail))
        num, den, m = softmax_partial(    # scores (B,H,1,t)
            [(scores(q_lat, qr_l, ckv, kr), ckv, valid)
             for ckv, kr, valid in parts], "bhst,btr->bshr")
        o_lat = flash_decode_psum(num, den.transpose(1, 2),
                                  m.transpose(1, 2), "model")[:, :, a:b]
    else:
        sm = torch.where(torch.arange(Tm, device=dev) < main_len,
                         scores(q_lat, qr_l, main_ckv, main_kr), _NEG)
        st = torch.where(torch.arange(Tt, device=dev) <= n_tail,
                         scores(q_lat, qr_l, tckv, tkr), _NEG)
        p_attn = torch.softmax(torch.cat([sm, st], dim=-1), dim=-1)
        pm = p_attn[..., :Tm].to(main_ckv.dtype)
        pt = p_attn[..., Tm:].to(tckv.dtype)
        o_lat = (f32_einsum("bhst,btr->bshr", pm, main_ckv)
                 + f32_einsum("bhst,btr->bshr", pt, tckv))
    o = f32_einsum("bshr,rhv->bshv", o_lat.to(w_uv.dtype), w_uv)
    o = o.reshape(B, 1, (b - a) * dv).to(x.dtype)
    wo = p["wo"]
    if o.shape[-1] != wo.shape[0]:  # every head here: wo's columns
        lo, hi = ax.block(H * dv)
        o = o[..., lo:hi]
    return leave(o @ wo, ax), tckv, tkr
