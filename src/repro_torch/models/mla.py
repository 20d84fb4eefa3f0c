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
and every head computed, ``wo``'s rows taking their columns.

Params:
    wq_a (D, q_lora)        q_norm (q_lora,)        wq_b (q_lora, H*(dn+dr))
    wkv_a (D, kv_lora+dr)   kv_norm (kv_lora,)      wkv_b (kv_lora, H*(dn+dv))
    wo (H*dv, D)
"""

from __future__ import annotations

import torch

from ..runtime.partition import enter, gather, leave, tp_axis
from ..runtime.sharding import note
from .attention import blockwise_attention, prefill_attention
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


def mla_attention(cfg, p, x, positions, *, train: bool = False):
    """Causal attention of a whole sequence from position 0.  Returns
    (out (B,S,D), (c_kv, k_rope)) for the cache write.  ``train``: the
    differentiable :func:`blockwise_attention`; otherwise the kernel.

    A region over this model rank's heads where ``wq_b`` holds its block
    (training under tensor parallelism; on ``UNIT`` otherwise, every
    head): the latent, the query's down-projection and the rope key
    computed whole, ``wq_b``/``wkv_b`` column-parallel and ``wo``
    row-parallel."""
    B, S, _ = x.shape
    H, dn, dr, dv = (cfg.n_heads, cfg.nope_head_dim, cfg.rope_head_dim,
                     cfg.v_head_dim)
    ax = tp_axis(p["wq_b"].shape[-1], H * (dn + dr))
    cq, c_kv, k_r = _latent(cfg, p, x, positions)
    q = enter(cq, ax) @ p["wq_b"]
    w = p["wkv_b"]
    kv_split = ax.split(w.shape[-1], H * (dn + dv))
    kv = enter(c_kv, ax) @ (w if kv_split else enter(w, ax))
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
    kv = kv.reshape(B, S, Hl, dn + dv)
    kn, v = kv[..., :dn], kv[..., dn:]
    k_full = torch.cat(
        [kn, enter(k_r, ax)[:, :, None, :].expand(B, S, Hl, dr)], dim=-1)
    attend = blockwise_attention if train else prefill_attention
    out = attend(q, k_full, v, causal=True, scale=_scale(cfg))
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


def mla_decode_two_tier(cfg, p, x, pos: int, main_ckv, main_kr, tckv, tkr):
    """Absorbed MLA decode over a two-tier latent cache.

    main_* (B,Tm,·) is read only; t* (B,Tt,·) is the append buffer, written
    in place at slot pos % Tt.  Invariant: positions [0, pos - pos % Tt) in
    main, the rest in the tail.  Returns (out, tckv, tkr).
    """
    B = x.shape[0]
    H, dn, dv = cfg.n_heads, cfg.nope_head_dim, cfg.v_head_dim
    Tm, Tt = main_ckv.shape[1], tckv.shape[1]
    n_tail = pos % Tt
    main_len = pos - n_tail
    positions = torch.full((1,), pos, device=x.device)
    q, c_kv_new, k_r_new = mla_project_qkv(cfg, p, x, positions)
    qn, qr = q[..., :dn], q[..., dn:]
    tckv[:, n_tail] = c_kv_new[:, 0]
    tkr[:, n_tail] = k_r_new[:, 0]
    q_lat, w_uv = _absorbed(cfg, p, qn)
    q_lat = q_lat.to(main_ckv.dtype)
    qr_l = qr.to(main_kr.dtype)

    def scores(ckv, kr):
        return (f32_einsum("bshr,btr->bhst", q_lat, ckv)
                + f32_einsum("bshd,btd->bhst", qr_l, kr)) * _scale(cfg)

    dev = x.device
    sm = torch.where(torch.arange(Tm, device=dev) < main_len,
                     scores(main_ckv, main_kr), _NEG)   # (B,H,1,Tm)
    st = torch.where(torch.arange(Tt, device=dev) <= n_tail,
                     scores(tckv, tkr), _NEG)           # (B,H,1,Tt)
    p_attn = torch.softmax(torch.cat([sm, st], dim=-1), dim=-1)
    pm = p_attn[..., :Tm].to(main_ckv.dtype)
    pt = p_attn[..., Tm:].to(tckv.dtype)
    o_lat = (f32_einsum("bhst,btr->bshr", pm, main_ckv)
             + f32_einsum("bhst,btr->bshr", pt, tckv))
    o = f32_einsum("bshr,rhv->bshv", o_lat.to(w_uv.dtype), w_uv)
    out = o.reshape(B, 1, H * dv).to(x.dtype) @ p["wo"]
    return out, tckv, tkr
