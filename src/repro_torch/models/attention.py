"""Attention: the prefill kernel in the model layout, the training
attention, and the decode path.

The counterpart of ``repro.models.attention``.  The reference's
``blockwise_attention`` (an online-softmax scan in XLA) is what its docstring
says the Pallas kernel replaces on the accelerator for a forward; here
:func:`prefill_attention` takes that role and calls
:func:`repro_torch.kernels.ops.flash_attention`: the CUDA kernel for CUDA
tensors, its plain version for CPU tensors.  Training differentiates
through attention, and no kernel has a backward (neither has the TPU
kernel), so the loss runs :func:`blockwise_attention`, the reference's
online-softmax scan in plain PyTorch, as the reference's loss runs it in
XLA.  The decode functions are plain PyTorch, as they are XLA code in the
reference; :func:`full_attention` is a test oracle only.  Given the
``offset`` of a block of a cache split over ranks, they return that
block's online-softmax partial ``(num, den, m)`` for
:func:`~repro_torch.runtime.collectives.flash_decode_psum` to combine.

Layout: q (B, S, H, dh); k (B, T, K, dh); v (B, T, K, dhv) with H = K * G
(GQA); dhv may differ from dh (MLA).
Numerical scheme: finite masking (-1e30, never -inf) keeps fully masked
rows NaN-free.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels import ops
from .layers import f32_einsum

__all__ = ["blockwise_attention", "prefill_attention", "decode_attention",
           "decode_attention_two_tier", "full_attention", "softmax_partial"]

_NEG = -1e30


def _mask_bias(q_pos, kv_pos, *, causal: bool, window: int | None,
               t_actual: int) -> torch.Tensor:
    """(S, T) additive bias: 0 where attendable, -1e30 where masked."""
    m = kv_pos[None, :] < t_actual
    if causal:
        m = m & (kv_pos[None, :] <= q_pos[:, None])
    if window is not None:
        m = m & (q_pos[:, None] - kv_pos[None, :] < window)
    return torch.where(m, 0.0, _NEG)


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int | None = None,
                        q_offset: int = 0, q_block: int = 512,
                        kv_block: int = 1024,
                        scale: float | None = None) -> torch.Tensor:
    """Online-softmax attention, differentiable (the reference's
    ``blockwise_attention``: the same blocks, masks and casts).

    q: (B, S, H, dh); k, v: (B, T, K, dh) with H = K * G (GQA).
    ``q_offset``: absolute position of q[0].  Returns (B, S, H, dh) in
    q.dtype.  No S x T score tensor is made: one (q block, kv block) tile
    at a time.  A causal kv block that starts after a q block's last
    position is skipped: every one of its scores is masked, so its
    probabilities are exactly 0 and the scan leaves the carry as it was.
    """
    B, S, H, dh = q.shape
    _, T, K, dhv = v.shape
    G = H // K
    scale = dh ** -0.5 if scale is None else scale
    qb = min(q_block, max(16, S))
    kb = min(kv_block, max(16, T))
    nq, nk = -(-S // qb), -(-T // kb)
    q_p = F.pad(q, (0, 0, 0, 0, 0, nq * qb - S))
    k_p = F.pad(k, (0, 0, 0, 0, 0, nk * kb - T))
    v_p = F.pad(v, (0, 0, 0, 0, 0, nk * kb - T))
    dev = q.device
    outs = []
    for qi in range(nq):
        q_pos = q_offset + qi * qb + torch.arange(qb, device=dev)
        qblk = q_p[:, qi * qb:(qi + 1) * qb].reshape(B, qb, K, G, dh)
        qs = qblk * torch.tensor(scale, dtype=qblk.dtype)
        m = torch.full((B, qb, K, G), _NEG, dtype=torch.float32, device=dev)
        num = torch.zeros((B, qb, K, G, dhv), dtype=torch.float32, device=dev)
        den = torch.zeros((B, qb, K, G), dtype=torch.float32, device=dev)
        for kj in range(nk):
            lo = kj * kb
            if causal and lo > q_offset + (qi + 1) * qb - 1:
                break
            kj_, vj = k_p[:, lo:lo + kb], v_p[:, lo:lo + kb]
            kv_pos = lo + torch.arange(kb, device=dev)
            s = f32_einsum("bqkgd,btkd->bqkgt", qs, kj_)
            s = s + _mask_bias(q_pos, kv_pos, causal=causal, window=window,
                               t_actual=T)[None, :, None, None, :]
            m_new = torch.maximum(m, s.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            num = num * alpha[..., None] + f32_einsum(
                "bqkgt,btkd->bqkgd", p.to(vj.dtype), vj)
            den = den * alpha + p.sum(dim=-1)
            m = m_new
        # cast per block: the stacked output stays in q.dtype
        outs.append((num / torch.clamp(den, min=1e-30)[..., None])
                    .to(q.dtype))
    out = torch.stack(outs, dim=1).reshape(B, nq * qb, H, dhv)[:, :S]
    return out.to(q.dtype)


def prefill_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: int | None = None,
                      scale: float | None = None) -> torch.Tensor:
    """Attention of a whole prompt, positions from 0.

    q: (B, S, H, dh); k: (B, T, K, dh); v: (B, T, K, dhv) (MLA: dh 192,
    dhv 128).  Returns (B, S, H, dhv) in q.dtype.  The kernel reads the (B, H, S, dh) views through their
    strides and writes its output with q's strides, so no layout copy is
    made on the card.
    """
    # a gather over "model" along the last dimension hands a view whose
    # head dimension is strided; the kernel reads it contiguous
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    o = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal=causal, window=window,
                            scale=scale)
    return o.transpose(1, 2)


def softmax_partial(parts, spec: str):
    """The online-softmax partial of ``parts``, each (scores (..., t),
    values, valid (t,)): ``m`` the largest valid score, ``den`` the sum of
    ``exp(s - m)`` over the valid ones and ``num`` their sum with the
    values by the einsum ``spec``, float32 (a part with none valid adds
    nothing; where none is, ``m`` is -1e30)."""
    ss = [torch.where(valid, s, _NEG) for s, _, valid in parts]
    m = torch.stack([s.amax(dim=-1) for s in ss]).amax(dim=0)
    num = den = 0
    for s, (_, v, valid) in zip(ss, parts):
        p = torch.where(valid, torch.exp(s - m[..., None]), 0.0)
        num = num + f32_einsum(spec, p.to(v.dtype), v)
        den = den + p.sum(dim=-1)
    return num, den, m


def _partial(qs, parts):
    """:func:`softmax_partial` of scaled queries ``qs`` (B, K, G, dh) over
    ``parts``, (k (B, t, K, dh), v (B, t, K, dhv), valid (t,)) each:
    ``num`` (B, 1, H, dhv) and ``den``, ``m`` (B, 1, H)."""
    B, K, G, _ = qs.shape
    num, den, m = softmax_partial(
        [(f32_einsum("bkgd,btkd->bkgt", qs, k), v, valid)
         for k, v, valid in parts], "bkgt,btkd->bkgd")
    H = K * G
    return (num.reshape(B, 1, H, -1), den.reshape(B, 1, H),
            m.reshape(B, 1, H))


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, length: int, *,
                     window: int | None = None, scale: float | None = None,
                     offset: int | None = None):
    """Single-step attention against a cache.

    q: (B, 1, H, dh); caches: (B, T, K, dh); ``length``: number of valid
    cache positions.  One pass over the cache, f32 softmax.  With
    ``offset``, the caches are the block of positions ``offset ..
    offset + T - 1`` of a longer cache, and the block's partial ``(num,
    den, m)`` is returned (:func:`_partial`).
    """
    B, _, H, dh = q.shape
    _, T, K, dhv = v_cache.shape
    G = H // K
    scale = dh ** -0.5 if scale is None else scale
    qs = q.reshape(B, K, G, dh) * torch.tensor(scale, dtype=q.dtype)
    idx = torch.arange(offset or 0, (offset or 0) + T, device=q.device)
    valid = idx < length
    if window is not None:
        valid = valid & (idx >= length - window)
    if offset is not None:
        return _partial(qs, [(k_cache, v_cache, valid)])
    s = f32_einsum("bkgd,btkd->bkgt", qs, k_cache)
    s = torch.where(valid, s, _NEG)
    p = torch.softmax(s, dim=-1)
    out = f32_einsum("bkgt,btkd->bkgd", p.to(v_cache.dtype), v_cache)
    return out.reshape(B, 1, H, dhv).to(q.dtype)


def full_attention(q, k, v, *, causal=True, window=None, q_offset=0,
                   scale=None) -> torch.Tensor:
    """Naive O(S*T) attention -- test oracle only."""
    B, S, H, dh = q.shape
    _, T, K, dhv = v.shape
    G = H // K
    scale = dh ** -0.5 if scale is None else scale
    qf = q.reshape(B, S, K, G, dh).float() * scale
    s = torch.einsum("bqkgd,btkd->bqkgt", qf, k.float())
    q_pos = q_offset + torch.arange(S, device=q.device)
    bias = _mask_bias(q_pos, torch.arange(T, device=q.device), causal=causal,
                      window=window, t_actual=T)
    s = s + bias[None, :, None, None, :]
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bqkgt,btkd->bqkgd", p, v.float())
    return out.reshape(B, S, H, dhv).to(q.dtype)


def decode_attention_two_tier(q, k_main, v_main, k_tail, v_tail, pos: int, *,
                              scale: float | None = None,
                              offset: int | None = None,
                              with_tail: bool = True):
    """Decode attention over a two-tier cache.

    The *main* cache (B, Tm, K, d) holds positions [0, pos - pos % Tt); the
    *tail* (B, Tt, K, d) is a small append buffer written once per step and
    holds the rest, position p at slot p % Tt, up to and including ``pos``.
    With ``offset``, main is the block of positions ``offset .. offset +
    Tm - 1`` of a longer one, and the partial ``(num, den, m)`` of that
    block and of the tail (left out without ``with_tail``: another rank
    counts it) is returned (:func:`_partial`).
    """
    B, _, H, dh = q.shape
    _, Tm, K, dhv = v_main.shape
    G = H // K
    scale = dh ** -0.5 if scale is None else scale
    qs = q.reshape(B, K, G, dh) * torch.tensor(scale, dtype=q.dtype)
    Tt = v_tail.shape[1]
    n_tail = pos % Tt
    main_len = pos - n_tail
    if offset is not None:
        parts = [(k_main, v_main, torch.arange(
            offset, offset + Tm, device=q.device) < main_len)]
        if with_tail:
            parts.append((k_tail, v_tail, torch.arange(
                Tt, device=q.device) <= n_tail))
        return _partial(qs, parts)
    sm = f32_einsum("bkgd,btkd->bkgt", qs, k_main)
    st = f32_einsum("bkgd,btkd->bkgt", qs, k_tail)
    sm = torch.where(torch.arange(Tm, device=q.device) < main_len, sm, _NEG)
    st = torch.where(torch.arange(Tt, device=q.device) <= n_tail, st, _NEG)
    p = torch.softmax(torch.cat([sm, st], dim=-1), dim=-1)
    pm, pt = p[..., :Tm], p[..., Tm:]
    out = (f32_einsum("bkgt,btkd->bkgd", pm.to(v_main.dtype), v_main)
           + f32_einsum("bkgt,btkd->bkgd", pt.to(v_tail.dtype), v_tail))
    return out.reshape(B, 1, H, dhv).to(q.dtype)
