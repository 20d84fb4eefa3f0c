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
reference; :func:`full_attention` is a test oracle only.

Layout: q (B, S, H, dh); k, v (B, T, K, dh) with H = K * G (GQA).
Numerical scheme: finite masking (-1e30, never -inf) keeps fully masked
rows NaN-free.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels import ops
from .layers import f32_einsum

__all__ = ["blockwise_attention", "prefill_attention", "decode_attention",
           "decode_attention_two_tier", "full_attention"]

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

    q: (B, S, H, dh); k, v: (B, T, K, dh).  Returns (B, S, H, dh) in
    q.dtype.  The kernel reads the (B, H, S, dh) views through their
    strides and writes its output with q's strides, so no layout copy is
    made on the card.
    """
    o = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal=causal, window=window,
                            scale=scale)
    return o.transpose(1, 2)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, length: int, *,
                     window: int | None = None,
                     scale: float | None = None) -> torch.Tensor:
    """Single-step attention against a cache.

    q: (B, 1, H, dh); caches: (B, T, K, dh); ``length``: number of valid
    cache positions.  One pass over the cache, f32 softmax.
    """
    B, _, H, dh = q.shape
    _, T, K, dhv = v_cache.shape
    G = H // K
    scale = dh ** -0.5 if scale is None else scale
    qs = q.reshape(B, K, G, dh) * torch.tensor(scale, dtype=q.dtype)
    s = f32_einsum("bkgd,btkd->bkgt", qs, k_cache)
    idx = torch.arange(T, device=q.device)
    valid = idx < length
    if window is not None:
        valid = valid & (idx >= length - window)
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
                              scale: float | None = None) -> torch.Tensor:
    """Decode attention over a two-tier cache.

    The *main* cache (B, Tm, K, d) holds positions [0, pos - pos % Tt); the
    *tail* (B, Tt, K, d) is a small append buffer written once per step and
    holds the rest, position p at slot p % Tt, up to and including ``pos``.
    """
    B, _, H, dh = q.shape
    _, Tm, K, dhv = v_main.shape
    Tt = v_tail.shape[1]
    G = H // K
    scale = dh ** -0.5 if scale is None else scale
    n_tail = pos % Tt
    main_len = pos - n_tail
    qs = q.reshape(B, K, G, dh) * torch.tensor(scale, dtype=q.dtype)
    sm = f32_einsum("bkgd,btkd->bkgt", qs, k_main)
    st = f32_einsum("bkgd,btkd->bkgt", qs, k_tail)
    sm = torch.where(torch.arange(Tm, device=q.device) < main_len, sm, _NEG)
    st = torch.where(torch.arange(Tt, device=q.device) <= n_tail, st, _NEG)
    p = torch.softmax(torch.cat([sm, st], dim=-1), dim=-1)
    pm, pt = p[..., :Tm], p[..., Tm:]
    out = (f32_einsum("bkgt,btkd->bkgd", pm.to(v_main.dtype), v_main)
           + f32_einsum("bkgt,btkd->bkgd", pt.to(v_tail.dtype), v_tail))
    return out.reshape(B, 1, H, dhv).to(q.dtype)
