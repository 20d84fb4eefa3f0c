"""Attention: the prefill kernel in the model layout, and the decode path.

The counterpart of ``repro.models.attention``.  The reference's
``blockwise_attention`` (an online-softmax scan in XLA) is what its docstring
says the Pallas kernel replaces on the accelerator; here
:func:`prefill_attention` takes that role and calls
:func:`repro_torch.kernels.ops.flash_attention`: the CUDA kernel for CUDA
tensors, its plain version for CPU tensors.  The decode functions are plain
PyTorch, as they are XLA code in the reference; :func:`full_attention` is a
test oracle only.

Layout: q (B, S, H, dh); k, v (B, T, K, dh) with H = K * G (GQA).
Numerical scheme: finite masking (-1e30, never -inf) keeps fully masked
rows NaN-free.
"""

from __future__ import annotations

import torch

from ..kernels import ops
from .layers import f32_einsum

__all__ = ["prefill_attention", "decode_attention",
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
