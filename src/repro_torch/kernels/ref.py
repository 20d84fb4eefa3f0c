"""Plain PyTorch versions of the kernels: the ground truth they are held to.

``dirty_diff_ref`` mirrors ``repro.kernels.ref.dirty_diff_ref``,
``diff_pack_ref`` mirrors ``repro.kernels.pack_diff.diff_pack_ref``,
``flash_attention_ref`` mirrors ``repro.kernels.ref.flash_attention_ref``,
``ssd_scan_ref`` mirrors ``repro.kernels.ref.ssd_scan_ref`` and
``rg_lru_ref`` mirrors ``repro.kernels.ref.rg_lru_ref``.  The
wrappers in :mod:`repro_torch.kernels.ops` run them for CPU tensors;
``chip_smoke.py`` holds the CUDA kernels against them on the card.
"""

from __future__ import annotations

import torch

__all__ = ["dirty_diff_ref", "diff_pack_ref", "flash_attention_ref",
           "rg_lru_ref", "ssd_scan_ref"]

_NEG = -1e30

_INT_OF_WIDTH = {1: torch.int8, 2: torch.int16, 4: torch.int32,
                 8: torch.int64}


def _bit_view(x: torch.Tensor) -> torch.Tensor:
    """Same-width signed-int view for exact bit-pattern comparison (signed,
    because PyTorch covers few ops of its wider unsigned types; equality
    does not depend on the sign)."""
    if x.is_floating_point():
        return x.view(_INT_OF_WIDTH[x.element_size()])
    return x


def dirty_diff_ref(cur: torch.Tensor, snap: torch.Tensor) -> torch.Tensor:
    """(nblocks, block_elems) pair -> (nblocks,) int32 changed flags, on bit
    patterns (an unchanged block of NaNs stays clean)."""
    return (_bit_view(cur) != _bit_view(snap)).any(dim=-1).to(torch.int32)


def diff_pack_ref(cur: torch.Tensor, snap: torch.Tensor):
    """(nblocks, block_elems) pair -> ``(flags (nb,) int32, packed (nb,
    block_elems) cur.dtype, count (1,) int32)``: ``packed[:count]`` holds
    the changed rows in block order, the rows after it are zero."""
    flags = dirty_diff_ref(cur, snap)
    f = flags.bool()
    k = int(f.sum())
    packed = torch.zeros_like(cur)
    if k:
        packed[:k] = cur[f]
    return flags, packed, torch.tensor([k], dtype=torch.int32,
                                       device=cur.device)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int | None = None,
                        scale: float | None = None,
                        t_actual: int | None = None) -> torch.Tensor:
    """q: (B,H,S,d); k/v: (B,K,T,d) with H = K*G.  Naive full-matrix
    softmax attention in float32 (the query cast, then scaled), masked
    scores -1e30; returns (B,H,S,d) in q.dtype."""
    B, H, S, d = q.shape
    _, K, T, _ = k.shape
    G = H // K
    scale = d ** -0.5 if scale is None else scale
    t_actual = T if t_actual is None else t_actual
    kk = k.repeat_interleave(G, dim=1).float()
    vv = v.repeat_interleave(G, dim=1).float()
    s = torch.einsum("bhsd,bhtd->bhst", q.float() * scale, kk)
    q_pos = torch.arange(S, device=q.device)[:, None]
    k_pos = torch.arange(T, device=q.device)[None, :]
    mask = k_pos < t_actual
    if causal:
        mask = mask & (k_pos <= q_pos)
    if window is not None:
        mask = mask & (q_pos - k_pos < window)
    s = torch.where(mask, s, _NEG)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhst,bhtd->bhsd", p, vv).to(q.dtype)


def ssd_scan_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 Bm: torch.Tensor, C: torch.Tensor, *,
                 return_state: bool = False):
    """Sequential SSD recurrence in float32.  x: (B,H,S,P); dt: (B,H,S);
    A: (H,); Bm/C: (B,H,S,N) -> y (B,H,S,P) float32, and with
    ``return_state`` also the final state (B,H,N,P) float32."""
    B, H, S, P = x.shape
    N = Bm.shape[-1]
    xf, dtf, Af = x.float(), dt.float(), A.float()
    bf, cf = Bm.float(), C.float()
    h = torch.zeros((B, H, N, P), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        dt_t = dtf[:, :, t]
        da = torch.exp(dt_t * Af[None, :])
        h = h * da[..., None, None] + torch.einsum(
            "bhn,bhp->bhnp", bf[:, :, t], xf[:, :, t] * dt_t[..., None])
        ys.append(torch.einsum("bhn,bhnp->bhp", cf[:, :, t], h))
    y = (torch.stack(ys, dim=2) if ys
         else torch.zeros((B, H, 0, P), dtype=torch.float32, device=x.device))
    return (y, h) if return_state else y


def rg_lru_ref(a: torch.Tensor, gx: torch.Tensor) -> torch.Tensor:
    """Sequential gated recurrence in float32, from h = 0: ``h = a_t * h +
    g_t`` as two operations (a product, then a sum, each rounded), which is
    how the CUDA kernel rounds too.  a, gx: (B,S,W) -> y (B,S,W) float32."""
    af, gf = a.float(), gx.float()
    h = torch.zeros((a.shape[0], a.shape[2]), dtype=torch.float32,
                    device=a.device)
    y = torch.empty(af.shape, dtype=torch.float32, device=a.device)
    for t in range(a.shape[1]):
        h = af[:, t] * h + gf[:, t]
        y[:, t] = h
    return y
