"""Public kernel wrappers: layout normalization and dispatch by device.

The counterpart of ``repro.kernels.ops`` for the two kernels of device-side
selective sync, for attention, for the SSD scan and for the RG-LRU
recurrence.  A CUDA tensor goes to the CUDA kernel, and a failing build
or launch raises; a CPU tensor goes to the kernel's plain PyTorch version
(:mod:`repro_torch.kernels.ref`).  Nothing else chooses between the two.
Attention, the SSD scan and the RG-LRU recurrence also take ``meta``
tensors, the dry-run's (:mod:`repro_torch.launch.dryrun`): they go to the
CUDA kernel's wrapper as CUDA tensors would, which makes the same checks
and allocates the same outputs and scratch, then counts the launch, with
its ``work``, for the active :class:`~repro_torch.perf.OpCounter` and runs
nothing.  The diff kernels run in window syncs, which no dry-run contains,
and take no meta tensors.  Any other device raises.
Attention, the SSD scan and the RG-LRU recurrence find their CUDA kernel
by dtype (:func:`cuda_kernel`).  Attention and the scan have two each,
both on the tensor cores: bfloat16 inputs go to ``*_tc``, float32 inputs
to ``*_tc32``, whose float32-accurate products (TF32 hi + lo, three
products each) their float32 limits need.  The recurrence has one for both,
``rg_lru_pipe``.  Any other dtype on the card raises.  The earlier kernels
(:mod:`.flash_attention`, :mod:`.ssd_scan` on the CUDA cores,
:mod:`.rg_lru` with loads in the walk) are on no path; they stay as
comparators that ``chip_smoke.py`` checks and times.

The CUDA kernels take flat byte views and mask the short last block
themselves, so nothing is padded or copied on the card.  The plain versions
see the reference's layout: a bit view, flattened and zero-padded to whole
blocks of ``block_elems``.  Both give the same flags, and the same bytes in
``packed[:count]``.  The attention kernel masks ragged lengths itself too:
the reference's padding to block multiples has no counterpart here, and
neither has its padding of the SSD scan to whole chunks or of the RG-LRU
recurrence to whole blocks (a = 1, gx = 0).
"""

from __future__ import annotations

import sys
from types import ModuleType
from typing import Callable

import torch

from . import ref
from .dirty_diff import dirty_diff_cuda
from .flash_attention_tc import D_MAX, flash_attention_tc_cuda
from .flash_attention_tc32 import flash_attention_tc32_cuda
from .pack_diff import diff_pack_cuda
from .rg_lru_pipe import rg_lru_pipe_cuda
from .ssd_scan_tc import ssd_scan_tc_cuda
from .ssd_scan_tc32 import ssd_scan_tc32_cuda

__all__ = ["cuda_kernel", "dirty_blocks", "dirty_pack", "flash_attention",
           "kernel_module", "padded_rows", "rg_lru_scan", "ssd_scan"]

# the CUDA kernel that serves CUDA tensors of each dtype
_CUDA_KERNELS = {
    "flash_attention": {torch.float32: flash_attention_tc32_cuda,
                        torch.bfloat16: flash_attention_tc_cuda},
    "ssd_scan": {torch.float32: ssd_scan_tc32_cuda,
                 torch.bfloat16: ssd_scan_tc_cuda},
    "rg_lru": {torch.float32: rg_lru_pipe_cuda,
               torch.bfloat16: rg_lru_pipe_cuda},
}


def cuda_kernel(op: str, dtype: torch.dtype) -> Callable:
    """The wrapper of the CUDA kernel that ``op`` (``"flash_attention"``,
    ``"ssd_scan"`` or ``"rg_lru"``) launches for CUDA tensors of
    ``dtype``.  Raises ``ValueError`` for a dtype that no kernel takes."""
    kernel = _CUDA_KERNELS[op].get(dtype)
    if kernel is None:
        raise ValueError(f"no CUDA kernel of {op} takes {dtype}; it takes "
                         "float32 or bfloat16")
    return kernel


def kernel_module(op: str, dtype: torch.dtype) -> ModuleType:
    """The module of :func:`cuda_kernel`'s wrapper, whose ``launches``
    counts that kernel's launches."""
    return sys.modules[cuda_kernel(op, dtype).__module__]


def _check_pair(cur: torch.Tensor, snap: torch.Tensor,
                block_elems: int) -> None:
    if cur.shape != snap.shape or cur.dtype != snap.dtype:
        raise ValueError("cur/snap must have one shape and dtype, got "
                         f"{tuple(cur.shape)} {cur.dtype} and "
                         f"{tuple(snap.shape)} {snap.dtype}")
    if cur.device != snap.device:
        raise ValueError(f"cur/snap on different devices: {cur.device} "
                         f"and {snap.device}")
    if cur.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no kernel for device {cur.device}")
    if block_elems <= 0:
        raise ValueError(f"block_elems must be > 0, got {block_elems}")


def _bytes(x: torch.Tensor) -> torch.Tensor:
    """Flat uint8 view of a tensor (a copy only if it is not contiguous)."""
    return x.reshape(-1).view(torch.uint8)


def padded_rows(x: torch.Tensor, block_elems: int) -> torch.Tensor:
    """The reference's layout: flattened, zero-padded to whole blocks,
    shaped (nblocks, block_elems)."""
    flat = x.reshape(-1)
    pad = (-flat.numel()) % block_elems
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.reshape(-1, block_elems)


def dirty_blocks(cur: torch.Tensor, snap: torch.Tensor, *,
                 block_elems: int = 1024) -> torch.Tensor:
    """Flatten two same-shape tensors into blocks of ``block_elems``;
    return ``(nblocks,)`` int32 changed flags on their device.

    Feeds ``DirtyTracker.mark_blocks`` for device-state incremental
    checkpoints (``Window.sync_from_device`` sizes ``block_elems`` so one
    flag covers one tracker page).
    """
    _check_pair(cur, snap, block_elems)
    if cur.is_cuda:
        return dirty_diff_cuda(_bytes(cur), _bytes(snap),
                               block_elems * cur.element_size())
    return ref.dirty_diff_ref(padded_rows(cur, block_elems),
                              padded_rows(snap, block_elems))


def dirty_pack(cur: torch.Tensor, snap: torch.Tensor, *,
               block_elems: int = 1024):
    """Fused diff+pack: ``(flags (nb,) int32, packed (nb, block_elems)
    cur.dtype, count (1,) int32)``, all on the tensors' device.

    ``packed[:count]`` holds the changed blocks in block order, so one
    device->host fetch of those rows moves every changed byte;
    :func:`~repro_torch.kernels.pack_diff.packed_run_layout` maps the bitmap
    to the span geometry shared with the per-span route.  In the short last
    block, elements past the tensor's end are zero.  Rows from ``count`` on
    are not part of the result (the CUDA kernel leaves them unwritten).
    """
    _check_pair(cur, snap, block_elems)
    if cur.is_cuda:
        flags, packed, count = diff_pack_cuda(
            _bytes(cur), _bytes(snap), block_elems * cur.element_size())
        return flags, packed.view(cur.dtype), count
    return ref.diff_pack_ref(padded_rows(cur, block_elems),
                             padded_rows(snap, block_elems))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    scale: float | None = None,
                    t_actual: int | None = None) -> torch.Tensor:
    """q: (B,H,S,d); k: (B,K,T,d); v: (B,K,T,dv) with H = K*G and
    1 <= d, dv <= 256 (MLA's prefill: d 192, dv 128).  Returns (B,H,S,dv)
    in q.dtype.  Keys at or past ``t_actual`` (default T) are masked;
    ``window`` keeps keys with ``q_pos - k_pos < window``.  Queries and
    keys both count positions from 0; ``scale`` defaults to d**-0.5."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 \
            or k.shape[:3] != v.shape[:3]:
        raise ValueError("q must be (B,H,S,d), k (B,K,T,d) and v (B,K,T,dv), "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, H, S, d = q.shape
    Bk, K, T, dk = k.shape
    dv = v.shape[3]
    if Bk != B or dk != d or K == 0 or H % K:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do "
                         "not pair: batch and head dimension must agree and "
                         "the kv heads divide the heads")
    if not (1 <= d <= D_MAX and 1 <= dv <= D_MAX):
        raise ValueError(f"head dimensions d {d} and dv {dv} must be in "
                         f"[1, {D_MAX}]")
    if not q.dtype == k.dtype == v.dtype:
        raise ValueError(f"q, k, v must share a dtype, got {q.dtype}, "
                         f"{k.dtype}, {v.dtype}")
    if not q.device == k.device == v.device:
        raise ValueError(f"q, k, v on different devices: {q.device}, "
                         f"{k.device}, {v.device}")
    if q.device.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"no kernel for device {q.device}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    t_actual = T if t_actual is None else t_actual
    if not 1 <= t_actual <= T:
        raise ValueError(f"t_actual must be in [1, {T}], got {t_actual}")
    scale = d ** -0.5 if scale is None else scale
    if q.is_cuda or q.is_meta:
        return cuda_kernel("flash_attention", q.dtype)(
            q, k, v, causal=causal, window=window, scale=scale,
            t_actual=t_actual)
    return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                   scale=scale, t_actual=t_actual)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, C: torch.Tensor, *, return_state: bool = False):
    """x: (B,H,S,P); dt: (B,H,S); A: (H,); Bm/C: (B,H,S,N) -> y (B,H,S,P)
    float32, and with ``return_state`` also the final state (B,H,N,P)
    float32.  x, Bm and C share a dtype; the arithmetic is float32."""
    if x.dim() != 4 or dt.dim() != 3 or A.dim() != 1 or Bm.dim() != 4 \
            or Bm.shape != C.shape:
        raise ValueError("x must be (B,H,S,P), dt (B,H,S), A (H,) and Bm, C "
                         f"one (B,H,S,N) shape, got {tuple(x.shape)}, "
                         f"{tuple(dt.shape)}, {tuple(A.shape)}, "
                         f"{tuple(Bm.shape)}, {tuple(C.shape)}")
    B, H, S, _ = x.shape
    if tuple(dt.shape) != (B, H, S) or tuple(A.shape) != (H,) \
            or tuple(Bm.shape[:3]) != (B, H, S):
        raise ValueError(f"x {tuple(x.shape)}, dt {tuple(dt.shape)}, A "
                         f"{tuple(A.shape)} and Bm/C {tuple(Bm.shape)} do not "
                         "pair: batch, heads and positions must agree")
    if not x.dtype == Bm.dtype == C.dtype:
        raise ValueError(f"x, Bm, C must share a dtype, got {x.dtype}, "
                         f"{Bm.dtype}, {C.dtype}")
    if not x.device == dt.device == A.device == Bm.device == C.device:
        raise ValueError("x, dt, A, Bm, C on different devices: "
                         f"{x.device}, {dt.device}, {A.device}, {Bm.device}, "
                         f"{C.device}")
    if x.device.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"no kernel for device {x.device}")
    if x.is_cuda or x.is_meta:
        y, h = cuda_kernel("ssd_scan", x.dtype)(x, dt.float(), A.float(), Bm,
                                                 C)
        return (y, h) if return_state else y
    return ref.ssd_scan_ref(x, dt, A, Bm, C, return_state=return_state)


def rg_lru_scan(a: torch.Tensor, gx: torch.Tensor) -> torch.Tensor:
    """a, gx: (B,S,W) of one floating dtype -> y (B,S,W) float32, the
    recurrence ``h_t = a_t * h_{t-1} + gx_t`` from h = 0."""
    if a.dim() != 3 or a.shape != gx.shape:
        raise ValueError("a and gx must be one (B,S,W) shape, got "
                         f"{tuple(a.shape)}, {tuple(gx.shape)}")
    if a.dtype != gx.dtype or not a.is_floating_point():
        raise ValueError("a and gx must share a floating dtype, got "
                         f"{a.dtype}, {gx.dtype}")
    if a.device != gx.device:
        raise ValueError(f"a and gx on different devices: {a.device}, "
                         f"{gx.device}")
    if a.device.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"no kernel for device {a.device}")
    if a.is_cuda or a.is_meta:
        return cuda_kernel("rg_lru", a.dtype)(a, gx)
    return ref.rg_lru_ref(a, gx)
