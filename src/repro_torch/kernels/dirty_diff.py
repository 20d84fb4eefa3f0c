"""Changed-page flags on the card: the ``dirty_diff`` CUDA kernel.

The paper's ``MPI_Win_sync`` is *selective*: only dirty pages are flushed.
When the authoritative state lives on the device, finding the pages that
changed would otherwise cost a device->host copy of everything.  This kernel
(``csrc/dirty_diff.cu``, the counterpart of the JAX package's
``dirty_diff_tpu``) reduces a (current, snapshot) pair to one changed flag
per page on the device, in one streaming pass; only the bitmap then crosses
to the host, feeding the same ``DirtyTracker`` bitmap as the host-side
compare-on-write path.

The kernel compares bytes, so every dtype is compared by bit pattern: an
unchanged block full of NaNs stays clean, exactly like the host page
cache's byte compare.  Its plain PyTorch version is
:func:`repro_torch.kernels.ref.dirty_diff_ref`.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["changed_elem_spans", "dirty_diff_cuda", "launches"]

#: kernel launches made by :func:`dirty_diff_cuda` (a run that must show it
#: went through the kernel sets this to 0 before and reads it after)
launches = 0

_SIGNATURES = {
    "dirty_diff_launch": (
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
         ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p], ctypes.c_int),
}

_MAX_GRID = 2 ** 31 - 1


def changed_elem_spans(flags, block_elems: int,
                       nelems: int) -> list[tuple[int, int]]:
    """Geometry helper: changed-flag bitmap -> coalesced element spans.

    Translates the kernel's per-block flags into contiguous
    ``[lo_elem, hi_elem)`` runs clipped to ``nelems`` (the last block may
    be partial).  These are exactly the spans that must cross the
    device->host boundary and ride the masked span-write, so every consumer
    of the bitmap shares one clipping rule.
    """
    from ..core.storage import dirty_runs  # lazy: core imports this module
    out = []
    for b0, b1 in dirty_runs(flags):
        lo = b0 * block_elems
        hi = min(b1 * block_elems, nelems)
        if lo < hi:
            out.append((lo, hi))
    return out


def check_byte_pair(cur: torch.Tensor, snap: torch.Tensor,
                    block_bytes: int) -> int:
    """Validate a kernel input pair; returns the number of blocks."""
    if not (cur.is_cuda and snap.is_cuda and cur.device == snap.device):
        raise ValueError("the CUDA kernels take two tensors on one CUDA "
                         f"device, got {cur.device} and {snap.device}")
    if cur.dtype != torch.uint8 or snap.dtype != torch.uint8:
        raise ValueError("the CUDA kernels take uint8 byte views")
    if cur.dim() != 1 or cur.shape != snap.shape:
        raise ValueError("the CUDA kernels take two flat byte views of one "
                         f"length, got {tuple(cur.shape)} and "
                         f"{tuple(snap.shape)}")
    if not (cur.is_contiguous() and snap.is_contiguous()):
        raise ValueError("the CUDA kernels take contiguous tensors")
    if block_bytes <= 0:
        raise ValueError(f"block_bytes must be > 0, got {block_bytes}")
    nblocks = -(-cur.numel() // block_bytes)
    if nblocks > _MAX_GRID:
        raise ValueError(f"{nblocks} blocks exceed one CUDA grid")
    return nblocks


def raise_on_error(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def dirty_diff_cuda(cur: torch.Tensor, snap: torch.Tensor,
                    block_bytes: int) -> torch.Tensor:
    """``cur``, ``snap``: flat contiguous uint8 CUDA tensors of one length.
    Returns ``(ceil(len / block_bytes),)`` int32 flags on their device, 1
    where the block differs; the short last block is masked in the kernel.
    Launches on the current stream and does not synchronise."""
    global launches
    nblocks = check_byte_pair(cur, snap, block_bytes)
    flags = torch.empty(nblocks, dtype=torch.int32, device=cur.device)
    if nblocks == 0:
        return flags
    lib = _build.library("dirty_diff", _SIGNATURES)
    with torch.cuda.device(cur.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.dirty_diff_launch(cur.data_ptr(), snap.data_ptr(),
                                    flags.data_ptr(), nblocks, block_bytes,
                                    cur.numel(), stream)
    raise_on_error(err, "dirty_diff")
    launches += 1
    return flags
