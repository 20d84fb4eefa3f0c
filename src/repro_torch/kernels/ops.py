"""Public kernel wrappers: layout normalization and dispatch by device.

The counterpart of ``repro.kernels.ops`` for the two kernels of device-side
selective sync.  A CUDA tensor goes to the CUDA kernel, and a failing build
or launch raises; a CPU tensor goes to the kernel's plain PyTorch version
(:mod:`repro_torch.kernels.ref`).  Nothing else chooses between the two.

The CUDA kernels take flat byte views and mask the short last block
themselves, so nothing is padded or copied on the card.  The plain versions
see the reference's layout: a bit view, flattened and zero-padded to whole
blocks of ``block_elems``.  Both give the same flags, and the same bytes in
``packed[:count]``.
"""

from __future__ import annotations

import torch

from . import ref
from .dirty_diff import dirty_diff_cuda
from .pack_diff import diff_pack_cuda

__all__ = ["dirty_blocks", "dirty_pack", "padded_rows"]


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
