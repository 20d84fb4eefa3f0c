"""Changed pages compacted on the card: the ``diff_pack`` CUDA kernels.

``dirty_diff`` alone leaves the expensive half of selective device sync to
the host: once the bitmap is known, each changed span still crosses to the
host as its own slice.  ``diff_pack`` (the counterpart of the JAX package's
``diff_pack_tpu``) also emits a compacted buffer whose first ``count`` rows
are exactly the changed blocks in block order, so the changed bytes cross
as ONE contiguous transfer however fragmented the dirty set is.

The TPU kernel places rows optimistically on its sequential grid.  GPU
blocks run in parallel and in no order, so :func:`diff_pack_cuda` is three
steps on one stream: the ``dirty_diff`` flags kernel, an exclusive scan of
the flags that also writes ``count``, and a copy kernel that moves each
dirty block to its row (``csrc/pack_diff.cu``).  Its plain PyTorch version
is :func:`repro_torch.kernels.ref.diff_pack_ref`.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build
from .dirty_diff import (changed_elem_spans, check_byte_pair,
                         dirty_diff_cuda, raise_on_error)

__all__ = ["diff_pack_cuda", "packed_run_layout", "launches"]

#: calls of :func:`diff_pack_cuda` that launched its scan and copy kernels
#: (its first pass counts as a launch of ``dirty_diff`` too)
launches = 0

_SIGNATURES = {
    "diff_pack_tile": ([], ctypes.c_int64),
    "diff_pack_launch": (
        [ctypes.c_void_p] * 6 + [ctypes.c_int64] * 3 + [ctypes.c_void_p],
        ctypes.c_int),
}


def packed_run_layout(flags, block_elems: int,
                      nelems: int) -> list[tuple[int, int, int]]:
    """Bitmap -> ``[(lo_elem, hi_elem, packed_elem_off)]`` for span rebuild.

    Packing preserves block order, so a coalesced dirty run ``[b0, b1)``
    occupies packed rows ``[pos(b0), pos(b0) + (b1 - b0))`` contiguously,
    where ``pos`` is the exclusive prefix count of dirty blocks.  The
    ``(lo_elem, hi_elem)`` geometry is exactly
    :func:`~repro_torch.kernels.dirty_diff.changed_elem_spans` -- the packed
    route and the per-span route share one clipping rule by construction.
    """
    f = np.asarray(flags, np.int64).ravel()
    excl = np.concatenate(([0], np.cumsum(f)[:-1])) if f.size else f
    out = []
    for lo, hi in changed_elem_spans(f, block_elems, nelems):
        out.append((lo, hi, int(excl[lo // block_elems]) * block_elems))
    return out


def diff_pack_cuda(cur: torch.Tensor, snap: torch.Tensor, block_bytes: int):
    """``cur``, ``snap``: flat contiguous uint8 CUDA tensors of one length.

    Returns ``(flags (nb,) int32, packed (nb, block_bytes) uint8, count (1,)
    int32)`` on their device: ``packed[:count]`` are the changed blocks in
    block order, with the bytes past the input's end zero in the short last
    block; rows from ``count`` on are not written.  Launches on the current
    stream and does not synchronise: ``count`` stays on the device.
    """
    global launches
    nblocks = check_byte_pair(cur, snap, block_bytes)
    dev = cur.device
    packed = torch.empty((nblocks, block_bytes), dtype=torch.uint8,
                         device=dev)
    if nblocks == 0:
        return (torch.empty(0, dtype=torch.int32, device=dev), packed,
                torch.zeros(1, dtype=torch.int32, device=dev))
    flags = dirty_diff_cuda(cur, snap, block_bytes)
    lib = _build.library("pack_diff", _SIGNATURES)
    ntiles = -(-nblocks // lib.diff_pack_tile())
    pos = torch.empty(nblocks, dtype=torch.int32, device=dev)
    tile_offs = torch.empty(ntiles, dtype=torch.int32, device=dev)
    count = torch.empty(1, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.diff_pack_launch(
            cur.data_ptr(), flags.data_ptr(), pos.data_ptr(),
            tile_offs.data_ptr(), count.data_ptr(), packed.data_ptr(),
            nblocks, block_bytes, cur.numel(), stream)
    raise_on_error(err, "diff_pack")
    launches += 1
    return flags, packed, count
