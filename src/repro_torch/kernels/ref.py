"""Plain PyTorch versions of the kernels: the ground truth they are held to.

``dirty_diff_ref`` mirrors ``repro.kernels.ref.dirty_diff_ref`` and
``diff_pack_ref`` mirrors ``repro.kernels.pack_diff.diff_pack_ref``.  The
wrappers in :mod:`repro_torch.kernels.ops` run them for CPU tensors;
``chip_smoke.py`` holds the CUDA kernels against them on the card.
"""

from __future__ import annotations

import torch

__all__ = ["dirty_diff_ref", "diff_pack_ref"]

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
