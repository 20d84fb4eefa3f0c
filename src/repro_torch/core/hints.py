"""Performance hints for window allocations.

Mirrors the paper's MPI Info key/value hints (Section 2.1).  Hints are
advisory: unknown keys are ignored, and if storage allocation is not
supported the window silently falls back to memory -- exactly the MPI
semantics ("if the specific MPI implementation does not support storage
allocations, the performance hints are simply ignored").

The seven storage hints from the paper:
    alloc_type               "memory" (default) | "storage"
    storage_alloc_filename   target file or block device path
    storage_alloc_offset     byte offset into an existing target
    storage_alloc_factor     combined-allocation split: float in [0,1] or "auto"
    storage_alloc_order      "memory_first" (default) | "storage_first"
    storage_alloc_unlink     delete the file at window free
    storage_alloc_discard    skip the final sync at window free

plus one extension hint of this implementation (resilience subsystem):
    storage_alloc_replication  total copies k >= 1 of each rank's partition
                               (k-1 replicas on other ranks, in the JAX
                               package's resilience layer; this package
                               refuses windows it would replicate until that
                               layer is ported).  Advisory like every hint:
                               ignored for memory/combined windows and
                               clamped to the communicator size.

plus the MPI-I/O reserved hints the paper integrates:
    access_style, file_perm, striping_factor, striping_unit
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Union

__all__ = ["Info", "WindowHints", "HintError"]

# An MPI_Info object is just string->string pairs.
Info = Mapping[str, str]


class HintError(ValueError):
    """Raised when a hint value is present but malformed."""


_ALLOC_TYPES = ("memory", "storage")
_ORDERS = ("memory_first", "storage_first")
_ACCESS_STYLES = (
    "",
    "read_once", "write_once", "read_mostly", "write_mostly",
    "sequential", "reverse_sequential", "random",
)


def _parse_bool(key: str, value: str) -> bool:
    v = value.strip().lower()
    if v in ("true", "1", "yes"):
        return True
    if v in ("false", "0", "no"):
        return False
    raise HintError(f"hint {key!r}: expected boolean, got {value!r}")


def _parse_factor(value: str) -> Union[float, str]:
    v = value.strip().lower()
    if v == "auto":
        return "auto"
    try:
        f = float(v)
    except ValueError:
        raise HintError(f"hint 'storage_alloc_factor': expected float or 'auto', got {value!r}") from None
    if not 0.0 <= f <= 1.0:
        raise HintError(f"hint 'storage_alloc_factor': must be in [0, 1], got {f}")
    return f


@dataclasses.dataclass(frozen=True)
class WindowHints:
    """Validated, typed view of an Info object.

    ``factor`` follows the paper's convention: the fraction of the
    allocation placed *in memory* ("A value of 0.5 would associate half of
    the addresses into memory, and half into storage").  ``factor == 1.0``
    with ``alloc_type == "storage"`` means a pure storage window (the
    default when no factor hint is given), matching Listing 1.
    """

    alloc_type: str = "memory"
    filename: str | None = None
    offset: int = 0
    factor: Union[float, str, None] = None  # None => not a combined window
    order: str = "memory_first"
    unlink: bool = False
    discard: bool = False
    # resilience extension: total copies of each rank's partition (k >= 1)
    replication: int = 1
    # MPI-I/O reserved hints (paper Section 2.1)
    access_style: str = ""
    file_perm: int = 0o644
    striping_factor: int = 1
    striping_unit: int = 1 << 20

    @property
    def is_storage(self) -> bool:
        return self.alloc_type == "storage"

    @property
    def is_combined(self) -> bool:
        return self.is_storage and self.factor is not None

    @classmethod
    def from_info(cls, info: Info | None) -> "WindowHints":
        """Parse an MPI_Info-style mapping.  Unknown keys are ignored."""
        if info is None:
            return cls()
        kw = {}
        if "alloc_type" in info:
            at = info["alloc_type"].strip().lower()
            if at not in _ALLOC_TYPES:
                raise HintError(f"hint 'alloc_type': expected one of {_ALLOC_TYPES}, got {at!r}")
            kw["alloc_type"] = at
        if "storage_alloc_filename" in info:
            kw["filename"] = info["storage_alloc_filename"]
        if "storage_alloc_offset" in info:
            try:
                off = int(info["storage_alloc_offset"])
            except ValueError:
                raise HintError("hint 'storage_alloc_offset': expected integer") from None
            if off < 0:
                raise HintError("hint 'storage_alloc_offset': must be >= 0")
            kw["offset"] = off
        if "storage_alloc_factor" in info:
            kw["factor"] = _parse_factor(info["storage_alloc_factor"])
        if "storage_alloc_order" in info:
            order = info["storage_alloc_order"].strip().lower()
            if order not in _ORDERS:
                raise HintError(f"hint 'storage_alloc_order': expected one of {_ORDERS}, got {order!r}")
            kw["order"] = order
        if "storage_alloc_unlink" in info:
            kw["unlink"] = _parse_bool("storage_alloc_unlink", info["storage_alloc_unlink"])
        if "storage_alloc_discard" in info:
            kw["discard"] = _parse_bool("storage_alloc_discard", info["storage_alloc_discard"])
        if "storage_alloc_replication" in info:
            try:
                rep = int(info["storage_alloc_replication"])
            except ValueError:
                raise HintError("hint 'storage_alloc_replication': "
                                "expected integer >= 1") from None
            if rep < 1:
                raise HintError("hint 'storage_alloc_replication': "
                                "must be >= 1")
            kw["replication"] = rep
        if "access_style" in info:
            style = info["access_style"].strip().lower()
            if style not in _ACCESS_STYLES:
                raise HintError(f"hint 'access_style': unknown style {style!r}")
            kw["access_style"] = style
        if "file_perm" in info:
            try:
                kw["file_perm"] = int(info["file_perm"], 8)
            except ValueError:
                raise HintError("hint 'file_perm': expected octal permissions") from None
        if "striping_factor" in info:
            sf = int(info["striping_factor"])
            if sf < 1:
                raise HintError("hint 'striping_factor': must be >= 1")
            kw["striping_factor"] = sf
        if "striping_unit" in info:
            su = int(info["striping_unit"])
            if su < 1:
                raise HintError("hint 'striping_unit': must be >= 1")
            kw["striping_unit"] = su

        hints = cls(**kw)
        if hints.is_storage and not hints.filename:
            raise HintError(
                "alloc_type='storage' requires the 'storage_alloc_filename' hint "
                "(path to a file or block device)"
            )
        return hints

    def memory_bytes(self, size: int, memory_budget: int | None = None) -> int:
        """Bytes of a ``size``-byte combined allocation that live in memory.

        Implements the paper's factor semantics, including ``auto``: "when
        the requested allocation exceeds the main memory capacity, the
        factor will be adapted to map the part that exceeds the main memory
        into storage; otherwise the window allocation remains in memory".
        """
        if not self.is_storage:
            return size
        if self.factor is None:
            return 0  # pure storage window
        if self.factor == "auto":
            if memory_budget is None:
                raise HintError("factor='auto' requires a memory budget")
            return size if size <= memory_budget else memory_budget
        return int(size * float(self.factor))
