"""Combined (heterogeneous) window allocations.

Paper §2.1 / Fig. 2-3: "Combined window allocations are defined by dividing
the reserved range of virtual addresses, and then mapping each subrange
individually. Thus, applications are provided with a single address space
that contains both allocation types."

``CombinedSegment`` provides exactly that: one logical [0, size) byte space
whose first part (``memory_first``, default) is a plain in-memory buffer --
inherently "pinned", never subject to write-back -- and whose remainder is
storage-backed.  The ``factor`` hint picks the split; ``auto`` spills only
the bytes that exceed a memory budget (out-of-core, Fig. 3c).
"""

from __future__ import annotations

import numpy as np

from .hints import WindowHints
from .storage import dirty_runs, make_backing, mark_span

__all__ = ["CombinedSegment"]


class CombinedSegment:
    """One rank's combined memory+storage allocation."""

    def __init__(self, size: int, hints: WindowHints, path: str, *,
                 memory_budget: int | None = None, mechanism: str = "cached",
                 page_size: int = 4096, cache_bytes: int | None = None,
                 writeback_interval: float | None = None,
                 compare_on_write: bool = False):
        self.size = size
        self.hints = hints
        mem_bytes = hints.memory_bytes(size, memory_budget)
        sto_bytes = size - mem_bytes
        self.mem_bytes = mem_bytes
        self.sto_bytes = sto_bytes
        self.order = hints.order
        self._mem = np.zeros(mem_bytes, dtype=np.uint8)
        if sto_bytes > 0:
            self.backing = make_backing(
                path, sto_bytes, mechanism=mechanism, offset=hints.offset,
                page_size=page_size, file_perm=hints.file_perm,
                striping_factor=hints.striping_factor,
                striping_unit=hints.striping_unit,
                **({"cache_bytes": cache_bytes,
                    "writeback_interval": writeback_interval,
                    "compare_on_write": compare_on_write}
                   if mechanism == "cached" else {}),
            )
        else:
            self.backing = None

    # Logical layout: memory_first => [mem | storage]; storage_first reversed.
    def _split(self, offset: int, nbytes: int):
        """Split a logical range into (memory ranges, storage ranges).

        Each entry is (part_offset, length, buf_offset).
        """
        if self.order == "memory_first":
            mem_lo, mem_hi = 0, self.mem_bytes
            sto_lo = self.mem_bytes
        else:
            sto_lo = 0
            mem_lo, mem_hi = self.sto_bytes, self.size
        mem_rs, sto_rs = [], []
        end = offset + nbytes
        # memory overlap
        a, b = max(offset, mem_lo), min(end, mem_hi)
        if a < b:
            mem_rs.append((a - mem_lo, b - a, a - offset))
        # storage overlap
        a, b = max(offset, sto_lo), min(end, sto_lo + self.sto_bytes)
        if a < b:
            sto_rs.append((a - sto_lo, b - a, a - offset))
        return mem_rs, sto_rs

    def read(self, offset: int, nbytes: int) -> np.ndarray:
        if offset < 0 or offset + nbytes > self.size:
            raise IndexError(f"access [{offset},{offset + nbytes}) outside {self.size}B window")
        out = np.empty(nbytes, dtype=np.uint8)
        mem_rs, sto_rs = self._split(offset, nbytes)
        for po, ln, bo in mem_rs:
            out[bo:bo + ln] = self._mem[po:po + ln]
        for po, ln, bo in sto_rs:
            out[bo:bo + ln] = self.backing.read(po, ln)
        return out

    def write(self, offset: int, data) -> None:
        data = np.asarray(data, dtype=np.uint8).ravel()
        if offset < 0 or offset + data.nbytes > self.size:
            raise IndexError(f"access [{offset},{offset + data.nbytes}) outside {self.size}B window")
        mem_rs, sto_rs = self._split(offset, data.nbytes)
        for po, ln, bo in mem_rs:
            self._mem[po:po + ln] = data[bo:bo + ln]
        for po, ln, bo in sto_rs:
            self.backing.write(po, data[bo:bo + ln])

    def _storage_mask(self, mask) -> np.ndarray:
        """Translate a window-block mask into storage-tracker coordinates.

        ``mask`` indexes ``page_size`` blocks of the *combined* [0, size)
        byte space; the storage tracker indexes blocks of the storage
        subrange only.  With ``memory_first`` the storage part starts at
        ``mem_bytes``, so window block ``b`` lands ``mem_bytes`` lower; when
        the split is not page-aligned a window block straddles two storage
        blocks and both are selected (conservative, never skips).  Window
        blocks entirely inside the memory part select nothing -- the memory
        part has no durability to sync.
        """
        ps = self.backing.page_size
        sto_lo = self.mem_bytes if self.order == "memory_first" else 0
        out = np.zeros(self.backing.tracker.num_blocks, dtype=bool)
        for b0, b1 in dirty_runs(np.asarray(mask, dtype=bool).ravel()):
            mark_span(out, b0 * ps - sto_lo,
                      min(b1 * ps - sto_lo, self.sto_bytes), ps)
        return out

    def sync(self, full: bool = False, mask: np.ndarray | None = None) -> int:
        """Flush the storage part's dirty blocks.  The memory part is pinned
        (volatile) by design -- the paper's combined windows only persist the
        storage subrange.  ``mask`` is given in window-block coordinates and
        is shifted onto the storage subrange (see :meth:`_storage_mask`)."""
        if self.backing is None:
            return 0
        if mask is None:
            return self.backing.sync(full=full)
        return self.backing.sync(full=full, mask=self._storage_mask(mask))

    def mark_blocks(self, mask: np.ndarray) -> None:
        """OR a *window-block* mask into the storage tracker (masked
        span-write apply); translated like :meth:`sync`, so blocks entirely
        inside the memory part mark nothing."""
        if self.backing is not None:
            self.backing.tracker.mark_blocks(self._storage_mask(mask))

    @property
    def has_storage(self) -> bool:
        """True if any bytes spilled to storage (the ``auto`` factor may
        keep the whole allocation pinned in memory)."""
        return self.backing is not None

    def dirty_bytes(self, mask: np.ndarray | None = None) -> int:
        """Un-persisted bytes of the storage subrange (memory part never
        counts: it has no durability to fall behind on).  Feeds the
        nonblocking layer's ``Window.dirty_bytes`` observability and the
        backpressure charge estimate; ``mask`` is in window-block
        coordinates."""
        if self.backing is None:
            return 0
        if mask is None:
            return self.backing.dirty_bytes()
        return self.backing.dirty_bytes(mask=self._storage_mask(mask))

    @property
    def tracker(self):
        return self.backing.tracker if self.backing is not None else None

    def close(self, unlink: bool = False, discard: bool = False) -> None:
        if self.backing is not None:
            self.backing.close(unlink=unlink, discard=discard)
        self._mem = np.zeros(0, dtype=np.uint8)
