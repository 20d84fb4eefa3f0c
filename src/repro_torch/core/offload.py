"""Window bridge for out-of-core arrays and trees.

The counterpart of ``repro.core.offload``: training state (parameters,
optimizer moments), KV caches and data shards are laid out inside MPI-style
windows.  The window's combined allocation (``factor`` hint) decides how
much of each array is pinned in memory and how much lives behind the
user-level page cache on storage; ``sync()`` gives the selective,
dirty-block-only persistence that checkpoints build on.  Everything here
works on host numpy arrays; device tensors reach the windows through
``Window.sync_from_device`` and :mod:`repro_torch.convert`.

Two classes:

``WindowedArray``
    One logical ndarray mapped onto a rank's window segment at a byte
    offset.  Supports whole-array get/put, *blockwise* streaming (the
    out-of-core optimizer walks blocks: fetch -> update -> put back), and
    zero-copy views when the backing allows it.

``WindowedPyTree``
    A named tree of arrays packed into one window with an offset table.
    The layout (sorted names, page-aligned slots) is the reference's, so
    both packages write byte-identical window files for the same tree.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator, Mapping

import numpy as np

from .comm import Communicator
from .window import Request, Window

__all__ = ["auto_factor", "WindowedArray", "WindowedPyTree"]


def auto_factor(nbytes: int, memory_budget: int) -> float:
    """The paper's ``storage_alloc_factor='auto'`` policy as a number:
    fraction of the allocation that stays in memory."""
    if nbytes <= 0:
        return 1.0
    if nbytes <= memory_budget:
        return 1.0
    return memory_budget / nbytes


def _align(n: int, a: int) -> int:
    return -(-n // a) * a


@dataclasses.dataclass(frozen=True)
class _Slot:
    """Placement of one named array inside the window byte space."""

    name: str
    shape: tuple[int, ...]
    dtype: np.dtype
    offset: int  # bytes, within the rank's segment

    @property
    def nbytes(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64)) * self.dtype.itemsize


class WindowedArray:
    """A logical ndarray living inside a window segment."""

    def __init__(self, win: Window, rank: int, shape, dtype, *, offset: int = 0,
                 block_bytes: int = 1 << 22):
        self.win = win
        self.rank = rank
        self.shape = tuple(int(s) for s in shape)
        self.dtype = np.dtype(dtype)
        self.offset = offset
        self.nbytes = int(np.prod(self.shape, dtype=np.int64)) * self.dtype.itemsize
        self.block_bytes = _align(block_bytes, self.dtype.itemsize)

    # -- whole-array access --------------------------------------------------
    def get(self) -> np.ndarray:
        raw = self.win.get(self.rank, self.offset, self.nbytes, np.uint8)
        return raw.view(self.dtype).reshape(self.shape)

    def put(self, value) -> None:
        arr = np.ascontiguousarray(value, dtype=self.dtype)
        if int(np.prod(arr.shape, dtype=np.int64)) != int(
                np.prod(self.shape, dtype=np.int64)):
            raise ValueError(f"shape mismatch: window holds {self.shape}, got {arr.shape}")
        self.win.put(arr.view(np.uint8).ravel(), self.rank, self.offset)

    # -- blockwise streaming (out-of-core walk) ------------------------------
    @property
    def num_blocks(self) -> int:
        return max(1, -(-self.nbytes // self.block_bytes)) if self.nbytes else 0

    def _block_span(self, i: int) -> tuple[int, int]:
        lo = i * self.block_bytes
        hi = min(lo + self.block_bytes, self.nbytes)
        if lo >= self.nbytes:
            raise IndexError(f"block {i} out of {self.num_blocks}")
        return lo, hi

    def block_byte_span(self, i: int) -> tuple[int, int]:
        """Absolute [lo, hi) byte range of block ``i`` within the segment
        (used to build window-block flush masks for write-behind walks)."""
        lo, hi = self._block_span(i)
        return self.offset + lo, self.offset + hi

    def read_block(self, i: int) -> np.ndarray:
        lo, hi = self._block_span(i)
        raw = self.win.get(self.rank, self.offset + lo, hi - lo, np.uint8)
        return raw.view(self.dtype)

    def read_block_async(self, i: int) -> Request:
        """Nonblocking block fetch (rget): ``wait()`` returns the block.

        The out-of-core optimizer prefetches block ``i+1`` with this while
        the Adam math for block ``i`` runs on the caller's thread.  Ordered
        after pending writes to the same rank (per-rank FIFO).
        """
        lo, hi = self._block_span(i)
        req = self.win.rget(self.rank, self.offset + lo, hi - lo, np.uint8)
        return req.map(lambda raw: raw.view(self.dtype))

    def write_block(self, i: int, flat) -> None:
        lo, hi = self._block_span(i)
        arr = np.ascontiguousarray(flat, dtype=self.dtype)
        if arr.nbytes != hi - lo:
            raise ValueError(f"block {i}: expected {hi - lo} bytes, got {arr.nbytes}")
        self.win.put(arr.view(np.uint8).ravel(), self.rank, self.offset + lo)

    def write_block_async(self, i: int, flat) -> Request:
        """Nonblocking block write-behind (rput); data snapshotted eagerly."""
        lo, hi = self._block_span(i)
        arr = np.ascontiguousarray(flat, dtype=self.dtype)
        if arr.nbytes != hi - lo:
            raise ValueError(f"block {i}: expected {hi - lo} bytes, got {arr.nbytes}")
        return self.win.rput(arr.view(np.uint8).ravel(), self.rank,
                             self.offset + lo)

    def blocks(self) -> Iterator[tuple[int, np.ndarray]]:
        for i in range(self.num_blocks):
            yield i, self.read_block(i)

    def update_blocks(self, fn: Callable[[np.ndarray], np.ndarray]) -> None:
        """Streamed in-place transform: fetch block -> fn -> put back.

        This is the paper's out-of-core pattern (§3.4) applied to tensors:
        only ``block_bytes`` of the array ever needs to be resident.
        """
        for i in range(self.num_blocks):
            self.write_block(i, fn(self.read_block(i)))

    def sync(self) -> int:
        return self.win.sync(self.rank)


class WindowedPyTree:
    """A dict of named arrays packed into one window per rank.

    Layout is deterministic (sorted by name, page-aligned slots) so that a
    restarted process reconstructs identical offsets from shapes alone --
    that property is what makes window files directly restorable.
    """

    PAGE = 4096

    def __init__(self, win: Window, slots: Mapping[str, _Slot], rank: int = 0,
                 *, block_bytes: int = 1 << 22):
        self.win = win
        self.rank = rank
        self.slots = dict(slots)
        self.block_bytes = block_bytes

    # -- construction ---------------------------------------------------------
    @staticmethod
    def layout(specs: Mapping[str, tuple[tuple[int, ...], Any]]) -> tuple[dict[str, _Slot], int]:
        """Compute slot offsets for {name: (shape, dtype)}; returns total bytes."""
        slots: dict[str, _Slot] = {}
        off = 0
        for name in sorted(specs):
            shape, dtype = specs[name]
            dt = np.dtype(dtype)
            off = _align(off, WindowedPyTree.PAGE)
            slot = _Slot(name, tuple(int(s) for s in shape), dt, off)
            slots[name] = slot
            off += slot.nbytes
        return slots, _align(off, WindowedPyTree.PAGE)

    @classmethod
    def allocate(cls, comm: Communicator, specs: Mapping[str, tuple[tuple[int, ...], Any]],
                 info=None, *, rank: int = 0, memory_budget: int | None = None,
                 mechanism: str = "cached", shared_file: bool = False,
                 writeback_interval: float | None = None,
                 block_bytes: int = 1 << 22) -> "WindowedPyTree":
        slots, total = cls.layout(specs)
        win = Window.allocate(comm, total, info=info, memory_budget=memory_budget,
                              mechanism=mechanism, shared_file=shared_file,
                              writeback_interval=writeback_interval)
        return cls(win, slots, rank, block_bytes=block_bytes)

    @classmethod
    def from_tree(cls, comm: Communicator, tree: Mapping[str, np.ndarray], info=None,
                  **kw) -> "WindowedPyTree":
        specs = {k: (np.asarray(v).shape, np.asarray(v).dtype) for k, v in tree.items()}
        wt = cls.allocate(comm, specs, info, **kw)
        wt.put_tree(tree)
        return wt

    # -- access ---------------------------------------------------------------
    def array(self, name: str) -> WindowedArray:
        s = self.slots[name]
        return WindowedArray(self.win, self.rank, s.shape, s.dtype,
                             offset=s.offset, block_bytes=self.block_bytes)

    def __contains__(self, name: str) -> bool:
        return name in self.slots

    def names(self) -> list[str]:
        return sorted(self.slots)

    def get(self, name: str) -> np.ndarray:
        return self.array(name).get()

    def put(self, name: str, value) -> None:
        self.array(name).put(value)

    def get_tree(self) -> dict[str, np.ndarray]:
        return {k: self.get(k) for k in self.slots}

    def put_tree(self, tree: Mapping[str, Any]) -> None:
        for k, v in tree.items():
            self.put(k, np.asarray(v))

    def sync(self, *, mask: np.ndarray | None = None,
             spans: list | None = None) -> int:
        """MPI_Win_sync over the rank's segment: selective dirty-block flush.
        ``mask`` restricts it to ``host_dirty AND mask`` window blocks;
        ``spans`` first applies the given ``(offset, bytes)`` spans through
        the transport's masked span-write primitive (one round trip per
        rank on remote transports)."""
        return self.win.sync(self.rank, mask=mask, spans=spans)

    def sync_async(self, *, exclusive: bool = False, on_complete=None,
                   mask: np.ndarray | None = None,
                   spans: list | None = None) -> Request:
        """Queue the rank's selective flush on the window's write-back pool.

        ``wait()`` returns bytes flushed; see :meth:`Window.flush_async` for
        the ``exclusive`` / ``on_complete`` / ``mask`` / ``spans``
        semantics.  The checkpoint manager overlaps this with the next
        train step and narrows it with the snapshot-diff mask (its changed
        pages riding along as spans).
        """
        return self.win.flush_async(self.rank, exclusive=exclusive,
                                    on_complete=on_complete, mask=mask,
                                    spans=spans)

    def manifest(self) -> dict[str, Any]:
        """Serializable layout description (used by the checkpoint manager)."""
        return {
            "slots": {
                k: {"shape": list(s.shape), "dtype": s.dtype.str, "offset": s.offset}
                for k, s in self.slots.items()
            },
        }

    @staticmethod
    def slots_from_manifest(m: Mapping[str, Any]) -> dict[str, _Slot]:
        return {
            k: _Slot(k, tuple(v["shape"]), np.dtype(v["dtype"]), int(v["offset"]))
            for k, v in m["slots"].items()
        }

    def free(self) -> None:
        self.win.free()
