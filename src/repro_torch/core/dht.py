"""Distributed Hash Table on MPI-style windows (paper §3.3 / §3.4).

This package's own copy of ``repro.core.dht``: placement (``_mix64``), CAS
chaining and the heap counter are the reference's, so the same inserts
give byte-identical tables and window files under either package.

Faithful port of the structure used in the paper (Gerstenberger et al.'s
foMPI DHT): every rank owns a *Local Volume* (LV) of hash slots plus an
*overflow heap* for collisions, all exposed through windows so that every
update is a one-sided operation -- ``get``/``put``/``compare_and_swap``/
``fetch_and_op`` -- against the owner's window.  Because the storage vs
memory decision is entirely in the window hints, the exact same data
structure runs in memory, on storage, or on a combined allocation
(out-of-core, §3.4) without touching this file.  The same is true of the
*transport*: under ``REPRO_TRANSPORT=mp`` the owners are real worker
processes and every CAS/accumulate executes atomically in the owner's
progress thread -- still without touching this file.  And the same again
for *resilience*: with ``replication=k`` the window layer mirrors each
local volume to k-1 replica ranks at every sync and transparently fails
``get``/``put``/CAS over to a live replica when the owner dies, so the
table keeps serving through rank death (``repro_torch.core.resilience``).

Entry layout (3 int64 words): [key, value, next]
    key   == EMPTY sentinel -> slot unused (CAS target for claiming)
    next  == -1             -> end of collision chain; otherwise heap index

Per-rank segment layout:
    [ lv_entries * 24 bytes | heap counter (8) | heap_entries * 24 bytes ]
"""

from __future__ import annotations

import numpy as np

from .comm import Communicator
from .window import Request, Window

__all__ = ["DistributedHashTable"]

_EMPTY = np.int64(-(2**62))  # sentinel: no real key may equal this
_WORD = 8
_ENTRY = 3 * _WORD  # key, value, next


def _mix64(x: int) -> int:
    """SplitMix64 finalizer -- cheap, well-distributed 64-bit hash."""
    z = (x + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return z ^ (z >> 31)


class DistributedHashTable:
    """One-sided DHT over a window; works for memory/storage/combined."""

    def __init__(self, comm: Communicator, lv_entries: int, *,
                 heap_factor: int = 4, info=None, memory_budget: int | None = None,
                 mechanism: str = "cached", writeback_interval: float | None = None,
                 resume: bool = False, replication: int = 1):
        """``resume=True`` maps the windows over their existing storage
        files *without* re-initializing the slots -- restart/recovery: the
        table is whatever the last ``sync`` persisted.  Only meaningful for
        storage windows whose files already exist.

        ``replication=k`` (storage tables only; shorthand for the
        ``storage_alloc_replication`` info hint) keeps ``k`` copies of
        every rank's local volume: a ``sync`` then means ``k`` durable
        copies, and a dead rank's partition keeps serving ``get``/``put``/
        CAS traffic from its replicas instead of raising
        ``TransportError`` -- see ``repro_torch.core.resilience``."""
        if lv_entries < 1:
            raise ValueError("lv_entries must be >= 1")
        if replication > 1:
            info = dict(info or {})
            info.setdefault("storage_alloc_replication", str(replication))
        self.comm = comm
        self.lv_entries = lv_entries
        self.heap_entries = heap_factor * lv_entries
        self.counter_off = lv_entries * _ENTRY
        self.heap_off = self.counter_off + _WORD
        seg_size = self.heap_off + self.heap_entries * _ENTRY
        self.segment_bytes = seg_size
        self.win = Window.allocate(comm, seg_size, info=info,
                                   memory_budget=memory_budget,
                                   mechanism=mechanism,
                                   writeback_interval=writeback_interval)
        if not resume:
            self._init_segments()
        self.insert_conflicts = 0

    def _init_segments(self) -> None:
        """Set every key word to EMPTY and heap counters to 0.

        Batched nonblocking puts: all ranks' LV/counter/heap initializations
        are issued as rput requests at once (per-rank FIFO keeps each
        segment's three writes ordered) and completed with one waitall --
        the initialization analogue of the paper's overlapped RMA.
        """
        lv = np.empty((self.lv_entries, 3), dtype=np.int64)
        lv[:, 0] = _EMPTY
        lv[:, 1] = 0
        lv[:, 2] = -1
        heap = np.empty((self.heap_entries, 3), dtype=np.int64)
        heap[:, 0] = _EMPTY
        heap[:, 1] = 0
        heap[:, 2] = -1
        reqs = []
        for r in range(self.comm.size):
            reqs.append(self.win.rput(lv.view(np.uint8).ravel(), r, 0))
            reqs.append(self.win.rput(np.zeros(1, np.int64).view(np.uint8),
                                      r, self.counter_off))
            reqs.append(self.win.rput(heap.view(np.uint8).ravel(), r,
                                      self.heap_off))
        Request.waitall(reqs)

    # -- addressing -----------------------------------------------------------
    def _owner_slot(self, key: int) -> tuple[int, int]:
        h = _mix64(int(key))
        return h % self.comm.size, (h >> 16) % self.lv_entries

    def _entry_off(self, idx: int) -> int:
        """Byte offset of entry ``idx``: LV if < lv_entries, else heap."""
        if idx < self.lv_entries:
            return idx * _ENTRY
        return self.heap_off + (idx - self.lv_entries) * _ENTRY

    def _read_entry(self, rank: int, idx: int) -> np.ndarray:
        return self.win.get(rank, self._entry_off(idx), 3, np.int64)

    # -- operations -----------------------------------------------------------
    def insert(self, key: int, value: int, op: str = "replace") -> bool:
        """One-sided upsert.  ``op``: 'replace' or 'sum' (accumulate).

        Returns True if a fresh slot/heap entry was consumed.
        Raises RuntimeError when the owner's heap is exhausted (the paper
        sizes the heap via ``heap_factor`` to make this improbable).
        """
        key = int(key)
        if key == int(_EMPTY):
            raise ValueError("key collides with the EMPTY sentinel")
        rank, slot = self._owner_slot(key)
        idx = slot
        for _ in range(self.lv_entries + self.heap_entries + 2):
            off = self._entry_off(idx)
            old = self.win.compare_and_swap(key, _EMPTY, rank, off, np.int64)
            if old == _EMPTY:
                # Claimed an empty slot: write value (+ next already -1).
                self.win.put(np.asarray([value], np.int64).view(np.uint8),
                             rank, off + _WORD)
                return True
            if old == key:
                if op == "sum":
                    self.win.get_accumulate(np.asarray([value], np.int64), rank,
                                            off + _WORD, "sum")
                else:
                    self.win.put(np.asarray([value], np.int64).view(np.uint8),
                                 rank, off + _WORD)
                return False
            # Collision: a different key owns this entry -> follow/extend chain.
            self.insert_conflicts += 1
            nxt = int(self.win.get(rank, off + 2 * _WORD, 1, np.int64)[0])
            if nxt >= 0:
                idx = nxt
                continue
            # Allocate a heap entry on the owner and link it in with CAS.
            heap_i = int(self.win.fetch_and_op(1, rank, self.counter_off, "sum"))
            if heap_i >= self.heap_entries:
                raise RuntimeError(f"DHT heap exhausted on rank {rank}")
            new_idx = self.lv_entries + heap_i
            new_off = self._entry_off(new_idx)
            self.win.put(np.asarray([key, value, -1], np.int64).view(np.uint8),
                         rank, new_off)
            old_nxt = self.win.compare_and_swap(new_idx, -1, rank,
                                                off + 2 * _WORD, np.int64)
            if old_nxt == -1:
                return True
            # Lost the race: someone else linked first; walk into their entry
            # (our heap entry is leaked -- same behaviour as the reference DHT).
            idx = int(old_nxt)
        raise RuntimeError("DHT chain walk did not terminate")

    def lookup(self, key: int) -> int | None:
        key = int(key)
        rank, slot = self._owner_slot(key)
        idx = slot
        for _ in range(self.lv_entries + self.heap_entries + 2):
            e = self._read_entry(rank, idx)
            if e[0] == _EMPTY:
                return None
            if e[0] == key:
                return int(e[1])
            if e[2] < 0:
                return None
            idx = int(e[2])
        raise RuntimeError("DHT chain walk did not terminate")

    # -- maintenance ----------------------------------------------------------
    def items(self) -> list[tuple[int, int]]:
        """All (key, value) pairs across every rank (test/verification aid)."""
        out: list[tuple[int, int]] = []
        for r in range(self.comm.size):
            lv = self.win.get(r, 0, self.lv_entries * 3, np.int64).reshape(-1, 3)
            heap = self.win.get(r, self.heap_off, self.heap_entries * 3,
                                np.int64).reshape(-1, 3)
            for e in (lv, heap):
                used = e[e[:, 0] != _EMPTY]
                out.extend((int(k), int(v)) for k, v, _ in used)
        return out

    def heap_used(self, rank: int) -> int:
        return int(self.win.get(rank, self.counter_off, 1, np.int64)[0])

    def sync(self, blocking: bool = True, *, on_complete=None):
        """Checkpoint: exclusive lock + selective sync (paper Listing 4).

        ``blocking=False`` queues the per-rank locked flushes on the
        window's write-back pool and returns a :class:`Request` whose
        ``wait()`` yields total bytes -- MapReduce overlaps this with the
        next map task.  ``on_complete(total_bytes)`` runs on the write-back
        thread after a successful flush (see :meth:`Window.flush_async`).
        """
        if not blocking:
            return self.win.flush_async(exclusive=True,
                                        on_complete=on_complete)
        total = 0
        for r in range(self.comm.size):
            self.win.lock(r, exclusive=True)
            try:
                total += self.win.sync(r)
            finally:
                self.win.unlock(r)
        return total

    def free(self) -> None:
        self.win.free()
