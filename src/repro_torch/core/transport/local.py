"""In-process transport: every rank's segment lives in this process.

This is the original single-controller deployment (and the default): one
Python process "is" every rank, segments are plain local objects, and the
one-sided semantics (put/get only touch the page cache, sync persists,
accumulates are atomic under the window's target lock) are preserved
exactly.  It exists so the higher layers can program against the
:class:`~repro_torch.core.transport.base.Transport` interface with **zero
behavior change** for existing code, while the multiprocess backend slots
in behind the same calls.  :class:`RankLocalTransport` is its one-rank
view for externally launched rank processes.
"""

from __future__ import annotations

import numpy as np

from ..combined import CombinedSegment
from ..hints import WindowHints
from ..storage import make_backing
from .base import (Transport, TransportError, apply_accumulate,
                   apply_compare_and_swap, apply_get_accumulate,
                   reduce_values)

__all__ = ["InprocTransport", "RankLocalTransport", "_MemorySegment",
           "_StorageSegment", "_make_segment"]


class _MemorySegment:
    """Traditional MPI memory window segment."""

    def __init__(self, size: int):
        self.size = size
        self.buf = np.zeros(size, dtype=np.uint8)

    def read(self, offset: int, nbytes: int) -> np.ndarray:
        if offset < 0 or offset + nbytes > self.size:
            raise IndexError(f"access [{offset},{offset + nbytes}) outside {self.size}B window")
        return self.buf[offset:offset + nbytes].copy()

    def write(self, offset: int, data) -> None:
        data = np.asarray(data, dtype=np.uint8).ravel()
        if offset < 0 or offset + data.nbytes > self.size:
            raise IndexError(f"access [{offset},{offset + data.nbytes}) outside {self.size}B window")
        self.buf[offset:offset + data.nbytes] = data

    def sync(self, full: bool = False, mask: np.ndarray | None = None) -> int:
        return 0  # nothing to persist

    def close(self, unlink: bool = False, discard: bool = False) -> None:
        self.buf = np.zeros(0, dtype=np.uint8)


class _StorageSegment:
    """Pure storage window segment (memory copy = page cache of backing)."""

    def __init__(self, size: int, hints: WindowHints, path: str, *,
                 mechanism: str, page_size: int, cache_bytes: int | None,
                 writeback_interval: float | None, compare_on_write: bool = False):
        self.size = size
        extra = ({"cache_bytes": cache_bytes, "writeback_interval": writeback_interval,
                  "compare_on_write": compare_on_write}
                 if mechanism == "cached" else {})
        self.backing = make_backing(
            path, size, mechanism=mechanism, offset=hints.offset,
            page_size=page_size, file_perm=hints.file_perm,
            striping_factor=hints.striping_factor,
            striping_unit=hints.striping_unit, **extra)

    def read(self, offset: int, nbytes: int) -> np.ndarray:
        return self.backing.read(offset, nbytes)

    def write(self, offset: int, data) -> None:
        self.backing.write(offset, data)

    def sync(self, full: bool = False, mask: np.ndarray | None = None) -> int:
        return self.backing.sync(full=full, mask=mask)

    def dirty_bytes(self, mask: np.ndarray | None = None) -> int:
        return self.backing.dirty_bytes(mask=mask)

    def mark_blocks(self, mask: np.ndarray) -> None:
        """OR a block mask into the dirty tracker (masked span-write
        apply: the mask may conservatively cover straddled blocks)."""
        self.backing.tracker.mark_blocks(mask)

    @property
    def tracker(self):
        return self.backing.tracker

    def close(self, unlink: bool = False, discard: bool = False) -> None:
        self.backing.close(unlink=unlink, discard=discard)


def _make_segment(size: int, hints: WindowHints, rank: int, nranks: int, *,
                  shared_file: bool, memory_budget: int | None,
                  mechanism: str, page_size: int, cache_bytes: int | None,
                  writeback_interval: float | None, compare_on_write: bool = False):
    """Build one rank's segment from the window spec.

    The path/offset policy here is transport-invariant: the multiprocess
    workers call this exact function, so the on-disk layout (and hence any
    checkpoint written through it) is identical across backends -- a run
    can crash under one transport and recover under the other.
    """
    if not hints.is_storage:
        return _MemorySegment(size)
    if shared_file:
        # Paper: "shared files are allowed if the same target is defined
        # among all the processes of the communicator"; each rank maps at
        # hint offset + rank * segment size (cf. Fig. 4's offset x).
        path = hints.filename
        hints = WindowHints(**{**hints.__dict__, "offset": hints.offset + rank * size})
    else:
        # independent file per process (the paper's benchmark default)
        path = hints.filename if nranks == 1 else f"{hints.filename}.{rank}"
    if hints.is_combined:
        return CombinedSegment(size, hints, path, memory_budget=memory_budget,
                               mechanism=mechanism, page_size=page_size,
                               cache_bytes=cache_bytes,
                               writeback_interval=writeback_interval,
                               compare_on_write=compare_on_write)
    return _StorageSegment(size, hints, path, mechanism=mechanism,
                           page_size=page_size, cache_bytes=cache_bytes,
                           writeback_interval=writeback_interval,
                           compare_on_write=compare_on_write)


class InprocTransport(Transport):
    """All ranks in one process; segments are direct local objects."""

    kind = "inproc"

    def allocate_segments(self, size: int, hints, spec: dict) -> list:
        return [_make_segment(size, hints, r, self.size, **spec)
                for r in range(self.size)]

    def allocate_segment(self, rank: int, size: int, hints, spec: dict, *,
                         name_rank: int, name_nranks: int):
        # every rank lives here: the hosting rank only matters for the mp
        # backend's process placement, the naming policy is shared
        return _make_segment(size, hints, name_rank, name_nranks, **spec)

    # Atomicity of the RMW ops comes from the window's target lock (the
    # caller holds it exclusively): every origin is a thread of this
    # process, so a process-local lock serializes them all.
    def accumulate(self, seg, offset, data, op):
        apply_accumulate(seg, offset, data, op)

    def get_accumulate(self, seg, offset, data, op):
        return apply_get_accumulate(seg, offset, data, op)

    def compare_and_swap(self, seg, offset, value, compare, dtype):
        return apply_compare_and_swap(seg, offset, value, compare, dtype)

    # -- collectives: single-process, ordering bookkeeping only ------------
    def barrier(self) -> None:
        pass

    def allreduce(self, value, op: str = "sum"):
        if self._check_contributions(value):
            return reduce_values(value, op)
        return value

    def bcast(self, value, root: int = 0):
        self._check_root(root)
        return value

    def split(self, color: int, ranks: list[int]) -> "InprocTransport":
        return InprocTransport(len(ranks))

    @property
    def is_local(self) -> bool:
        return True


class RankLocalTransport(InprocTransport):
    """One externally-launched rank's own slice of an n-rank window world.

    For deployments where a scheduler starts the rank processes: each
    process sets ``REPRO_RANK``/``REPRO_NRANKS`` and gets a communicator
    whose windows materialize *only its own partition* -- same file naming
    as every other transport (``<file>.<rank>``), so n independent
    processes produce the exact on-disk layout of one driver-origin run.
    Peer partitions are ``None`` placeholders: this transport carries no
    control channel, so cross-rank data ops raise :class:`TransportError`
    (use the mp transport when ranks must address each other) and
    collectives are rank-local no-ops like the inproc transport's.
    """

    kind = "ranklocal"

    #: window layer: replicate/allocate only what this rank can host
    single_rank_view = True

    def allocate_segments(self, size: int, hints, spec: dict) -> list:
        return [_make_segment(size, hints, r, self.size, **spec)
                if r == self.rank else None
                for r in range(self.size)]

    def allocate_segment(self, rank: int, size: int, hints, spec: dict, *,
                         name_rank: int, name_nranks: int):
        if rank != self.rank:
            raise TransportError(
                f"rank-local transport (rank {self.rank}) cannot host a "
                f"segment on rank {rank}")
        return _make_segment(size, hints, name_rank, name_nranks, **spec)

    @staticmethod
    def _own(seg, what: str):
        if seg is None:
            raise TransportError(
                f"rank-local transport: {what} targets a partition owned "
                "by another externally-launched rank (no control channel; "
                "run under the mp transport for cross-rank ops)")
        return seg

    def put(self, seg, offset: int, data) -> None:
        self._own(seg, "put").write(offset, data)

    def get(self, seg, offset: int, nbytes: int):
        return self._own(seg, "get").read(offset, nbytes)

    def write_spans_masked(self, seg, spans, mask):
        return super().write_spans_masked(self._own(seg, "write_spans"),
                                          spans, mask)

    def accumulate(self, seg, offset, data, op):
        apply_accumulate(self._own(seg, "accumulate"), offset, data, op)

    def get_accumulate(self, seg, offset, data, op):
        return apply_get_accumulate(self._own(seg, "get_accumulate"),
                                    offset, data, op)

    def compare_and_swap(self, seg, offset, value, compare, dtype):
        return apply_compare_and_swap(self._own(seg, "compare_and_swap"),
                                      offset, value, compare, dtype)

    def op_batch(self, seg, ops, defer: bool = False):
        return super().op_batch(self._own(seg, "op_batch"), ops, defer=defer)

    def op_complete(self, seg) -> int:
        return super().op_complete(self._own(seg, "op_complete"))

    def split(self, color: int, ranks: list[int]) -> "RankLocalTransport":
        return RankLocalTransport(len(ranks),
                                  ranks.index(self.rank)
                                  if self.rank in ranks else 0)
