"""MPI-style windows over memory and storage.

The PyTorch package's copy of ``repro.core.window`` (the JAX package's
reference): the same single-controller re-implementation of the paper's
extended routines, with the device-sync half rewritten over torch tensors.

    MPI_Win_allocate          -> Window.allocate(comm, size, info=...)
    MPI_Win_allocate_shared   -> Window.allocate_shared(...)
    MPI_Win_create_dynamic    -> Window.create_dynamic(comm) + attach/detach
    MPI_Win_free              -> win.free()
    MPI_Win_sync              -> win.sync(rank)      (selective storage flush)
    MPI_Put/Get               -> win.put / win.get
    MPI_Accumulate / CAS      -> win.accumulate / win.compare_and_swap
    MPI_Win_lock/unlock       -> win.lock(rank, exclusive=...) / win.unlock

"Ranks" are logical positions of a :class:`~repro_torch.core.comm.Communicator`,
and *where a rank's segment physically lives is the communicator's
transport's decision* (``repro_torch.core.transport``): ``inproc`` keeps
every segment addressable in this process, ``mp`` maps each rank onto a
spawned worker process that owns its segments and page cache, and
``ranklocal`` holds one externally launched rank's own partition.
``Window`` never touches segment internals for data movement:
``put``/``get`` and the ``accumulate`` family route through
``comm.transport``.  What stays local to the *origin* is the nonblocking
machinery -- ``Request`` bookkeeping and the ``WritebackPool``.

Crucial paper nuance kept intact: put/get only touch the *memory copy*
(page cache) of a storage window -- persistence requires an explicit
``win.sync()``; data not yet synced is lost on failure.

Nonblocking I/O (request-based RMA + async flush pipeline)
----------------------------------------------------------

    MPI_Rput / MPI_Rget / MPI_Raccumulate
        -> win.rput / win.rget / win.raccumulate, each returning a
           :class:`Request` with ``test()`` / ``wait()`` /
           ``Request.waitall()`` semantics.
    MPI_Win_flush(rank) / MPI_Win_flush_all
        -> win.flush(rank) / win.flush_all(): block until every pending
           request targeting the rank(s) has completed at the target.
    asynchronous MPI_Win_sync
        -> win.flush_async(rank) or win.sync(rank, blocking=False): queue a
           selective dirty-page flush on the window's background
           :class:`~repro_torch.core.storage.WritebackPool` and return a
           Request whose ``wait()`` yields the bytes flushed.

``rput``/``raccumulate`` snapshot the origin buffer eagerly.  Requests aimed
at the same target rank complete in issue order (FIFO per rank).  On a
non-dynamic window they ride a per-target *aggregation buffer* dispatched as
ONE ``Transport.op_batch`` train at a flush/sync boundary, when a caller
waits its request, or when the buffer tops out (``AGG_MAX_OPS`` ops /
``AGG_MAX_BYTES`` payload); result-free trains are posted notified-access
style and confirmed by one ``Transport.op_complete`` read at the next
boundary.  Request completion is *not* durability: persistence still
requires ``sync``/``flush_async``.  ``free()`` drains every pending request
and queued flush before closing the segments.

Device-side selective sync (mask path)
--------------------------------------

``flush_async(rank, mask=...)`` / ``sync(rank, mask=...)`` take a boolean
*block mask* (``page_size`` blocks over the rank's [0, size) byte space) and
flush the **intersection** ``host_dirty AND mask``: dirty blocks outside the
mask stay dirty, clean blocks inside it cost nothing, combined windows shift
the mask onto their storage subrange, and a mask of the wrong length raises
``WindowError``.

``sync_from_device(rank, cur, snap)`` builds that mask from torch tensors
(on the card, or on the CPU): the ``diff_pack`` CUDA kernel reduces the
current/snapshot states to a per-page changed bitmap and a compacted buffer
of the changed pages on the device, and only those cross to the host (one
bitmap and one payload transfer per shard set).  The spans and the mask then
travel together through ``Transport.write_spans_masked`` to the rank's page
cache.  ``sync_shards_from_device(rank, [(cur, snap, target_disp), ...])``
extends this to sharded device state with one merged mask and one flush.
CPU tensors take the kernels' plain PyTorch versions; nothing else differs.
On a replicated window both route through the partition's acting holder
like ``put``.

Write-back backpressure (bounded in-flight bytes)
-------------------------------------------------

``Window.allocate(..., max_inflight_bytes=..., low_watermark=...)`` bounds
the bytes queued on the window's WritebackPool; a submission past the high
watermark blocks the caller until completions drain to the low watermark.
A thread submitting from inside its own lock epoch bypasses the stall
(deadlock avoidance); its bytes are still charged.

Replication, failover and rebuild (resilience)
----------------------------------------------

A pure storage window allocated with the ``storage_alloc_replication=k``
hint keeps ``k`` total copies of every rank's partition: the primary on the
rank itself plus ``k-1`` replica segments on the following ranks in a
rotating chain (:class:`~repro_torch.core.resilience.ReplicaPlacement`),
each backed by its own file (``<filename>.rep<j>.<rank>``) owned by the
*holder*'s process.

* Writes and atomics target the partition's **acting holder**, the first
  live rank in chain order (the primary while it lives); reads rotate over
  the live holders unless the rank has un-mirrored writes.
* **Mirroring rides the flush path**: every ``sync(rank)`` /
  ``flush_async(rank)`` forwards the spans written since the last mirror
  from the acting holder to every other live holder and syncs them there,
  so a completed epoch means *k durable copies*.  Mirror failures re-mark
  the spans (replay, never skip).
* A ``TransportError`` from any window operation (device syncs included)
  marks the holder dead on the communicator and replays the whole operation
  on the next live holder; ``comm.mark_dead`` / ``Transport.probe`` /
  ``FailureDetector`` do the same ahead of time.
* ``rebuild_rank`` (or ``comm.rebuild_rank``, which also respawns the
  worker) re-maps the rank's segments over its backing files and
  reconciles them page-diff-granularly from the acting holders.

See :mod:`repro_torch.core.resilience` for the failure-model table.

Epoch & lock discipline
-----------------------

The same rules as the reference: pair every ``lock`` with ``unlock`` on
every path (``with win.locked(rank):`` is the sanctioned shape); complete
epochs (``flush``/``sync``) before reading bytes written by nonblocking ops;
errors of posted trains surface at the next flush, so complete before
``free()``; put touches the page cache only, sync persists.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import threading
import time
from typing import Any

import numpy as np
import torch

from ..kernels.dirty_diff import changed_elem_spans
from ..kernels.ops import dirty_blocks, dirty_pack
from ..kernels.pack_diff import packed_run_layout
from .hints import Info, WindowHints
from .resilience.placement import ReplicaPlacement
from .storage import (DEFAULT_PAGE_SIZE, DirtyTracker, WritebackPool,
                      dirty_runs, mark_span)
from .transport.base import ACC_OPS, DEFERRABLE_OPS, TransportError
from .transport.local import _make_segment

__all__ = ["Window", "WindowError", "Request", "LOCK_SHARED",
           "LOCK_EXCLUSIVE", "alloc_mem"]

LOCK_SHARED = "shared"
LOCK_EXCLUSIVE = "exclusive"


class WindowError(RuntimeError):
    pass


class _RWLock:
    """Readers-writer lock: MPI_LOCK_SHARED vs MPI_LOCK_EXCLUSIVE."""

    def __init__(self):
        self._cond = threading.Condition()
        self._readers = 0
        self._writer = False

    def acquire(self, exclusive: bool) -> None:
        with self._cond:
            if exclusive:
                while self._writer or self._readers:
                    self._cond.wait()
                self._writer = True
            else:
                while self._writer:
                    self._cond.wait()
                self._readers += 1

    def release(self) -> None:
        with self._cond:
            if self._writer:
                self._writer = False
            elif self._readers:
                self._readers -= 1
            else:
                raise WindowError("unlock without matching lock")
            self._cond.notify_all()


class Request:
    """MPI_Request analogue for request-based RMA and asynchronous flushes.

    Wraps one or more :class:`~repro_torch.core.storage.WritebackPool` tickets.
    ``wait()`` returns the operation's value: the fetched array for
    ``rget``, bytes flushed for ``flush_async``, ``None`` for ``rput``.
    Exceptions raised by the background task re-raise at ``wait()``.
    """

    def __init__(self, tickets, combine=None, _obs=None):
        self._tickets = list(tickets) if isinstance(tickets, (list, tuple)) \
            else [tickets]
        self._combine = combine
        # Shared mutable cell: a wait() reached completion (ok or error).
        # Shared (not copied) by map(), so observing a derived request also
        # marks the original one the window registered.
        self._obs = [False] if _obs is None else _obs

    @property
    def _observed(self) -> bool:
        return self._obs[0]

    def _failed(self) -> bool:
        """True iff the (completed) operation raised on the pool thread."""
        return any(t.exception is not None for t in self._tickets)

    def test(self) -> bool:
        """MPI_Test: True iff the operation has completed (never blocks)."""
        return all(t.done() for t in self._tickets)

    def wait(self, timeout: float | None = None):
        """MPI_Wait: block for completion, re-raise task errors, return the
        operation's value.  ``timeout`` (seconds) raises TimeoutError."""
        deadline = None if timeout is None else time.monotonic() + timeout
        for t in self._tickets:
            left = None if deadline is None else \
                max(0.0, deadline - time.monotonic())
            if not t.wait(left):
                raise TimeoutError("request did not complete within timeout")
        self._obs[0] = True
        for t in self._tickets:
            if t.exception is not None:
                raise t.exception
        results = [t.result for t in self._tickets]
        if self._combine is not None:
            return self._combine(results)
        return results[0] if len(results) == 1 else results

    def map(self, fn) -> "Request":
        """Derived request: same completion event, result passed through
        ``fn`` (used by the offload layer to reinterpret fetched bytes)."""
        inner = self._combine
        if inner is None:
            combine = lambda rs: fn(rs[0] if len(rs) == 1 else rs)  # noqa: E731
        else:
            combine = lambda rs: fn(inner(rs))  # noqa: E731
        return Request(self._tickets, combine=combine, _obs=self._obs)

    @staticmethod
    def waitall(requests, timeout: float | None = None) -> list:
        """MPI_Waitall: complete every request; returns their values."""
        deadline = None if timeout is None else time.monotonic() + timeout
        out = []
        for r in requests:
            left = None if deadline is None else \
                max(0.0, deadline - time.monotonic())
            out.append(r.wait(left if timeout is not None else None))
        return out

    @staticmethod
    def testall(requests) -> bool:
        """MPI_Testall: True iff every request has completed."""
        return all(r.test() for r in requests)


class _AggTicket:
    """Completion ticket of ONE op riding a per-target aggregation batch.

    Duck-types the WritebackPool ticket surface :class:`Request` consumes
    (``done``/``wait``/``result``/``exception``).  ``wait()`` first kicks
    the target rank's buffered batch out for dispatch (idempotent) so a
    caller blocking on its own request cannot deadlock on an op still
    sitting in the aggregation buffer; the batch's pool task completes all
    its tickets when the train is applied (reply form) or posted
    (notified form -- MPI local completion; target-side completion is the
    window's next ``flush``/``sync`` boundary).
    """

    __slots__ = ("_win", "_rank", "_ev", "result", "exception")

    def __init__(self, win: "Window", rank: int):
        self._win = win
        self._rank = rank
        self._ev = threading.Event()
        self.result = None
        self.exception: BaseException | None = None

    def done(self) -> bool:
        return self._ev.is_set()

    def wait(self, timeout: float | None = None) -> bool:
        if not self._ev.is_set():
            self._win._agg_dispatch(self._rank)
        return self._ev.wait(timeout)

    def complete(self, result) -> None:
        self.result = result
        self._ev.set()

    def fail(self, exc: BaseException) -> None:
        self.exception = exc
        self._ev.set()


class Window:
    """An MPI-style window: per-rank segments + one-sided access."""

    def __init__(self, comm, segments, hints: WindowHints, *, disp_unit: int = 1,
                 flavor: str, dynamic: bool = False, async_workers: int = 2,
                 max_inflight_bytes: int | None = None,
                 low_watermark: int | None = None,
                 target_flush_latency: float | None = None,
                 placement: ReplicaPlacement | None = None,
                 replica_segs: dict | None = None,
                 mirror_page_size: int = DEFAULT_PAGE_SIZE,
                 alloc_size: int | None = None,
                 alloc_spec: dict | None = None):
        self.comm = comm
        self.segments = segments  # list, one per rank (dynamic: list of lists)
        self.hints = hints
        self.disp_unit = disp_unit
        self.flavor = flavor
        self.dynamic = dynamic
        self.freed = False
        # resilience: chain placement + replica segments, keyed (rank, copy)
        # for copy in 1..k-1, plus per-rank mirror-pending span trackers
        self.placement = placement
        self.replica_segs = replica_segs or {}
        self.replication = placement.k if placement is not None else 1
        self._mirror_pending = (
            {r: DirtyTracker(segments[r].size, mirror_page_size)
             for r in range(comm.size)}
            if placement is not None else {})
        # remembered allocation geometry (rebuild re-creates segments with it)
        self._alloc_size = alloc_size
        self._alloc_spec = dict(alloc_spec) if alloc_spec is not None else {}
        self._locks = [_RWLock() for _ in range(comm.size)]
        self._epoch_depth = [0] * comm.size
        # thread ident -> number of lock epochs it holds on this window
        # (shared or exclusive); see _caller_in_lock_epoch
        self._epoch_threads: dict[int, int] = {}
        self._epoch_lock = threading.Lock()
        # nonblocking layer: lazily-started per-window write-back pool plus
        # per-target-rank pending request lists (epoch completion bookkeeping)
        self._async_workers = async_workers
        self._max_inflight_bytes = max_inflight_bytes
        self._low_watermark = low_watermark
        self._target_flush_latency = target_flush_latency
        self._pool: WritebackPool | None = None
        self._pool_lock = threading.Lock()
        self._req_lock = threading.Lock()
        self._pending_reqs: dict[int, list[Request]] = {}
        # request aggregation (hot-path small ops): per-target-rank buffers
        # of (wire_op, ticket) coalesced until a dispatch boundary, plus the
        # notified-access ledger of already-POSTED batches awaiting their
        # target-side completion read at the next flush/sync boundary
        # ((holder, op train) pairs, per rank)
        self._agg_lock = threading.Lock()
        self._agg_ops: dict[int, list] = {}
        self._agg_nbytes: dict[int, int] = {}
        self._agg_posted: dict[int, list] = {}
        # per-rank dispatch serialization: pool submission order (= key-FIFO
        # execution order) must match buffer drain order, and pool.submit may
        # block on backpressure so _agg_lock cannot be held across it
        self._agg_dispatch_locks = [threading.Lock() for _ in range(comm.size)]
        # replica read balancing: rotate reads across live holders (only
        # when no mirror-pending writes -- read-your-writes stickiness);
        # _mirror_inflight pins reads to the acting holder while a mirror
        # pass is copying already-cleared spans out to the replicas
        self._read_rr = itertools.count()
        self._mirror_inflight: dict[int, int] = {}
        # MPI attribute caching (paper: metadata on the window object)
        self.attrs: dict[str, Any] = {
            "alloc_type": hints.alloc_type,
            "filename": hints.filename,
            "flavor": flavor,
            "disp_unit": disp_unit,
        }
        comm._register(self)

    # -- allocation (collective) -------------------------------------------
    @classmethod
    def allocate(cls, comm, size: int, *, disp_unit: int = 1,
                 info: Info | None = None, shared_file: bool = False,
                 memory_budget: int | None = None, mechanism: str = "cached",
                 page_size: int = DEFAULT_PAGE_SIZE, cache_bytes: int | None = None,
                 writeback_interval: float | None = None,
                 compare_on_write: bool = False,
                 async_workers: int = 2,
                 max_inflight_bytes: int | None = None,
                 low_watermark: int | None = None,
                 target_flush_latency: float | None = None) -> "Window":
        """Collective MPI_Win_allocate over all ranks of ``comm``.

        ``size`` is the per-rank window size in bytes (like MPI, each rank
        passes its own size; we use a uniform size for the common case).
        Segment placement is the communicator's *transport's* decision:
        ``inproc`` builds local segments, ``mp`` has each rank's worker
        process build (and own) its segment and hands back shared-memory
        views / remote proxies, ``ranklocal`` builds only this rank's.  ``async_workers`` sizes the background
        write-back pool used by the request-based (rput/rget/flush_async)
        layer; the pool's threads only start on first nonblocking use.
        ``max_inflight_bytes`` / ``low_watermark`` bound the pool's queued
        write-back bytes (backpressure; see the module docstring) --
        default unbounded; ``target_flush_latency`` instead sizes the high
        watermark adaptively from the observed flush throughput.
        """
        hints = WindowHints.from_info(info)
        comm.barrier()  # collective
        spec = dict(
            shared_file=shared_file, memory_budget=memory_budget,
            mechanism=mechanism, page_size=page_size, cache_bytes=cache_bytes,
            writeback_interval=writeback_interval,
            compare_on_write=compare_on_write)
        segments = comm.transport.allocate_segments(size, hints, spec)
        flavor = ("combined" if hints.is_combined else
                  "storage" if hints.is_storage else "memory")
        # replication (advisory, like every hint): pure storage windows
        # only -- replicas must be durable to add fault tolerance -- and
        # clamped to the communicator size (each copy on a distinct rank)
        k = (hints.replication
             if hints.is_storage and not hints.is_combined else 1)
        k = max(1, min(k, comm.size))
        if getattr(comm.transport, "single_rank_view", False):
            # rank-local transports materialize only this rank's
            # partition: there is no peer to host a replica on
            k = 1
        placement = ReplicaPlacement(comm.size, k) if k > 1 else None
        replica_segs: dict = {}
        if placement is not None:
            for j in range(1, k):
                h_j = cls._replica_hints_for(hints, j)
                for r in range(comm.size):
                    replica_segs[(r, j)] = comm.transport.allocate_segment(
                        placement.holders(r)[j], size, h_j, spec,
                        name_rank=r, name_nranks=comm.size)
        return cls(comm, segments, hints, disp_unit=disp_unit, flavor=flavor,
                   async_workers=async_workers,
                   max_inflight_bytes=max_inflight_bytes,
                   low_watermark=low_watermark,
                   target_flush_latency=target_flush_latency,
                   placement=placement, replica_segs=replica_segs,
                   mirror_page_size=page_size, alloc_size=size,
                   alloc_spec=spec)

    @classmethod
    def allocate_shared(cls, comm, size: int, **kw) -> "Window":
        """MPI_Win_allocate_shared: consecutive per-rank segments.

        Within a shared node the segments are directly load/store accessible
        by all ranks; we additionally expose ``shared_view()`` spanning all
        ranks' memory (memory windows only), matching "the mapped addresses
        are consecutive, unless specified".
        """
        win = cls.allocate(comm, size, **kw)
        win.attrs["shared"] = True
        return win

    @classmethod
    def create_dynamic(cls, comm) -> "Window":
        """MPI_Win_create_dynamic: start with no attached segments.

        Dynamic windows attach arbitrary local segment objects, so they
        require a transport whose ranks live in this process.
        """
        if not comm.transport.is_local:
            raise WindowError(
                "dynamic windows require the in-process transport "
                "(attached segments are local objects)")
        hints = WindowHints()
        win = cls.__new__(cls)
        Window.__init__(win, comm, [[] for _ in range(comm.size)], hints,
                        flavor="dynamic", dynamic=True)
        return win

    # -- dynamic windows ----------------------------------------------------
    def attach(self, rank: int, segment) -> int:
        """MPI_Win_attach: returns a segment handle for addressing."""
        if not self.dynamic:
            raise WindowError("attach requires a dynamic window")
        self.segments[rank].append(segment)
        return len(self.segments[rank]) - 1

    def detach(self, rank: int, handle: int) -> None:
        if not self.dynamic:
            raise WindowError("detach requires a dynamic window")
        if self.segments[rank][handle] is None:
            raise WindowError("segment already detached")
        self.segments[rank][handle] = None

    def _seg(self, rank: int, handle: int | None = None):
        if self.freed:
            raise WindowError("window has been freed")
        if rank < 0 or rank >= self.comm.size:
            raise WindowError(f"rank {rank} outside communicator of size {self.comm.size}")
        if self.dynamic:
            if handle is None:
                raise WindowError("dynamic windows require a segment handle")
            seg = self.segments[rank][handle]
            if seg is None:
                raise WindowError("segment was detached")
            return seg
        return self.segments[rank]

    # -- replication / failover routing --------------------------------------
    @property
    def replicated(self) -> bool:
        return self.placement is not None

    @staticmethod
    def _replica_hints_for(hints: WindowHints, j: int) -> WindowHints:
        """Hints for replica generation ``j``: same window, distinct file
        namespace (the transport's naming policy then appends the *home*
        rank, so copy ``j`` of rank ``r`` is ``<file>.rep<j>.<r>``)."""
        return dataclasses.replace(hints, filename=f"{hints.filename}.rep{j}")

    def _replica_hints(self, j: int) -> WindowHints:
        return self._replica_hints_for(self.hints, j)

    def _live_holders(self, rank: int) -> list[int]:
        """``rank``'s live holders in chain order; raises when none is left."""
        dead = self.comm.dead_ranks
        live = [h for h in self.placement.holders(rank) if h not in dead]
        if not live:
            raise WindowError(
                f"no live holder for rank {rank}'s partition "
                f"(k={self.replication}, dead={sorted(dead)})")
        return live

    def _holder_of(self, rank: int) -> int:
        """Acting holder of ``rank``'s partition: the first live rank in
        chain order (primary first).  Every origin resolves this from the
        communicator's shared dead set, so they agree without coordination."""
        if self.placement is None:
            return rank
        return self._live_holders(rank)[0]

    def _seg_at(self, rank: int, holder: int):
        """The segment through which ``holder`` serves ``rank``'s bytes."""
        if holder == rank:
            return self.segments[rank]
        return self.replica_segs[(rank, self.placement.copy_index(rank, holder))]

    def _route(self, rank: int, handle: int | None = None):
        """(segment, acting holder) for ``rank``'s partition; validates
        freed/rank/handle exactly like :meth:`_seg`."""
        seg = self._seg(rank, handle)
        if self.placement is None:
            return seg, rank
        holder = self._holder_of(rank)
        return self._seg_at(rank, holder), holder

    def _failover(self, rank: int, fn, *, handle: int | None = None):
        """Run ``fn(segment)`` against the acting holder; a TransportError
        marks the holder dead and retries on the next live replica
        (primary -> chain order).  Non-replicated windows propagate the
        error unchanged.  The loop terminates: every retry removes a
        holder, and ``_route`` raises WindowError once none is left."""
        while True:
            seg, holder = self._route(rank, handle)
            try:
                return fn(seg)
            except TransportError:
                if self.placement is None:
                    raise
                self.comm.mark_dead(holder)

    def _read_holder_of(self, rank: int) -> int:
        """Holder to serve a READ of ``rank``'s partition.

        Writes always land on the acting holder (:meth:`_holder_of`), but
        every synced copy holds the same bytes -- so reads rotate across
        the live holders to spread traffic, *except* while the rank has
        mirror-pending spans (or a mirror pass in flight): those exist only
        on the acting holder until the mirror lands, so reads stick there
        (read-your-writes).  The rotation seeds from the origin's rank and
        advances per read.
        """
        if self.placement is None:
            return rank
        live = self._live_holders(rank)
        if (len(live) == 1 or self._mirror_pending[rank].dirty_count
                or self._mirror_inflight.get(rank, 0)):
            return live[0]
        return live[(self.comm.rank + next(self._read_rr)) % len(live)]

    def _failover_read(self, rank: int, fn, *, handle: int | None = None):
        """:meth:`_failover` for reads: routes via :meth:`_read_holder_of`
        (load-spread across replicas) instead of the acting holder."""
        while True:
            seg = self._seg(rank, handle)  # freed/rank/handle validation
            if self.placement is None:  # incl. dynamic: handle addressing
                return fn(seg)
            holder = self._read_holder_of(rank)
            try:
                return fn(self._seg_at(rank, holder))
            except TransportError:
                self.comm.mark_dead(holder)

    def _note_write(self, rank: int, offset: int, nbytes: int) -> None:
        """Record a written span for mirroring at the next sync/flush."""
        if self.placement is not None and nbytes > 0:
            self._mirror_pending[rank].mark(offset, nbytes)

    # -- one-sided operations ------------------------------------------------
    def put(self, data: np.ndarray, target_rank: int, target_disp: int = 0,
            *, handle: int | None = None) -> None:
        """MPI_Put: write ``data`` into the target rank's window.

        Only the memory copy (page cache) is updated -- storage consistency
        requires a subsequent ``sync`` (paper §2.1.1).  On a replicated
        window the write targets the partition's acting holder and its span
        is recorded for mirroring at the next sync.
        """
        buf = np.ascontiguousarray(data).view(np.uint8).ravel()
        off = target_disp * self.disp_unit
        self._failover(target_rank,
                       lambda seg: self.comm.transport.put(seg, off, buf),
                       handle=handle)
        self._note_write(target_rank, off, buf.nbytes)

    def get(self, target_rank: int, target_disp: int, count: int,
            dtype=np.uint8, *, handle: int | None = None) -> np.ndarray:
        """MPI_Get: read ``count`` items of ``dtype`` from the target (on a
        replicated window, from any live holder of the synced partition;
        see :meth:`_read_holder_of`)."""
        dt = np.dtype(dtype)
        off = target_disp * self.disp_unit
        raw = self._failover_read(
            target_rank,
            lambda seg: self.comm.transport.get(seg, off, count * dt.itemsize),
            handle=handle)
        return raw.view(dt)[:count].copy()

    # kept as an alias: the op table now lives with the transport layer so
    # the multiprocess worker applies the same reductions target-side
    _ACC_OPS = ACC_OPS

    def accumulate(self, data: np.ndarray, target_rank: int, target_disp: int = 0,
                   op: str = "sum", *, handle: int | None = None) -> None:
        """MPI_Accumulate with a reduction op.

        The read-modify-write executes through the transport *at the
        target*, held under the
        target rank's exclusive lock so it also serializes against this
        process's epochs and request traffic.
        """
        if op not in ACC_OPS:
            raise WindowError(f"unknown accumulate op {op!r}")
        data = np.ascontiguousarray(data)
        if op == "no_op":
            return
        off = target_disp * self.disp_unit
        lock = self._locks[target_rank]
        lock.acquire(exclusive=True)
        try:
            self._failover(
                target_rank,
                lambda seg: self.comm.transport.accumulate(seg, off, data, op),
                handle=handle)
            self._note_write(target_rank, off, data.nbytes)
        finally:
            lock.release()

    def get_accumulate(self, data: np.ndarray, target_rank: int,
                       target_disp: int = 0, op: str = "sum",
                       *, handle: int | None = None) -> np.ndarray:
        """MPI_Get_accumulate: fetch old value, then accumulate."""
        if op not in ACC_OPS:
            raise WindowError(f"unknown accumulate op {op!r}")
        data = np.ascontiguousarray(data)
        off = target_disp * self.disp_unit
        lock = self._locks[target_rank]
        lock.acquire(exclusive=True)
        try:
            old = self._failover(
                target_rank,
                lambda seg: self.comm.transport.get_accumulate(
                    seg, off, data, op),
                handle=handle)
            if op != "no_op":
                self._note_write(target_rank, off, data.nbytes)
            return old
        finally:
            lock.release()

    def fetch_and_op(self, value, target_rank: int, target_disp: int = 0,
                     op: str = "sum", dtype=np.int64, *, handle: int | None = None):
        """MPI_Fetch_and_op: single-element get_accumulate."""
        arr = np.asarray([value], dtype=dtype)
        return self.get_accumulate(arr, target_rank, target_disp, op,
                                   handle=handle)[0]

    def compare_and_swap(self, value, compare, target_rank: int,
                         target_disp: int = 0, dtype=np.int64,
                         *, handle: int | None = None):
        """MPI_Compare_and_swap: atomic CAS; returns the old value."""
        dt = np.dtype(dtype)
        off = target_disp * self.disp_unit
        lock = self._locks[target_rank]
        lock.acquire(exclusive=True)
        try:
            old = self._failover(
                target_rank,
                lambda seg: self.comm.transport.compare_and_swap(
                    seg, off, value, compare, dt),
                handle=handle)
            self._note_write(target_rank, off, dt.itemsize)
            return old
        finally:
            lock.release()

    # -- nonblocking one-sided operations --------------------------------------
    def _get_pool(self) -> WritebackPool:
        if self._pool is None:
            with self._pool_lock:
                if self._pool is None:
                    self._pool = WritebackPool(
                        self._async_workers,
                        max_inflight_bytes=self._max_inflight_bytes,
                        low_watermark=self._low_watermark,
                        target_latency=self._target_flush_latency)
        return self._pool

    def pool_stats(self) -> dict | None:
        """Write-back pool counters (None until first nonblocking use).

        Alongside the pool's own counters, the snapshot reports both sides
        of the compression ledger when they exist: ``"wire"`` (the
        transport's logical-vs-wire byte counters -- encoding backends
        only) and ``"device_sync"`` (device->host transfer accounting from
        the fused diff+pack path).  Backpressure *charges* remain logical
        bytes: the charge is taken before the flush runs, when the encoded
        size is not yet known, and logical bytes are the safe upper bound.
        """
        if self._pool is None:
            return None
        st = self._pool.stats()
        # always a well-formed (possibly all-zero) snapshot -- see
        # Transport.wire_stats_snapshot
        st["wire"] = self.comm.transport.wire_stats_snapshot()
        dev = getattr(self, "_dev_sync_stats", None)
        if dev is not None:
            st["device_sync"] = dict(dev)
        return st

    def device_sync_stats(self) -> dict:
        """Device->host transfer accounting for selective device sync.

        ``syncs`` counts :meth:`sync_shards_from_device` calls;
        ``payload_transfers`` counts device->host *data* fetches (the fused
        diff+pack path does exactly ONE per shard set, however fragmented
        the dirty set); ``bitmap_transfers`` the tiny per-set bitmap
        fetches; ``span_transfers`` per-span slice fetches on the host
        fallback path; ``payload_bytes``/``logical_bytes`` the packed bytes
        fetched vs the changed bytes shipped.
        """
        st = getattr(self, "_dev_sync_stats", None)
        if st is None:
            st = self._dev_sync_stats = {
                "syncs": 0, "payload_transfers": 0, "bitmap_transfers": 0,
                "span_transfers": 0, "payload_bytes": 0, "logical_bytes": 0}
        return st

    #: pending-list length that triggers a prune pass in _register --
    #: amortizes the scan (pruning on EVERY submit made registering a train
    #: of N small ops O(N^2) Event checks, which dominated the aggregated
    #: hot path's per-op cost)
    _PRUNE_THRESHOLD = 64

    def _register(self, req: Request, ranks) -> Request:
        with self._req_lock:
            for r in ranks:
                pend = self._pending_reqs.setdefault(r, [])
                # prune completed requests -- but keep ones that failed
                # without anyone waiting, so flush()/free() still surface
                # fire-and-forget errors instead of silently dropping them
                if len(pend) >= self._PRUNE_THRESHOLD:
                    pend[:] = [p for p in pend
                               if not p.test()
                               or (p._failed() and not p._observed)]
                pend.append(req)
        return req

    def _caller_in_lock_epoch(self) -> bool:
        """True if the calling thread holds any lock epoch on this window
        (shared OR exclusive).

        Such a caller must never stall in a backpressure submit: queued
        tasks it would wait on may be blocked on its exclusive lock, or --
        for a shared epoch -- behind an exclusive-acquiring task (a
        raccumulate, a locked flush) that its own reader hold is blocking;
        the caller cannot unlock while stuck inside submit(), so stalling
        would deadlock.  Its submissions bypass the watermark stall instead
        (and may transiently exceed the high mark; lock epochs are expected
        to be short, per the paper's Listing 4 checkpoint pattern).
        """
        return threading.get_ident() in self._epoch_threads

    def _submit(self, fn, rank: int, nbytes: int = 0) -> Request:
        pool = self._get_pool()
        return self._register(
            Request(pool.submit(fn, key=rank, nbytes=nbytes,
                                force=self._caller_in_lock_epoch())),
            [rank])

    # -- request aggregation (hot-path small ops) ---------------------------
    #: dispatch a target's buffered ops once either bound is hit (a flush/
    #: sync boundary or a waiting ticket dispatches earlier regardless)
    AGG_MAX_OPS = 128
    AGG_MAX_BYTES = 1 << 20

    @staticmethod
    def _op_write_span(op) -> tuple[int, int]:
        """(offset, nbytes) a batch sub-op writes (0 for reads)."""
        kind = op[0]
        if kind == "put":
            data = op[2]
            return op[1], (data.nbytes if hasattr(data, "nbytes")
                           else len(data))
        if kind in ("acc", "gacc"):
            return op[1], np.ascontiguousarray(op[2]).nbytes
        if kind == "cas":
            return op[1], np.dtype(op[4]).itemsize
        return op[1], 0  # get

    def _agg_submit(self, rank: int, op: tuple, nbytes: int = 0) -> Request:
        """Buffer one wire op for ``rank`` and return its Request.

        The op rides the rank's next batch train; the pool is created
        eagerly so ``free()`` drains buffered-but-never-dispatched ops.
        """
        ticket = _AggTicket(self, rank)
        pool = self._get_pool()
        # a bounded pool's high watermark also caps the train: one batch is
        # ONE charged submission, so letting it grow past the watermark
        # would defeat the backpressure bound the user configured
        cap = self.AGG_MAX_BYTES
        if pool.max_inflight_bytes is not None:
            cap = min(cap, pool.max_inflight_bytes)
        with self._agg_lock:
            overflow = (self._agg_ops.get(rank)
                        and self._agg_nbytes.get(rank, 0) + nbytes > cap)
        if overflow:
            self._agg_dispatch(rank)
        with self._agg_lock:
            buf = self._agg_ops.setdefault(rank, [])
            buf.append((op, ticket))
            self._agg_nbytes[rank] = self._agg_nbytes.get(rank, 0) + nbytes
            full = (len(buf) >= self.AGG_MAX_OPS
                    or self._agg_nbytes[rank] >= cap)
        req = self._register(Request(ticket), [rank])
        if full:
            self._agg_dispatch(rank)
        return req

    def _agg_dispatch(self, rank: int) -> None:
        """Drain ``rank``'s aggregation buffer into ONE batched pool task.

        Idempotent (an empty buffer is a no-op).  The task applies the
        whole train through ``transport.op_batch`` under a single
        target-lock epoch: result-free trains are *posted* (notified
        access -- no reply; target-side completion read at the next
        flush/sync boundary), any train with a read replies inline.
        """
        with self._agg_dispatch_locks[rank]:
            with self._agg_lock:
                entries = self._agg_ops.pop(rank, None)
                total = self._agg_nbytes.pop(rank, 0)
            if not entries:
                return
            ops = [op for op, _ in entries]
            tickets = [t for _, t in entries]
            deferrable = all(op[0] in DEFERRABLE_OPS for op in ops)
            exclusive = any(op[0] in ("acc", "gacc", "cas") for op in ops)

            def task():
                lock = self._locks[rank]
                lock.acquire(exclusive=exclusive)
                try:
                    while True:
                        seg, holder = self._route(rank)
                        try:
                            res = self.comm.transport.op_batch(
                                seg, ops, defer=deferrable)
                            break
                        except TransportError:
                            if self.placement is None:
                                raise
                            self.comm.mark_dead(holder)
                except BaseException as e:
                    for t in tickets:
                        t.fail(e)
                    return
                finally:
                    lock.release()
                try:
                    if res is None:
                        # posted: MPI local completion -- tickets complete
                        # now, target-side completion (and error surfacing)
                        # at the next flush/sync boundary's notify read
                        for op in ops:
                            self._note_write(rank, *self._op_write_span(op))
                        with self._agg_lock:
                            self._agg_posted.setdefault(rank, []).append(
                                (holder, ops))
                        for t in tickets:
                            t.complete(None)
                    else:
                        # per-op results; a failed sub-op ships its
                        # exception in its slot and fails only its ticket
                        for op, t, r in zip(ops, tickets, res):
                            if isinstance(r, BaseException):
                                t.fail(r)
                                continue
                            self._note_write(rank, *self._op_write_span(op))
                            t.complete(r)
                except BaseException as e:
                    for t in tickets:
                        if not t.done():
                            t.fail(e)

            self._get_pool().submit(task, key=rank, nbytes=total,
                                    force=self._caller_in_lock_epoch())

    def _agg_complete(self, rank: int) -> int:
        """Notified-access completion: one ``op_complete`` read per holder
        confirms every batch posted to it since the last boundary.  A dead
        holder's unconfirmed trains are replayed (reply form) on the next
        live replica -- safe because the replacement never saw the posted
        originals (replay-never-skip).  Returns confirmed+replayed op count;
        deferred application errors surface here, MPI-flush-style.
        """
        with self._agg_lock:
            posted = self._agg_posted.pop(rank, None)
        if not posted:
            return 0
        # consecutive same-holder trains share one completion read
        groups: list[list] = []
        for holder, ops in posted:
            if groups and groups[-1][0] == holder:
                groups[-1][1].extend(ops)
            else:
                groups.append([holder, list(ops)])
        done = 0
        replay: list = []
        for holder, ops in groups:
            try:
                self.comm.transport.op_complete(self._seg_at(rank, holder))
                done += len(ops)
            except TransportError:
                if self.placement is None:
                    raise
                self.comm.mark_dead(holder)
                replay.extend(ops)
        if replay:
            res = self._failover(
                rank, lambda seg: self.comm.transport.op_batch(seg, replay))
            for op in replay:
                self._note_write(rank, *self._op_write_span(op))
            done += len(replay)
            for r in res or ():
                if isinstance(r, BaseException):
                    raise r  # deferred op error: surface at the boundary
        return done

    def rput(self, data: np.ndarray, target_rank: int, target_disp: int = 0,
             *, handle: int | None = None) -> Request:
        """MPI_Rput: nonblocking put; completion = target memory copy updated.

        The origin buffer is snapshotted eagerly, so the caller may reuse it
        immediately.  Storage persistence still requires sync/flush_async.

        Non-dynamic windows ride the per-target aggregation buffer: the put
        coalesces with neighboring small ops into one batched train (posted
        with notified access when the train is result-free).
        """
        buf = np.ascontiguousarray(data).view(np.uint8).ravel().copy()
        self._seg(target_rank, handle)  # eager rank/handle validation
        off = target_disp * self.disp_unit
        if not self.dynamic:
            return self._agg_submit(target_rank, ("put", off, buf),
                                    buf.nbytes)

        def task():
            lock = self._locks[target_rank]
            lock.acquire(exclusive=False)
            try:
                self.comm.transport.put(self._seg(target_rank, handle), off,
                                        buf)
            finally:
                lock.release()

        return self._submit(task, target_rank, nbytes=buf.nbytes)

    def rget(self, target_rank: int, target_disp: int, count: int,
             dtype=np.uint8, *, handle: int | None = None) -> Request:
        """MPI_Rget: nonblocking get; ``wait()`` returns the fetched array.

        On a non-dynamic window the get joins the target's batched train
        (its presence makes the train reply inline rather than post)."""
        self._seg(target_rank, handle)
        if not self.dynamic:
            dt = np.dtype(dtype)
            off = target_disp * self.disp_unit
            req = self._agg_submit(target_rank,
                                   ("get", off, count * dt.itemsize))
            return req.map(
                lambda raw: np.asarray(raw, dtype=np.uint8)
                .view(dt)[:count].copy())

        def task():
            lock = self._locks[target_rank]
            lock.acquire(exclusive=False)
            try:
                return self.get(target_rank, target_disp, count, dtype,
                                handle=handle)
            finally:
                lock.release()

        return self._submit(task, target_rank)

    def raccumulate(self, data: np.ndarray, target_rank: int,
                    target_disp: int = 0, op: str = "sum",
                    *, handle: int | None = None) -> Request:
        """MPI_Raccumulate: nonblocking accumulate (atomic at the target).

        Non-dynamic windows batch it with neighboring ops; an accumulate in
        a train makes the whole train apply under the target's exclusive
        lock (one epoch for N ops), and an all-put/acc train still posts
        notified."""
        if op not in self._ACC_OPS:
            raise WindowError(f"unknown accumulate op {op!r}")
        buf = np.ascontiguousarray(data).copy()
        self._seg(target_rank, handle)
        if not self.dynamic:
            if op == "no_op":
                ticket = _AggTicket(self, target_rank)
                ticket.complete(None)
                return self._register(Request(ticket), [target_rank])
            off = target_disp * self.disp_unit
            return self._agg_submit(target_rank, ("acc", off, buf, op),
                                    buf.nbytes)

        def task():
            self.accumulate(buf, target_rank, target_disp, op, handle=handle)

        return self._submit(task, target_rank, nbytes=buf.nbytes)

    def flush_async(self, rank: int | None = None, *, full: bool = False,
                    mask: np.ndarray | None = None,
                    spans: list | None = None,
                    exclusive: bool = False, on_complete=None) -> Request:
        """Asynchronous MPI_Win_sync: queue a selective dirty-page flush.

        Ordered after every pending request to the same rank(s), so an
        ``rput -> flush_async`` pipeline persists the rput's bytes.  The
        returned Request's ``wait()`` yields total bytes flushed.

        ``mask`` (boolean block mask, ``page_size`` blocks of the rank's
        byte space -- typically a ``dirty_diff`` device bitmap) restricts
        the flush to the intersection ``host_dirty AND mask``: clean pages
        are skipped without host compares, and dirty pages outside the mask
        stay dirty for a later sync (narrowing, never skipping).  Requires a
        specific ``rank`` on a non-dynamic window and must cover the rank's
        block count exactly.

        ``spans`` (``(offset, bytes)`` pairs; requires ``mask``) is the
        masked span-write path: the flush task first applies the spans to
        the target's page cache through the transport's
        ``write_spans_masked`` primitive -- one control-channel round trip
        per rank on remote transports -- and then the masked flush runs
        owner-side.  This is how ``sync_from_device`` and the checkpoint
        manager's snapshot-diff staging ship only changed pages.  Like an
        ``rput``, the spans reach the page cache only when the queued task
        executes (FIFO-ordered after pending requests to the rank): a
        blocking ``put`` issued while the request is in flight follows the
        same rule as mixing ``put`` with rputs -- interpose a
        ``flush(rank)``, or the older span payload may overwrite it.

        ``exclusive`` wraps each rank's flush in its exclusive lock (paper
        Listing 4's consistent checkpoint).  ``on_complete(total_bytes)``
        runs on the write-back thread once every rank has flushed -- only on
        success -- and its errors surface at ``wait()``.

        With backpressure configured the submission charges the rank's
        (masked) dirty-byte estimate plus the span payload and may block
        past the high watermark.
        """
        if self.freed:
            raise WindowError("window has been freed")
        mask = self._validate_mask(rank, mask)
        spans = self._validate_spans(spans, mask)
        ranks = list(range(self.comm.size)) if rank is None else [rank]
        for r in ranks:
            if r < 0 or r >= self.comm.size:
                raise WindowError(
                    f"rank {r} outside communicator of size {self.comm.size}")
        state = {"remaining": len(ranks), "total": 0}
        state_lock = threading.Lock()
        pool = self._get_pool()
        for r in ranks:
            # aggregation boundary: buffered trains go out now; pool
            # key-FIFO orders each rank's batch task before its flush task
            self._agg_dispatch(r)

        def make_task(r: int):
            def task():
                if exclusive:
                    self._locks[r].acquire(exclusive=True)
                try:
                    # notified-access boundary: confirm posted trains
                    # before measuring the sync
                    self._agg_complete(r)
                    # time only the I/O (lock waits would deflate the
                    # adaptive-watermark throughput estimate); remote
                    # segments report the owner-measured I/O time, which
                    # also excludes control-channel queueing
                    n = 0
                    k = pool.begin_flush_sample()
                    t0 = time.monotonic()
                    try:
                        n = self._sync_rank_segs(r, full, mask,
                                                 mirror=False, spans=spans)
                    finally:
                        dt = time.monotonic() - t0
                        pool.end_flush_sample(
                            n, self._rank_sync_io(r, dt), k)
                    if self.placement is not None:
                        # replica mirroring after the sample closes: its
                        # seconds would otherwise be charged against
                        # primary-only bytes.  Still inside the task (and
                        # the exclusive epoch, if any): request completion
                        # = k durable copies, and on_complete runs only
                        # after the mirror.
                        self._mirror_rank(r)
                finally:
                    if exclusive:
                        self._locks[r].release()
                with state_lock:
                    state["total"] += n
                    state["remaining"] -= 1
                    last = state["remaining"] == 0
                if last and on_complete is not None:
                    on_complete(state["total"])
                return n
            return task

        force = self._caller_in_lock_epoch()
        # the task times its own I/O via begin/end_flush_sample (excluding
        # lock waits), so the ticket itself is not worker-sampled
        span_bytes = sum(d.nbytes for _, d in spans) if spans else 0
        tickets = [pool.submit(make_task(r), key=r,
                               nbytes=(self._flush_charge(r, full, mask)
                                       + span_bytes
                                       if pool.bounded else 0),
                               force=force)
                   for r in ranks]
        return self._register(Request(tickets, combine=sum), ranks)

    def _rank_segs_for_io(self, rank: int) -> list:
        """Segments a sync of ``rank`` touches (the acting holder's, on a
        replicated window with the primary dead)."""
        if self.dynamic:
            return self.segments[rank]
        return [self._route(rank)[0]]

    def _rank_sync_io(self, rank: int, measured: float) -> float:
        """I/O seconds of the rank's just-completed sync: the owner-side
        measurement when every segment reports one (mp transport), else the
        caller's wall measurement (local segments have no channel wait)."""
        total = 0.0
        for seg in self._rank_segs_for_io(rank):
            io = getattr(seg, "last_sync_io", None)
            if io is None:
                return measured
            total += io
        return total

    def _flush_charge(self, rank: int, full: bool,
                      mask: np.ndarray | None) -> int:
        """Backpressure byte charge for one rank's queued flush: the (masked)
        dirty bytes at submit time.  An estimate -- writes landing between
        submit and execution flush too but are charged to *their* tickets.
        Only bytes a flush can actually write count: memory segments (and
        the pinned memory part of combined windows) charge nothing.  Only
        computed for a bounded pool, and remote segments answer from their
        origin-side ``dirty_bytes_estimate`` -- an exact cross-process
        ``dirty_bytes`` query would serialize behind an in-flight sync on
        the same rank's channel."""
        segs = self._rank_segs_for_io(rank)
        total = 0
        for seg in segs:
            if seg is None or not hasattr(seg, "dirty_bytes"):
                continue
            if full:
                total += (seg.sto_bytes if hasattr(seg, "sto_bytes")
                          else getattr(seg, "size", 0))
            elif hasattr(seg, "dirty_bytes_estimate"):
                total += seg.dirty_bytes_estimate(mask=mask)
            else:
                total += (seg.dirty_bytes() if mask is None
                          else seg.dirty_bytes(mask=mask))
        return total

    def dirty_bytes(self, rank: int | None = None) -> int:
        """Upper bound on un-persisted (dirty page-cache) bytes."""
        ranks = range(self.comm.size) if rank is None else [rank]
        total = 0
        for r in ranks:
            for seg in self._rank_segs_for_io(r):
                if seg is not None and hasattr(seg, "dirty_bytes"):
                    total += seg.dirty_bytes()
        return total

    # -- load/store access ----------------------------------------------------
    def baseptr(self, rank: int):
        """Local load/store pointer (memory windows and mmap storage windows
        return a zero-copy numpy view; cached storage and combined windows
        return the segment itself, which supports read()/write()).  Stores
        through it bypass the replication mirror's bookkeeping."""
        seg, _ = self._route(rank)
        if hasattr(seg, "buf"):  # plain memory segment
            return seg.buf
        if hasattr(seg, "backing") and hasattr(seg.backing, "view"):
            view = seg.backing.view(0, seg.size)
            return view
        return seg

    def shared_view(self) -> np.ndarray:
        """Consecutive view across all ranks (shared memory windows)."""
        if not all(hasattr(s, "buf") for s in self.segments):
            raise WindowError("shared_view requires memory segments")
        return np.concatenate([s.buf for s in self.segments])

    # -- epochs / synchronization ----------------------------------------------
    def lock(self, rank: int, exclusive: bool = False) -> None:
        """MPI_Win_lock (passive target epoch start)."""
        self._locks[rank].acquire(exclusive=exclusive)
        self._epoch_depth[rank] += 1
        ident = threading.get_ident()
        with self._epoch_lock:
            self._epoch_threads[ident] = self._epoch_threads.get(ident, 0) + 1

    @contextlib.contextmanager
    def locked(self, rank: int, exclusive: bool = False):
        """Scoped passive-target epoch: ``with win.locked(rank): ...``.

        The lint-sanctioned lock/unlock pairing (rmalint RMA001) -- the
        epoch closes on every exit path, exceptions included.  Yields the
        window so one-liners read naturally::

            with win.locked(target) as w:
                w.put(data, target, 0)
        """
        self.lock(rank, exclusive=exclusive)
        try:
            yield self
        finally:
            self.unlock(rank)

    def unlock(self, rank: int) -> None:
        """MPI_Win_unlock: completes all RMA ops at the target (ops here are
        synchronous, so completion is immediate; storage is NOT yet synced)."""
        self._epoch_depth[rank] -= 1
        ident = threading.get_ident()
        with self._epoch_lock:
            depth = self._epoch_threads.get(ident, 0) - 1
            if depth <= 0:
                self._epoch_threads.pop(ident, None)
            else:
                self._epoch_threads[ident] = depth
        self._locks[rank].release()

    def flush(self, rank: int) -> None:
        """MPI_Win_flush: complete every pending request-based RMA operation
        and queued flush targeting ``rank`` (epoch-style completion)."""
        if self.freed:
            raise WindowError("window has been freed")
        if rank < 0 or rank >= self.comm.size:
            raise WindowError(f"rank {rank} outside communicator of size {self.comm.size}")
        self._agg_dispatch(rank)  # flush is an aggregation boundary
        with self._req_lock:
            reqs = list(self._pending_reqs.get(rank, ()))
            self._pending_reqs[rank] = []
        first: BaseException | None = None
        for r in reqs:
            seen = r._observed
            try:
                r.wait()
            except BaseException as e:
                # complete *every* request before raising; errors already
                # observed via wait() don't re-raise
                if not seen and first is None:
                    first = e
        try:
            # notified-access boundary: ONE completion read confirms
            # every batch posted since the last flush/sync;
            # deferred application errors surface here (MPI flush rule)
            self._agg_complete(rank)
        except BaseException as e:
            if first is None:
                first = e
        if first is not None:
            raise first

    def flush_all(self) -> None:
        """MPI_Win_flush_all: complete pending requests at every rank."""
        for rank in range(self.comm.size):
            self.flush(rank)

    def sync(self, rank: int | None = None, full: bool = False,
             *, blocking: bool = True, mask: np.ndarray | None = None,
             spans: list | None = None):
        """MPI_Win_sync: flush dirty pages of the rank's storage segment(s).

        Returns bytes flushed (0 for memory windows / already-clean storage:
        'this routine may return immediately if the pages are already
        synchronized' -- the selective synchronization of the paper).

        ``mask`` restricts the flush to ``host_dirty AND mask`` blocks (see
        :meth:`flush_async` for the intersection rules and the exact-length
        requirement); ``spans`` additionally applies the given
        ``(offset, bytes)`` spans through the transport's masked span-write
        primitive before the flush (one round trip per rank on remote
        transports -- see :meth:`flush_async`).

        ``blocking=False`` queues the flush on the background write-back
        pool and returns a :class:`Request` whose ``wait()`` yields the
        bytes flushed (equivalent to ``flush_async``).
        """
        if not blocking:
            return self.flush_async(rank, full=full, mask=mask, spans=spans)
        if self.freed:
            raise WindowError("window has been freed")
        mask = self._validate_mask(rank, mask)
        spans = self._validate_spans(spans, mask)
        ranks = range(self.comm.size) if rank is None else [rank]
        total = 0
        for r in ranks:
            # sync is an aggregation + notified-access boundary: buffered
            # trains dispatch, already-posted ones are confirmed before the
            # storage flush
            self._agg_dispatch(r)
            self._agg_complete(r)
            total += self._sync_rank_segs(r, full, mask, spans=spans)
        return total

    def _mask_blocks(self, rank: int) -> int | None:
        """Expected mask length for ``rank``: its window-block count, or
        None when the segment has no page geometry to validate against
        (memory windows, where a masked sync is a no-op anyway)."""
        seg = self.segments[rank]
        tracker = getattr(seg, "tracker", None)
        ps = (tracker.page_size if tracker is not None
              else getattr(seg, "page_size", None))
        if ps is None:
            return None
        return -(-seg.size // ps)

    def _validate_mask(self, rank: int | None, mask, *, pad: bool = False):
        """Shared mask preconditions for sync/flush_async; returns the
        normalized boolean mask (masks are per-segment block coordinates).

        The mask must cover the rank's block count *exactly*: a short mask
        would silently leave a dirty tail unselected (the tail blocks fall
        outside every intersection), a long one is a geometry bug at the
        call site -- both raise ``WindowError``.  Multi-dimensional masks
        are accepted when their raveled length matches.  ``pad=True`` (the
        internal device-diff path only) keeps the tolerant normalization:
        short masks are False-padded and trailing extra blocks -- a device
        bitmap padded past the last page -- are ignored.
        """
        if mask is None:
            return None
        if rank is None:
            raise WindowError("mask requires a specific rank (masks are "
                              "per-segment block coordinates)")
        if self.dynamic:
            raise WindowError("mask is not supported on dynamic windows")
        if rank < 0 or rank >= self.comm.size:
            raise WindowError(
                f"rank {rank} outside communicator of size {self.comm.size}")
        m = np.asarray(mask, dtype=bool).ravel()
        expected = self._mask_blocks(rank)
        if expected is None or len(m) == expected:
            return m
        if not pad:
            raise WindowError(
                f"mask covers {len(m)} blocks but rank {rank}'s window has "
                f"{expected} (a short mask would silently skip a dirty "
                f"tail; pass exactly one flag per page_size block)")
        out = np.zeros(expected, dtype=bool)
        n = min(len(m), expected)
        out[:n] = m[:n]
        return out

    def _validate_spans(self, spans, mask):
        """Normalize masked span-write payloads to (int offset, uint8
        array) pairs; spans always travel with their mask (one primitive)."""
        if spans is None:
            return None
        if mask is None:
            raise WindowError(
                "spans require a mask (the masked span-write primitive "
                "ships the changed spans and the block mask together)")
        out = []
        for offset, data in spans:
            data = np.ascontiguousarray(
                np.asarray(data, dtype=np.uint8).ravel())
            if data.nbytes:
                out.append((int(offset), data))
        return out or None

    def _sync_rank_segs(self, rank: int, full: bool, mask,
                        mirror: bool = True, spans: list | None = None) -> int:
        """Sync every segment of one rank.  The mask kw is only forwarded
        when set: dynamically attached segments may be third-party objects
        whose sync() predates the mask parameter (mask is already rejected
        for dynamic windows).

        ``spans`` switches to the masked span-write primitive: the spans
        and the mask go through ``Transport.write_spans_masked`` against
        the partition's acting holder (one round trip per rank on remote
        transports), routed with the same failover as ``put`` -- a
        ``TransportError`` marks the holder dead and replays the whole span
        set, with its mask, on the next holder (never a partial epoch).

        Replicated windows sync the partition's *acting* holder and then
        piggyback the mirror (:meth:`_mirror_rank`), so the completed epoch
        means ``k`` durable copies.  Returns the acting holder's bytes.
        ``mirror=False`` skips the piggyback: the flush_async task mirrors
        outside its throughput sample.
        """
        if spans:
            total = self._failover(
                rank,
                lambda seg: self.comm.transport.write_spans_masked(
                    seg, spans, mask))
            for offset, data in spans:
                self._note_write(rank, offset, data.nbytes)
        elif self.dynamic or self.placement is None:
            segs = (self.segments[rank] if self.dynamic
                    else [self.segments[rank]])
            total = 0
            for seg in segs:
                if seg is not None and hasattr(seg, "sync"):
                    total += (seg.sync(full=full) if mask is None
                              else seg.sync(full=full, mask=mask))
        else:
            total = self._failover(
                rank, lambda seg: (seg.sync(full=full) if mask is None
                                   else seg.sync(full=full, mask=mask)))
        if mirror and self.placement is not None:
            self._mirror_rank(rank)
        return total

    #: bytes of mirror spans read off the acting holder in one train
    MIRROR_CHUNK = 4 << 20

    def _mirror_trains(self, take: np.ndarray, page_size: int,
                       size: int) -> list[list[tuple[int, int]]]:
        """The dirty runs of ``take`` as ``(offset, nbytes)`` pieces, cut at
        :attr:`MIRROR_CHUNK` and grouped into trains of at most that many
        bytes: one read and one posted write a train, however fragmented
        the dirty set (a page-spread change is one run a page)."""
        trains: list[list[tuple[int, int]]] = []
        train: list[tuple[int, int]] = []
        nbytes = 0
        for b0, b1 in dirty_runs(take):
            lo, hi = b0 * page_size, min(b1 * page_size, size)
            while lo < hi:
                n = min(hi - lo, self.MIRROR_CHUNK)
                if train and nbytes + n > self.MIRROR_CHUNK:
                    trains.append(train)
                    train, nbytes = [], 0
                train.append((lo, n))
                nbytes += n
                lo += n
        if train:
            trains.append(train)
        return trains

    def _mirror_rank(self, rank: int) -> int:
        """Forward the spans written since the last mirror from ``rank``'s
        acting holder to every other live holder, then sync them there.

        Piggybacked on the flush path (the caller just synced the acting
        holder).  The source is the acting holder's *memory copy*, which is
        at least as new as its disk.  The spans travel in trains
        (:meth:`_mirror_trains`): one reply-form ``op_batch`` of gets off
        the acting holder and one posted ``op_batch`` of puts to each
        replica a train, where the JAX package sends one get and one post
        a run -- the same bytes in far fewer round trips.  Failures re-mark
        the taken spans so the next sync replays them (never skips); a
        holder dying mid-mirror is marked dead and skipped.  Returns bytes
        made durable on the replicas.
        """
        tracker = self._mirror_pending[rank]
        take = tracker.snapshot_and_clear()
        if not take.any():
            return 0
        dead = self.comm.dead_ranks
        acting = self._holder_of(rank)
        src = self._seg_at(rank, acting)
        live = {h: self._seg_at(rank, h)
                for h in self.placement.holders(rank)
                if h != acting and h not in dead}
        if not live:
            tracker.restore(take)  # degraded: keep pending for the rebuild
            return 0
        partial = False
        mirrored = 0
        with self._agg_lock:
            self._mirror_inflight[rank] = \
                self._mirror_inflight.get(rank, 0) + 1
        try:
            for train in self._mirror_trains(take, tracker.page_size,
                                             tracker.size):
                got = self.comm.transport.op_batch(
                    src, [("get", lo, n) for lo, n in train])
                for r in got:
                    if isinstance(r, BaseException):
                        raise r
                puts = [("put", lo, data)
                        for (lo, _), data in zip(train, got)]
                for h in list(live):
                    try:
                        # notified post: the op_complete below is the
                        # one completion read for the whole mirror
                        self.comm.transport.op_batch(live[h], puts,
                                                     defer=True)
                    except TransportError:
                        self.comm.mark_dead(h)
                        live.pop(h)
                        partial = True
            for h in list(live):
                try:
                    self.comm.transport.op_complete(live[h])
                    mirrored += live[h].sync()
                except TransportError:
                    self.comm.mark_dead(h)
                    live.pop(h)
                    partial = True
        except BaseException:
            # reading the acting holder failed (or a replica sync raised a
            # non-transport error): this epoch is not k-durable -- re-mark
            # and surface so the flush's caller sees it
            tracker.restore(take)
            raise
        finally:
            with self._agg_lock:
                self._mirror_inflight[rank] -= 1
        if partial or not live:
            tracker.restore(take)
        return mirrored

    # -- device-side selective sync -----------------------------------------
    def _device_page_geometry(self, rank: int,
                              itemsize: int) -> tuple[int, int, int]:
        """(page_size, block_elems, window_blocks) for the rank's segment
        and an element of ``itemsize`` bytes."""
        seg = self._seg(rank)
        tracker = getattr(seg, "tracker", None)
        ps = (tracker.page_size if tracker is not None
              else getattr(seg, "page_size", None))
        if ps is None:
            raise WindowError(
                "device-mask sync requires a storage-backed segment "
                "(memory windows have no pages to flush)")
        if ps % itemsize:
            raise WindowError(
                f"page size {ps} is not a multiple of itemsize {itemsize}")
        return ps, ps // itemsize, -(-seg.size // ps)

    @staticmethod
    def _check_shard_pair(cur, snap) -> None:
        if not (isinstance(cur, torch.Tensor)
                and isinstance(snap, torch.Tensor)):
            raise WindowError("device sync takes torch tensors for cur/snap")
        if cur.shape != snap.shape:
            raise WindowError("cur/snap shape mismatch")
        if cur.dtype != snap.dtype:
            raise WindowError("cur/snap dtype mismatch")
        if cur.device != snap.device:
            raise WindowError("cur/snap device mismatch")

    def _device_flags(self, rank: int, cur, snap) -> np.ndarray:
        """Per-page-span changed flags from the ``dirty_diff`` kernel (its
        plain version for CPU tensors); only the bitmap leaves the device."""
        self._check_shard_pair(cur, snap)
        _, block_elems, _ = self._device_page_geometry(rank,
                                                       cur.element_size())
        flags = dirty_blocks(cur, snap, block_elems=block_elems)
        return flags.cpu().numpy().astype(bool)

    def _flags_to_window_mask(self, rank: int, flags: np.ndarray,
                              itemsize: int, nelems: int,
                              target_disp: int) -> np.ndarray:
        """Element-block flags (relative to target_disp) -> window-block mask.

        A non-page-aligned ``target_disp`` makes element blocks straddle two
        window pages; both are selected (conservative, never skips).
        """
        ps, block_elems, nwin = self._device_page_geometry(rank, itemsize)
        byte_off = target_disp * self.disp_unit
        mask = np.zeros(nwin, dtype=bool)
        for b0, b1 in dirty_runs(flags):
            mark_span(mask, byte_off + b0 * block_elems * itemsize,
                      byte_off + min(b1 * block_elems, nelems) * itemsize, ps)
        return mask

    def device_dirty_mask(self, rank: int, cur, snap, *,
                          target_disp: int = 0) -> np.ndarray:
        """Window-block mask of pages where ``cur`` differs from ``snap``.

        Runs the ``dirty_diff`` kernel (one flag per ``page_size`` span of
        elements) on the tensors' device; only the bitmap crosses to the
        host.  ``target_disp`` positions element 0 at that displacement in
        the rank's segment.  The mask feeds ``flush_async(mask=...)`` or
        ``DirtyTracker.mark_blocks``.
        """
        flags = self._device_flags(rank, cur, snap)
        return self._flags_to_window_mask(rank, flags, cur.element_size(),
                                          cur.numel(), target_disp)

    def sync_from_device(self, rank: int, cur, snap, *, target_disp: int = 0,
                         blocking: bool = False, impl: str | None = None):
        """Selective device-state sync: diff on the device, ship + flush
        only changed pages.

        ``cur``/``snap`` are same-shape, same-dtype torch tensors on one
        device, covering the window region that starts at ``target_disp``:
        ``snap`` is the state the window already holds (last synced),
        ``cur`` the new state.  The fused ``diff_pack`` kernel reduces them
        to a per-page bitmap *and* a compacted buffer of the changed blocks
        on the device; only the bitmap plus that packed buffer leave it (one
        contiguous payload transfer -- see :meth:`device_sync_stats`), and
        the rebuilt spans travel *with* the mask through the transport's
        masked span-write primitive to the rank's page cache.  Device->host
        traffic and storage writes scale with the *changed* bytes, not the
        window size.

        Returns the flush's :class:`Request` (``wait()`` -> bytes flushed),
        or the bytes directly with ``blocking=True``.  With
        ``blocking=False`` the spans reach the page cache only when the
        queued request executes (rput semantics: FIFO with other requests
        to the rank; mixing in a blocking ``put`` needs ``flush(rank)``).
        """
        return self.sync_shards_from_device(
            rank, [(cur, snap, target_disp)], blocking=blocking, impl=impl)

    def sync_shards_from_device(self, rank: int, shards, *,
                                blocking: bool = False,
                                impl: str | None = None):
        """Sharded :meth:`sync_from_device`: one merged mask, one flush.

        ``shards`` is an iterable of ``(cur, snap, target_disp)`` regions
        of the rank's window (sharded device state: per-parameter slots,
        per-device partitions).  Each shard's device bitmap is translated
        by its displacement and OR-merged into a single window-block mask;
        all shards' changed spans are gathered and shipped together with
        that mask in one masked span-write -- still one round trip per
        target rank, however many shards contributed.

        ``impl`` picks the route, never the implementation: ``None`` (the
        default) is the packed route -- each shard's changed blocks are
        compacted on the device by ``diff_pack``, every shard's kernels are
        launched before anything is fetched, and the whole shard set
        crosses to the host in ONE bitmap transfer plus ONE payload
        transfer, however fragmented the dirty set is.  ``'ref'`` is the
        per-span route: ``dirty_diff`` flags, then one device->host slice
        per changed span.  Which implementation runs follows the tensors'
        device alone: the CUDA kernels for CUDA tensors, their plain
        PyTorch versions for CPU tensors.  Both routes derive their spans
        from the same ``changed_elem_spans`` geometry, so the bytes shipped
        are identical; see :meth:`device_sync_stats` for the transfer
        accounting.

        Shard regions must not overlap: the merged flush would apply them
        in list order, silently making the outcome order-dependent, so
        overlapping ``(target_disp, nelems)`` regions raise
        :class:`WindowError` up front.

        Returns the flush's :class:`Request` (``wait()`` -> bytes flushed),
        or the bytes directly with ``blocking=True``.
        """
        shards = list(shards)
        if not shards:
            raise WindowError(
                "sync_shards_from_device requires at least one shard")
        if impl not in (None, "ref"):
            raise WindowError(
                f"unknown impl {impl!r}: None (packed route) or 'ref' "
                "(per-span route)")
        self._check_shard_overlap(shards)
        stats = self.device_sync_stats()
        stats["syncs"] += 1
        if impl is None:
            spans, mask = self._packed_device_spans(rank, shards, stats)
        else:
            spans = []
            mask = None
            for cur, snap, target_disp in shards:
                flags = self._device_flags(rank, cur, snap)
                itemsize = cur.element_size()
                _, block_elems, _ = self._device_page_geometry(rank, itemsize)
                byte_off = target_disp * self.disp_unit
                nelems = cur.numel()
                m = self._flags_to_window_mask(rank, flags, itemsize, nelems,
                                               target_disp)
                mask = m if mask is None else mask | m
                # per-span route: one device->host slice per changed span
                # (same changed_elem_spans geometry as the packed route).
                # The copy is real on the CPU too, so a queued flush never
                # sees a later in-place change of ``cur``.
                cur_flat = cur.reshape(-1)
                for lo_e, hi_e in changed_elem_spans(flags, block_elems,
                                                     nelems):
                    chunk = cur_flat[lo_e:hi_e].to("cpu", copy=True)
                    spans.append((byte_off + lo_e * itemsize,
                                  chunk.view(torch.uint8).numpy()))
                    stats["span_transfers"] += 1
                    stats["logical_bytes"] += (hi_e - lo_e) * itemsize
        # normalize here with the tolerant device-diff rule (a device bitmap
        # may pad past the last page); sync/flush_async then see an
        # exact-length mask and keep their strict validation for everyone
        # else -- user-supplied masks never get the padding leniency
        mask = self._validate_mask(rank, mask, pad=True)
        if blocking:
            return self.sync(rank, mask=mask, spans=spans)
        return self.flush_async(rank, mask=mask, spans=spans)

    def _check_shard_overlap(self, shards) -> None:
        """Raise WindowError when two shards' byte regions intersect."""
        regions = []
        for i, (cur, _snap, target_disp) in enumerate(shards):
            nbytes = cur.numel() * cur.element_size()
            lo = int(target_disp) * self.disp_unit
            regions.append((lo, lo + nbytes, i))
        regions.sort()
        for (alo, ahi, ai), (blo, bhi, bi) in zip(regions, regions[1:]):
            if blo < ahi:
                raise WindowError(
                    f"shard regions overlap: shard {bi} (bytes "
                    f"[{blo}, {bhi})) intersects shard {ai} (bytes "
                    f"[{alo}, {ahi})); overlapping shards would be applied "
                    "in list order")

    def _packed_device_spans(self, rank: int, shards, stats: dict):
        """Fused-kernel span gathering: ONE payload transfer per shard set.

        Runs ``dirty_pack`` per shard (bitmap + compacted dirty blocks on
        the device) -- every shard's kernels are queued before the first
        fetch -- then fetches all shards' bitmaps in one transfer and all
        shards' compacted blocks (byte views, concatenated on the device)
        in one more, and rebuilds the span list on the host from the shared
        ``changed_elem_spans`` geometry (``packed_run_layout``).
        """
        per = []
        for cur, snap, target_disp in shards:
            self._check_shard_pair(cur, snap)
            _, block_elems, _ = self._device_page_geometry(
                rank, cur.element_size())
            flags_d, packed_d, _count_d = dirty_pack(cur, snap,
                                                     block_elems=block_elems)
            per.append((flags_d, packed_d, cur, target_disp, block_elems))
        # one bitmap fetch covers every shard (int32 flags, concatenated)
        flags_host = (torch.cat([p[0] for p in per]) if len(per) > 1
                      else per[0][0]).cpu().numpy()
        stats["bitmap_transfers"] += 1
        parts = []
        split = 0
        shard_flags = []
        for flags_d, packed_d, _cur, _disp, _be in per:
            f = flags_host[split:split + flags_d.shape[0]]
            split += flags_d.shape[0]
            shard_flags.append(f)
            k = int(f.sum())
            if k:
                parts.append(packed_d[:k].view(torch.uint8).reshape(-1))
        spans: list[tuple[int, np.ndarray]] = []
        mask: np.ndarray | None = None
        if parts:
            payload = (parts[0] if len(parts) == 1
                       else torch.cat(parts)).cpu().numpy()
            stats["payload_transfers"] += 1
            stats["payload_bytes"] += payload.nbytes
        else:
            payload = np.zeros(0, np.uint8)
        base = 0
        for f, (_flags_d, _packed_d, cur, target_disp, block_elems) in zip(
                shard_flags, per):
            itemsize = cur.element_size()
            byte_off = target_disp * self.disp_unit
            nelems = cur.numel()
            m = self._flags_to_window_mask(rank, f.astype(bool), itemsize,
                                           nelems, target_disp)
            mask = m if mask is None else mask | m
            for lo_e, hi_e, poff in packed_run_layout(f, block_elems,
                                                      nelems):
                b0 = base + poff * itemsize
                spans.append((byte_off + lo_e * itemsize,
                              payload[b0:b0 + (hi_e - lo_e) * itemsize]))
                stats["logical_bytes"] += (hi_e - lo_e) * itemsize
            base += int(f.sum()) * block_elems * itemsize
        return spans, mask

    # -- resilience: live rebuild -------------------------------------------
    def rebuild_rank(self, rank: int, *, mark_alive: bool = True) -> int:
        """Restore a dead rank's state in this window from live replicas.

        Re-maps the rank's segments (on transports whose workers can be
        respawned -- call ``comm.rebuild_rank`` to also respawn), then
        reconciles its partition and the replica copies it hosts with a
        page-diff-granular copy from each partition's acting holder.  With
        ``mark_alive`` (default) the rank is returned to service, routing
        traffic back to the primary.  Returns bytes copied.
        """
        from .resilience.rebuild import rebuild_window_rank
        copied = rebuild_window_rank(self, rank)
        if mark_alive:
            self.comm.mark_alive(rank)
        return copied

    # -- teardown -----------------------------------------------------------
    def free(self) -> None:
        """Collective MPI_Win_free; honors unlink/discard hints.

        Drains the nonblocking layer first: every pending request and queued
        ``flush_async`` completes before segments close, so fire-and-forget
        flushes are durable once free() returns.  Errors raised by pending
        background operations re-raise here after teardown finishes --
        except on a replicated window where every error is a
        ``TransportError`` and every partition still has a live holder: the
        death was already observable and no data is at risk, so a job that
        kept serving through the failure also shuts down through it.
        """
        if self.freed:
            return
        errors: list[BaseException] = []
        try:
            self.comm.barrier()
        except BaseException as e:
            # a dead rank must not abort teardown: keep draining and
            # closing so the surviving segments (and their files) shut
            # down cleanly
            errors.append(e)
        if self._pool is not None:
            for r in range(self.comm.size):
                self._agg_dispatch(r)  # buffered trains must not be lost
            with self._req_lock:
                pending = [r for rs in self._pending_reqs.values() for r in rs]
                self._pending_reqs.clear()
            for req in pending:
                seen = req._observed
                try:
                    req.wait()
                except BaseException as e:
                    if not seen:
                        errors.append(e)
            for r in range(self.comm.size):
                try:
                    self._agg_complete(r)  # confirm/replay posted trains
                except BaseException as e:
                    errors.append(e)
            self._pool.shutdown()
            self._pool = None
        if self.placement is not None and not self.hints.discard:
            # final mirror: closing a segment flushes its holder's own page
            # cache, but only a mirror pass carries the last un-synced spans
            # to the replicas
            for r in range(self.comm.size):
                try:
                    self._mirror_rank(r)
                except BaseException as e:
                    errors.append(e)
        # dynamic windows never replicate, so replica_segs is empty there
        for rank_seg in list(self.segments) + list(self.replica_segs.values()):
            segs = rank_seg if self.dynamic else [rank_seg]
            for seg in segs:
                if seg is not None:
                    try:
                        seg.close(unlink=self.hints.unlink,
                                  discard=self.hints.discard)
                    except BaseException as e:
                        # close every remaining segment before surfacing:
                        # one unreachable rank must not leak the others
                        errors.append(e)
        self.freed = True
        self.comm._unregister(self)
        if errors and not self._survivable_teardown(errors):
            raise errors[0]

    def _survivable_teardown(self, errors) -> bool:
        """True when free() may swallow its errors: replicated window,
        transport-only failures, and a live holder for every partition."""
        if self.placement is None:
            return False
        if not all(isinstance(e, TransportError) for e in errors):
            return False
        try:
            for r in range(self.comm.size):
                self._holder_of(r)
        except WindowError:
            return False
        return True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.free()


def alloc_mem(size: int, info: Info | None = None, *, rank: int = 0, nranks: int = 1,
              mechanism: str = "cached", page_size: int = DEFAULT_PAGE_SIZE,
              memory_budget: int | None = None):
    """MPI_Alloc_mem with hints: used to pre-establish storage mappings for
    dynamic windows (paper Listing 3)."""
    hints = WindowHints.from_info(info)
    return _make_segment(size, hints, rank, nranks, shared_file=False,
                         memory_budget=memory_budget, mechanism=mechanism,
                         page_size=page_size, cache_bytes=None,
                         writeback_interval=None)
