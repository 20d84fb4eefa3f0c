"""SPMD program-execution mode: every rank is an origin.

The driver-origin mp transport keeps all application code on rank 0's
process and treats workers as passive targets.  That serializes every
origin-side issue through one process -- precisely the single-origin
bottleneck Schuchart et al. ("Quo Vadis MPI RMA?") warn against.  This
module promotes the workers to *application ranks*:

* :class:`SpmdLauncher` spawns ``size`` worker processes, ships each a
  pickled entry point, and then shrinks to a launcher/monitor: it runs
  liveness probes, heartbeat bookkeeping and :meth:`~SpmdLauncher.
  rebuild_rank` -- and issues **zero data-path operations** (asserted by
  its own op accounting, :meth:`~SpmdLauncher.data_ops`).
* Each worker builds a :class:`_WorkerTransport` -- its rank-local view of
  the same window substrate -- wraps it in a ``Communicator`` and calls
  the entry point.  Window put/get/sync/atomics route exactly as in
  driver-origin mode, only the *origin* is now the rank itself: own-rank
  partitions are serviced in-process (through the shared
  :class:`~repro_torch.core.transport.multiproc._SegmentService`, so peer
  origins and the local application stay serialized against each other),
  peer partitions through lazy per-peer Unix-socket channels that speak
  the identical op protocol as the driver-origin control channel.
* Collectives run through the launcher's :class:`_Coordinator`: each rank
  posts its contribution for the next *round* of its participant group;
  the coordinator releases the round when every live participant has
  contributed and the ranks reduce/bcast locally.  Completed rounds are
  cached so a respawned rank deterministically replaying its program
  receives the very values the survivors agreed on -- consistency over
  completeness, the same recovery contract as cached MPI collectives.

On-disk layout is byte-identical to driver-origin mode: segments are
created by the same ``_make_segment`` naming (``<file>.<rank>``), so a
crashed SPMD job recovers under either mode and vice versa.

Failure semantics follow the paper's storage-window story: a killed rank
loses its page cache and its memory (shm) windows; everything synced to
storage survives.  ``rebuild_rank`` re-enters the *application function*
on the respawned rank -- recovery is the application restoring its own
checkpoint, not the driver reconstructing worker state.

Entry points must be importable module-level callables (the spawn start
method pickles them by reference) with signature ``entry(comm, *args,
**kwargs)``; their return value travels back to the launcher and must be
picklable.  Respawn correctness requires the entry to issue the same
sequence of collective operations on replay (MPI-like determinism).

This is the JAX package's ``repro.core.transport.spmd``, message for
message.  As in this package's mp transport, every control channel (the
launcher's, the coordinator's and the peers' AF_UNIX sockets) reads and
writes in bounded chunks (``multiproc._send``/``_recv``), ranks are always
started with "spawn", and a rank whose entry runs on the card is an origin
of device syncs like any driver: the window layer above is the same.
"""

from __future__ import annotations

import atexit
import multiprocessing
import os
import shutil
import tempfile
import threading
import time
import traceback
from collections import Counter
from multiprocessing import connection as mpc

import numpy as np

from ..codec import CodecPolicy, WireStats
from .base import (Transport, TransportError, apply_accumulate,
                   apply_compare_and_swap, apply_get_accumulate,
                   apply_masked_spans, apply_op_batch, reduce_values)
from .multiproc import (_codec_ops, _DriverShmBuf, _encode_ops,
                        _READY_TIMEOUT_S, _recv, _RemoteSegment,
                        _SegmentService, _send, _ShmBuf, _SHUTDOWN_JOIN_S,
                        _call_timeout_s, _probe_timeout_s, _worker_main)

__all__ = ["SpmdLauncher"]

#: ops that move or manage window data -- the launcher must issue none
DATA_OPS = frozenset({"alloc", "put", "get", "acc", "gacc", "cas", "sync",
                      "wsync", "dirty", "free", "opbatch", "opbatch_nb",
                      "notify_read"})


# -- rank-local segment view ------------------------------------------------

class _LocalSeg:
    """This rank's own partition, serialized against peer origins.

    The raw segment lives in the rank's :class:`_SegmentService` registry
    where peer server threads operate on it; the application thread goes
    through this wrapper, which takes the same service lock around every
    mutating/reading call -- restoring the total order the driver-origin
    progress thread provided.  Attribute access (``tracker``, ``size``,
    ``buf``...) delegates untouched, so window-layer feature detection
    (``hasattr(seg, "mark_blocks")``) sees exactly the raw segment's
    surface.
    """

    _LOCKED = frozenset({"read", "write", "sync", "mark_blocks",
                         "dirty_bytes", "discard_cache"})

    def __init__(self, service: _SegmentService, win_id):
        object.__setattr__(self, "_service", service)
        object.__setattr__(self, "_win_id", win_id)
        # registry read under the service lock: a peer's server thread may
        # be mid-execute (alloc/free mutates the same dict), and close_all
        # swaps the registry wholesale during teardown
        with service.lock:
            object.__setattr__(self, "_seg", service.segments[win_id])

    def __getattr__(self, name):
        attr = getattr(object.__getattribute__(self, "_seg"), name)
        if name in _LocalSeg._LOCKED and callable(attr):
            service = object.__getattribute__(self, "_service")

            def locked(*a, __f=attr, **kw):
                with service.lock:
                    return __f(*a, **kw)

            return locked
        return attr

    def close(self, unlink: bool = False, discard: bool = False) -> None:
        service = object.__getattribute__(self, "_service")
        with service.lock:
            service.segments.pop(object.__getattribute__(self, "_win_id"),
                                 None)
            object.__getattribute__(self, "_seg").close(unlink=unlink,
                                                        discard=discard)


class _DeadSegment:
    """Placeholder for a partition whose owner died before describing it.

    Any access raises :class:`TransportError`; replicated windows fail
    over past it, unreplicated ones surface the loss at the call site --
    the paper's failure model (un-synced data on a dead rank is gone).
    """

    tracker = None
    kind = "storage"
    mem_bytes = 0
    page_size = None

    def __init__(self, rank: int, win_id, size: int = 0):
        self._rank = rank
        self._win_id = win_id
        self.size = size
        self.sto_bytes = size
        self.closed = False

    def _dead(self, *a, **kw):
        raise TransportError(f"rank {self._rank} died before its window "
                             "partition was published")

    read = write = sync = dirty_bytes = write_spans_sync = _dead
    op_batch = op_complete = _dead

    def close(self, unlink: bool = False, discard: bool = False) -> None:
        self.closed = True


# -- peer-to-peer control channels ------------------------------------------

class _PeerChannel:
    """Lazy client connection to one peer rank's op listener.

    Speaks the same request/reply protocol as the driver-origin control
    channel.  Connection failures drop the cached socket and retry once
    with a fresh dial -- a respawned peer rebinds the same address, so
    surviving origins heal their channels transparently.  Reply timeouts
    poison (drop) the connection without retry: the reply stream would be
    off by one.
    """

    def __init__(self, rank: int, address: str, authkey: bytes):
        self.rank = rank
        self._address = address
        self._authkey = authkey
        self._conn = None
        self._lock = threading.Lock()

    def _drop(self) -> None:
        conn, self._conn = self._conn, None
        if conn is not None:
            try:
                conn.close()
            except Exception:
                pass

    def call(self, msg, timeout: float):
        with self._lock:
            for attempt in (0, 1):
                try:
                    if self._conn is None:
                        self._conn = mpc.Client(self._address,
                                                family="AF_UNIX",
                                                authkey=self._authkey)
                    _send(self._conn, msg)
                    if timeout > 0 and not self._conn.poll(timeout):
                        self._drop()
                        raise TransportError(
                            f"rank {self.rank} peer did not reply within "
                            f"{timeout:.0f}s (hung channel; see "
                            "REPRO_MP_TIMEOUT)")
                    status, payload = _recv(self._conn)
                except TransportError:
                    raise
                except (EOFError, OSError, BrokenPipeError,
                        mpc.AuthenticationError) as e:
                    self._drop()
                    if attempt:
                        raise TransportError(
                            f"rank {self.rank} peer is unreachable") from e
                    continue
                if status == "err":
                    raise payload
                return payload

    def post(self, msg, timeout: float) -> None:
        """Notified-access send: ship ``msg`` with NO reply read, keeping
        the request/reply stream aligned for the next :meth:`call`.  A
        broken cached socket redials once, like :meth:`call`."""
        with self._lock:
            for attempt in (0, 1):
                try:
                    if self._conn is None:
                        self._conn = mpc.Client(self._address,
                                                family="AF_UNIX",
                                                authkey=self._authkey)
                    _send(self._conn, msg)
                    return
                except (EOFError, OSError, BrokenPipeError,
                        mpc.AuthenticationError) as e:
                    self._drop()
                    if attempt:
                        raise TransportError(
                            f"rank {self.rank} peer is unreachable") from e

    def ping(self, timeout: float) -> bool:
        if not self._lock.acquire(blocking=False):
            return True  # channel busy being serviced => making progress
        try:
            try:
                if self._conn is None:
                    self._conn = mpc.Client(self._address, family="AF_UNIX",
                                            authkey=self._authkey)
                _send(self._conn, ("ping",))
                if not self._conn.poll(timeout):
                    self._drop()
                    return False
                status, _ = _recv(self._conn)
                return status == "ok"
            except (EOFError, OSError, BrokenPipeError,
                    mpc.AuthenticationError):
                self._drop()
                return False
        finally:
            self._lock.release()

    def close(self) -> None:
        with self._lock:
            self._drop()


class _CollectiveChannel:
    """Worker-side client of the launcher's collective coordinator.

    Rounds are matched positionally per participant group, MPI-style: the
    ``pos``-th collective a rank issues against group ``ptuple`` pairs
    with every other member's ``pos``-th.  The coordinator replies with
    the contributions of all *live* participants.
    """

    def __init__(self, conn, rank: int):
        self._conn = conn
        self.rank = rank
        self._pos: dict[tuple, int] = {}
        self._lock = threading.Lock()

    def round(self, ptuple: tuple, payload, timeout: float) -> dict:
        with self._lock:
            pos = self._pos.get(ptuple, 0)
            self._pos[ptuple] = pos + 1
            try:
                _send(self._conn, ("round", self.rank, ptuple, pos,
                                   payload))
                if timeout > 0 and not self._conn.poll(timeout):
                    raise TransportError(
                        f"rank {self.rank}: collective round {pos} on "
                        f"{ptuple} timed out after {timeout:.0f}s")
                status, reply = _recv(self._conn)
            except (EOFError, OSError, BrokenPipeError) as e:
                raise TransportError(
                    f"rank {self.rank}: lost the coordinator channel") from e
        if status == "err":
            raise reply if isinstance(reply, BaseException) \
                else TransportError(str(reply))
        return reply

    def send_result(self, tag: str, payload) -> None:
        with self._lock:
            try:
                _send(self._conn, (tag, self.rank, payload))
            except (EOFError, OSError, BrokenPipeError):
                pass  # launcher gone; nothing left to report to


# -- the rank-local transport ----------------------------------------------

class _WorkerTransport(Transport):
    """A worker rank's origin-side view of the shared window substrate.

    Own-rank segments are local (service-lock serialized); peer segments
    are the very same proxy handles the driver-origin transport uses
    (:class:`_RemoteSegment` for storage, attached shm for memory) -- the
    window layer above cannot tell which mode it is running under, which
    is what keeps routing, failover and backpressure accounting
    rank-agnostic.  Every operation is tallied in :attr:`stats` so tests
    can assert each rank genuinely originates its own traffic.
    """

    kind = "mp"
    # One lazily-dialed persistent channel per peer, served in receive
    # order -- posted trains and later calls to the same owner ride the
    # same conn, so channel-FIFO completion holds per origin.
    ordered_channels = True

    def __init__(self, rank: int, size: int, service: _SegmentService,
                 coll: _CollectiveChannel, addrs: list[str],
                 authkey: bytes):
        super().__init__(size, rank)
        self.service = service
        self._coll = coll
        self._addrs = addrs
        self._authkey = authkey
        self._chans: dict[int, _PeerChannel] = {}
        self._chan_lock = threading.Lock()
        self._world = tuple(range(size))
        self._win_seq: dict[tuple, int] = {}
        self._seq_lock = threading.Lock()
        self.stats = {"local": Counter(), "remote": Counter(),
                      "targets": Counter(), "rounds": 0}
        # peer-bound spans/op trains ride the lossless wire codec exactly
        # like driver-origin mp traffic (_RemoteSegment consults these);
        # own-rank (_LocalSeg) and attached-shm paths stay raw -- no wire
        self.codec_policy = CodecPolicy()
        self.wire_stats = WireStats()

    # -- peer channels -----------------------------------------------------
    def _chan(self, rank: int) -> _PeerChannel:
        with self._chan_lock:
            ch = self._chans.get(rank)
            if ch is None:
                ch = self._chans[rank] = _PeerChannel(
                    rank, self._addrs[rank], self._authkey)
            return ch

    # timeout hooks: subclasses on another fabric (the tcp fleet) re-point
    # these at their own env knobs without re-implementing _call/_post/probe
    def _timeout_s(self) -> float:
        return _call_timeout_s()

    def _probe_s(self) -> float:
        return _probe_timeout_s()

    def _call(self, rank: int, msg):
        if rank == self.rank:
            self.stats["local"][msg[0]] += 1
            return self.service.execute(msg)
        self.stats["remote"][msg[0]] += 1
        self.stats["targets"][rank] += 1
        try:
            return self._chan(rank).call(msg, self._timeout_s())
        except TransportError:
            if msg[0] == "free":
                # best-effort: the peer is dead, so its segment registry
                # died with it -- there is nothing left to free, and a
                # respawned rank frees its own segment when its replayed
                # run reaches the same teardown
                return ("ok",)
            raise

    # -- window ids --------------------------------------------------------
    def _next_win_id(self, ptuple: tuple):
        """Deterministic across the group: every member draws the same id
        for the same (group, sequence-position) allocation, so holder-side
        allocs from n origins converge on one segment."""
        with self._seq_lock:
            seq = self._win_seq.get(ptuple, 0)
            self._win_seq[ptuple] = seq + 1
        return ("w", ptuple, seq)

    # -- segments ----------------------------------------------------------
    def _wrap_local(self, win_id) -> _LocalSeg:
        return _LocalSeg(self.service, win_id)

    def _make_proxy(self, rank: int, win_id, size: int, meta: dict):
        if meta.get("shm") is not None:
            try:
                return _DriverShmBuf(self, win_id, rank, size, meta["shm"])
            except FileNotFoundError:
                # owner respawned since creating it: the mapping (and its
                # contents) died with the old process -- memory windows
                # are volatile by the paper's model
                return _DeadSegment(rank, win_id, size)
        return _RemoteSegment(self, win_id, rank, meta)

    def _alloc_group(self, ptuple: tuple, global_ranks: list[int],
                     size: int, hints, spec: dict) -> list:
        win_id = self._next_win_id(ptuple)
        hints_kw = dict(hints.__dict__)
        my_idx = global_ranks.index(self.rank)
        self.stats["local"]["alloc"] += 1
        meta = self.service.execute(("alloc", win_id, size, hints_kw,
                                     my_idx, len(global_ranks), dict(spec)))
        # one gather publishes every member's segment metadata (shm names,
        # geometry); peers never receive n-1 separate alloc requests
        contribs = self._round(ptuple, ("alloc", win_id, meta))
        segs = []
        for i, gr in enumerate(global_ranks):
            if gr == self.rank:
                segs.append(self._wrap_local(win_id))
            elif gr in contribs:
                segs.append(self._make_proxy(gr, win_id, size,
                                             contribs[gr][2]))
            else:
                segs.append(_DeadSegment(gr, win_id, size))
        return segs

    def allocate_segments(self, size: int, hints, spec: dict) -> list:
        return self._alloc_group(self._world, list(self._world), size,
                                 hints, spec)

    def _alloc_targeted(self, ptuple: tuple, global_rank: int, size: int,
                        hints, spec: dict, name_rank: int,
                        name_nranks: int):
        win_id = self._next_win_id(ptuple)
        msg = ("alloc", win_id, size, dict(hints.__dict__), name_rank,
               name_nranks, dict(spec))
        if global_rank == self.rank:
            self.stats["local"]["alloc"] += 1
            self.service.execute(msg)
            return self._wrap_local(win_id)
        meta = self._call(global_rank, msg)
        return self._make_proxy(global_rank, win_id, size, meta)

    def allocate_segment(self, rank: int, size: int, hints, spec: dict, *,
                         name_rank: int, name_nranks: int):
        """Targeted allocation (replica placement, rebuild).  Must be
        issued in the same order by every rank: the deterministic win_id
        plus the holder's idempotent alloc make n origin requests
        materialize one segment."""
        return self._alloc_targeted(self._world, rank, size, hints, spec,
                                    name_rank, name_nranks)

    # -- liveness ----------------------------------------------------------
    def probe(self, rank: int, timeout: float | None = None) -> bool:
        super().probe(rank)  # range check
        if rank == self.rank:
            return True
        return self._chan(rank).ping(timeout if timeout is not None
                                     else self._probe_s())

    # -- data path ---------------------------------------------------------
    def put(self, seg, offset: int, data) -> None:
        self._note(seg, "put")
        seg.write(offset, data)

    def get(self, seg, offset: int, nbytes: int):
        self._note(seg, "get")
        return seg.read(offset, nbytes)

    def _note(self, seg, op: str) -> None:
        if isinstance(seg, _LocalSeg):
            self.stats["local"][op] += 1
        elif isinstance(seg, _ShmBuf):
            # direct load/store on the attached mapping: one-sided for
            # real, but still origin-issued traffic worth tallying
            self.stats["remote"][op] += 1
            self.stats["targets"][getattr(seg, "_rank", -1)] += 1
        # _RemoteSegment traffic is counted at the _call layer

    def write_spans_masked(self, seg, spans, mask):
        if isinstance(seg, _LocalSeg):
            # route through the service so spans+mark+flush run as one
            # critical section, same as a peer-issued wsync would
            payload = [(int(off),
                        np.ascontiguousarray(np.asarray(d, np.uint8)
                                             .ravel()).tobytes())
                       for off, d in spans]
            self.stats["local"]["wsync"] += 1
            n, _io_s = self.service.execute(
                ("wsync", object.__getattribute__(seg, "_win_id"),
                 payload, mask))
            return n
        if isinstance(seg, _ShmBuf):
            return apply_masked_spans(seg, spans, mask)
        return seg.write_spans_sync(spans, mask)

    def _post(self, rank: int, msg) -> None:
        """Fire-and-forget peer send (notified access): no reply consumed."""
        self.stats["remote"][msg[0]] += 1
        self.stats["targets"][rank] += 1
        self._chan(rank).post(msg, self._timeout_s())

    def op_batch(self, seg, ops, defer: bool = False):
        """Aggregated op train, routed like every other data op: own-rank
        partitions execute through the shared service (one lock
        acquisition for the whole train), attached shm applies load/stores
        directly (atomic-carrying batches still ship whole to the owner),
        peer storage partitions speak ``opbatch``/``opbatch_nb``."""
        if isinstance(seg, _LocalSeg):
            self.stats["local"]["opbatch"] += 1
            return self.service.execute(
                ("opbatch", object.__getattribute__(seg, "_win_id"),
                 list(ops)))
        if isinstance(seg, _ShmBuf):
            if any(o[0] in ("acc", "gacc", "cas") for o in ops):
                return self._call(seg._rank,
                                  ("opbatch", seg._win_id,
                                   _codec_ops(self, _encode_ops(ops))))
            self._note(seg, "opbatch")
            return apply_op_batch(seg, ops)
        return seg.op_batch(ops, defer=defer)

    def op_complete(self, seg) -> int:
        if isinstance(seg, (_LocalSeg, _ShmBuf)):
            return 0  # local/shm batches complete synchronously
        return seg.op_complete()

    # -- target-side atomics ----------------------------------------------
    def _atomic(self, seg, msg_builder, local_apply):
        if isinstance(seg, _LocalSeg):
            op = msg_builder(None)[0]
            self.stats["local"][op] += 1
            service = object.__getattribute__(seg, "_service")
            with service.lock:
                return local_apply(object.__getattribute__(seg, "_seg"))
        rank, win_id = seg._rank, seg._win_id
        return self._call(rank, msg_builder(win_id))

    def accumulate(self, seg, offset, data, op):
        data = np.ascontiguousarray(data)
        self._atomic(seg,
                     lambda wid: ("acc", wid, offset, data, op),
                     lambda raw: apply_accumulate(raw, offset, data, op))

    def get_accumulate(self, seg, offset, data, op):
        data = np.ascontiguousarray(data)
        return self._atomic(
            seg,
            lambda wid: ("gacc", wid, offset, data, op),
            lambda raw: apply_get_accumulate(raw, offset, data, op))

    def compare_and_swap(self, seg, offset, value, compare, dtype):
        dtype = np.dtype(dtype)
        return self._atomic(
            seg,
            lambda wid: ("cas", wid, offset, value, compare, dtype),
            lambda raw: apply_compare_and_swap(raw, offset, value, compare,
                                               dtype))

    # -- collectives -------------------------------------------------------
    def _round(self, ptuple: tuple, payload) -> dict:
        self.stats["rounds"] += 1
        return self._coll.round(ptuple, payload, self._timeout_s())

    def _barrier_on(self, ptuple: tuple) -> None:
        self._round(ptuple, ("barrier",))

    def barrier(self) -> None:
        self._barrier_on(self._world)

    def _allreduce_on(self, ptuple: tuple, group_rank: int, value, op: str):
        if self._is_vector(value, len(ptuple)):
            value = value[group_rank]
        contribs = self._round(ptuple, ("allreduce", op, np.asarray(value)))
        return reduce_values([contribs[r][2] for r in sorted(contribs)], op)

    @staticmethod
    def _is_vector(value, n: int) -> bool:
        return isinstance(value, (list, tuple)) and len(value) == n

    def allreduce(self, value, op: str = "sum"):
        """Genuine reduction across ranks.  A size-``n`` list/tuple is the
        driver-style contribution vector (this rank contributes its own
        element -- results match driver-origin mode when every rank passes
        the same vector); anything else is this rank's contribution."""
        if isinstance(value, (list, tuple)) and len(value) != self.size:
            raise ValueError(
                f"allreduce expects {self.size} contributions, "
                f"got {len(value)}")
        return self._allreduce_on(self._world, self.rank, value, op)

    def _bcast_on(self, ptuple: tuple, value, root_global: int):
        mine = value if self.rank == root_global else None
        contribs = self._round(ptuple, ("bcast", mine))
        if root_global not in contribs:
            raise TransportError(
                f"bcast root {root_global} died before contributing")
        return contribs[root_global][1]

    def bcast(self, value, root: int = 0):
        self._check_root(root)
        return self._bcast_on(self._world, value, root)

    def split(self, color: int, ranks: list[int]) -> "Transport":
        return _WorkerSubTransport(self, list(ranks))

    # -- accounting / lifecycle --------------------------------------------
    def stats_snapshot(self) -> dict:
        return {"local": dict(self.stats["local"]),
                "remote": dict(self.stats["remote"]),
                "targets": {int(k): v
                            for k, v in self.stats["targets"].items()},
                "rounds": self.stats["rounds"],
                "wire": self.wire_stats.snapshot()}

    def shutdown(self) -> None:
        with self._chan_lock:
            chans, self._chans = list(self._chans.values()), {}
        for ch in chans:
            ch.close()


class _WorkerSubTransport(Transport):
    """Rank-translated view of a worker transport (``Communicator.split``).

    Collectives run as coordinator rounds over the sub-group's global-rank
    tuple; segment handles stay bound to their owner's channel, so data
    ops delegate verbatim.  A rank outside ``ranks`` must not issue group
    collectives (they would hang waiting for it) -- enforced here.
    """

    kind = "mp"
    ordered_channels = True  # delegates to the parent's FIFO channels

    def __init__(self, parent: _WorkerTransport, ranks: list[int]):
        member = parent.rank in ranks
        super().__init__(len(ranks), ranks.index(parent.rank) if member
                         else 0)
        self.parent = parent
        self.ranks = list(ranks)
        self._ptuple = tuple(ranks)
        self._member = member

    def _require_member(self) -> None:
        if not self._member:
            raise TransportError(
                f"rank {self.parent.rank} is not a member of group "
                f"{self.ranks}")

    def allocate_segments(self, size: int, hints, spec: dict) -> list:
        self._require_member()
        return self.parent._alloc_group(self._ptuple, self.ranks, size,
                                        hints, spec)

    def allocate_segment(self, rank: int, size: int, hints, spec: dict, *,
                         name_rank: int, name_nranks: int):
        self._require_member()
        return self.parent._alloc_targeted(self._ptuple, self.ranks[rank],
                                           size, hints, spec, name_rank,
                                           name_nranks)

    def probe(self, rank: int, timeout: float | None = None) -> bool:
        super().probe(rank)  # range check against the group size
        return self.parent.probe(self.ranks[rank], timeout)

    def accumulate(self, seg, offset, data, op):
        self.parent.accumulate(seg, offset, data, op)

    def get_accumulate(self, seg, offset, data, op):
        return self.parent.get_accumulate(seg, offset, data, op)

    def compare_and_swap(self, seg, offset, value, compare, dtype):
        return self.parent.compare_and_swap(seg, offset, value, compare,
                                            dtype)

    def write_spans_masked(self, seg, spans, mask):
        return self.parent.write_spans_masked(seg, spans, mask)

    def op_batch(self, seg, ops, defer: bool = False):
        return self.parent.op_batch(seg, ops, defer=defer)

    def op_complete(self, seg) -> int:
        return self.parent.op_complete(seg)

    def barrier(self) -> None:
        self._require_member()
        self.parent._barrier_on(self._ptuple)

    def allreduce(self, value, op: str = "sum"):
        self._require_member()
        if isinstance(value, (list, tuple)) and len(value) != self.size:
            raise ValueError(
                f"allreduce expects {self.size} contributions, "
                f"got {len(value)}")
        return self.parent._allreduce_on(self._ptuple, self.rank, value, op)

    def bcast(self, value, root: int = 0):
        self._check_root(root)
        self._require_member()
        return self.parent._bcast_on(self._ptuple, value, self.ranks[root])

    def split(self, color: int, ranks: list[int]) -> "Transport":
        return _WorkerSubTransport(self.parent,
                                   [self.ranks[r] for r in ranks])

    def shutdown(self) -> None:
        pass  # the parent owns the channels


# -- worker main -----------------------------------------------------------

def _run_spmd_worker(conn, rank: int, cfg: dict) -> None:
    """Program-execution mode of ``_worker_main``: serve AND compute.

    Three concurrent roles share one :class:`_SegmentService`:

    * the driver control channel (handshake, pings, shutdown) on the
      progress thread, exactly as in driver-origin mode;
    * an accept loop turning every connecting peer origin into its own
      server thread (service-lock serialization keeps target-side
      atomics atomic across all of them);
    * the main thread, which builds the rank-local ``Communicator`` view
      and *runs the application*.

    The worker keeps servicing peers after its application returns --
    ranks finish at different times and late peers still read from this
    rank's partitions -- and only exits when the launcher sends shutdown.
    """
    address = cfg["addrs"][rank]
    try:
        os.unlink(address)  # stale socket from a previous incarnation
    except FileNotFoundError:
        pass
    service = _SegmentService(rank)
    listener = mpc.Listener(address, family="AF_UNIX",
                            authkey=cfg["authkey"])

    def accept_loop() -> None:
        while True:
            try:
                c = listener.accept()
            except mpc.AuthenticationError:
                continue
            except (OSError, EOFError):
                break  # listener closed: shutting down
            threading.Thread(target=service.serve_conn, args=(c,),
                             name=f"repro-peer-{rank}", daemon=True).start()

    acceptor = threading.Thread(target=accept_loop,
                                name=f"repro-accept-{rank}", daemon=True)
    acceptor.start()
    progress = threading.Thread(target=service.serve_conn, args=(conn,),
                                kwargs={"ready": ("ready", rank)},
                                name=f"repro-progress-{rank}", daemon=True)
    progress.start()

    coll = _CollectiveChannel(cfg["coll"], rank)
    transport = _WorkerTransport(rank, cfg["size"], service, coll,
                                 cfg["addrs"], cfg["authkey"])
    from ..comm import Communicator
    comm = Communicator(cfg["size"], rank=rank, transport=transport)
    try:
        result = cfg["entry"](comm, *(cfg.get("args") or ()),
                              **(cfg.get("kwargs") or {}))
    except BaseException as e:
        traceback.print_exc()
        try:
            coll.send_result("err", e)
        except Exception:
            coll.send_result("err", TransportError(
                f"rank {rank}: {type(e).__name__}: {e}"))
    else:
        payload = {"result": result,
                   "stats": transport.stats_snapshot()}
        try:
            coll.send_result("done", payload)
        except Exception:
            coll.send_result("done", {"result": None,
                                      "stats": transport.stats_snapshot()})
    progress.join()  # until the launcher's shutdown (or channel EOF)
    try:
        listener.close()
    except Exception:
        pass
    transport.shutdown()
    service.close_all()
    try:
        os.unlink(address)
    except OSError:
        pass


# -- the launcher's collective coordinator ----------------------------------

class _Coordinator(threading.Thread):
    """Matches collective rounds across worker ranks.

    Keyed ``(participants, position)``; a round completes when every
    participant not yet *excluded* (finished, errored, or dead) has
    contributed, and every waiter receives the full contribution map.
    Completed rounds are cached for deterministic replay by respawned
    ranks.
    """

    def __init__(self, size: int):
        super().__init__(name="repro-spmd-coord", daemon=True)
        self.size = size
        self._lock = threading.Lock()
        self._conns: dict[int, object] = {}
        self._excluded: set[int] = set()
        self._pending: dict[tuple, dict] = {}
        self._cache: dict[tuple, dict] = {}
        self.results: dict[int, tuple] = {}
        self._closing: list = []
        self._stopped = False

    # -- membership --------------------------------------------------------
    def attach(self, rank: int, conn) -> None:
        with self._lock:
            self._conns[rank] = conn
            self._excluded.discard(rank)
            self.results.pop(rank, None)

    def mark_dead(self, rank: int) -> None:
        with self._lock:
            conn = self._conns.pop(rank, None)
            self._excluded.add(rank)
            self._recheck_locked()
            if conn is not None:
                # closed by the matching loop between two waits: closed
                # here, its fd could go to the respawn's channel while the
                # loop still reads the old one, and the loop would read
                # the new channel's bytes as the old one's
                self._closing.append(conn)

    def _close_dropped(self) -> None:
        with self._lock:
            closing, self._closing = self._closing, []
        for conn in closing:
            try:
                conn.close()
            except Exception:
                pass

    def results_snapshot(self) -> dict:
        with self._lock:
            return dict(self.results)

    def stop(self) -> None:
        self._stopped = True
        self.join(timeout=_SHUTDOWN_JOIN_S)
        if not self.is_alive():
            self._close_dropped()

    # -- the matching loop -------------------------------------------------
    def run(self) -> None:
        while not self._stopped:
            self._close_dropped()
            with self._lock:
                conns = dict(self._conns)
            if not conns:
                time.sleep(0.02)
                continue
            by_conn = {id(c): r for r, c in conns.items()}
            try:
                ready = mpc.wait(list(conns.values()), timeout=0.2)
            except OSError:
                continue
            for conn in ready:
                rank = by_conn[id(conn)]
                with self._lock:
                    current = self._conns.get(rank) is conn
                if not current:
                    continue  # dropped (``mark_dead``) since the snapshot
                try:
                    msg = _recv(conn)
                except (EOFError, OSError):
                    self._on_eof(rank, conn)
                    continue
                self._handle(rank, msg)

    def _on_eof(self, rank: int, conn) -> None:
        with self._lock:
            if self._conns.get(rank) is not conn:
                return  # a stale channel: the rank was attached anew
            del self._conns[rank]
            if rank not in self.results:
                # died without reporting: exclude so pending rounds of the
                # survivors can complete (the launcher's monitor decides
                # whether to respawn)
                self._excluded.add(rank)
                self._recheck_locked()

    def _handle(self, rank: int, msg) -> None:
        tag = msg[0]
        with self._lock:
            if tag == "round":
                _, _, ptuple, pos, payload = msg
                rkey = (ptuple, pos)
                cached = self._cache.get(rkey)
                if cached is not None:
                    self._reply_locked(rank, ("ok", cached))
                    return
                pend = self._pending.setdefault(
                    rkey, {"contribs": {}, "waiting": set()})
                pend["contribs"][rank] = payload
                pend["waiting"].add(rank)
                self._maybe_complete_locked(rkey)
            elif tag in ("done", "err"):
                self.results[rank] = (tag, msg[2])
                self._excluded.add(rank)
                self._recheck_locked()

    def _maybe_complete_locked(self, rkey) -> None:
        pend = self._pending.get(rkey)
        if pend is None:
            return
        need = [r for r in rkey[0] if r not in self._excluded]
        if not all(r in pend["contribs"] for r in need):
            return
        snapshot = dict(pend["contribs"])
        self._cache[rkey] = snapshot
        del self._pending[rkey]
        for r in pend["waiting"]:
            self._reply_locked(r, ("ok", snapshot))

    def _recheck_locked(self) -> None:
        for rkey in list(self._pending):
            self._maybe_complete_locked(rkey)

    def _reply_locked(self, rank: int, reply) -> None:
        conn = self._conns.get(rank)
        if conn is None:
            return
        try:
            _send(conn, reply)
        except (OSError, BrokenPipeError):
            pass


# -- the launcher ----------------------------------------------------------

class SpmdLauncher:
    """Spawn ``size`` application ranks; monitor; never touch their data.

    The inversion of the driver-origin transport: application code runs
    *in the workers*, and this process keeps only control-plane duties --
    ready handshakes, liveness probes (:meth:`probe`), result collection
    (:meth:`wait`), heartbeat-driven supervision
    (:meth:`monitor_until_done`) and :meth:`rebuild_rank`, which respawns
    a dead rank and re-enters the application function there (recovery is
    the application restoring its own checkpoint).  Every control message
    this process sends is tallied in :attr:`op_counts`; :meth:`data_ops`
    must stay zero -- the acceptance check that the driver really shrank
    to a launcher.
    """

    def __init__(self, size: int, entry, args: tuple = (),
                 kwargs: dict | None = None):
        if size < 1:
            raise ValueError("size must be >= 1")
        self.size = size
        self._entry = entry
        self._args = tuple(args)
        self._kwargs = dict(kwargs or {})
        self._ctx = multiprocessing.get_context("spawn")
        self._dir = tempfile.mkdtemp(prefix="repro-spmd-")
        self._authkey = os.urandom(16)
        self._addrs = [os.path.join(self._dir, f"r{r}.sock")
                       for r in range(size)]
        self._procs: list = [None] * size
        self._conns: list = [None] * size
        self._chan_locks = [threading.Lock() for _ in range(size)]
        self.op_counts: Counter = Counter()
        self.respawns: Counter = Counter()
        self._coord = _Coordinator(size)
        self._coord.start()
        self._shutdown_done = False
        try:
            for r in range(size):
                self._spawn(r)
            for r in range(size):
                self._await_ready(r)
        except BaseException:
            self.shutdown()
            raise
        atexit.register(self.shutdown)

    # -- process management ------------------------------------------------
    def _spawn(self, rank: int) -> None:
        parent, child = self._ctx.Pipe(duplex=True)
        coll_parent, coll_child = self._ctx.Pipe(duplex=True)
        cfg = {"size": self.size, "addrs": self._addrs,
               "authkey": self._authkey, "coll": coll_child,
               "entry": self._entry, "args": self._args,
               "kwargs": self._kwargs}
        p = self._ctx.Process(target=_worker_main, args=(child, rank),
                              kwargs={"spmd": cfg},
                              name=f"repro-spmd-{rank}", daemon=True)
        p.start()
        child.close()
        coll_child.close()
        self._procs[rank] = p
        self._conns[rank] = parent
        self._coord.attach(rank, coll_parent)

    def _await_ready(self, rank: int) -> None:
        conn = self._conns[rank]
        if not conn.poll(_READY_TIMEOUT_S):
            raise TransportError(f"rank {rank} worker did not start")
        try:
            tag, got = _recv(conn)
        except (EOFError, OSError) as e:
            raise TransportError(
                f"rank {rank} worker died during start-up") from e
        if tag != "ready" or got != rank:
            raise TransportError(f"rank {rank} worker handshake failed")

    # -- control channel ---------------------------------------------------
    def _control(self, rank: int, msg):
        self.op_counts[msg[0]] += 1
        conn = self._conns[rank]
        timeout = _call_timeout_s()
        with self._chan_locks[rank]:
            try:
                _send(conn, msg)
                if timeout > 0 and not conn.poll(timeout):
                    try:
                        conn.close()
                    except Exception:
                        pass
                    raise TransportError(
                        f"rank {rank} worker did not reply within "
                        f"{timeout:.0f}s")
                status, payload = _recv(conn)
            except (EOFError, OSError, BrokenPipeError) as e:
                raise TransportError(
                    f"rank {rank} worker is unreachable") from e
        if status == "err":
            raise payload
        return payload

    def data_ops(self) -> int:
        """Data-path operations this launcher has issued: must be zero."""
        return sum(n for op, n in self.op_counts.items() if op in DATA_OPS)

    # -- liveness / recovery -----------------------------------------------
    def probe(self, rank: int, timeout: float | None = None) -> bool:
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} out of range")
        p = self._procs[rank]
        if p is None or not p.is_alive():
            return False
        lk = self._chan_locks[rank]
        if not lk.acquire(blocking=False):
            return True  # channel busy => worker making progress
        try:
            conn = self._conns[rank]
            self.op_counts["ping"] += 1
            _send(conn, ("ping",))
            if not conn.poll(timeout if timeout is not None
                             else _probe_timeout_s()):
                try:
                    conn.close()
                except Exception:
                    pass
                return False
            status, _ = _recv(conn)
            return status == "ok"
        except (EOFError, OSError, BrokenPipeError):
            return False
        finally:
            lk.release()

    def rebuild_rank(self, rank: int) -> None:
        """Respawn a dead rank and re-enter the application function.

        The respawned process replays the entry from the top: allocations
        re-map the same files, collective rounds replay from the
        coordinator's cache, and the application itself restores from the
        last checkpoint it synced -- the paper's recovery model with the
        *application* as the recovery agent.  Refuses to replace a
        responsive rank.
        """
        p = self._procs[rank]
        if p is not None and p.is_alive():
            if self.probe(rank):
                raise TransportError(
                    f"rank {rank} is alive and responsive; "
                    "refusing to respawn")
            p.terminate()
            p.join(timeout=_SHUTDOWN_JOIN_S)
            if p.is_alive():
                p.kill()
        if p is not None:
            p.join(timeout=_SHUTDOWN_JOIN_S)
        try:
            self._conns[rank].close()
        except Exception:
            pass
        self._coord.mark_dead(rank)
        self._chan_locks[rank] = threading.Lock()
        self.respawns[rank] += 1
        self._spawn(rank)
        self._await_ready(rank)

    # -- result collection -------------------------------------------------
    def wait(self, timeout: float | None = None,
             poll_s: float = 0.05) -> list:
        """Block until every rank reported; return their entry results.

        Raises :class:`TransportError` if a rank died without reporting
        (call :meth:`rebuild_rank` first to recover it) or re-raises the
        first application error.  Per-rank transport accounting is kept
        in :attr:`rank_stats` afterwards.
        """
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            res = self._coord.results_snapshot()
            missing = [r for r in range(self.size) if r not in res]
            if not missing:
                break
            for r in missing:
                p = self._procs[r]
                if p is not None and not p.is_alive():
                    # grace re-check: its "done" may still sit in the
                    # coordinator's pipe buffer
                    time.sleep(poll_s)
                    if r not in self._coord.results_snapshot():
                        raise TransportError(
                            f"rank {r} died without reporting a result "
                            "(rebuild_rank to recover)")
            if deadline is not None and time.monotonic() > deadline:
                raise TransportError(
                    f"ranks {missing} did not finish within {timeout:.0f}s")
            time.sleep(poll_s)
        for r in range(self.size):
            tag, payload = res[r]
            if tag == "err":
                raise payload if isinstance(payload, BaseException) \
                    else TransportError(f"rank {r}: {payload}")
        self.rank_stats = {r: res[r][1].get("stats", {})
                           for r in range(self.size)}
        return [res[r][1].get("result") for r in range(self.size)]

    def monitor_until_done(self, *, interval_s: float = 0.5,
                           respawn: bool = True, max_respawns: int = 1,
                           timeout: float | None = None) -> list:
        """The driver's whole job: heartbeats and rebuild_rank.

        Probes every unfinished rank each tick, feeds the heartbeat
        monitor, and respawns dead ranks (up to ``max_respawns`` each)
        via :meth:`rebuild_rank`.  Returns :meth:`wait`'s results.
        """
        from ...runtime.fault import HeartbeatMonitor
        hb = HeartbeatMonitor(self.size)
        tick = 0
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            res = self._coord.results_snapshot()
            if len(res) == self.size:
                break
            tick += 1
            for r in range(self.size):
                if r in res:
                    hb.beat(r, tick)
                    continue
                if self.probe(r):
                    hb.beat(r, tick)
                    continue
                if not respawn or self.respawns[r] >= max_respawns:
                    raise TransportError(
                        f"rank {r} died (respawn budget exhausted)")
                self.rebuild_rank(r)
            if deadline is not None and time.monotonic() > deadline:
                raise TransportError(f"job did not finish within "
                                     f"{timeout:.0f}s")
            time.sleep(interval_s)
        return self.wait(timeout=_SHUTDOWN_JOIN_S)

    # -- lifecycle ---------------------------------------------------------
    def shutdown(self) -> None:
        """Stop the ranks (idempotent; robust to already-dead children)."""
        if self._shutdown_done:
            return
        self._shutdown_done = True
        atexit.unregister(self.shutdown)
        for r in range(self.size):
            conn = self._conns[r]
            if conn is None:
                continue
            with self._chan_locks[r]:
                try:
                    self.op_counts["shutdown"] += 1
                    _send(conn, ("shutdown",))
                    if conn.poll(_SHUTDOWN_JOIN_S):
                        _recv(conn)
                except (EOFError, OSError, BrokenPipeError):
                    pass
        for p in self._procs:
            if p is None:
                continue
            p.join(timeout=_SHUTDOWN_JOIN_S)
            if p.is_alive():
                p.terminate()
                p.join(timeout=_SHUTDOWN_JOIN_S)
        self._coord.stop()
        for conn in self._conns:
            try:
                if conn is not None:
                    conn.close()
            except Exception:
                pass
        shutil.rmtree(self._dir, ignore_errors=True)
