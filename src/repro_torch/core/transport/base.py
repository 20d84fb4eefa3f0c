"""Abstract transport layer for MPI-style windows.

The paper's premise is *one interface over memory and storage across ranks*;
which fabric actually moves the bytes is an implementation decision.  This
module defines that boundary: a :class:`Transport` owns

* **segment allocation** -- given a window's size/hints, produce one segment
  handle per rank.  A segment handle exposes the uniform access interface
  (``read``/``write``/``sync``/``dirty_bytes``/``close``) regardless of
  whether the bytes live in this process, in another process's shared-memory
  mapping, or behind a control channel serviced by the owner's progress
  thread.
* **target-side atomics** -- ``accumulate``/``get_accumulate``/
  ``compare_and_swap`` execute *at the target rank* so they are atomic with
  respect to every origin, not just threads of one process.
* **request aggregation** -- :meth:`Transport.op_batch` ships N small
  puts/gets/accumulates for ONE target in ONE control-channel message; the
  owner applies the whole train under a single service-lock acquisition
  with byte-contiguous put runs coalesced into single span writes
  (:func:`apply_op_batch`).  The hot-path cost of N 8-byte ops drops from
  N round trips to one.
* **notified-access completion** -- ``op_batch(..., defer=True)`` may
  *post* a result-free batch with no reply at all; the owner counts
  applied batches per (origin channel, window) and the origin later reads
  that counter ONCE via :meth:`Transport.op_complete`.  Because each
  origin->owner channel is FIFO, a single counter read confirms every
  previously posted batch, and any deferred error surfaces there -- MPI's
  "errors are reported at flush" rule.
* **collectives** -- ``barrier``, ``allreduce``, ``bcast``, ``split``.

:class:`~repro_torch.core.window.Window` programs exclusively against this
interface; swapping ``InprocTransport`` for ``MultiprocessTransport`` or
the tcp backends changes no window, DHT, MapReduce or checkpoint code.

Batched op wire form
--------------------
A batch is a list of tuples, applied strictly in list order (the origin's
issue order -- FIFO per target is the windows-on-storage ordering
contract):

==========  ===========================================  ================
kind        tuple                                        result slot
==========  ===========================================  ================
``put``     ``("put", offset, uint8-bytes-or-array)``    ``None``
``get``     ``("get", offset, nbytes)``                  ``uint8 array``
``acc``     ``("acc", offset, typed array, op)``         ``None``
``gacc``    ``("gacc", offset, typed array, op)``        old typed array
``cas``     ``("cas", offset, value, compare, dtype)``   old scalar
==========  ===========================================  ================

Only result-free kinds (``put``/``acc`` -- :data:`DEFERRABLE_OPS`) may be
posted notified; a batch containing any reading op always takes the
reply form so its results travel back on the same round trip.

On remote backends the batched train and the masked-span payload may
additionally ride the lossless wire codec (:mod:`repro_torch.core.codec`):
the origin replaces the raw payload with a tagged
``("encops1"|"enc1", codec_id, header, blob)`` tuple when the roofline
policy predicts a win, and the owner decodes *before* applying -- segment
state and on-disk layout are byte-identical either way.  In-process
backends (this base implementation, ``inproc``, ``ranklocal``,
shared-memory handles) never see encoded payloads.
"""

from __future__ import annotations

import abc
import os

import numpy as np

from ..codec import WireStats

__all__ = ["Transport", "TransportError", "ACC_OPS", "BATCH_OPS",
           "DEFERRABLE_OPS", "ENV_TIMEOUTS", "apply_accumulate",
           "apply_get_accumulate", "apply_compare_and_swap",
           "apply_masked_spans", "apply_op_batch", "env_timeout_s",
           "reduce_values"]


class TransportError(RuntimeError):
    """A transport-level failure (e.g. an unreachable/crashed rank worker)."""


#: Every transport timeout env knob of this package, with its default
#: (seconds).  All backends resolve these through :func:`env_timeout_s` --
#: one table to read, one table to document -- instead of scattered
#: ``os.environ`` lookups.  The names and defaults are the JAX package's:
#:
#: ==========================  =======  ===================================
#: knob                        default  governs
#: ==========================  =======  ===================================
#: REPRO_MP_TIMEOUT            120      mp/spmd control-channel reply wait
#:                                      (0 disables; on expiry the channel
#:                                      is poisoned -- its reply stream is
#:                                      off by one)
#: REPRO_MP_PROBE_TIMEOUT      5        mp/spmd liveness-ping reply wait
#: REPRO_TCP_TIMEOUT           120      tcp control-channel reply wait
#:                                      (0 disables; expiry poisons the
#:                                      connection the same way)
#: REPRO_TCP_PROBE_TIMEOUT     5        tcp liveness-ping reply wait
#: REPRO_TCP_CONNECT_TIMEOUT   10       total tcp dial budget, including
#:                                      retry-with-backoff redials to a
#:                                      peer that is still binding (fleet
#:                                      startup skew) or respawning
#: REPRO_TCP_RETRY_BACKOFF     0.05     initial tcp redial backoff
#:                                      (doubles per retry, capped at 1s)
#: ==========================  =======  ===================================
ENV_TIMEOUTS = {
    "REPRO_MP_TIMEOUT": 120.0,
    "REPRO_MP_PROBE_TIMEOUT": 5.0,
    "REPRO_TCP_TIMEOUT": 120.0,
    "REPRO_TCP_PROBE_TIMEOUT": 5.0,
    "REPRO_TCP_CONNECT_TIMEOUT": 10.0,
    "REPRO_TCP_RETRY_BACKOFF": 0.05,
}


def env_timeout_s(name: str) -> float:
    """Resolve a transport timeout knob: env override or documented default.

    ``name`` must be a key of :data:`ENV_TIMEOUTS` -- an unknown knob is a
    programming error and raises ``KeyError`` rather than silently
    returning a made-up default.  Empty/whitespace values fall back to the
    default; malformed numbers raise ``ValueError`` naming the variable.
    """
    default = ENV_TIMEOUTS[name]
    raw = os.environ.get(name, "").strip()
    if not raw:
        return default
    try:
        return float(raw)
    except ValueError:
        raise ValueError(f"{name}={raw!r} is not a number "
                         f"(seconds; default {default})") from None


#: MPI_Accumulate reduction ops shared by every backend (and by the
#: multiprocess worker's progress loop, which applies them target-side).
ACC_OPS = {
    "sum": np.add, "prod": np.multiply, "min": np.minimum,
    "max": np.maximum, "band": np.bitwise_and, "bor": np.bitwise_or,
    "replace": None, "no_op": None,
}

_REDUCE_OPS = {"sum": "sum", "max": "max", "min": "min"}

#: Sub-op kinds a batched request may carry (see module docstring).
BATCH_OPS = frozenset({"put", "get", "acc", "gacc", "cas"})

#: Result-free sub-ops: the only kinds eligible for notified (no-reply)
#: posting.  Anything that reads must ride the reply form.
DEFERRABLE_OPS = frozenset({"put", "acc"})


def apply_accumulate(seg, offset: int, data: np.ndarray, op: str) -> None:
    """Read-modify-write ``op`` against a segment (caller provides atomicity:
    either the window's target lock or the owner's progress thread)."""
    if op not in ACC_OPS:
        raise ValueError(f"unknown accumulate op {op!r}")
    if op == "no_op":
        return
    data = np.ascontiguousarray(data)
    if op == "replace":
        seg.write(offset, data.view(np.uint8).ravel())
        return
    cur = seg.read(offset, data.nbytes).view(data.dtype).reshape(data.shape)
    out = ACC_OPS[op](cur, data).astype(data.dtype)
    seg.write(offset, out.view(np.uint8).ravel())


def apply_get_accumulate(seg, offset: int, data: np.ndarray,
                         op: str) -> np.ndarray:
    """Fetch the old value, then accumulate; returns the old value."""
    if op not in ACC_OPS:
        raise ValueError(f"unknown accumulate op {op!r}")
    data = np.ascontiguousarray(data)
    old = seg.read(offset, data.nbytes).view(data.dtype).reshape(data.shape)
    if op == "no_op":
        return old
    new = data if op == "replace" else ACC_OPS[op](old, data).astype(data.dtype)
    seg.write(offset, np.ascontiguousarray(new).view(np.uint8).ravel())
    return old


def apply_compare_and_swap(seg, offset: int, value, compare, dtype):
    """Atomic CAS against a segment; returns the old value (scalar)."""
    dt = np.dtype(dtype)
    old = seg.read(offset, dt.itemsize).view(dt)[0]
    if old == np.asarray(compare, dtype=dt):
        seg.write(offset, np.asarray([value], dtype=dt).view(np.uint8).ravel())
    return old


def apply_masked_spans(seg, spans, mask) -> int:
    """Target-side half of the masked span-write primitive.

    Applies the changed byte ``spans`` (``(offset, uint8 array)`` pairs) to
    the segment's memory copy, ORs the block ``mask`` into its dirty
    tracker (segments exposing ``mark_blocks``; conservative -- the mask
    may cover straddled blocks the spans only partially rewrite), then runs
    the masked flush.  This is the whole device-diff epilogue in one call,
    executed wherever the segment's page cache lives: directly for local
    segments, inside the owner's progress thread for remote ones.  Returns
    bytes flushed.
    """
    for offset, data in spans:
        seg.write(offset, np.asarray(data, dtype=np.uint8).ravel())
    mark = getattr(seg, "mark_blocks", None)
    if mask is not None and mark is not None:
        mark(mask)
    return seg.sync(mask=mask)


def _as_u8(data) -> np.ndarray:
    """Normalize a put payload (bytes or any array) to a flat uint8 array."""
    if isinstance(data, (bytes, bytearray, memoryview)):
        return np.frombuffer(data, dtype=np.uint8)
    return np.ascontiguousarray(np.asarray(data)).view(np.uint8).ravel()


def _coalesce_put_runs(run):
    """Merge byte-contiguous successive ``(offset, uint8 array)`` spans.

    This is the owner-side *vectorized span application*: a train of small
    adjacent puts becomes one segment write (one memcpy + one dirty-tracker
    mark) instead of N.  Only exactly-adjacent successors merge, so
    rewrites of the same range keep their issue order.  Returns
    ``(offset, [spans])`` groups; the caller concatenates (keeping the
    constituent spans lets it fall back to per-span application on error).
    """
    groups: list[list] = []
    for off, data in run:
        if groups and groups[-1][0] + groups[-1][1] == off and data.nbytes:
            groups[-1][1] += data.nbytes
            groups[-1][2].append(data)
        else:
            groups.append([off, data.nbytes, [data]])
    return [(off, parts) for off, _nbytes, parts in groups]


def apply_op_batch(seg, ops) -> list:
    """Target-side half of request aggregation: apply a batched op train.

    ``ops`` is a list in the wire form of the module docstring, applied in
    list order under whatever atomicity the caller provides (the window's
    target lock in-process, the owner's service lock remotely) -- the whole
    batch is ONE critical section, which is what makes aggregation cheaper
    than N independent ops even before the round trips are counted.
    Contiguous put runs are coalesced into single span writes.  Returns one
    result slot per op (``None`` for result-free kinds).

    The sub-ops stay as INDEPENDENT as the MPI calls they batch: a failing
    op does not abort its successors -- its exception object fills the op's
    result slot (the origin re-raises it at that op's request, or at the
    flush boundary for a notified train) and application continues.
    """
    results: list = []
    i, n = 0, len(ops)
    while i < n:
        kind = ops[i][0]
        if kind == "put":
            j = i
            while j < n and ops[j][0] == "put":
                j += 1
            run = [(int(off), _as_u8(data)) for _, off, data in ops[i:j]]
            for off, parts in _coalesce_put_runs(run):
                data = parts[0] if len(parts) == 1 else np.concatenate(parts)
                try:
                    seg.write(off, data)
                    results.extend([None] * len(parts))
                except Exception as exc:
                    if len(parts) == 1:
                        results.append(exc)
                        continue
                    # degrade to per-span application: an out-of-range
                    # straggler must not take out its valid neighbors
                    for p in parts:
                        try:
                            seg.write(off, p)
                            results.append(None)
                        except Exception as e:
                            results.append(e)
                        off += p.nbytes
            i = j
            continue
        op = ops[i]
        try:
            if kind == "get":
                raw = seg.read(int(op[1]), int(op[2]))
                results.append(np.asarray(raw, dtype=np.uint8).copy())
            elif kind == "acc":
                apply_accumulate(seg, int(op[1]), op[2], op[3])
                results.append(None)
            elif kind == "gacc":
                results.append(
                    apply_get_accumulate(seg, int(op[1]), op[2], op[3]))
            elif kind == "cas":
                results.append(
                    apply_compare_and_swap(seg, int(op[1]), op[2], op[3],
                                           op[4]))
            else:
                raise TransportError(f"unknown batched op kind {kind!r}")
        except Exception as e:
            results.append(e)
        i += 1
    return results


def reduce_values(contribs, op: str):
    """Reduce a list of per-rank contributions (numpy semantics)."""
    if op not in _REDUCE_OPS:
        raise ValueError(f"unknown allreduce op {op!r}")
    arr = np.asarray(contribs)
    if op == "sum":
        return arr.sum(axis=0)
    if op == "max":
        return arr.max(axis=0)
    return arr.min(axis=0)


class Transport(abc.ABC):
    """One-sided transport over the ranks of a communicator.

    ``size`` is the number of ranks; ``rank`` is the local identity (the
    single-controller driver uses 0 and may address every rank).  Segment
    handles returned by :meth:`allocate_segments` are the only way window
    code touches remote bytes.
    """

    #: short identifier used by the factory / env bootstrap ("inproc", "mp")
    kind: str = "abstract"

    def __init__(self, size: int, rank: int = 0):
        if size < 1:
            raise ValueError("transport size must be >= 1")
        self.size = size
        self.rank = rank
        #: lossless wire-codec negotiation state
        #: (:class:`repro_torch.core.codec.CodecPolicy`); remote backends
        #: install one, in-process backends leave ``None`` -- there is no
        #: wire to save, so their payloads always ship (and apply) raw.
        self.codec_policy = None
        #: logical-vs-wire byte telemetry
        #: (:class:`repro_torch.core.codec.WireStats`) on encoding backends.
        self.wire_stats = None

    def wire_stats_snapshot(self) -> dict:
        """Logical vs wire byte counters (always a well-formed snapshot).

        Backends without a codec policy have no wire to account, but they
        still return the full all-zero counter schema rather than ``None``
        -- stats plumbing (``Window.pool_stats()["wire"]``, benchmark
        reports) never has to branch on the backend kind.
        """
        if self.wire_stats is None:
            return WireStats().snapshot()
        return self.wire_stats.snapshot()

    # -- segment lifecycle -------------------------------------------------
    @abc.abstractmethod
    def allocate_segments(self, size: int, hints, spec: dict) -> list:
        """Collectively allocate one ``size``-byte segment per rank.

        ``hints`` is a :class:`~repro_torch.core.hints.WindowHints`; ``spec`` the
        backing kwargs (``shared_file``, ``memory_budget``, ``mechanism``,
        ``page_size``, ``cache_bytes``, ``writeback_interval``,
        ``compare_on_write``).  Returns segment handles indexed by rank.
        """

    def allocate_segment(self, rank: int, size: int, hints, spec: dict, *,
                         name_rank: int, name_nranks: int):
        """Allocate (or re-map) ONE segment hosted by ``rank``.

        Unlike the collective :meth:`allocate_segments`, this is a targeted
        call: ``name_rank``/``name_nranks`` feed the transport-invariant
        file naming policy, so the segment maps the same on-disk bytes
        whichever rank hosts it (the hook the resilience layer places
        replicas and rebuilds a respawned rank with).
        """
        raise NotImplementedError(
            f"{type(self).__name__} does not support targeted segment "
            "allocation (required for replication/rebuild)")

    # -- liveness ----------------------------------------------------------
    def probe(self, rank: int, timeout: float | None = None) -> bool:
        """Liveness probe: is ``rank`` able to make progress?

        Returns True when the rank is alive (or liveness cannot be
        determined without blocking behind in-flight traffic), False when
        its process is known dead or its control channel is unresponsive.
        Never raises for a dead rank -- failure detectors want a boolean;
        the mp backend converts its internal timeout ``TransportError``
        into False.  In-process ranks cannot die: the default is True.
        """
        if rank < 0 or rank >= self.size:
            raise ValueError(
                f"probe rank {rank} outside transport of size {self.size}")
        return True

    #: does every op from this origin to one target ride a single FIFO
    #: channel, so a later op is applied at the target strictly after
    #: every earlier (even posted/notified) op?  Every backend of this
    #: package guarantees this ("channel-FIFO completion": one conn/socket
    #: per rank, served in receive order) -- it is what makes a blocking
    #: ``get`` after a waited ``rput`` train well-defined without a
    #: flush.  The portable-MPI assumption is False (an RDMA fabric may
    #: reorder), and the runtime sanitizer checks same-epoch data
    #: hazards only where this is False (or REPRO_SANITIZE_PORTABLE=1
    #: forces the portable model).
    ordered_channels = False

    def kill_rank(self, rank: int, timeout: float = 10.0) -> None:
        """SIGKILL ``rank``'s worker (fault injection for failure drills).

        The public alternative to reaching into backend privates:
        process-backed transports (mp, tcp) kill and join the worker;
        backends with no killable worker process refuse.
        """
        raise TransportError(
            f"{self.kind} transport has no worker process to kill "
            f"(rank {rank}); fault injection needs a process-backed "
            "transport (mp, tcp)")

    # -- one-sided data movement ------------------------------------------
    def put(self, seg, offset: int, data: np.ndarray) -> None:
        """Write raw bytes into a (possibly remote) segment's memory copy."""
        seg.write(offset, data)

    def get(self, seg, offset: int, nbytes: int) -> np.ndarray:
        """Read raw bytes from a (possibly remote) segment's memory copy."""
        return seg.read(offset, nbytes)

    def write_spans_masked(self, seg, spans, mask) -> int:
        """Masked span write + flush: the device-diff one-sided primitive.

        The origin ships the changed byte ``spans`` **and** the block
        ``mask`` together; the segment's owner applies the spans to its
        page cache, ORs the mask into its ``DirtyTracker``, and runs the
        masked flush there -- on remote transports this is a single
        control-channel round trip per target rank, so selective device
        sync never degenerates into per-span messages or a full-window
        transfer.  Returns bytes flushed.

        The base implementation covers every transport whose segment
        handles expose ``write``/``sync`` locally (the in-process backend:
        zero behavior change).
        """
        return apply_masked_spans(seg, spans, mask)

    def op_batch(self, seg, ops, defer: bool = False):
        """Aggregated one-sided ops: N small puts/gets/accumulates to one
        target in ONE control-channel message.

        ``ops`` uses the wire form of the module docstring and is applied
        at the target in list order under one service-lock acquisition
        (FIFO per target preserved).  Returns the per-op result list.

        ``defer=True`` requests *notified-access* posting: when every op
        is result-free (:data:`DEFERRABLE_OPS`) a remote backend may send
        the batch with NO reply and return ``None``; the caller learns
        completion -- and any deferred error -- from one later
        :meth:`op_complete` read on the same target.  Backends where the
        batch completes synchronously (this base implementation: segment
        handles with local ``read``/``write``) ignore ``defer`` and always
        return results.
        """
        return apply_op_batch(seg, ops)

    def op_complete(self, seg) -> int:
        """Notified-access completion boundary for ``seg``'s target.

        One read of the target-side applied-batch counter: on return,
        every batch this origin posted with ``op_batch(..., defer=True)``
        has been applied at the target, and the first error any of them
        raised is re-raised here (MPI flush-reports-errors semantics).
        Returns the number of posted batches confirmed -- 0 on transports
        where batches complete synchronously (this base implementation).
        """
        return 0

    @abc.abstractmethod
    def accumulate(self, seg, offset: int, data: np.ndarray, op: str) -> None:
        """MPI_Accumulate, atomic at the target."""

    @abc.abstractmethod
    def get_accumulate(self, seg, offset: int, data: np.ndarray,
                       op: str) -> np.ndarray:
        """MPI_Get_accumulate, atomic at the target; returns the old value."""

    @abc.abstractmethod
    def compare_and_swap(self, seg, offset: int, value, compare, dtype):
        """MPI_Compare_and_swap, atomic at the target; returns the old value."""

    # -- collectives -------------------------------------------------------
    @abc.abstractmethod
    def barrier(self) -> None:
        """Complete outstanding control traffic on every rank."""

    def _check_contributions(self, value):
        """Shared allreduce argument contract.

        A list/tuple is a *per-rank contribution vector* and must have
        exactly ``size`` entries -- a wrong length raises instead of being
        silently passed through, so SPMD call sites fail loudly.  Anything
        else (scalar/array) is treated as already reduced and returned
        as-is by :meth:`allreduce`.
        """
        if isinstance(value, (list, tuple)):
            if len(value) != self.size:
                raise ValueError(
                    f"allreduce expected one contribution per rank "
                    f"({self.size}), got {len(value)}")
            return True
        return False

    def _check_root(self, root: int) -> None:
        """Shared bcast root-range contract."""
        if root < 0 or root >= self.size:
            raise ValueError(
                f"bcast root {root} outside communicator of size {self.size}")

    @abc.abstractmethod
    def allreduce(self, value, op: str = "sum"):
        """Reduce per-rank contributions; see :meth:`_check_contributions`."""

    @abc.abstractmethod
    def bcast(self, value, root: int = 0):
        """Broadcast ``value`` from ``root`` to every rank; returns it."""

    @abc.abstractmethod
    def split(self, color: int, ranks: list[int]) -> "Transport":
        """Transport for a sub-group; local rank ``i`` maps to parent
        ``ranks[i]``."""

    # -- capabilities / lifecycle -----------------------------------------
    @property
    def is_local(self) -> bool:
        """True when every rank's segment lives in this process (enables
        dynamic windows and zero-copy baseptr views)."""
        return False

    def shutdown(self) -> None:
        """Release transport resources (idempotent)."""
