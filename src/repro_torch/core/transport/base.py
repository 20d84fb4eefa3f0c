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
interface; adding the multiprocess and TCP backends (later slices of this
package, see ROADMAP) changes no window or checkpoint code.

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

In-process backends (this base implementation and ``inproc``, the only
backend of this package so far) apply every payload raw: there is no wire
to encode for.
"""

from __future__ import annotations

import abc

import numpy as np

__all__ = ["Transport", "TransportError", "ACC_OPS", "BATCH_OPS",
           "DEFERRABLE_OPS", "WIRE_STATS_KEYS", "apply_accumulate",
           "apply_get_accumulate", "apply_compare_and_swap",
           "apply_masked_spans", "apply_op_batch", "reduce_values"]


class TransportError(RuntimeError):
    """A transport-level failure (e.g. an unreachable/crashed rank worker)."""


#: Logical-vs-wire byte counters of an encoding transport, in the order the
#: JAX package's ``repro.core.codec.WireStats`` reports them.  No backend of
#: this package encodes yet, so :meth:`Transport.wire_stats_snapshot` returns
#: them all zero.
WIRE_STATS_KEYS = ("spans_logical_bytes", "spans_wire_bytes", "spans_msgs",
                   "spans_encoded_msgs", "ops_logical_bytes", "ops_wire_bytes",
                   "ops_msgs", "ops_encoded_msgs")


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

    def wire_stats_snapshot(self) -> dict:
        """Logical vs wire byte counters (always a well-formed snapshot).

        Backends without a codec policy have no wire to account, but they
        still return the full all-zero counter schema rather than ``None``
        -- stats plumbing (``Window.pool_stats()["wire"]``, benchmark
        reports) never has to branch on the backend kind.
        """
        out = {k: 0 for k in WIRE_STATS_KEYS}
        out["logical_bytes"] = 0
        out["wire_bytes"] = 0
        return out

    # -- segment lifecycle -------------------------------------------------
    @abc.abstractmethod
    def allocate_segments(self, size: int, hints, spec: dict) -> list:
        """Collectively allocate one ``size``-byte segment per rank.

        ``hints`` is a :class:`~repro_torch.core.hints.WindowHints`; ``spec`` the
        backing kwargs (``shared_file``, ``memory_budget``, ``mechanism``,
        ``page_size``, ``cache_bytes``, ``writeback_interval``,
        ``compare_on_write``).  Returns segment handles indexed by rank.
        """

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

    # -- liveness ----------------------------------------------------------
    def probe(self, rank: int) -> bool:
        """Is ``rank`` able to make progress?  Never raises for a dead rank:
        failure detectors want a boolean.  In-process ranks cannot die on
        their own, so this default (the ``inproc`` backend's) is True; the
        communicator reports a rank dead once it is marked so."""
        if rank < 0 or rank >= self.size:
            raise ValueError(
                f"probe rank {rank} outside transport of size {self.size}")
        return True

    # -- capabilities / lifecycle -----------------------------------------
    @property
    def is_local(self) -> bool:
        """True when every rank's segment lives in this process (enables
        dynamic windows and zero-copy baseptr views)."""
        return False

    def shutdown(self) -> None:
        """Release transport resources (idempotent)."""
