"""Multiprocess transport: real worker processes under the same windows.

``MultiprocessTransport`` maps each communicator rank onto a spawned worker
process.  Placement of the bytes follows the paper's taxonomy:

* **Memory windows** are backed by ``multiprocessing.shared_memory``: the
  owning worker creates a named segment, the driver attaches, and put/get
  are genuine one-sided load/stores on the shared mapping -- the target
  never participates.
* **Storage (and combined) windows** reuse the existing file backings,
  which are *already cross-process by construction*: the file layout
  produced by :func:`~repro_torch.core.transport.local._make_segment` is
  byte-identical to the in-process transport, so a checkpoint written under
  one backend restores under the other.  The owner's user-level page cache
  (dirty bitmap, selective sync) must live in exactly one process, so
  remote access to these segments is serviced by the owner.
* **Atomics** (accumulate / get_accumulate / compare_and_swap) always
  execute at the target, serialized by its progress thread -- atomic with
  respect to every origin process, not merely threads of one process.

Passive-target progress: each worker runs a dedicated *progress thread*
(`repro-progress-<rank>`) that services RMA requests arriving over a
control channel -- a ``multiprocessing.Pipe(duplex=True)``, which on Unix
is a ``socket.socketpair()``.  The target application never has to enter
MPI calls for an origin to make progress, the property Schuchart et al.
("Quo Vadis MPI RMA?") identify as the precondition for one-sided
semantics to pay off.  The worker's main thread only joins the progress
thread (driver-origin mode: the spawning process issues every application
op, the workers are passive targets).  The JAX package's second mode,
*program execution* (an SPMD launcher ships an entry point and every rank
becomes an origin), is not ported yet: ROADMAP queue A, A14.

This is the JAX package's ``repro.core.transport.multiproc``, message for
message: the same control-channel vocabulary, the same wire codec
(:mod:`repro_torch.core.codec`), the same file layout.  In this package the
origin is typically a GPU process: the device diff runs on the card and
only the changed pages and the block mask cross into the owner's process
(one ``wsync`` message per sync).

Small-op hot path: the control channel also speaks the *aggregated* form
(``opbatch``: N puts/gets/atomics applied under one service-lock
acquisition, one round trip) and its *notified* variant (``opbatch_nb``:
no reply at all; each server thread counts applied batches per window and
the origin confirms a whole train of posts with one later ``notify_read``)
-- the Quo Vadis MPI RMA prescription of request aggregation plus
notified-access completion, which turns N small-op round trips into one.

Failure semantics match the paper's storage-window story: a killed worker
loses its page cache (un-synced data is gone, exactly like a crashed MPI
rank), subsequent operations against it raise :class:`TransportError`, and
a fresh transport over the same files recovers everything that was synced.

Workers are always started with "spawn", the one start method that is
safe once the driver has initialised CUDA or runs threads; they import only
the torch-free storage stack of ``repro_torch.core``: numpy, the codec, the
backings.
"""

from __future__ import annotations

import atexit
import itertools
import multiprocessing
import os
import struct
import threading
import time
from multiprocessing.reduction import ForkingPickler

import numpy as np

from ..codec import (CodecPolicy, WireStats, decode_ops, decode_spans,
                     encode_ops, encode_spans, is_encoded_ops,
                     is_encoded_spans)
from ..hints import WindowHints
from .base import (DEFERRABLE_OPS, Transport, TransportError,
                   apply_accumulate, apply_compare_and_swap,
                   apply_get_accumulate, apply_masked_spans, apply_op_batch,
                   env_timeout_s, reduce_values)
from .local import _make_segment, _MemorySegment

__all__ = ["MultiprocessTransport"]

_READY_TIMEOUT_S = 60.0
_SHUTDOWN_JOIN_S = 5.0


def _call_timeout_s() -> float:
    """Per-request reply timeout (a hung worker must surface as a
    TransportError, not block the driver forever).  Generous by default --
    a legitimate storage sync can take a while on a slow disk; tune with
    ``REPRO_MP_TIMEOUT`` (seconds, 0 disables; defaults documented in
    :data:`repro_torch.core.transport.base.ENV_TIMEOUTS`)."""
    return env_timeout_s("REPRO_MP_TIMEOUT")


def _probe_timeout_s() -> float:
    """Reply timeout for liveness pings -- much tighter than the data-path
    timeout: a probe must answer "dead or alive" quickly, and it only runs
    on an otherwise idle channel (``REPRO_MP_PROBE_TIMEOUT`` seconds)."""
    return env_timeout_s("REPRO_MP_PROBE_TIMEOUT")


#: largest single read or write on a control channel
_IO_CHUNK = 1 << 20


def _send(conn, obj) -> None:
    """``conn.send(obj)``, written in bounded chunks.

    Same framing as :class:`multiprocessing.connection.Connection` (a
    ``!i`` length, or ``-1`` and a ``!Q`` length past 2 GiB, then the
    pickle), so either side may use the stock ``send``/``recv``.
    """
    buf = memoryview(ForkingPickler.dumps(obj))
    n = buf.nbytes
    hdr = (struct.pack("!i", n) if n <= 0x7FFFFFFF
           else struct.pack("!iQ", -1, n))
    # a small message goes out in one write, as Connection.send does
    parts = ((hdr + buf,) if n <= _IO_CHUNK else (hdr, buf))
    fd = conn.fileno()
    for part in map(memoryview, parts):
        off = 0
        while off < part.nbytes:
            off += os.write(fd, part[off:off + _IO_CHUNK])


def _read_exact(fd: int, n: int) -> bytearray:
    out = bytearray(n)
    view = memoryview(out)
    got = 0
    while got < n:
        k = os.readv(fd, [view[got:got + _IO_CHUNK]])
        if k == 0:
            raise EOFError("control channel closed")
        got += k
    return out


def _recv(conn):
    """``conn.recv()`` into one preallocated buffer, in bounded reads.

    ``Connection.recv`` reads a message with reads that each ask for (and
    allocate) every byte still missing; on the H100's host a message of
    hundreds of MB then crawls (``scripts/time_channel.py`` times both
    ways; PERF.md has the numbers).
    """
    fd = conn.fileno()
    n, = struct.unpack("!i", _read_exact(fd, 4))
    if n == -1:
        n, = struct.unpack("!Q", _read_exact(fd, 8))
    return ForkingPickler.loads(_read_exact(fd, n))


def _shm_open(name: str | None, size: int, create: bool):
    from multiprocessing import shared_memory
    if create:
        return shared_memory.SharedMemory(create=True, size=max(1, size))
    return shared_memory.SharedMemory(name=name)


class _ShmBuf:
    """A memory segment over a named shared-memory mapping.

    Worker side it replaces ``_MemorySegment`` as the window's backing;
    driver side it is the handle returned to :class:`Window` -- both views
    alias the same pages, so put/get are direct load/stores (true one-sided
    access), while atomics still route to the owner's progress thread.
    """

    kind = "memory"

    def __init__(self, size: int, *, name: str | None = None,
                 create: bool = False):
        self.size = size
        self._shm = _shm_open(name, size, create)
        self._owner = create
        self.buf = np.frombuffer(self._shm.buf, dtype=np.uint8, count=size) \
            if size else np.zeros(0, dtype=np.uint8)
        self.closed = False

    @property
    def name(self) -> str:
        return self._shm.name

    read = _MemorySegment.read
    write = _MemorySegment.write

    def sync(self, full: bool = False, mask: np.ndarray | None = None) -> int:
        return 0  # nothing to persist

    def close(self, unlink: bool = False, discard: bool = False) -> None:
        if self.closed:
            return
        self.closed = True
        self.buf = np.zeros(0, dtype=np.uint8)
        try:
            self._shm.close()
        except BufferError:
            # a baseptr()/shared_view() view is still alive out there; the
            # mapping stays until that view dies, but unlink still proceeds
            # (the eventual SharedMemory.__del__ may warn -- drop views
            # before free() to close cleanly)
            pass
        if self._owner:
            try:
                self._shm.unlink()
            except FileNotFoundError:
                pass


class _DriverShmBuf(_ShmBuf):
    """Driver-side handle for a worker-owned shared-memory segment.

    Reads/writes are direct load/stores on the attached mapping;
    ``close()`` additionally releases the owner's mapping (the worker
    unlinks, being the creator).  Carries the ``(_rank, _win_id)`` address
    the transport's target-side atomics dispatch on.
    """

    def __init__(self, transport: "MultiprocessTransport", win_id: int,
                 rank: int, size: int, name: str):
        super().__init__(size, name=name)
        self._t = transport
        self._win_id = win_id
        self._rank = rank

    def close(self, unlink: bool = False, discard: bool = False) -> None:
        if self.closed:
            return
        super().close(unlink=unlink, discard=discard)
        self._t._call(self._rank, ("free", self._win_id, unlink, discard))


def _encode_ops(ops) -> list:
    """Batched ops in channel wire form: put payloads as raw bytes (cheap
    to pickle), typed accumulate operands as contiguous arrays."""
    out = []
    for o in ops:
        kind = o[0]
        if kind == "put":
            out.append(("put", int(o[1]),
                        np.ascontiguousarray(np.asarray(o[2], np.uint8)
                                             .ravel()).tobytes()))
        elif kind in ("acc", "gacc"):
            out.append((kind, int(o[1]), np.ascontiguousarray(o[2]), o[3]))
        else:
            out.append(o)
    return out


def _encoded_write_bytes(payload) -> int:
    """Bytes a wire-form batch will write into the target's page cache."""
    total = 0
    for o in payload:
        if o[0] == "put":
            total += len(o[2])
        elif o[0] == "acc":
            total += o[2].nbytes
    return total


def _codec_spans(transport, payload):
    """Origin-side codec gate for a raw ``wsync`` span payload.

    Consults the transport's :class:`~repro_torch.core.codec.CodecPolicy`
    (roofline threshold); returns the wire payload -- the encoded tuple
    when the policy accepts, the raw list otherwise -- and tallies
    logical/wire bytes into the transport's :class:`WireStats`.
    """
    enc, logical, wire = encode_spans(payload, transport.codec_policy)
    if transport.wire_stats is not None:
        transport.wire_stats.add("spans", logical, wire, enc is not None)
    return payload if enc is None else enc


def _codec_ops(transport, payload):
    """Origin-side codec gate for a wire-form op train (put bytes only)."""
    enc, logical, wire = encode_ops(payload, transport.codec_policy)
    if transport.wire_stats is not None:
        transport.wire_stats.add("ops", logical, wire, enc is not None)
    return payload if enc is None else enc


class _RemoteSegment:
    """Driver-side handle for a segment owned by a worker process.

    Storage-backed segments keep their page cache (and ``DirtyTracker``) in
    the owning rank's process; every access is a request serviced by that
    rank's progress thread.  ``sync``/``dirty_bytes`` therefore reflect the
    *owner's* dirty state -- selective synchronization happens where the
    data lives.
    """

    #: no local tracker: the dirty bitmap lives with the owner -- device
    #: masks reach it through :meth:`write_spans_sync` (the ``wsync`` op),
    #: and the window layer reads block geometry from ``page_size``
    tracker = None

    def __init__(self, transport: "MultiprocessTransport", win_id: int,
                 rank: int, meta: dict):
        self._t = transport
        self._win_id = win_id
        self._rank = rank
        self.kind = meta["kind"]
        self.size = meta["size"]
        self.mem_bytes = meta["mem_bytes"]
        self.sto_bytes = meta["sto_bytes"]
        self.page_size = meta["page_size"]
        self.closed = False
        # driver-side upper bound on the owner's dirty bytes: written bytes
        # accumulate, completed syncs drain.  Lets the backpressure charge
        # (Window._flush_charge) avoid a blocking cross-process query that
        # would serialize behind an in-flight sync on this rank's channel.
        self._approx_dirty = 0
        self._approx_lock = threading.Lock()
        # batches posted notified (no reply yet) since the last
        # op_complete boundary on this segment's channel
        self._posted = 0
        #: owner-measured seconds of the last sync's storage I/O (excludes
        #: the channel round trip / queueing this driver observed)
        self.last_sync_io: float | None = None

    @property
    def has_storage(self) -> bool:
        return self.sto_bytes > 0

    def read(self, offset: int, nbytes: int) -> np.ndarray:
        raw = self._t._call(self._rank, ("get", self._win_id, offset, nbytes))
        return np.frombuffer(raw, dtype=np.uint8).copy()

    def write(self, offset: int, data) -> None:
        data = np.ascontiguousarray(np.asarray(data, dtype=np.uint8).ravel())
        self._t._call(self._rank, ("put", self._win_id, offset, data.tobytes()))
        # only storage-backed segments have a sync that ever drains this
        # estimate; charging a pure-memory segment would inflate the
        # backpressure charge forever
        if self.has_storage:
            with self._approx_lock:
                self._approx_dirty = min(self.size,
                                         self._approx_dirty + data.nbytes)

    def op_batch(self, ops, defer: bool = False):
        """Aggregated op train against this owner, one channel message.

        Reply form (``opbatch``) round-trips once and returns per-op
        results.  With ``defer=True`` and a result-free train, the batch
        is *posted* (``opbatch_nb``, no reply): returns ``None`` and the
        owner-side application is confirmed by :meth:`op_complete`.
        """
        payload = _encode_ops(ops)
        written = _encoded_write_bytes(payload)
        wire_payload = _codec_ops(self._t, payload)
        if defer and all(o[0] in DEFERRABLE_OPS for o in payload):
            self._t._post(self._rank,
                          ("opbatch_nb", self._win_id, wire_payload))
            with self._approx_lock:
                self._posted += 1
                if self.has_storage:
                    self._approx_dirty = min(self.size,
                                             self._approx_dirty + written)
            return None
        res = self._t._call(self._rank,
                            ("opbatch", self._win_id, wire_payload))
        if self.has_storage and written:
            with self._approx_lock:
                self._approx_dirty = min(self.size,
                                         self._approx_dirty + written)
        return res

    def op_complete(self) -> int:
        """One ``notify_read`` round trip: the owner's applied-batch count
        for this window (channel FIFO => it covers every batch posted
        before this call) plus the first deferred error, re-raised here."""
        with self._approx_lock:
            posted, self._posted = self._posted, 0
        if not posted:
            return 0
        _count, err = self._t._call(self._rank,
                                    ("notify_read", self._win_id))
        if err is not None:
            raise err
        return posted

    def sync(self, full: bool = False, mask: np.ndarray | None = None) -> int:
        n, io_s = self._t._call(self._rank,
                                ("sync", self._win_id, full, mask))
        self.last_sync_io = io_s
        with self._approx_lock:
            self._approx_dirty = max(0, self._approx_dirty - n)
        return n

    def write_spans_sync(self, spans, mask) -> int:
        """Masked span write + flush, one control-channel round trip: the
        owner's progress thread applies the spans to its page cache, ORs
        the mask into its ``DirtyTracker`` and runs the masked flush --
        the device-diff epilogue without per-span messages.  The span
        payload rides the lossless wire codec when the transport's policy
        accepts (the owner decodes before applying, so its page cache --
        and the on-disk layout -- see exactly the raw bytes)."""
        payload = [(int(off),
                    np.ascontiguousarray(np.asarray(d, np.uint8).ravel())
                    .tobytes())
                   for off, d in spans]
        written = sum(len(raw) for _, raw in payload)
        wire_payload = _codec_spans(self._t, payload)
        n, io_s = self._t._call(self._rank,
                                ("wsync", self._win_id, wire_payload, mask))
        self.last_sync_io = io_s
        with self._approx_lock:
            self._approx_dirty = max(
                0, min(self.size, self._approx_dirty + written) - n)
        return n

    def dirty_bytes(self, mask: np.ndarray | None = None) -> int:
        return self._t._call(self._rank, ("dirty", self._win_id, mask))

    def dirty_bytes_estimate(self, mask: np.ndarray | None = None) -> int:
        """Upper bound on un-synced bytes, computed without touching the
        owner (``mask`` is ignored -- conservative).  Backpressure-charge
        use only; for exact numbers query :meth:`dirty_bytes`."""
        with self._approx_lock:
            return self._approx_dirty

    def close(self, unlink: bool = False, discard: bool = False) -> None:
        if self.closed:
            return
        self.closed = True
        self._t._call(self._rank, ("free", self._win_id, unlink, discard))


def _seg_meta(seg) -> dict:
    """Describe a worker-side segment for the driver's handle."""
    tracker = getattr(seg, "tracker", None)
    kind = getattr(seg, "kind", None) or (
        "combined" if hasattr(seg, "mem_bytes") else
        "storage" if tracker is not None else "memory")
    sto = getattr(seg, "sto_bytes", None)
    if sto is None:
        # a tracker-less memory segment has NO storage tier: advertising
        # seg.size here made remote handles report has_storage=True and
        # charge backpressure for bytes no sync ever drains
        sto = 0 if (tracker is None and kind == "memory") else seg.size
    return {
        "kind": kind,
        "size": seg.size,
        "mem_bytes": getattr(seg, "mem_bytes", 0),
        "sto_bytes": sto,
        "page_size": tracker.page_size if tracker is not None else None,
        "shm": seg.name if isinstance(seg, _ShmBuf) else None,
    }


class _SegmentService:
    """A rank's segment registry plus the target-side op interpreter.

    :func:`_serve` wraps it -- one progress thread, one channel, requests
    interpreted in FIFO order.  :meth:`execute` serializes on the service
    lock all the same, so target-side atomics stay atomic with respect to
    every thread that reaches the service (the JAX package's SPMD and tcp
    modes share one service across several server threads).
    """

    def __init__(self, rank: int):
        self.rank = rank
        self.segments: dict[object, object] = {}
        self.lock = threading.RLock()

    def _require_sync(self, seg, op: str) -> None:
        """A sync-less segment must fail with a message that names the op
        and the window kind, not leak an AttributeError through the
        channel."""
        if not callable(getattr(seg, "sync", None)):
            kind = getattr(seg, "kind", None) or type(seg).__name__
            raise TransportError(
                f"rank {self.rank}: {op!r} is unsupported on a {kind} "
                "window segment with no sync method")

    def execute(self, msg):
        """Interpret one transport op; returns the reply payload (raises to
        signal an error back to the origin)."""
        op = msg[0]
        with self.lock:
            if op == "alloc":
                _, win_id, size, hints_kw, name_rank, name_nranks, spec = msg
                hints = WindowHints(**hints_kw)
                if not hints.is_storage:
                    seg = _ShmBuf(size, create=True)
                else:
                    seg = _make_segment(size, hints, name_rank,
                                        name_nranks, **spec)
                self.segments[win_id] = seg
                return _seg_meta(seg)
            if op == "put":
                _, win_id, offset, raw = msg
                self.segments[win_id].write(offset,
                                            np.frombuffer(raw, np.uint8))
                return None
            if op == "get":
                _, win_id, offset, nbytes = msg
                return self.segments[win_id].read(offset, nbytes).tobytes()
            if op == "acc":
                _, win_id, offset, data, aop = msg
                apply_accumulate(self.segments[win_id], offset, data, aop)
                return None
            if op == "gacc":
                _, win_id, offset, data, aop = msg
                return apply_get_accumulate(self.segments[win_id], offset,
                                            data, aop)
            if op == "cas":
                _, win_id, offset, value, compare, dtype = msg
                return apply_compare_and_swap(self.segments[win_id], offset,
                                              value, compare, dtype)
            if op == "opbatch":
                # request aggregation: the whole op train under this ONE
                # lock acquisition, contiguous put runs coalesced into
                # single span writes (apply_op_batch).  Codec-encoded
                # trains are decoded here, before any byte touches the
                # segment; raw trains pass through untouched.
                _, win_id, ops = msg
                if is_encoded_ops(ops):
                    ops = decode_ops(ops)
                return apply_op_batch(self.segments[win_id], ops)
            if op == "sync":
                _, win_id, full, mask = msg
                seg = self.segments[win_id]
                self._require_sync(seg, "sync")
                # reply carries the owner-side I/O time so the origin's
                # throughput estimate excludes channel queueing
                t0 = time.monotonic()
                n = seg.sync(full=full, mask=mask)
                return (n, time.monotonic() - t0)
            if op == "wsync":
                # masked span write + flush (the device-diff primitive):
                # spans land in this owner's page cache, the mask ORs
                # into its DirtyTracker, and the masked flush runs here
                # -- one round trip carried everything
                _, win_id, spans, mask = msg
                seg = self.segments[win_id]
                self._require_sync(seg, "wsync")
                if is_encoded_spans(spans):
                    # decode-before-apply: the page cache and the files
                    # below it see raw bytes, byte-identical to the
                    # uncompressed path (crash-recovery artifacts stay
                    # cross-compatible whichever side encoded)
                    spans = decode_spans(spans)
                for offset, raw in spans:
                    seg.write(offset, np.frombuffer(raw, np.uint8)
                              if isinstance(raw, (bytes, bytearray))
                              else np.asarray(raw, np.uint8))
                mark = getattr(seg, "mark_blocks", None)
                if mask is not None and mark is not None:
                    mark(mask)
                t0 = time.monotonic()  # time only the storage I/O
                n = seg.sync(mask=mask)
                return (n, time.monotonic() - t0)
            if op == "dirty":
                _, win_id, mask = msg
                seg = self.segments[win_id]
                return (seg.dirty_bytes(mask=mask)
                        if hasattr(seg, "dirty_bytes") else 0)
            if op == "free":
                _, win_id, unlink, discard = msg
                seg = self.segments.pop(win_id, None)
                if seg is not None:
                    seg.close(unlink=unlink, discard=discard)
                return None
            if op == "barrier":
                return None
            if op == "reduce_part":
                # echo the rank's contribution through the process
                # boundary (the driver reduces the gathered parts)
                return np.asarray(msg[1])
            if op == "bcast":
                # driver-origin delivery: ack with the value -- the round
                # trip through the rank's process is the delivery
                return msg[1]
            raise TransportError(f"unknown transport op {op!r}")

    def serve_conn(self, conn, *, ready=None) -> None:
        """Service one origin's control channel until shutdown or EOF.

        ``ping`` is answered without taking the service lock: a probe must
        report "alive" even while another thread holds the lock through a
        long storage sync.
        **AUDIT EXEMPTION (lock discipline):** this is the one sanctioned
        lock-free path on the service.  It is safe because the ping reply
        reads only ``self.rank`` (immutable after construction) and this
        connection's own socket; it never touches the shared
        ``self.segments`` registry.  Likewise the ``nb_count``/``nb_err``
        notified-access dicts below are *thread-confined locals* of this
        connection's server thread -- per-origin by construction, so they
        need no lock.  Every ``segments`` access goes through
        :meth:`execute` (which takes the RLock) or ``close_all`` (which
        swaps the registry under it).

        Notified access lives here, per connection: ``opbatch_nb`` applies
        a batch and sends NO reply, bumping a per-window applied counter
        (first error retained); ``notify_read`` hands that counter + error
        back in one reply.  The state is per origin channel, so each
        origin reads exactly the completions -- and errors -- of its own
        posts.
        """
        nb_count: dict[object, int] = {}
        nb_err: dict[object, BaseException] = {}
        if ready is not None:
            _send(conn, ready)
        while True:
            try:
                msg = _recv(conn)
            except (EOFError, OSError):
                break
            op = msg[0]
            if op == "shutdown":
                try:
                    _send(conn, ("ok", None))
                except (OSError, BrokenPipeError):
                    pass
                break
            if op == "ping":
                # liveness probe: any reply at all proves this server
                # thread is servicing its channel
                try:
                    _send(conn, ("ok", self.rank))
                except (OSError, BrokenPipeError):
                    break
                continue
            if op == "opbatch_nb":
                _, win_id, ops = msg
                try:
                    # per-op errors come back slot-captured (sub-ops are
                    # independent); retain the first for the notify reply
                    for r in self.execute(("opbatch", win_id, ops)):
                        if isinstance(r, BaseException):
                            nb_err.setdefault(win_id, r)
                            break
                except BaseException as e:
                    nb_err.setdefault(win_id, e)
                nb_count[win_id] = nb_count.get(win_id, 0) + 1
                continue  # notified: no reply message at all
            if op == "notify_read":
                _, win_id = msg
                payload = (nb_count.pop(win_id, 0), nb_err.pop(win_id, None))
                try:
                    _send(conn, ("ok", payload))
                except (OSError, BrokenPipeError):
                    break
                except Exception:
                    # unpicklable deferred error: degrade to a description
                    _send(conn, ("ok", (payload[0], TransportError(
                        f"rank {self.rank}: {type(payload[1]).__name__}: "
                        f"{payload[1]}"))))
                continue
            try:
                reply = self.execute(msg)
            except BaseException as e:  # surfaced at the origin's call site
                try:
                    _send(conn, ("err", e))
                except Exception:
                    _send(conn, ("err", TransportError(
                        f"rank {self.rank}: {type(e).__name__}: {e}")))
                continue
            _send(conn, ("ok", reply))

    def close_all(self) -> None:
        with self.lock:
            segs, self.segments = list(self.segments.values()), {}
        for seg in segs:
            try:
                seg.close()
            except Exception:
                pass


def _serve(conn, rank: int) -> None:
    """The progress loop: service passive-target RMA until shutdown.

    One request at a time, in channel FIFO order -- which is what makes the
    target-side atomics atomic and keeps a rank's operations ordered the
    way the window layer's per-rank request FIFO expects.
    """
    service = _SegmentService(rank)
    try:
        service.serve_conn(conn, ready=("ready", rank))
    finally:
        service.close_all()
        try:
            conn.close()
        except Exception:
            pass


def _worker_main(conn, rank: int, spmd: dict | None = None) -> None:
    """Entry point of one rank's worker process.

    Passive-target mode (``spmd=None``, the driver-origin transport): all
    servicing happens on the *progress thread*; the main thread merely
    joins it, mirroring an MPI implementation's asynchronous progress
    engine running beside the application.

    Program-execution mode (``spmd`` carries a launcher's config) is the
    JAX package's SPMD launcher, which this package does not port yet.
    """
    if spmd is not None:
        raise NotImplementedError(
            "SPMD program execution is not ported to repro_torch yet: see "
            "ROADMAP.md queue A, A14 'launch' (the mp transport's "
            "driver-origin mode is)")
    t = threading.Thread(target=_serve, args=(conn, rank),
                         name=f"repro-progress-{rank}", daemon=True)
    t.start()
    t.join()


class MultiprocessTransport(Transport):
    """Spawned worker processes, one per rank, driven over socketpairs."""

    kind = "mp"

    def __init__(self, size: int, rank: int = 0):
        super().__init__(size, rank)
        self._ctx = multiprocessing.get_context("spawn")
        # lossless wire codec: spans/op trains crossing the control channel
        # are encoded per the roofline policy; logical-vs-wire telemetry
        # accumulates here (surfaced via wire_stats_snapshot / pool_stats)
        self.codec_policy = CodecPolicy()
        self.wire_stats = WireStats()
        self._procs = []
        self._conns = []
        self._chan_locks = [threading.Lock() for _ in range(size)]
        # serializes respawn_rank's proc/conn/lock slot swaps against each
        # other; readers (_call/_post/probe) instead fetch the conn only
        # AFTER acquiring the channel lock, so a swapped-in channel is
        # never mixed with a pre-swap conn handle
        self._respawn_lock = threading.Lock()
        self._win_ids = itertools.count()
        self._id_lock = threading.Lock()
        self._shutdown_done = False
        try:
            for r in range(size):
                p, parent = self._spawn_worker(r)
                self._procs.append(p)
                self._conns.append(parent)
            for r, conn in enumerate(self._conns):
                self._await_ready(r, conn)
        except BaseException:
            self.shutdown()
            raise
        atexit.register(self.shutdown)

    def _spawn_worker(self, rank: int):
        # duplex Pipe == socket.socketpair() on Unix: the control
        # channel the progress thread services
        parent, child = self._ctx.Pipe(duplex=True)
        p = self._ctx.Process(target=_worker_main, args=(child, rank),
                              name=f"repro-rank-{rank}", daemon=True)
        p.start()
        child.close()
        return p, parent

    @staticmethod
    def _await_ready(rank: int, conn) -> None:
        if not conn.poll(_READY_TIMEOUT_S):
            raise TransportError(f"rank {rank} worker did not start")
        try:
            tag, got = _recv(conn)
        except (EOFError, OSError) as e:
            # the child died before its handshake (an import error, or a
            # main module that spawns at import time)
            raise TransportError(
                f"rank {rank} worker died during start-up") from e
        if tag != "ready" or got != rank:
            raise TransportError(f"rank {rank} worker handshake failed")

    # -- control channel ---------------------------------------------------
    def _call(self, rank: int, msg):
        timeout = _call_timeout_s()
        with self._chan_locks[rank]:
            # conn is read under the channel lock: respawn_rank swaps the
            # conn slot before the lock slot, so a caller on the new lock
            # always sees the new channel (never the poisoned one)
            conn = self._conns[rank]
            try:
                _send(conn, msg)
                if timeout > 0 and not conn.poll(timeout):
                    # poison the channel: the reply stream is now off by
                    # one (a late reply would be read as the *next* call's
                    # payload), so this rank must never be reused
                    try:
                        conn.close()
                    except Exception:
                        pass
                    raise TransportError(
                        f"rank {rank} worker did not reply within "
                        f"{timeout:.0f}s (hung channel; see REPRO_MP_TIMEOUT)")
                status, payload = _recv(conn)
            except (EOFError, OSError, BrokenPipeError) as e:
                alive = self._procs[rank].is_alive()
                raise TransportError(
                    f"rank {rank} worker is unreachable"
                    f" ({'hung channel' if alive else 'process died'})"
                ) from e
        if status == "err":
            raise payload
        return payload

    def _post(self, rank: int, msg) -> None:
        """Fire-and-forget send (notified access): no reply is consumed, so
        the request/reply stream stays aligned for the next ``_call``."""
        with self._chan_locks[rank]:
            conn = self._conns[rank]  # under the lock, as in _call
            try:
                _send(conn, msg)
            except (EOFError, OSError, BrokenPipeError) as e:
                alive = self._procs[rank].is_alive()
                raise TransportError(
                    f"rank {rank} worker is unreachable"
                    f" ({'hung channel' if alive else 'process died'})"
                ) from e

    def _next_win_id(self) -> int:
        with self._id_lock:
            return next(self._win_ids)

    # -- segments ----------------------------------------------------------
    def _alloc_one(self, rank: int, win_id: int, size: int, hints,
                   spec: dict, name_rank: int, name_nranks: int):
        meta = self._call(rank, ("alloc", win_id, size, dict(hints.__dict__),
                                 name_rank, name_nranks, dict(spec)))
        if meta["shm"] is not None:
            return _DriverShmBuf(self, win_id, rank, size, meta["shm"])
        return _RemoteSegment(self, win_id, rank, meta)

    def allocate_segments(self, size: int, hints, spec: dict) -> list:
        win_id = self._next_win_id()
        return [self._alloc_one(r, win_id, size, hints, spec, r, self.size)
                for r in range(self.size)]

    def allocate_segment(self, rank: int, size: int, hints, spec: dict, *,
                         name_rank: int, name_nranks: int):
        """Targeted allocation: ``rank``'s worker hosts (and owns the page
        cache of) a segment named after ``name_rank``'s partition -- replica
        placement and post-respawn rebuild."""
        return self._alloc_one(rank, self._next_win_id(), size, hints, spec,
                               name_rank, name_nranks)

    # -- liveness / recovery -----------------------------------------------
    def probe(self, rank: int, timeout: float | None = None) -> bool:
        """Liveness of ``rank``'s worker.

        Two-level check: the worker *process* first (cheap ``is_alive`` --
        catches SIGKILL immediately), then, only if the control channel is
        idle, a ``ping`` round trip with a tight timeout (catches a live
        process whose progress thread stopped servicing its channel).  A
        busy channel is treated as alive -- queueing a ping behind an
        in-flight storage sync would misreport a slow disk as a death.
        The internal ``TransportError`` paths all surface as False.
        """
        super().probe(rank)  # range check
        if not self._procs[rank].is_alive():
            return False
        lk = self._chan_locks[rank]
        if not lk.acquire(blocking=False):
            return True  # channel busy being serviced => making progress
        try:
            conn = self._conns[rank]
            _send(conn, ("ping",))
            if not conn.poll(timeout if timeout is not None
                             else _probe_timeout_s()):
                # unresponsive: poison the channel (a late reply would
                # desync the request/reply stream, same as _call's timeout)
                try:
                    conn.close()
                except Exception:
                    pass
                return False
            status, payload = _recv(conn)
            return status == "ok"
        except (EOFError, OSError, BrokenPipeError):
            return False
        finally:
            lk.release()

    def respawn_rank(self, rank: int) -> None:
        """Replace a dead rank's worker with a freshly spawned one.

        The new worker starts with no segments -- callers (the window
        layer's rebuild) must re-allocate everything the rank hosted via
        :meth:`allocate_segment`.  Refuses to replace a *responsive*
        worker; a process that is technically alive but probe-dead (wedged
        progress thread, channel poisoned by a ``_call`` timeout) is
        terminated first -- both death modes must be recoverable, and its
        channel is already unusable.
        """
        with self._respawn_lock:
            old = self._procs[rank]
            if old.is_alive():
                if self.probe(rank):
                    raise TransportError(
                        f"rank {rank} worker is alive and responsive; "
                        "refusing to respawn")
                old.terminate()
                old.join(timeout=_SHUTDOWN_JOIN_S)
                if old.is_alive():
                    old.kill()
            old.join(timeout=_SHUTDOWN_JOIN_S)
            try:
                self._conns[rank].close()
            except Exception:
                pass
            p, parent = self._spawn_worker(rank)
            self._await_ready(rank, parent)
            self._procs[rank] = p
            # conn slot swaps BEFORE the lock slot: _call/_post read the
            # conn after acquiring the lock, so anyone who lands on the
            # fresh lock is guaranteed the fresh channel
            self._conns[rank] = parent
            # fresh lock: the old channel may have been poisoned mid-_call
            self._chan_locks[rank] = threading.Lock()

    def kill_rank(self, rank: int, timeout: float = 10.0) -> None:
        """SIGKILL ``rank``'s worker process (fault injection).

        The public surface for failure drills (examples/benchmarks/tests)
        -- reaching into ``_procs`` pins callers to one backend.  Joins the
        corpse so ``probe`` observes the death immediately.
        """
        super().probe(rank)  # range check
        p = self._procs[rank]
        p.kill()
        p.join(timeout=timeout)

    # -- target-side atomics ----------------------------------------------
    @staticmethod
    def _addr(seg) -> tuple[int, int]:
        return seg._rank, seg._win_id

    def accumulate(self, seg, offset, data, op):
        rank, win_id = self._addr(seg)
        self._call(rank, ("acc", win_id, offset,
                          np.ascontiguousarray(data), op))

    def get_accumulate(self, seg, offset, data, op):
        rank, win_id = self._addr(seg)
        return self._call(rank, ("gacc", win_id, offset,
                                 np.ascontiguousarray(data), op))

    def compare_and_swap(self, seg, offset, value, compare, dtype):
        rank, win_id = self._addr(seg)
        return self._call(rank, ("cas", win_id, offset, value, compare,
                                 np.dtype(dtype)))

    def write_spans_masked(self, seg, spans, mask):
        """Device-diff primitive over the control channel: spans + mask in
        one ``wsync`` message, applied and flushed by the owner's progress
        thread.  Driver-side shared-memory handles (memory windows) apply
        locally -- they alias the owner's pages and have nothing to flush."""
        if isinstance(seg, _ShmBuf):
            return apply_masked_spans(seg, spans, mask)
        return seg.write_spans_sync(spans, mask)

    def op_batch(self, seg, ops, defer: bool = False):
        """Aggregated op train: one channel message however many ops.

        Shared-memory handles (memory windows) apply puts/gets as direct
        load/stores; a batch containing any atomic still ships whole to
        the owner so the entire train runs under one service-lock
        acquisition.  Remote segments speak ``opbatch``/``opbatch_nb``
        (see :meth:`_RemoteSegment.op_batch`).
        """
        if isinstance(seg, _ShmBuf):
            if any(o[0] in ("acc", "gacc", "cas") for o in ops):
                rank, win_id = self._addr(seg)
                return self._call(rank, ("opbatch", win_id,
                                         _codec_ops(self, _encode_ops(ops))))
            return apply_op_batch(seg, ops)
        return seg.op_batch(ops, defer=defer)

    def op_complete(self, seg) -> int:
        if isinstance(seg, _ShmBuf):
            return 0  # load/stores (and reply-form atomics) are complete
        return seg.op_complete()

    # -- collectives -------------------------------------------------------
    def _barrier_on(self, ranks) -> None:
        # channel FIFO: by the time each worker acks, it has serviced every
        # operation sent before the barrier -- completion across all ranks
        for r in ranks:
            self._call(r, ("barrier",))

    def barrier(self) -> None:
        self._barrier_on(range(self.size))

    def _reduce_on(self, ranks, value, op: str):
        contribs = [self._call(r, ("reduce_part", np.asarray(v)))
                    for r, v in zip(ranks, value)]
        return reduce_values(contribs, op)

    def allreduce(self, value, op: str = "sum"):
        if self._check_contributions(value):
            return self._reduce_on(range(self.size), value, op)
        return value

    def _bcast_on(self, ranks, value, root: int):
        if root not in ranks:
            raise ValueError(f"bcast root {root} outside group {list(ranks)}")
        out = value
        for r in ranks:
            got = self._call(r, ("bcast", value))
            if r == root:
                out = got  # the root's echo proves the round trip
        return out

    def bcast(self, value, root: int = 0):
        self._check_root(root)
        return self._bcast_on(range(self.size), value, root)

    def split(self, color: int, ranks: list[int]) -> "Transport":
        return _MpSubTransport(self, ranks)

    # -- lifecycle ---------------------------------------------------------
    def shutdown(self) -> None:
        """Stop the workers (idempotent; robust to already-dead children)."""
        if self._shutdown_done:
            return
        self._shutdown_done = True
        atexit.unregister(self.shutdown)  # don't retain closed transports
        for r, conn in enumerate(self._conns):
            with self._chan_locks[r]:
                try:
                    _send(conn, ("shutdown",))
                    if conn.poll(_SHUTDOWN_JOIN_S):
                        _recv(conn)
                except (EOFError, OSError, BrokenPipeError):
                    pass
        for p in self._procs:
            p.join(timeout=_SHUTDOWN_JOIN_S)
            if p.is_alive():
                p.terminate()
                p.join(timeout=_SHUTDOWN_JOIN_S)
        for conn in self._conns:
            try:
                conn.close()
            except Exception:
                pass


class _MpSubTransport(Transport):
    """Rank-translated view of a parent multiprocess transport.

    Sub-group rank ``i`` is served by the parent's worker ``ranks[i]``;
    windows allocated through it exist only on those workers (with
    group-local file naming, matching what an in-process sub-communicator
    would produce).  The parent owns the worker processes -- shutting a
    sub-transport down is a no-op.
    """

    kind = "mp"

    def __init__(self, parent: MultiprocessTransport, ranks: list[int]):
        super().__init__(len(ranks))
        self.parent = parent
        self.ranks = list(ranks)

    def allocate_segments(self, size: int, hints, spec: dict) -> list:
        win_id = self.parent._next_win_id()
        return [self.parent._alloc_one(pr, win_id, size, hints, spec,
                                       i, self.size)
                for i, pr in enumerate(self.ranks)]

    def allocate_segment(self, rank: int, size: int, hints, spec: dict, *,
                         name_rank: int, name_nranks: int):
        return self.parent._alloc_one(self.ranks[rank],
                                      self.parent._next_win_id(), size,
                                      hints, spec, name_rank, name_nranks)

    def probe(self, rank: int, timeout: float | None = None) -> bool:
        super().probe(rank)  # range check against the group size
        return self.parent.probe(self.ranks[rank], timeout)

    def respawn_rank(self, rank: int) -> None:
        self.parent.respawn_rank(self.ranks[rank])

    # segment handles are bound to their worker channel; delegate verbatim
    def accumulate(self, seg, offset, data, op):
        self.parent.accumulate(seg, offset, data, op)

    def get_accumulate(self, seg, offset, data, op):
        return self.parent.get_accumulate(seg, offset, data, op)

    def compare_and_swap(self, seg, offset, value, compare, dtype):
        return self.parent.compare_and_swap(seg, offset, value, compare, dtype)

    def write_spans_masked(self, seg, spans, mask):
        return self.parent.write_spans_masked(seg, spans, mask)

    def op_batch(self, seg, ops, defer: bool = False):
        return self.parent.op_batch(seg, ops, defer=defer)

    def op_complete(self, seg) -> int:
        return self.parent.op_complete(seg)

    def barrier(self) -> None:
        self.parent._barrier_on(self.ranks)

    def allreduce(self, value, op: str = "sum"):
        if self._check_contributions(value):
            return self.parent._reduce_on(self.ranks, value, op)
        return value

    def bcast(self, value, root: int = 0):
        self._check_root(root)
        return self.parent._bcast_on(self.ranks, value, self.ranks[root])

    def split(self, color: int, ranks: list[int]) -> "Transport":
        return _MpSubTransport(self.parent, [self.ranks[r] for r in ranks])

    def shutdown(self) -> None:
        pass  # the parent owns the workers
