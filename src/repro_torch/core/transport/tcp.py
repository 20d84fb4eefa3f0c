"""Inter-host TCP transport: storage windows across machines.

Every backend so far keeps all ranks on one host (pipes, AF_UNIX, shared
memory).  This module takes the same passive-target model across machines:
each rank is a standalone process reachable at ``host:port``, every
:class:`~repro_torch.core.transport.base.Transport` primitive rides a framed TCP
control channel, and the on-disk layout stays byte-identical to every
other backend (``_make_segment`` is the single naming policy) -- so a job
can crash on one host and recover on another, or under ``mp``/``inproc``.

Two bootstrap modes share all of the machinery:

* **Spawned fleet** (:class:`TcpTransport`, the default for
  ``REPRO_TRANSPORT=tcp`` with no host roster): the driver spawns one
  worker process per rank on this host, each binding an ephemeral loopback
  listener and reporting its port over a bootstrap pipe.  Driver-origin,
  like ``mp`` -- but all traffic crosses real sockets, which is the
  loopback/CI configuration of the multi-host fabric (and what the
  conformance suite runs).
* **Joined fleet** (:class:`TcpPeerTransport`, selected when
  ``REPRO_HOSTS``/``REPRO_RENDEZVOUS`` name the roster): each externally
  launched process *is* one rank (SPMD, like ``--spmd`` mode), binds its
  listed address, serves peers, and originates its own traffic.
  Collectives run as coordinator rounds hosted by rank 0 over a dedicated
  connection, with the same positional matching + completed-round cache as
  the SPMD launcher's coordinator.

Wire format
-----------
Length-prefixed frames: a fixed header (magic, version, skeleton length,
blob length), a pickled *skeleton* of the message in which every payload
buffer (``bytes``/``ndarray`` leaves) has been replaced by a
:class:`_Blob` placeholder, then the raw buffers concatenated verbatim.
Payload bytes therefore never pass through pickle -- a put of N bytes
costs N wire bytes plus a small skeleton, numpy arrays cross with dtype
and shape but no serializer overhead, and the aggregated op trains and
the span-wire codec apply unchanged (the codec's ``("encops1"|"enc1",
...)`` tuples carry their compressed blobs as ``bytes`` leaves, which ride
the same blob region).

Connections are lazy-dialed with retry-with-backoff (a fleet peer may
still be binding; a respawned peer rebinds), authenticated by an HMAC
challenge/response on a shared fleet token (the token never crosses the
wire; this prevents cross-talk between fleets, not a hostile network --
tunnel the links if you have one), and poisoned on a reply timeout exactly
like ``multiproc._call`` (the reply stream would be off by one).  All
timeout knobs resolve through
:data:`repro_torch.core.transport.base.ENV_TIMEOUTS` (``REPRO_TCP_TIMEOUT``,
``REPRO_TCP_PROBE_TIMEOUT``, ``REPRO_TCP_CONNECT_TIMEOUT``,
``REPRO_TCP_RETRY_BACKOFF``).

Failure model: ``probe`` = process liveness (spawned mode) plus a
ping round trip on an idle channel; a dead rank surfaces as
``TransportError`` at the origin's call site, replicated storage windows
fail over to the next live holder, and ``respawn_rank`` either spawns a
replacement worker (spawned mode) or waits, bounded, for the external
launcher to restart the peer at its configured address (joined mode).

This is the JAX package's ``repro.core.transport.tcp``: the same frame
layout (header, pickled skeleton, blob region) and handshake, and the same
files, so a job crashed under either package recovers under the other.
Spawned workers are always started with "spawn" and import only the
torch-free storage stack; a rank of a joined fleet whose application runs
on the card is an origin of device syncs like any driver.
"""

from __future__ import annotations

import atexit
import hashlib
import hmac
import itertools
import multiprocessing
import os
import pickle
import select
import socket
import struct
import threading
import time

import numpy as np

from ..codec import CodecPolicy, WireStats
from .base import Transport, TransportError, env_timeout_s, reduce_values
from .multiproc import (_MpSubTransport, _READY_TIMEOUT_S, _RemoteSegment,
                        _SegmentService, _SHUTDOWN_JOIN_S)
from .spmd import _WorkerSubTransport, _WorkerTransport

__all__ = ["TcpTransport", "TcpPeerTransport"]


# -- framing -----------------------------------------------------------------

_MAGIC = b"RW"
_VERSION = 1
#: magic, version, pad, skeleton nbytes, blob nbytes
_HDR = struct.Struct("!2sBxIQ")
#: refuse frames past this (corrupt header / desynced stream, not data)
_MAX_FRAME = 1 << 34
#: payload buffers smaller than this stay in the pickled skeleton -- a
#: placeholder would cost more than it saves
_BLOB_MIN = 32


class _Blob:
    """Placeholder left in a frame's skeleton where a payload buffer was
    extracted; records the buffer's length (and dtype/shape for arrays --
    ``dtype is None`` means a ``bytes`` payload) so the receiver can carve
    it back out of the frame's blob region in traversal order."""

    __slots__ = ("nbytes", "dtype", "shape")

    def __init__(self, nbytes: int, dtype=None, shape=None):
        self.nbytes = nbytes
        self.dtype = dtype
        self.shape = shape

    def __getstate__(self):
        return (self.nbytes, self.dtype, self.shape)

    def __setstate__(self, state):
        self.nbytes, self.dtype, self.shape = state


def _strip(obj, blobs: list):
    """Replace payload-buffer leaves with :class:`_Blob` placeholders,
    appending the raw buffers to ``blobs`` (traversal order = blob-region
    order).  Containers are rebuilt; everything else pickles as-is."""
    if isinstance(obj, np.ndarray):
        if obj.dtype.hasobject or obj.nbytes < _BLOB_MIN:
            return obj
        a = np.ascontiguousarray(obj)
        blobs.append(a)
        return _Blob(a.nbytes, str(a.dtype), a.shape)
    if isinstance(obj, (bytes, bytearray, memoryview)):
        b = obj if isinstance(obj, bytes) else bytes(obj)
        if len(b) < _BLOB_MIN:
            return b
        blobs.append(b)
        return _Blob(len(b))
    if isinstance(obj, tuple):
        return tuple(_strip(o, blobs) for o in obj)
    if isinstance(obj, list):
        return [_strip(o, blobs) for o in obj]
    if isinstance(obj, dict):
        return {k: _strip(v, blobs) for k, v in obj.items()}
    return obj


def _restore(obj, blob, pos: list):
    """Inverse of :func:`_strip`: rebuild the message, carving each
    placeholder's bytes out of ``blob`` at the running offset."""
    if isinstance(obj, _Blob):
        off = pos[0]
        pos[0] = off + obj.nbytes
        if obj.dtype is None:
            return bytes(blob[off:off + obj.nbytes])
        dt = np.dtype(obj.dtype)
        count = obj.nbytes // dt.itemsize if dt.itemsize else 0
        return np.frombuffer(blob, dtype=dt, count=count,
                             offset=off).reshape(obj.shape)
    if isinstance(obj, tuple):
        return tuple(_restore(o, blob, pos) for o in obj)
    if isinstance(obj, list):
        return [_restore(o, blob, pos) for o in obj]
    if isinstance(obj, dict):
        return {k: _restore(v, blob, pos) for k, v in obj.items()}
    return obj


def _recv_exact(sock: socket.socket, n: int) -> bytearray:
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        r = sock.recv_into(view[got:], n - got)
        if r == 0:
            raise EOFError("connection closed")
        got += r
    return buf


class _NetStats:
    """Socket-fabric telemetry: frames/bytes both directions, all
    connections of one transport (header + skeleton + payload -- the
    codec's :class:`WireStats` counts payload-level logical-vs-wire
    bytes; this counts what actually hit the fabric)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.frames_tx = 0
        self.frames_rx = 0
        self.bytes_tx = 0
        self.bytes_rx = 0

    def add_tx(self, nbytes: int) -> None:
        with self._lock:
            self.frames_tx += 1
            self.bytes_tx += nbytes

    def add_rx(self, nbytes: int) -> None:
        with self._lock:
            self.frames_rx += 1
            self.bytes_rx += nbytes

    def snapshot(self) -> dict:
        with self._lock:
            return {"frames_tx": self.frames_tx, "frames_rx": self.frames_rx,
                    "bytes_tx": self.bytes_tx, "bytes_rx": self.bytes_rx}


class _FramedConn:
    """Framed-socket adapter with the ``multiprocessing`` Connection API
    (``send``/``recv``/``poll``/``close``), so
    :meth:`_SegmentService.serve_conn` and :class:`_RemoteSegment` speak
    to it exactly like a pipe.  ``recv`` raises ``EOFError`` on a clean
    peer close and ``OSError`` on socket failure -- the exception families
    every caller already handles."""

    def __init__(self, sock: socket.socket, net: _NetStats | None = None):
        # small request frames must not wait out Nagle behind a previous
        # partial segment -- latency on the control channel is the product
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._sock = sock
        self._net = net

    def send(self, msg) -> None:
        blobs: list = []
        skel = pickle.dumps(_strip(msg, blobs),
                            protocol=pickle.HIGHEST_PROTOCOL)
        blob_len = sum(b.nbytes if isinstance(b, np.ndarray) else len(b)
                       for b in blobs)
        parts = [_HDR.pack(_MAGIC, _VERSION, len(skel), blob_len), skel]
        for b in blobs:
            parts.append(memoryview(b).cast("B") if isinstance(b, np.ndarray)
                         else b)
        frame = b"".join(parts)
        self._sock.sendall(frame)
        if self._net is not None:
            self._net.add_tx(len(frame))

    def recv(self):
        hdr = bytes(_recv_exact(self._sock, _HDR.size))
        magic, version, skel_len, blob_len = _HDR.unpack(hdr)
        if magic != _MAGIC or version != _VERSION:
            raise OSError(f"bad frame header {hdr!r} (desynced or foreign "
                          "peer)")
        if skel_len + blob_len > _MAX_FRAME:
            raise OSError(f"frame of {skel_len + blob_len} bytes exceeds "
                          "the sanity limit (corrupt stream)")
        skel = pickle.loads(bytes(_recv_exact(self._sock, skel_len)))
        blob = _recv_exact(self._sock, blob_len) if blob_len else b""
        if self._net is not None:
            self._net.add_rx(_HDR.size + skel_len + blob_len)
        return _restore(skel, blob, [0])

    def poll(self, timeout: float = 0.0) -> bool:
        r, _, _ = select.select([self._sock], [], [], max(0.0, timeout))
        return bool(r)

    def close(self) -> None:
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass


def _hmac_of(token: bytes, nonce: bytes) -> bytes:
    return hmac.new(token, nonce, hashlib.sha256).digest()


# -- origin-side channel ------------------------------------------------------

class _TcpChannel:
    """One origin's connection to one rank's listener.

    Same contract as the SPMD ``_PeerChannel``: lazy dial, one redial on a
    broken cached connection (heals to a respawned peer at the same or a
    refreshed address -- ``addr_of`` is consulted per dial), reply-timeout
    poison (a late reply would be read as the next call's payload, so the
    connection is dropped, never reused), and a non-blocking-lock ping
    where a busy channel counts as alive.  Dialing retries with backoff
    within the ``REPRO_TCP_CONNECT_TIMEOUT`` budget: connection-refused
    during fleet startup skew or mid-respawn is expected, not fatal.
    """

    def __init__(self, rank: int, addr_of, token: bytes,
                 net: _NetStats | None = None):
        self.rank = rank
        self._addr_of = addr_of  # () -> (host, port); respawn may move ports
        self._token = token
        self._net = net
        self._conn: _FramedConn | None = None
        self._lock = threading.Lock()

    def _drop(self) -> None:
        if self._conn is not None:
            try:
                self._conn.close()
            except Exception:
                pass
            self._conn = None

    def _dial(self, budget: float | None = None) -> _FramedConn:
        host, port = self._addr_of()
        budget = (env_timeout_s("REPRO_TCP_CONNECT_TIMEOUT")
                  if budget is None else budget)
        backoff = env_timeout_s("REPRO_TCP_RETRY_BACKOFF")
        deadline = time.monotonic() + budget
        while True:
            try:
                sock = socket.create_connection(
                    (host, port), timeout=max(0.5, budget))
                conn = _FramedConn(sock, self._net)
                try:
                    # HMAC challenge/response on the shared fleet token
                    if not conn.poll(max(1.0, budget)):
                        raise OSError("no auth challenge from peer")
                    tag, nonce = conn.recv()
                    if tag != "challenge":
                        raise OSError(f"unexpected greeting {tag!r}")
                    conn.send(("hello", _hmac_of(self._token, nonce)))
                    if not conn.poll(max(1.0, budget)):
                        raise OSError("peer did not accept the handshake")
                    status, peer_rank = conn.recv()
                    if status != "ok" or peer_rank != self.rank:
                        raise OSError(
                            f"handshake answered by rank {peer_rank!r}, "
                            f"expected {self.rank} (roster mismatch?)")
                except BaseException:
                    conn.close()
                    raise
                sock.settimeout(None)
                return conn
            except (OSError, EOFError) as e:
                if time.monotonic() >= deadline:
                    raise TransportError(
                        f"rank {self.rank} peer is unreachable at "
                        f"{host}:{port} (dial failed within {budget:.0f}s; "
                        f"see REPRO_TCP_CONNECT_TIMEOUT): {e}") from e
                time.sleep(backoff)
                backoff = min(1.0, backoff * 2)

    def call(self, msg, timeout: float | None = None):
        if timeout is None:
            timeout = env_timeout_s("REPRO_TCP_TIMEOUT")
        with self._lock:
            for attempt in (0, 1):
                try:
                    if self._conn is None:
                        self._conn = self._dial()
                    self._conn.send(msg)
                    if timeout > 0 and not self._conn.poll(timeout):
                        self._drop()
                        raise TransportError(
                            f"rank {self.rank} peer did not reply within "
                            f"{timeout:.0f}s (hung channel; see "
                            "REPRO_TCP_TIMEOUT)")
                    status, payload = self._conn.recv()
                except TransportError:
                    raise
                except (EOFError, OSError) as e:
                    self._drop()
                    if attempt:
                        raise TransportError(
                            f"rank {self.rank} peer is unreachable") from e
                    continue
                if status == "err":
                    raise payload
                return payload

    def post(self, msg, timeout: float | None = None) -> None:
        """Notified-access send: NO reply read, keeping the request/reply
        stream aligned for the next :meth:`call`."""
        with self._lock:
            for attempt in (0, 1):
                try:
                    if self._conn is None:
                        self._conn = self._dial()
                    self._conn.send(msg)
                    return
                except TransportError:
                    raise
                except (EOFError, OSError) as e:
                    self._drop()
                    if attempt:
                        raise TransportError(
                            f"rank {self.rank} peer is unreachable") from e

    def ping(self, timeout: float | None = None) -> bool:
        if timeout is None:
            timeout = env_timeout_s("REPRO_TCP_PROBE_TIMEOUT")
        if not self._lock.acquire(blocking=False):
            return True  # channel busy being serviced => making progress
        try:
            try:
                if self._conn is None:
                    # bound the dial by the probe budget: "dead or alive"
                    # must come back quickly, not after a full dial budget
                    self._conn = self._dial(budget=timeout)
                self._conn.send(("ping",))
                if not self._conn.poll(timeout):
                    self._drop()  # poisoned: a late pong would desync
                    return False
                status, _ = self._conn.recv()
                return status == "ok"
            except (TransportError, EOFError, OSError):
                self._drop()
                return False
        finally:
            self._lock.release()

    def close(self) -> None:
        with self._lock:
            self._drop()


# -- serving side -------------------------------------------------------------

class _SignalConn:
    """Connection wrapper that flips ``stop`` when a shutdown frame
    arrives, so a worker's main thread can close its listener and exit
    once :meth:`_SegmentService.serve_conn` acks the shutdown."""

    def __init__(self, conn: _FramedConn, stop: threading.Event):
        self._conn = conn
        self._stop = stop

    def send(self, msg) -> None:
        self._conn.send(msg)

    def recv(self):
        msg = self._conn.recv()
        if isinstance(msg, tuple) and msg and msg[0] == "shutdown":
            self._stop.set()
        return msg

    def poll(self, timeout: float = 0.0) -> bool:
        return self._conn.poll(timeout)

    def close(self) -> None:
        self._conn.close()


def _serve_listener(srv: socket.socket, service: _SegmentService,
                    token: bytes, stop: threading.Event, *,
                    handlers=None, net: _NetStats | None = None
                    ) -> threading.Thread:
    """Run a rank's accept loop: every authenticated connection gets its
    own daemon server thread over the shared service (service-lock
    serialization keeps target-side atomics atomic across all origins,
    exactly as under SPMD).  Returns the acceptor thread."""

    def serve_one(sock: socket.socket) -> None:
        conn = _FramedConn(sock, net)
        try:
            nonce = os.urandom(16)
            conn.send(("challenge", nonce))
            if not conn.poll(env_timeout_s("REPRO_TCP_CONNECT_TIMEOUT")):
                conn.close()
                return
            msg = conn.recv()
            if not (isinstance(msg, tuple) and len(msg) == 2
                    and msg[0] == "hello" and isinstance(msg[1], bytes)
                    and hmac.compare_digest(msg[1],
                                            _hmac_of(token, nonce))):
                conn.close()  # wrong fleet (or a port scanner); no reply
                return
            conn.send(("ok", service.rank))
        except (EOFError, OSError):
            conn.close()
            return
        try:
            service.serve_conn(_SignalConn(conn, stop), handlers=handlers)
        finally:
            conn.close()

    def accept_loop() -> None:
        while not stop.is_set():
            try:
                sock, _addr = srv.accept()
            except OSError:
                break  # listener closed (shutdown)
            threading.Thread(target=serve_one, args=(sock,), daemon=True,
                             name=f"repro-tcp-serve-{service.rank}").start()

    t = threading.Thread(target=accept_loop, daemon=True,
                         name=f"repro-tcp-accept-{service.rank}")
    t.start()
    return t


def _tcp_worker_main(boot, rank: int, token: bytes) -> None:
    """Entry point of one spawned tcp rank.

    Binds an ephemeral loopback listener, reports the port over the
    bootstrap pipe, then serves origins until a shutdown frame arrives --
    or the bootstrap pipe breaks, which means the driver died: spawned
    workers must not outlive their fleet as orphans.
    """
    service = _SegmentService(rank, use_shm=False)
    stop = threading.Event()
    srv = socket.create_server(("127.0.0.1", 0))
    boot.send(("ready", rank, srv.getsockname()[1]))

    def watch_driver() -> None:
        try:
            boot.recv()  # the driver never sends: EOF == driver gone
        except (EOFError, OSError):
            pass
        stop.set()

    threading.Thread(target=watch_driver, daemon=True,
                     name=f"repro-tcp-watch-{rank}").start()
    _serve_listener(srv, service, token, stop)
    stop.wait()
    try:
        srv.close()
    except OSError:
        pass
    service.close_all()


# -- spawned fleet (driver-origin) --------------------------------------------

class TcpTransport(Transport):
    """Driver-origin tcp fleet: spawned workers, all traffic over sockets.

    The structural twin of ``MultiprocessTransport`` with the pipe control
    channel replaced by framed TCP and *no shared memory anywhere*: memory
    windows live in the owning rank's address space as plain buffers and
    are served over the channel like storage windows (the multi-host
    memory model -- there is nothing to map across machines).  Storage
    windows keep the byte-identical file layout, so this backend
    interoperates with ``mp``/``inproc`` crash/recovery in both
    directions.
    """

    kind = "tcp"
    # One framed-TCP channel per rank served in receive order:
    # channel-FIFO completion, exactly like mp.
    ordered_channels = True

    def __init__(self, size: int, rank: int = 0):
        super().__init__(size, rank)
        self._ctx = multiprocessing.get_context("spawn")
        self.codec_policy = CodecPolicy()
        self.wire_stats = WireStats()
        self.net = _NetStats()
        self._token = os.urandom(16)
        self._procs: list = []
        self._ports: list[int] = []
        self._boots: list = []  # kept open: worker-side driver-death watch
        self._chans: list[_TcpChannel] = []
        # serializes respawn_rank's proc/port/boot/chan slot swaps; the
        # data path reads each slot once (the channel object itself
        # serializes its wire traffic under its own lock)
        self._respawn_lock = threading.Lock()
        self._win_ids = itertools.count()
        self._id_lock = threading.Lock()
        self._shutdown_done = False
        try:
            for r in range(size):
                p, port, boot = self._spawn_worker(r)
                self._procs.append(p)
                self._ports.append(port)
                self._boots.append(boot)
            self._chans = [self._make_chan(r) for r in range(size)]
        except BaseException:
            self.shutdown()
            raise
        atexit.register(self.shutdown)

    def _spawn_worker(self, rank: int):
        parent, child = self._ctx.Pipe(duplex=True)
        p = self._ctx.Process(target=_tcp_worker_main,
                              args=(child, rank, self._token),
                              name=f"repro-tcp-{rank}", daemon=True)
        p.start()
        child.close()
        try:
            if not parent.poll(_READY_TIMEOUT_S):
                raise TransportError(f"rank {rank} tcp worker did not start")
            tag, got, port = parent.recv()
        except (EOFError, OSError) as e:
            raise TransportError(
                f"rank {rank} tcp worker died during startup") from e
        if tag != "ready" or got != rank:
            raise TransportError(f"rank {rank} tcp worker handshake failed")
        return p, port, parent

    def _make_chan(self, rank: int) -> _TcpChannel:
        # addr resolved per dial: respawn_rank swaps the port in-place
        return _TcpChannel(rank, lambda r=rank: ("127.0.0.1", self._ports[r]),
                           self._token, self.net)

    def net_stats_snapshot(self) -> dict:
        """Socket-fabric frame/byte counters (driver side)."""
        return self.net.snapshot()

    # -- control channel ---------------------------------------------------
    def _call(self, rank: int, msg):
        if not self._procs[rank].is_alive():
            # fail fast: no point burning the dial-retry budget on a
            # process we can see is dead (SIGKILL detection latency)
            raise TransportError(
                f"rank {rank} worker is unreachable (process died)")
        return self._chans[rank].call(msg)

    def _post(self, rank: int, msg) -> None:
        if not self._procs[rank].is_alive():
            raise TransportError(
                f"rank {rank} worker is unreachable (process died)")
        self._chans[rank].post(msg)

    def _next_win_id(self) -> int:
        with self._id_lock:
            return next(self._win_ids)

    # -- segments ----------------------------------------------------------
    def _alloc_one(self, rank: int, win_id: int, size: int, hints,
                   spec: dict, name_rank: int, name_nranks: int):
        meta = self._call(rank, ("alloc", win_id, size, dict(hints.__dict__),
                                 name_rank, name_nranks, dict(spec)))
        return _RemoteSegment(self, win_id, rank, meta)

    def allocate_segments(self, size: int, hints, spec: dict) -> list:
        win_id = self._next_win_id()
        return [self._alloc_one(r, win_id, size, hints, spec, r, self.size)
                for r in range(self.size)]

    def allocate_segment(self, rank: int, size: int, hints, spec: dict, *,
                         name_rank: int, name_nranks: int):
        return self._alloc_one(rank, self._next_win_id(), size, hints, spec,
                               name_rank, name_nranks)

    # -- liveness / recovery -----------------------------------------------
    def probe(self, rank: int, timeout: float | None = None) -> bool:
        """Process liveness first (catches SIGKILL immediately), then a
        ping round trip on an idle channel; busy channel counts as alive
        (see ``MultiprocessTransport.probe`` -- same heuristic)."""
        super().probe(rank)  # range check
        if not self._procs[rank].is_alive():
            return False
        return self._chans[rank].ping(timeout)

    def respawn_rank(self, rank: int) -> None:
        """Replace a dead rank's worker with a freshly spawned one (new
        ephemeral port, fresh channel).  Refuses a responsive worker;
        terminates a probe-dead one first -- same contract as mp."""
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
            self._chans[rank].close()
            try:
                self._boots[rank].close()
            except Exception:
                pass
            p, port, boot = self._spawn_worker(rank)
            self._procs[rank] = p
            # port swaps before the channel: the new channel's dial
            # closure resolves the port per dial, so it can never redial
            # the dead worker's old port
            self._ports[rank] = port
            self._boots[rank] = boot
            self._chans[rank] = self._make_chan(rank)

    def kill_rank(self, rank: int, timeout: float = 10.0) -> None:
        """SIGKILL ``rank``'s worker process (fault injection) -- the
        public surface for failure drills; same contract as mp."""
        super().probe(rank)  # range check
        p = self._procs[rank]
        p.kill()
        p.join(timeout=timeout)

    # -- one-sided data movement -------------------------------------------
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
        # every segment is a remote proxy here -- no shared-memory fast
        # path exists across sockets
        return seg.write_spans_sync(spans, mask)

    def op_batch(self, seg, ops, defer: bool = False):
        return seg.op_batch(ops, defer=defer)

    def op_complete(self, seg) -> int:
        return seg.op_complete()

    # -- collectives -------------------------------------------------------
    def _barrier_on(self, ranks) -> None:
        # channel FIFO: each worker's ack proves it serviced everything
        # sent before the barrier (same completion contract as mp)
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
        return _TcpSubTransport(self, ranks)

    # -- lifecycle ---------------------------------------------------------
    def shutdown(self) -> None:
        if self._shutdown_done:
            return
        self._shutdown_done = True
        atexit.unregister(self.shutdown)
        for r, ch in enumerate(self._chans):
            if self._procs[r].is_alive():
                try:
                    ch.call(("shutdown",), timeout=_SHUTDOWN_JOIN_S)
                except TransportError:
                    pass
            ch.close()
        for boot in self._boots:
            try:
                boot.close()  # breaks the worker-side driver-death watch
            except Exception:
                pass
        for p in self._procs:
            p.join(timeout=_SHUTDOWN_JOIN_S)
            if p.is_alive():
                p.terminate()
                p.join(timeout=_SHUTDOWN_JOIN_S)


class _TcpSubTransport(_MpSubTransport):
    """Rank-translated view of a spawned tcp fleet (``Communicator.split``).

    Identical delegation to the mp sub-transport -- segment handles stay
    bound to their owner's channel -- just the right ``kind``."""

    kind = "tcp"

    def split(self, color: int, ranks: list[int]) -> "Transport":
        return _TcpSubTransport(self.parent, [self.ranks[r] for r in ranks])


# -- joined fleet (every rank an origin) --------------------------------------

class _RoundBoard:
    """Rank-0-hosted collective coordinator for a joined tcp fleet.

    The same matching rule as the SPMD launcher's ``_Coordinator``: rounds
    are keyed ``(participants, position)`` -- the ``pos``-th collective a
    rank issues against a group pairs with every other member's ``pos``-th
    -- and released when all participants contributed.  Completed rounds
    stay cached so a restarted rank replaying its run reads the agreed
    values instead of re-opening the round.  No death exclusion yet: a
    fleet collective blocks until its participants contribute or the
    round times out (ROADMAP: dead-rank exclusion rides the DCN/NCCL
    collectives item).
    """

    def __init__(self):
        self._cond = threading.Condition()
        self._pending: dict[tuple, dict] = {}
        self._cache: dict[tuple, dict] = {}

    def contribute(self, rank: int, ptuple: tuple, pos: int, payload,
                   timeout: float) -> dict:
        key = (tuple(ptuple), pos)
        deadline = (time.monotonic() + timeout) if timeout > 0 else None
        with self._cond:
            done = self._cache.get(key)
            if done is not None:
                return done
            contribs = self._pending.setdefault(key, {})
            contribs[rank] = payload
            if all(r in contribs for r in key[0]):
                self._cache[key] = self._pending.pop(key)
                self._cond.notify_all()
                return self._cache[key]
            while key not in self._cache:
                remaining = (None if deadline is None
                             else deadline - time.monotonic())
                if remaining is not None and remaining <= 0:
                    missing = [r for r in key[0]
                               if r not in self._pending.get(key, {})]
                    raise TransportError(
                        f"collective round {pos} on {key[0]} timed out "
                        f"after {timeout:.0f}s (missing contributions "
                        f"from ranks {missing})")
                self._cond.wait(timeout=remaining)
            return self._cache[key]


class _TcpCollectiveChannel:
    """``_CollectiveChannel``-compatible client of the rank-0 round board.

    Rank 0 contributes directly to its local board; every other rank
    speaks ``("round", rank, ptuple, pos, payload)`` over a *dedicated*
    connection to rank 0's listener (separate from the data channel, so a
    blocking barrier never serializes one-sided traffic behind it).
    """

    def __init__(self, transport: "TcpPeerTransport",
                 board: _RoundBoard | None):
        self._t = transport
        self._board = board
        self._chan: _TcpChannel | None = None
        self._pos: dict[tuple, int] = {}
        self._lock = threading.Lock()

    def round(self, ptuple: tuple, payload, timeout: float) -> dict:
        with self._lock:
            pos = self._pos.get(ptuple, 0)
            self._pos[ptuple] = pos + 1
            if self._board is not None:
                return self._board.contribute(self._t.rank, tuple(ptuple),
                                              pos, payload, timeout)
            if self._chan is None:
                self._chan = _TcpChannel(
                    0, lambda: self._t._addrs[0], self._t._authkey,
                    net=self._t.net)
            try:
                return self._chan.call(
                    ("round", self._t.rank, tuple(ptuple), pos, payload),
                    timeout)
            except TransportError as e:
                raise TransportError(
                    f"rank {self._t.rank}: lost the coordinator "
                    f"(rank 0): {e}") from e

    def send_result(self, tag: str, payload) -> None:
        pass  # no launcher to report to in a joined fleet

    def close(self) -> None:
        with self._lock:
            if self._chan is not None:
                self._chan.close()
                self._chan = None


def _fleet_token(hosts) -> bytes:
    """Shared fleet secret for the HMAC handshake.

    ``REPRO_TCP_AUTHKEY`` when set; otherwise derived deterministically
    from the rank roster, so every externally-launched rank computes the
    same default with no side channel.  Either way the token itself never
    crosses the wire -- but a roster-derived default only prevents
    cross-fleet accidents, not a hostile network: set ``REPRO_TCP_AUTHKEY``
    (and tunnel the links) when that matters.
    """
    key = os.environ.get("REPRO_TCP_AUTHKEY", "")
    if key:
        return key.encode()
    roster = ",".join(h.strip() for h in hosts)
    return hashlib.sha256(f"repro-tcp:{roster}".encode()).digest()


def _parse_endpoint(spec: str) -> tuple[str, int]:
    host, sep, port = spec.strip().rpartition(":")
    if not sep or not port.isdigit():
        raise ValueError(
            f"bad tcp endpoint {spec!r} (expected host:port, e.g. "
            "10.0.0.1:7000 -- one per rank in REPRO_HOSTS order)")
    return (host or "127.0.0.1", int(port))


class TcpPeerTransport(_WorkerTransport):
    """One externally-launched process per rank, addressed by the roster.

    SPMD across machines: this process *is* rank ``rank`` of the fleet
    listed in ``hosts`` (``["host:port", ...]``, index = rank).  It binds
    its own endpoint, serves every peer origin through the shared segment
    service, and originates its own traffic over lazy-dialed peer
    channels -- the origin-side machinery is ``_WorkerTransport``
    unchanged; only the channel fabric (framed TCP instead of AF_UNIX)
    and the collective coordinator (rank-0 round board instead of the
    launcher) differ.  There is no launcher: starting the processes --
    and restarting dead ones -- belongs to the external environment
    (``respawn_rank`` waits, bounded, for the configured address to come
    back).
    """

    kind = "tcp"

    def __init__(self, size: int, rank: int, hosts, *,
                 token: bytes | None = None):
        addrs = [_parse_endpoint(h) for h in hosts]
        if len(addrs) != size:
            raise ValueError(
                f"host roster lists {len(addrs)} endpoints for a fleet of "
                f"{size} ranks (REPRO_HOSTS must name one host:port per "
                "rank)")
        if not 0 <= rank < size:
            raise ValueError(f"rank {rank} outside fleet of {size} "
                             "(REPRO_RANK)")
        self.net = _NetStats()
        service = _SegmentService(rank, use_shm=False)
        super().__init__(rank, size, service, None, addrs,
                         token if token is not None else _fleet_token(hosts))
        self._stop = threading.Event()
        self._board = _RoundBoard() if rank == 0 else None
        self._coll = _TcpCollectiveChannel(self, self._board)
        self._shutdown_done = False
        host, port = addrs[rank]
        try:
            self._listener = socket.create_server((host, port))
        except OSError as e:
            raise TransportError(
                f"rank {rank} could not bind {host}:{port} (its "
                f"REPRO_HOSTS entry): {e}") from e
        handlers = ({"round": self._serve_round}
                    if self._board is not None else None)
        self._acceptor = _serve_listener(self._listener, service,
                                         self._authkey, self._stop,
                                         handlers=handlers, net=self.net)

    def _serve_round(self, msg):
        # runs on the per-connection server thread, outside the service
        # lock -- blocking here (waiting for the other participants) must
        # not wedge one-sided traffic
        _, origin, ptuple, pos, payload = msg
        return self._board.contribute(origin, tuple(ptuple), pos, payload,
                                      self._timeout_s())

    # -- channel fabric ----------------------------------------------------
    def _chan(self, rank: int) -> _TcpChannel:
        with self._chan_lock:
            ch = self._chans.get(rank)
            if ch is None:
                ch = self._chans[rank] = _TcpChannel(
                    rank, lambda r=rank: self._addrs[r], self._authkey,
                    net=self.net)
            return ch

    def _timeout_s(self) -> float:
        return env_timeout_s("REPRO_TCP_TIMEOUT")

    def _probe_s(self) -> float:
        return env_timeout_s("REPRO_TCP_PROBE_TIMEOUT")

    def net_stats_snapshot(self) -> dict:
        """Socket-fabric frame/byte counters (this rank, both roles)."""
        return self.net.snapshot()

    # -- recovery ----------------------------------------------------------
    def respawn_rank(self, rank: int) -> None:
        """Joined-fleet recovery: wait (bounded by
        ``REPRO_TCP_CONNECT_TIMEOUT``) for the external launcher to
        restart the peer at its configured address, then resume -- the
        rebuild path re-allocates its segments exactly as under mp."""
        super().probe(rank)  # range check
        if rank == self.rank:
            raise TransportError("a rank cannot respawn itself")
        deadline = time.monotonic() + env_timeout_s(
            "REPRO_TCP_CONNECT_TIMEOUT")
        probe_t = self._probe_s()
        while True:
            if self._chan(rank).ping(probe_t):
                return
            if time.monotonic() >= deadline:
                host, port = self._addrs[rank]
                raise TransportError(
                    f"rank {rank} has not rebound at {host}:{port}: tcp "
                    "fleet ranks are launched externally -- restart that "
                    "process (its REPRO_HOSTS entry) and retry")
            time.sleep(0.2)

    def split(self, color: int, ranks: list[int]) -> "Transport":
        return _TcpFleetSubTransport(self, list(ranks))

    def shutdown(self) -> None:
        if self._shutdown_done:
            return
        self._shutdown_done = True
        self._stop.set()
        try:
            self._listener.close()
        except OSError:
            pass
        self._coll.close()
        super().shutdown()  # closes peer channels
        self.service.close_all()


class _TcpFleetSubTransport(_WorkerSubTransport):
    """Sub-group view of a joined tcp fleet: collectives run as rank-0
    rounds over the sub-group's global-rank tuple, data ops delegate."""

    kind = "tcp"

    def split(self, color: int, ranks: list[int]) -> "Transport":
        return _TcpFleetSubTransport(self.parent,
                                     [self.ranks[r] for r in ranks])
