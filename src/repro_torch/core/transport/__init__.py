"""Pluggable transports for MPI-style windows.

``Window``/``Communicator`` never talk to segments or processes directly --
they go through a :class:`Transport`.  This package carries the JAX
package's whole matrix (``repro.core.transport``):

=============  ================================================================
``inproc``     every rank in this process (single-controller; the default).
               *Bootstrap:* none.  *Addressing:* in-process object handles.
               *Failure model:* none -- a crash takes the whole world; the
               storage layout is the recovery story.  Single-host.
``mp``         one spawned worker process per rank.  Memory windows ride
               ``multiprocessing.shared_memory``; storage windows reuse the
               file backings (already cross-process); atomics and storage
               access are serviced by the owner's progress thread over a
               socketpair control channel (passive-target progress), with
               spans and op trains on the lossless wire codec.
               *Bootstrap:* driver spawns the fleet (driver-only,
               ``REPRO_RANK=0``).  *Addressing:* inherited pipes.
               *Failure model:* ``probe`` (process liveness + ping),
               ``kill_rank`` for drills, ``respawn_rank`` replaces dead
               workers; un-synced page-cache bytes die with the worker,
               synced ones restore under any backend.  Single-host.  Two
               origin modes share this transport: *driver-origin* (the
               spawning process issues all application ops -- in this
               package typically the GPU process, whose device syncs
               reach each owner as one ``wsync`` message -- and workers
               are passive targets) and *SPMD program execution*
               (:class:`~repro_torch.core.transport.spmd.SpmdLauncher`
               ships an entry point and every rank becomes an origin over
               its own rank-local transport view, peers dialed over
               authenticated AF_UNIX sockets; the driver shrinks to a
               launcher/monitor issuing zero data-path ops).
``ranklocal``  one externally-launched process *is* one rank: windows
               materialize only this rank's partition (peers are ``None``),
               collectives are rank-local no-ops, but file naming matches
               the other transports exactly, so n such processes produce
               one driver-origin-identical on-disk layout.  Host-agnostic
               (ranks never talk).
``tcp``        the inter-host fabric: every ``Transport`` primitive rides a
               framed TCP control channel (length-prefixed frames, payload
               bytes never pickled), memory windows live in the owning
               rank's address space, storage windows keep the
               byte-identical file layout -- crash on one host, recover on
               another (or under ``mp``/``inproc``).  *Bootstrap:* with a
               ``REPRO_HOSTS``/``REPRO_RENDEZVOUS`` roster each
               externally-launched process joins as rank ``REPRO_RANK``
               of the fleet (:class:`~repro_torch.core.transport.tcp
               .TcpPeerTransport`, SPMD across machines); without one,
               rank 0 spawns a loopback fleet
               (:class:`~repro_torch.core.transport.tcp.TcpTransport`,
               driver-origin -- the CI/conformance configuration).
               *Addressing:* ``host:port`` per rank, lazy-dialed,
               HMAC-authenticated, retry-with-backoff redial to respawned
               peers, hung replies poisoned after ``REPRO_TCP_TIMEOUT``.
               *Failure model:* ``probe`` ping, ``respawn_rank`` spawns a
               replacement (spawned mode) or waits for the external
               launcher to rebind the address (joined mode); replicated
               storage windows fail over across hosts.  Multi-host.
=============  ================================================================

Rank-symmetric bootstrap contract
---------------------------------
Every process -- driver or worker -- resolves its identity the same way:

* ``REPRO_TRANSPORT`` picks the transport kind (``inproc`` default),
  ``REPRO_NRANKS`` the world size, ``REPRO_RANK`` this process's rank.
  Explicit arguments (``Communicator(n, transport=...)``,
  ``make_transport(kind=...)``) always beat the environment.
* ``REPRO_RANK=0`` (or unset) may assume driver identity: it is the only
  rank allowed to *spawn* (the mp transport's workers, a loopback tcp
  fleet, or an :class:`~repro_torch.core.transport.spmd.SpmdLauncher`
  fleet under ``python -m repro_torch.launch.train --spmd``).
* ``REPRO_RANK>0`` means some external launcher already placed this
  process as a worker rank: ``Communicator.from_env`` then returns a
  rank-local view (``ranklocal``) instead of assuming driver identity --
  requesting ``mp`` with a nonzero rank is an error, since that transport
  spawns a fresh world instead of joining one.  Requesting ``tcp`` with a
  nonzero rank requires a roster (``REPRO_HOSTS`` or
  ``REPRO_RENDEZVOUS``) to join.
* Under ``--spmd`` the launcher ships the entry point to spawned ranks,
  which build their own :class:`Communicator` over an internal per-rank
  transport; application code sees the same API in every mode.

The on-disk layout (``<file>.<rank>`` naming, offsets, replica naming) is
byte-identical across all of the above and to the JAX package's, so window
files written by either package under any backend restore under any other
-- including across hosts via ``tcp``.

Timeout/retry knobs (``REPRO_MP_TIMEOUT``, ``REPRO_TCP_TIMEOUT``, ...)
resolve through :func:`repro_torch.core.transport.base.env_timeout_s`; see
:data:`repro_torch.core.transport.base.ENV_TIMEOUTS` for the documented
defaults.  ``REPRO_SANITIZE=1`` wraps every transport
:func:`make_transport` builds in the runtime RMA sanitizer
(:class:`repro_torch.analysis.sanitizer.WindowSanitizer`).
"""

from __future__ import annotations

import os

from .base import ENV_TIMEOUTS, Transport, TransportError, env_timeout_s
from .local import InprocTransport, RankLocalTransport

__all__ = ["Transport", "TransportError", "InprocTransport",
           "RankLocalTransport", "MultiprocessTransport", "SpmdLauncher",
           "TcpTransport", "TcpPeerTransport", "ENV_TIMEOUTS",
           "env_timeout_s", "make_transport", "env_transport_kind",
           "env_nranks", "env_rank", "env_hosts"]

#: valid values of ``REPRO_TRANSPORT`` / ``make_transport(kind=...)``
TRANSPORT_KINDS = ("inproc", "mp", "ranklocal", "tcp")


def __getattr__(name):
    # lazy: importing the mp/spmd/tcp backends pulls in multiprocessing
    # and socket machinery the common in-process path never needs
    if name == "MultiprocessTransport":
        from .multiproc import MultiprocessTransport
        return MultiprocessTransport
    if name == "SpmdLauncher":
        from .spmd import SpmdLauncher
        return SpmdLauncher
    if name == "TcpTransport":
        from .tcp import TcpTransport
        return TcpTransport
    if name == "TcpPeerTransport":
        from .tcp import TcpPeerTransport
        return TcpPeerTransport
    raise AttributeError(name)


def env_transport_kind(default: str = "inproc") -> str:
    return os.environ.get("REPRO_TRANSPORT", "").strip().lower() or default


def env_nranks(default: int | None = None) -> int | None:
    v = os.environ.get("REPRO_NRANKS", "").strip()
    return int(v) if v else default


def env_rank(default: int = 0) -> int:
    v = os.environ.get("REPRO_RANK", "").strip()
    return int(v) if v else default


def env_hosts() -> list[str] | None:
    """The tcp fleet roster, if the environment names one.

    ``REPRO_HOSTS`` is a comma-separated ``host:port`` list (index =
    rank); ``REPRO_RENDEZVOUS`` points at a file with one ``host:port``
    per line (blank lines and ``#`` comments ignored) -- the file form is
    the rendezvous for launchers that materialize the roster after
    scheduling.  ``REPRO_HOSTS`` wins when both are set.  Returns ``None``
    when neither is set.
    """
    raw = os.environ.get("REPRO_HOSTS", "").strip()
    if raw:
        return [h for h in (p.strip() for p in raw.split(",")) if h]
    path = os.environ.get("REPRO_RENDEZVOUS", "").strip()
    if path:
        try:
            with open(path, "r", encoding="utf-8") as f:
                lines = f.readlines()
        except OSError as e:
            raise ValueError(
                f"REPRO_RENDEZVOUS={path!r} is not readable: {e}") from e
        hosts = [ln.strip() for ln in lines]
        return [h for h in hosts if h and not h.startswith("#")]
    return None


def make_transport(size: int, rank: int = 0,
                   kind: str | None = None) -> Transport:
    """Build a transport: ``kind`` or ``$REPRO_TRANSPORT`` or ``inproc``.

    Enforces the rank-symmetric bootstrap contract: a nonzero ``rank``
    never assumes driver identity -- ``inproc``/``mp`` requests from a
    worker-placed process resolve to (or reject toward) the rank-local
    view instead of spawning a second world, and ``tcp`` requests join
    the roster fleet (``REPRO_HOSTS``/``REPRO_RENDEZVOUS``) when one is
    named, else rank 0 spawns a loopback fleet.

    ``REPRO_SANITIZE=1`` wraps the built backend in the runtime RMA
    sanitizer (:class:`repro_torch.analysis.sanitizer.WindowSanitizer`).
    """
    return _maybe_sanitize(_make_transport(size, rank, kind))


def _maybe_sanitize(transport: Transport) -> Transport:
    if os.environ.get("REPRO_SANITIZE", "").strip().lower() in (
            "1", "true", "yes", "on"):
        from ...analysis.sanitizer import maybe_sanitize
        return maybe_sanitize(transport)
    return transport


def _make_transport(size: int, rank: int = 0,
                    kind: str | None = None) -> Transport:
    kind = (kind or env_transport_kind()).strip().lower()
    if kind == "inproc":
        if rank != 0:
            # an externally-launched worker rank: its "in-process world"
            # is just its own partition of the shared file layout
            return RankLocalTransport(size, rank)
        return InprocTransport(size, rank)
    if kind == "ranklocal":
        return RankLocalTransport(size, rank)
    if kind == "mp":
        if rank != 0:
            raise ValueError(
                "the mp transport spawns a fresh worker world and is "
                "driver-only (REPRO_RANK=0); externally-launched worker "
                "ranks use REPRO_TRANSPORT=ranklocal (or tcp with a "
                "REPRO_HOSTS roster), SPMD jobs use --spmd")
        from .multiproc import MultiprocessTransport
        return MultiprocessTransport(size, rank)
    if kind == "tcp":
        hosts = env_hosts()
        if hosts is not None:
            from .tcp import TcpPeerTransport
            return TcpPeerTransport(size, rank, hosts)
        if rank != 0:
            raise ValueError(
                "tcp transport with REPRO_RANK>0 needs a fleet roster to "
                "join: set REPRO_HOSTS to a comma-separated host:port "
                "list (index = rank, length = REPRO_NRANKS) or "
                "REPRO_RENDEZVOUS to a roster file; only REPRO_RANK=0 "
                "may spawn a loopback fleet")
        from .tcp import TcpTransport
        return TcpTransport(size, rank)
    raise ValueError(
        f"unknown transport {kind!r}: REPRO_TRANSPORT (or the explicit "
        f"kind argument) must be one of {', '.join(TRANSPORT_KINDS)}; "
        "the world is sized by REPRO_NRANKS, this process's identity by "
        "REPRO_RANK, and a tcp fleet's roster by REPRO_HOSTS")
