"""Pluggable transports for MPI-style windows.

``Window``/``Communicator`` never talk to segments or processes directly --
they go through a :class:`Transport`.  This package carries three backends
of the JAX package's matrix (``repro.core.transport``):

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
               spans and op trains on the lossless wire codec.  The
               spawning process is the only origin (driver-origin mode):
               in this package typically the GPU process, whose device
               syncs reach each owner as one ``wsync`` message.
               *Bootstrap:* driver spawns the fleet (driver-only,
               ``REPRO_RANK=0``).  *Addressing:* inherited pipes.
               *Failure model:* ``probe`` (process liveness + ping),
               ``kill_rank`` for drills, ``respawn_rank`` replaces dead
               workers; un-synced page-cache bytes die with the worker,
               synced ones restore under any backend.  Single-host.
``ranklocal``  one externally-launched process *is* one rank: windows
               materialize only this rank's partition (peers are ``None``),
               collectives are rank-local no-ops, but file naming matches
               the other transports exactly, so n such processes produce
               one driver-origin-identical on-disk layout.  Host-agnostic
               (ranks never talk).
=============  ================================================================

``tcp`` (the inter-host fabric) and the mp transport's SPMD program
execution mode are recognised and raise :class:`NotImplementedError`
naming the ROADMAP item that ports them (queue A: A1's tcp/spmd rest, A14).

Rank-symmetric bootstrap contract
---------------------------------
Every process -- driver or worker -- resolves its identity the same way:

* ``REPRO_TRANSPORT`` picks the transport kind (``inproc`` default),
  ``REPRO_NRANKS`` the world size, ``REPRO_RANK`` this process's rank.
  Explicit arguments (``Communicator(n, transport=...)``,
  ``make_transport(kind=...)``) always beat the environment.
* ``REPRO_RANK=0`` (or unset) may assume driver identity: it is the only
  rank allowed to *spawn* (the mp transport's workers).
* ``REPRO_RANK>0`` means some external launcher already placed this
  process as a worker rank: ``Communicator.from_env`` then returns a
  rank-local view (``ranklocal``) instead of assuming driver identity --
  requesting ``mp`` with a nonzero rank is an error, since that transport
  spawns a fresh world instead of joining one.

The on-disk layout (``<file>.<rank>`` naming, offsets) is byte-identical
across all of the above and to the JAX package's, so window files written
by either package under any backend restore under any other.

Timeout knobs (``REPRO_MP_TIMEOUT``, ``REPRO_MP_PROBE_TIMEOUT``) resolve
through :func:`repro_torch.core.transport.base.env_timeout_s`; see
:data:`repro_torch.core.transport.base.ENV_TIMEOUTS` for the documented
defaults.  ``REPRO_SANITIZE`` (the runtime RMA sanitizer) is not honoured
yet; it is a ROADMAP item of its own (A4).
"""

from __future__ import annotations

import os

from .base import ENV_TIMEOUTS, Transport, TransportError, env_timeout_s
from .local import InprocTransport, RankLocalTransport

__all__ = ["Transport", "TransportError", "InprocTransport",
           "RankLocalTransport", "MultiprocessTransport", "ENV_TIMEOUTS",
           "env_timeout_s", "make_transport", "env_transport_kind",
           "env_nranks", "env_rank", "env_hosts"]

#: valid values of ``REPRO_TRANSPORT`` / ``make_transport(kind=...)``
TRANSPORT_KINDS = ("inproc", "mp", "ranklocal", "tcp")


def __getattr__(name):
    # lazy: importing the mp backend pulls in multiprocessing machinery the
    # common in-process path never needs
    if name == "MultiprocessTransport":
        from .multiproc import MultiprocessTransport
        return MultiprocessTransport
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
    when neither is set.  (The roster's parsing is the JAX package's; the
    tcp backend that joins it is not ported yet.)
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
    view instead of spawning a second world.  ``tcp`` raises
    :class:`NotImplementedError` naming the ROADMAP item that ports it,
    never a silent fallback to another backend.
    """
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
                "ranks use REPRO_TRANSPORT=ranklocal")
        from .multiproc import MultiprocessTransport
        return MultiprocessTransport(size, rank)
    if kind == "tcp":
        raise NotImplementedError(
            "transport 'tcp' is not ported to repro_torch yet: see "
            "ROADMAP.md queue A, A1's tcp/spmd rest (the inter-host "
            "fabric; mp, ranklocal and inproc are ported)")
    raise ValueError(
        f"unknown transport {kind!r}: REPRO_TRANSPORT (or the explicit "
        f"kind argument) must be one of {', '.join(TRANSPORT_KINDS)}; "
        "the world is sized by REPRO_NRANKS, this process's identity by "
        "REPRO_RANK, and a tcp fleet's roster by REPRO_HOSTS")
