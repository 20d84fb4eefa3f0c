"""Pluggable transports for MPI-style windows.

``Window``/``Communicator`` never talk to segments or processes directly --
they go through a :class:`Transport`.  This package carries the first
backend of the JAX package's matrix (``repro.core.transport``):

=============  ================================================================
``inproc``     every rank in this process (single-controller; the default).
               *Bootstrap:* none.  *Addressing:* in-process object handles.
               *Failure model:* none -- a crash takes the whole world; the
               storage layout is the recovery story.  Single-host.
=============  ================================================================

The other kinds (``mp``, ``tcp``, ``ranklocal``) are recognised by name and
raise :class:`NotImplementedError` naming the ROADMAP item (queue A) that
ports them.

Rank-symmetric bootstrap contract
---------------------------------
Every process resolves its identity the same way:

* ``REPRO_TRANSPORT`` picks the transport kind (``inproc`` default),
  ``REPRO_NRANKS`` the world size, ``REPRO_RANK`` this process's rank.
  Explicit arguments (``Communicator(n, transport=...)``,
  ``make_transport(kind=...)``) always beat the environment.
* A nonzero rank would need the rank-local view (``ranklocal``), which is
  not ported yet.

The on-disk layout (``<file>.<rank>`` naming, offsets) is byte-identical to
the JAX package's, so window files written by either package restore under
the other.

``REPRO_SANITIZE`` (the runtime RMA sanitizer) is not honoured yet; it is a
ROADMAP item of its own.
"""

from __future__ import annotations

import os

from .base import Transport, TransportError
from .local import InprocTransport

__all__ = ["Transport", "TransportError", "InprocTransport",
           "make_transport", "env_transport_kind", "env_nranks", "env_rank"]

#: valid values of ``REPRO_TRANSPORT`` / ``make_transport(kind=...)``
TRANSPORT_KINDS = ("inproc", "mp", "ranklocal", "tcp")

#: kinds the JAX package has and this package does not port yet
_NOT_PORTED = ("mp", "ranklocal", "tcp")


def env_transport_kind(default: str = "inproc") -> str:
    return os.environ.get("REPRO_TRANSPORT", "").strip().lower() or default


def env_nranks(default: int | None = None) -> int | None:
    v = os.environ.get("REPRO_NRANKS", "").strip()
    return int(v) if v else default


def env_rank(default: int = 0) -> int:
    v = os.environ.get("REPRO_RANK", "").strip()
    return int(v) if v else default


def make_transport(size: int, rank: int = 0,
                   kind: str | None = None) -> Transport:
    """Build a transport: ``kind`` or ``$REPRO_TRANSPORT`` or ``inproc``.

    Only ``inproc`` at rank 0 exists in this package; every other request
    raises :class:`NotImplementedError` naming the ROADMAP item that ports
    it, never a silent fallback to another backend.
    """
    kind = (kind or env_transport_kind()).strip().lower()
    if kind in _NOT_PORTED or (kind == "inproc" and rank != 0):
        shown = kind if rank == 0 else f"{kind} at rank {rank} (ranklocal)"
        raise NotImplementedError(
            f"transport {shown!r} is not ported to repro_torch yet: see "
            "ROADMAP.md queue A, 'mp/tcp/spmd/ranklocal transports'")
    if kind == "inproc":
        return InprocTransport(size, rank)
    raise ValueError(
        f"unknown transport {kind!r}: REPRO_TRANSPORT (or the explicit "
        f"kind argument) must be one of {', '.join(TRANSPORT_KINDS)}; "
        "the world is sized by REPRO_NRANKS, this process's identity by "
        "REPRO_RANK")
