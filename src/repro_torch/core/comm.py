"""Communicators: rank bookkeeping, collectives, and the transport binding.

In the paper, windows are collective objects over an MPI communicator.  A
``Communicator`` here owns two things:

* **rank bookkeeping** -- ``size``, a local ``rank`` identity, the window
  registry, and sub-communicator bookkeeping (``split`` with translated
  ranks).
* **a transport** -- the pluggable backend (``repro_torch.core.transport``)
  that decides where each rank's window segments physically live and how
  one-sided operations and collectives reach them.  ``inproc`` (default)
  keeps every rank in this process, exactly the original single-controller
  semantics; ``mp`` maps ranks onto real spawned worker processes with
  shared-memory / file-backed segments and passive-target progress threads;
  ``ranklocal`` is one externally launched rank's view of its own partition.

Selection: ``Communicator(n, transport="mp")`` explicitly, or via the
environment (``REPRO_TRANSPORT`` / ``REPRO_NRANKS`` / ``REPRO_RANK``) with
:meth:`Communicator.from_env` -- the launcher's rank bootstrap.  Collectives
(``barrier``/``allreduce``/``bcast``) delegate to the transport, so under
``mp`` they are real cross-process operations.  Liveness (``dead_ranks``,
``probe``, ``mark_dead``, ``mark_alive``) feeds
:class:`~repro_torch.core.resilience.FailureDetector` and the failover
routing of replicated windows; ``rebuild_rank`` brings a dead rank back.
"""

from __future__ import annotations

from .transport import Transport, env_nranks, env_rank, make_transport

__all__ = ["Communicator"]


class Communicator:
    def __init__(self, size: int = 1, rank: int | None = None,
                 transport: "Transport | str | None" = None):
        if size < 1:
            raise ValueError("communicator size must be >= 1")
        self.size = size
        # In single-controller mode we "are" every rank; ``rank`` is kept for
        # SPMD-style code that wants a local identity.
        self.rank = 0 if rank is None else rank
        if not 0 <= self.rank < size:
            # fail at the bootstrap, not as an IndexError deep in a save():
            # a stale REPRO_RANK from a larger launch is a config error
            raise ValueError(
                f"rank {self.rank} outside communicator of size {size}")
        if isinstance(transport, Transport):
            self.transport = transport
            self._owns_transport = False
        else:
            self.transport = make_transport(size, self.rank, kind=transport)
            self._owns_transport = True
        self._windows: list = []
        self.barrier_count = 0
        # ranks known dead (probe- or error-detected); replicated windows
        # consult this set to fail reads/writes over to live replicas
        self._dead: set[int] = set()
        # sub-communicator bookkeeping (identity mapping at the top level)
        self.color: int | None = None
        self.parent_ranks: tuple[int, ...] = tuple(range(size))

    @classmethod
    def from_env(cls, default_size: int = 1,
                 transport: str | None = None,
                 nranks: int | None = None) -> "Communicator":
        """Rank bootstrap from the environment (used by launchers/examples).

        ``REPRO_TRANSPORT`` picks the backend, ``REPRO_NRANKS`` the world
        size and ``REPRO_RANK`` this process's identity; explicit arguments
        win over the environment.  With nothing set this is simply
        ``Communicator(default_size)``.

        Rank-symmetric: a nonzero ``REPRO_RANK`` never assumes driver
        identity -- the returned communicator is this worker rank's
        rank-local view (see ``repro_torch.core.transport
        .RankLocalTransport``), materializing only its own window
        partitions with the shared on-disk naming.  Requesting the
        (driver-only, world-spawning) ``mp`` transport from a nonzero rank
        raises.  ``REPRO_TRANSPORT=tcp`` with a roster (``REPRO_HOSTS`` or
        ``REPRO_RENDEZVOUS``) joins that fleet as rank ``REPRO_RANK``
        (``TcpPeerTransport``, every rank an origin); without one, rank 0
        spawns a loopback fleet.
        """
        size = nranks if nranks is not None else env_nranks(default_size)
        return cls(size, rank=env_rank(0), transport=transport)

    # -- collectives (delegated to the transport) ---------------------------
    def barrier(self) -> None:
        """Collective barrier.  Under ``mp`` every worker acks its control
        channel, which (channel FIFO) also completes all earlier traffic."""
        self.transport.barrier()
        self.barrier_count += 1

    def allreduce(self, value, op: str = "sum"):
        """Allreduce over per-rank contributions.

        ``value`` is either a list/tuple of per-rank contributions --
        which must have exactly ``size`` entries, a wrong length raises so
        SPMD call sites fail loudly -- or a scalar/array that is already
        reduced and passes through unchanged.
        """
        return self.transport.allreduce(value, op)

    def bcast(self, value, root: int = 0):
        """Broadcast ``value`` from ``root``; returns the broadcast value."""
        return self.transport.bcast(value, root)

    def split(self, color: int, ranks: list[int]) -> "Communicator":
        """MPI_Comm_split-style sub-communicator over ``ranks``.

        ``ranks`` lists the parent ranks joining this ``color`` group, in
        sub-communicator order: sub rank ``i`` is parent rank ``ranks[i]``
        (``translate_rank``/``group_rank`` convert between the two).  The
        local rank is translated when it belongs to the group, else 0 (the
        single-controller driver addresses every group).  The sub
        communicator has its own window registry and a rank-translated view
        of the parent transport.
        """
        ranks = [int(r) for r in ranks]
        if not ranks:
            raise ValueError("split requires a non-empty rank list")
        if len(set(ranks)) != len(ranks):
            raise ValueError(f"split rank list has duplicates: {ranks}")
        for r in ranks:
            if r < 0 or r >= self.size:
                raise ValueError(
                    f"split rank {r} outside communicator of size {self.size}")
        sub_rank = ranks.index(self.rank) if self.rank in ranks else 0
        sub = Communicator(size=len(ranks), rank=sub_rank,
                           transport=self.transport.split(color, ranks))
        sub.color = color
        # compose with our own mapping so nested splits translate to the root
        sub.parent_ranks = tuple(self.parent_ranks[r] for r in ranks)
        return sub

    def translate_rank(self, local_rank: int) -> int:
        """Sub-communicator rank -> root-communicator rank."""
        return self.parent_ranks[local_rank]

    def group_rank(self, parent_rank: int) -> int | None:
        """Root-communicator rank -> sub rank (None if not in the group)."""
        try:
            return self.parent_ranks.index(parent_rank)
        except ValueError:
            return None

    # -- liveness / resilience ----------------------------------------------
    @property
    def dead_ranks(self) -> set[int]:
        """Ranks currently considered dead."""
        return self._dead

    def probe(self, rank: int) -> bool:
        """Liveness of ``rank``: False once marked dead, else the
        transport's :meth:`~repro_torch.core.transport.base.Transport.probe`.
        A failed probe marks the rank dead, flipping every replicated
        window into failover routing before the first hung call."""
        if rank < 0 or rank >= self.size:
            raise ValueError(
                f"probe rank {rank} outside communicator of size {self.size}")
        if rank in self._dead:
            return False
        if rank == self.rank:
            return True
        alive = self.transport.probe(rank)
        if not alive:
            self._dead.add(rank)
        return alive

    def mark_dead(self, rank: int) -> None:
        """Record ``rank`` as dead (error- or probe-detected, or a simulated
        failure in tests): replicated windows stop routing to it until
        :meth:`mark_alive` / :meth:`rebuild_rank`."""
        if 0 <= rank < self.size:
            self._dead.add(rank)

    def mark_alive(self, rank: int) -> None:
        self._dead.discard(rank)

    def rebuild_rank(self, rank: int) -> int:
        """Bring a dead rank back: respawn its worker (transports that can),
        rebuild everything it hosted in every registered window from the
        live replicas (page-diff granular), then mark it alive -- traffic
        routes back to the primary.  Returns bytes copied while
        reconciling.  See :mod:`repro_torch.core.resilience`.
        """
        if rank < 0 or rank >= self.size:
            raise ValueError(
                f"rebuild rank {rank} outside communicator of size {self.size}")
        t = self.transport
        if hasattr(t, "respawn_rank") and not t.probe(rank):
            t.respawn_rank(rank)
        self._dead.add(rank)  # exclude it from acting-holder resolution
        copied = 0
        for w in list(self._windows):
            copied += w.rebuild_rank(rank, mark_alive=False)
        self.mark_alive(rank)
        return copied

    # -- window registry ----------------------------------------------------
    def _register(self, win) -> None:
        self._windows.append(win)

    def _unregister(self, win) -> None:
        try:
            self._windows.remove(win)
        except ValueError:
            pass

    def active_windows(self) -> int:
        return len(self._windows)

    def free_all(self) -> None:
        """Free every registered window; one failing window (e.g. a dead
        rank) does not stop the others from being freed.  The first error
        re-raises once all windows have been attempted."""
        errors: list[BaseException] = []
        for w in list(self._windows):
            try:
                w.free()
            except BaseException as e:
                errors.append(e)
        if errors:
            raise errors[0]

    # -- lifecycle ----------------------------------------------------------
    def close(self) -> None:
        """Free remaining windows and shut down an owned transport.

        Sub-communicators and communicators handed an existing transport
        leave it running (its owner closes it).  Idempotent.  The transport
        is shut down even when freeing a window fails (e.g. a crashed
        worker): surviving worker processes must not outlive the
        communicator.
        """
        try:
            self.free_all()
        finally:
            if self._owns_transport:
                self.transport.shutdown()
