"""Replica placement: which ranks hold copies of which window partition.

This package's copy of ``repro.core.resilience.placement``.

``ReplicaPlacement`` is the rotating/chain scheme classic to replicated
stores (and to chain replication): with replication factor ``k`` over ``n``
ranks, rank ``r``'s partition has its primary on ``r`` and copy ``j`` on
rank ``(r + j) % n`` for ``j in 1..k-1``.  Properties the failover and
rebuild layers rely on:

* **chain order is total and static** -- every origin computes the same
  ``holders(r)`` tuple, so when the primary dies all origins agree on the
  acting holder (the first live rank in chain order) without coordination.
* **load balance** -- each rank hosts exactly ``k-1`` replica copies
  (``held_by`` is the inverse rotation), so mirroring cost is uniform.
* **k-1 fault tolerance for synced data** -- any ``k-1`` rank deaths leave
  at least one live holder per partition.
"""

from __future__ import annotations

__all__ = ["ReplicaPlacement"]


class ReplicaPlacement:
    """Rotating chain placement of ``k`` total copies over ``nranks``."""

    def __init__(self, nranks: int, k: int):
        if nranks < 1:
            raise ValueError("nranks must be >= 1")
        if not 1 <= k <= nranks:
            raise ValueError(
                f"replication factor {k} outside [1, nranks={nranks}] "
                "(each copy needs a distinct rank)")
        self.nranks = nranks
        self.k = k

    def holders(self, rank: int) -> tuple[int, ...]:
        """All ranks holding ``rank``'s partition, chain order (primary
        first) -- the failover order for reads and writes."""
        self._check(rank)
        return tuple((rank + j) % self.nranks for j in range(self.k))

    def replicas(self, rank: int) -> tuple[int, ...]:
        """The ``k-1`` replica holders of ``rank``'s partition."""
        return self.holders(rank)[1:]

    def held_by(self, holder: int) -> tuple[int, ...]:
        """Partitions whose replica copies live on ``holder`` (the inverse
        rotation): copy ``j`` of rank ``(holder - j) % n`` for each ``j``."""
        self._check(holder)
        return tuple((holder - j) % self.nranks for j in range(1, self.k))

    def copy_index(self, rank: int, holder: int) -> int:
        """Which copy (0 = primary) of ``rank``'s partition ``holder`` has;
        raises if ``holder`` is not in the chain."""
        j = (holder - rank) % self.nranks
        if j >= self.k:
            raise ValueError(
                f"rank {holder} holds no copy of rank {rank}'s partition "
                f"(k={self.k})")
        return j

    def _check(self, rank: int) -> None:
        if rank < 0 or rank >= self.nranks:
            raise ValueError(
                f"rank {rank} outside placement of size {self.nranks}")

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"ReplicaPlacement(nranks={self.nranks}, k={self.k})"
