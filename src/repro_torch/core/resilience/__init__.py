"""Replicated storage windows: failure detection, failover, live rebuild.

This package's copy of ``repro.core.resilience``.  Each rank's window
partition is kept in ``k`` total copies (the ``storage_alloc_replication``
hint) placed by a rotating chain (:class:`ReplicaPlacement`); synced dirty
spans are mirrored to the replica holders on the flush path;
``Transport.probe`` + :class:`FailureDetector` turn rank death into an
observed event rather than a hung call; reads and writes aimed at a dead
rank fail over to the first live holder in chain order; and
:func:`rebuild_window_rank` restores a respawned worker to full chain
membership with a page-diff-granular copy.

Failure model (single rank death; "synced" = covered by a completed
``sync(rank)`` / ``flush(rank)`` epoch):

=============  ==================================  ==========================
configuration  dead primary                        dead replica holder
=============  ==================================  ==========================
k = 1          partition unreachable until         n/a (no replicas)
               restart/rebuild; synced bytes
               survive in the rank's backing
               file; un-synced page cache lost
k >= 2         reads/writes fail over to the       primary unaffected;
               first live holder in chain order;   un-mirrored spans stay
               every synced byte is served (zero   pending (re-marked) and
               lost synced data); un-synced page   replay on the next sync;
               cache lost; degraded to k-1         degraded to k-1 copies
               copies until rebuild                until rebuild
=============  ==================================  ==========================

A blocking ``win.sync(rank)`` mirrors inline; ``win.flush_async(rank)``
mirrors inside its pool task, so ``win.flush(rank)`` is the "k durable
copies" epoch boundary.  Only pure storage windows replicate, and only
writes made through window operations (device syncs included) are
mirrored.
"""

from .detector import FailureDetector
from .placement import ReplicaPlacement
from .rebuild import rebuild_window_rank

__all__ = ["FailureDetector", "ReplicaPlacement", "rebuild_window_rank"]
