"""Live rebuild: restore a dead rank's window state from its replicas.

This package's copy of ``repro.core.resilience.rebuild``.

A rank's death loses (a) its un-synced page cache -- gone by the paper's
failure model, nothing to rebuild -- and (b) *access* to everything it
hosted: the primary copy of its own partition and the replica copies it
held for other ranks.  ``rebuild_window_rank`` makes a respawned (or
never-actually-dead, for simulated inproc failures) rank a full chain
member again:

1. **re-map** -- on remote transports, fresh segments are allocated on the
   respawned worker over the existing backing files (the transport's
   deterministic naming policy finds them), so everything the rank had
   synced before death is already back.
2. **reconcile its partition** -- the *acting* holder (first live rank in
   chain order) is authoritative: it served the failover writes while the
   rank was down.  The copy is page-diff granular: both sides are read in
   chunks, compared per backing page, and only differing page runs are
   written back (then synced) -- a rebuild after a short outage moves only
   the delta, not the partition.
3. **reconcile the copies it hosts** -- each partition ``q`` whose replica
   lives on the rank is refreshed the same way from ``q``'s acting holder.

The caller (``Communicator.rebuild_rank`` / ``Window.rebuild_rank``)
re-marks the rank alive afterwards, which atomically routes traffic back
to the primary.  Pending mirror spans recorded while the rank was dead are
deliberately *not* cleared: the next sync re-mirrors them (replay, never
skip) -- redundant bytes, never lost ones.
"""

from __future__ import annotations

import numpy as np

from ..storage import DEFAULT_PAGE_SIZE, dirty_runs

__all__ = ["rebuild_window_rank"]

#: chunk size for the read-compare-write reconciliation walk
REBUILD_CHUNK = 4 << 20


def _page_diff(want: np.ndarray, have: np.ndarray, ps: int) -> np.ndarray:
    """Per-page changed flags between two equal-length uint8 buffers."""
    nb = -(-want.nbytes // ps) if want.nbytes else 0
    changed = np.zeros(nb, dtype=bool)
    whole = (want.nbytes // ps) * ps
    if whole:
        changed[: whole // ps] = np.any(
            want[:whole].reshape(-1, ps) != have[:whole].reshape(-1, ps),
            axis=1)
    if want.nbytes > whole:  # last partial page
        changed[-1] = not np.array_equal(want[whole:], have[whole:])
    return changed


def _diff_copy(transport, src, dst, size: int, page_size: int,
               chunk: int = REBUILD_CHUNK) -> int:
    """Make ``dst``'s bytes equal ``src``'s; returns bytes written.

    Page-diff granular: only runs of pages whose contents differ are
    written, so an almost-in-sync partition (the common rebuild case: the
    backing file survived the crash) costs reads but few writes.  A
    chunk's differing runs reach ``dst`` as one ``op_batch`` train (the
    JAX package writes them one ``put`` each: the same bytes, one round
    trip a chunk instead of one a run).
    """
    copied = 0
    for lo in range(0, size, chunk):
        n = min(chunk, size - lo)
        want = np.asarray(transport.get(src, lo, n), dtype=np.uint8).ravel()
        have = np.asarray(transport.get(dst, lo, n), dtype=np.uint8).ravel()
        puts = []
        for b0, b1 in dirty_runs(_page_diff(want, have, page_size)):
            blo, bhi = b0 * page_size, min(b1 * page_size, n)
            puts.append(("put", lo + blo, want[blo:bhi]))
            copied += bhi - blo
        if puts:
            for r in transport.op_batch(dst, puts):
                if isinstance(r, BaseException):
                    raise r
    return copied


def _retire(old) -> None:
    """Drop a stale driver-side handle without touching the dead worker."""
    if old is None:
        return
    from ..transport.multiproc import _ShmBuf
    if isinstance(old, _ShmBuf):
        _ShmBuf.close(old)  # detach the mapping; no control-channel call
        return
    try:
        old.closed = True  # its win_id means nothing to the fresh worker
    except Exception:
        pass


def _sync(seg) -> None:
    if seg is not None and hasattr(seg, "sync"):
        seg.sync()


def rebuild_window_rank(win, rank: int) -> int:
    """Rebuild everything ``rank`` hosts for one window; returns bytes
    copied during reconciliation (see the module docstring for the steps).

    The rank must still be marked dead on the communicator while this runs
    (acting-holder resolution has to exclude it); callers mark it alive
    after every window has been rebuilt.
    """
    if win.freed:
        raise RuntimeError("window has been freed")
    if rank < 0 or rank >= win.comm.size:
        raise ValueError(
            f"rank {rank} outside communicator of size {win.comm.size}")
    if win.dynamic:
        # dynamic windows require the in-process transport, whose ranks
        # cannot actually die -- nothing to re-map or reconcile
        return 0
    comm, t = win.comm, win.comm.transport
    n = comm.size
    size = win._alloc_size
    spec = dict(win._alloc_spec)
    ps = spec.get("page_size") or DEFAULT_PAGE_SIZE
    placement = win.placement

    # 1. fresh handles on the respawned worker (remote transports only);
    # in-process segments survive a simulated death intact.
    if not t.is_local:
        _retire(win.segments[rank])
        win.segments[rank] = t.allocate_segment(
            rank, size, win.hints, spec, name_rank=rank, name_nranks=n)
        if placement is not None:
            for q in placement.held_by(rank):
                j = placement.copy_index(q, rank)
                _retire(win.replica_segs[(q, j)])
                win.replica_segs[(q, j)] = t.allocate_segment(
                    rank, size, win._replica_hints(j), spec,
                    name_rank=q, name_nranks=n)
    if placement is None:
        return 0  # unreplicated: the file re-map restored all synced bytes

    dead = set(comm.dead_ranks) | {rank}

    def acting(part: int):
        for h in placement.holders(part):
            if h not in dead:
                return h
        return None

    def seg_of(part: int, holder: int):
        if holder == part:
            return win.segments[part]
        return win.replica_segs[(part, placement.copy_index(part, holder))]

    # 2. the rank's own partition <- its acting replica (authoritative:
    # it served the failover writes while the rank was down)
    copied = 0
    src_holder = acting(rank)
    if src_holder is not None:
        copied += _diff_copy(t, seg_of(rank, src_holder),
                             win.segments[rank], size, ps)
        _sync(win.segments[rank])

    # 3. the replica copies the rank hosts <- their partitions' acting
    # holders (the rank re-enters the placement as a usable replica)
    for q in placement.held_by(rank):
        src_holder = acting(q)
        if src_holder is None:
            continue  # no live holder for q: nothing to copy from
        dst = win.replica_segs[(q, placement.copy_index(q, rank))]
        copied += _diff_copy(t, seg_of(q, src_holder), dst, size, ps)
        _sync(dst)
    return copied
