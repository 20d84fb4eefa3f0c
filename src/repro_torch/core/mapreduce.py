"""MapReduce "One-Sided" (paper §3.5.2) with transparent window checkpoints.

This package's own copy of ``repro.core.mapreduce``: the word keys, the
task distribution, the checkpoint order and the file layout are the
reference's, so the same tasks give byte-identical files under either
package.

The paper's MR-1S overlaps Map and Reduce by letting every process push its
map output directly into the reducers' windows with one-sided operations --
no shuffle barrier.  Checkpointing is "transparent": a window sync after
each Map task (plus one after Reduce) persists exactly the dirty blocks.

Here the reduce state is a :class:`DistributedHashTable` over windows with
``op='sum'`` (WordCount reduction is commutative), and per-rank progress
lives in a tiny progress window so a restarted run resumes from the first
unfinished task.  The MR-2S baseline used in the benchmark writes a *full*
snapshot per checkpoint (the collective-I/O pattern the paper compares
against), while MR-1S pays only for dirty blocks.

Checkpoints are *pipelined*: each task commit queues the table flush as a
nonblocking request (``table.sync(blocking=False)``) and only waits for the
previous commit's request, so the storage write-back of checkpoint N
overlaps with map task N+1 -- the MR-1S overlap story extended to the
checkpoint path.  Recovery ordering is preserved by chaining: the progress
counter is persisted in the table flush's completion hook, so persisted
progress never runs ahead of the table state it describes (a crash can
only *replay* a task, never skip one).  The overlap does widen the paper's
replay window: a flush that executes mid-task may persist some of the next
task's commutative ``sum`` updates, which a replay then double-counts --
the synchronous scheme had the same window, confined to the sync call
itself.  Pass ``checkpoint=False`` (or wait each commit) where exactly-once
replay matters more than overlap.

Transports: the reduce state and progress windows ride whatever transport
the communicator carries.  Under ``mp`` the reducers are real worker
processes, and because the storage-window file layout is
transport-invariant, a job that dies mid-run (even by SIGKILL of a worker,
taking its page cache with it) restarts from the synced checkpoints with a
fresh communicator over the same files -- the paper's fault-tolerance
claim across real process boundaries.
"""

from __future__ import annotations

import re
from typing import Callable, Iterable, Mapping

import numpy as np

from .comm import Communicator
from .dht import DistributedHashTable
from .window import Window

__all__ = ["MapReduce1S", "wordcount_map", "wordcount_reduce", "stable_word_key"]

_TOKEN = re.compile(r"[A-Za-z0-9']+")


def stable_word_key(word: str) -> int:
    """Deterministic 62-bit key for a word (FNV-1a, avoiding the sentinel)."""
    h = 0xCBF29CE484222325
    for b in word.lower().encode():
        h = ((h ^ b) * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h & 0x3FFFFFFFFFFFFFFF  # keep clear of the DHT EMPTY sentinel


def wordcount_map(chunk: str) -> dict[int, int]:
    counts: dict[int, int] = {}
    for w in _TOKEN.findall(chunk):
        k = stable_word_key(w)
        counts[k] = counts.get(k, 0) + 1
    return counts


def wordcount_reduce(partials: Iterable[Mapping[int, int]]) -> dict[int, int]:
    out: dict[int, int] = {}
    for p in partials:
        for k, v in p.items():
            out[k] = out.get(k, 0) + v
    return out


class MapReduce1S:
    """Decentralized MapReduce on one-sided windows.

    Parameters
    ----------
    comm:          communicator (ranks = workers = reducers)
    lv_entries:    DHT local-volume slots per rank
    info:          window hints -- pass storage hints to make the reduce
                   state (and hence every checkpoint) persistent
    checkpoint:    sync windows after every map task (the paper's scheme)
    """

    def __init__(self, comm: Communicator, lv_entries: int = 1 << 12, *,
                 info=None, checkpoint: bool = True, heap_factor: int = 4,
                 mechanism: str = "cached", resume: bool = False):
        """``resume=True`` re-opens a checkpointed job after a crash/restart:
        the reduce table and progress windows map their existing storage
        files as-is (no re-initialization), so ``run()`` picks up at each
        rank's first unfinished task."""
        self.comm = comm
        self.checkpoint = checkpoint
        self.resume = resume
        self.table = DistributedHashTable(comm, lv_entries, info=info,
                                          heap_factor=heap_factor,
                                          mechanism=mechanism, resume=resume)
        # progress window: one int64 per rank = index of next unfinished task
        prog_info = None
        if info is not None and info.get("alloc_type") == "storage":
            prog_info = dict(info)
            prog_info["storage_alloc_filename"] = (
                info["storage_alloc_filename"] + ".progress")
        self.progress = Window.allocate(comm, 8, info=prog_info,
                                        mechanism=mechanism)
        if not resume:
            for r in range(comm.size):
                self.progress.put(np.zeros(1, np.int64).view(np.uint8), r, 0)
        self.ckpt_count = 0
        self.ckpt_bytes = 0
        self._ckpt_reqs: list = []  # in-flight checkpoint of the last commit
        self._hook_bytes: list = []  # progress-sync bytes from flush hooks
        #                              (list.append: safe from the pool thread)

    # -- task distribution ------------------------------------------------------
    def _tasks_of(self, rank: int, n_tasks: int) -> list[int]:
        return list(range(rank, n_tasks, self.comm.size))

    def _next_task_pos(self, rank: int) -> int:
        return int(self.progress.get(rank, 0, 1, np.int64)[0])

    def _drain_ckpt(self) -> None:
        """Complete the previous commit's in-flight checkpoint requests."""
        reqs, self._ckpt_reqs = self._ckpt_reqs, []
        for r in reqs:
            self.ckpt_bytes += int(r.wait())
        hooked, self._hook_bytes = self._hook_bytes, []
        self.ckpt_bytes += sum(hooked)

    def _commit_task(self, rank: int, pos: int) -> None:
        if self.checkpoint:
            # Complete the previous commit BEFORE touching the progress
            # window, so an older queued flush can never persist this
            # commit's (newer) counter.
            self._drain_ckpt()
        self.progress.put(np.asarray([pos + 1], np.int64).view(np.uint8), rank, 0)
        if self.checkpoint:
            # Paper Listing 4: exclusive lock + MPI_Win_sync = consistent,
            # selective (dirty-block-only) checkpoint.  Issued nonblocking,
            # so its write-back overlaps with the next map task; the
            # progress counter is persisted only in the completion hook,
            # after the table data it describes is on storage.
            def _persist_progress(_table_bytes: int) -> None:
                self._hook_bytes.append(self.progress.sync(rank))

            self._ckpt_reqs = [self.table.sync(blocking=False,
                                               on_complete=_persist_progress)]
            self.ckpt_count += 1

    # -- phases -------------------------------------------------------------------
    def run(self, tasks: list[str],
            map_fn: Callable[[str], dict[int, int]] = wordcount_map) -> None:
        """Map every task; emit (key, count) via one-sided accumulate."""
        for rank in range(self.comm.size):
            my = self._tasks_of(rank, len(tasks))
            start = self._next_task_pos(rank)
            for pos in range(start, len(my)):
                partial = map_fn(tasks[my[pos]])
                # Reduce-as-you-go: push into the owners' windows (no shuffle).
                for k, v in partial.items():
                    self.table.insert(k, v, op="sum")
                self._commit_task(rank, pos)
        if self.checkpoint:
            self._drain_ckpt()  # complete the last task's overlapped ckpt
            self.ckpt_bytes += self.table.sync()  # post-Reduce sync (paper)

    def result(self) -> dict[int, int]:
        return dict(self.table.items())

    def completed_tasks(self) -> int:
        return sum(self._next_task_pos(r) for r in range(self.comm.size))

    def free(self) -> None:
        if self.checkpoint:
            self._drain_ckpt()
        self.table.free()
        self.progress.free()
