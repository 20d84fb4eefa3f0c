"""MapReduce WordCount with transparent checkpointing (paper §3.5.2).

``python -m repro_torch.launch.mapreduce_wordcount`` -- the port of
``examples/mapreduce_wordcount.py``, host-only like it, with the same
results.  A crash mid-job loses nothing: the reduce state and per-rank
progress live in storage windows synced after every Map task; the
restarted job resumes from the first unfinished task.  The window file
layout is transport-invariant, so the same run works (and recovers) with
the ranks as worker processes: ``--transport mp`` (or
``REPRO_TRANSPORT=mp``).  The ``__main__`` guard keeps it spawn-safe: mp
workers import this module.  Exit code 1 if the resumed result differs
from a clean run's.

Run:  PYTHONPATH=src python -m repro_torch.launch.mapreduce_wordcount
      PYTHONPATH=src python -m repro_torch.launch.mapreduce_wordcount --transport mp
"""

from __future__ import annotations

import argparse
import shutil
import sys
import tempfile

import numpy as np


def tasks() -> list[str]:
    """The example's 16 tasks of 500 words from seed 0."""
    words = "the quick brown fox jumps over lazy dog lorem ipsum".split()
    rng = np.random.default_rng(0)
    return [" ".join(rng.choice(words, 500)) for _ in range(16)]


def run(comm, tmp: str, log=print) -> dict:
    """Rank 0 commits two tasks and "crashes"; the job resumes from the
    progress window and runs to its end.  Prints what the example prints;
    returns the result (``counts``: word key -> count) and the
    checkpoint numbers, ``ok`` whether the result equals a clean run's."""
    from ..core import MapReduce1S
    from ..core.mapreduce import stable_word_key, wordcount_map
    work = tasks()
    info = {"alloc_type": "storage", "storage_alloc_filename": f"{tmp}/mr.bin"}
    log(f"transport={comm.transport.kind} ranks={comm.size}")
    mr = MapReduce1S(comm, 1 << 10, info=info)
    try:
        # -- phase 1: run a few tasks, then "crash" --------------------------
        my0 = mr._tasks_of(0, len(work))
        for pos in range(2):  # rank 0 finishes only 2 tasks
            for k, v in wordcount_map(work[my0[pos]]).items():
                mr.table.insert(k, v, op="sum")
            mr._commit_task(0, pos)
        out = {"crash_after": mr.completed_tasks(),
               "crash_ckpt_kib": mr.ckpt_bytes >> 10}
        log(f"crash after {out['crash_after']} committed tasks "
            f"({out['crash_ckpt_kib']} KiB checkpointed so far)")

        # -- phase 2: resume -- the progress window knows where everyone
        # stopped
        mr.run(work)
        result = mr.result()
        expect: dict[int, int] = {}
        for t in work:
            for k, v in wordcount_map(t).items():
                expect[k] = expect.get(k, 0) + v
        out.update(counts=result, ok=result == expect,
                   ckpt_count=mr.ckpt_count, ckpt_kib=mr.ckpt_bytes >> 10)
        if out["ok"]:
            log(f"wordcount ok: 'the' -> {result[stable_word_key('the')]}")
        log(f"transparent checkpoints: {mr.ckpt_count} syncs, "
            f"{out['ckpt_kib']} KiB total (selective)")
    finally:
        mr.free()
    return out


def main(argv=None) -> int:
    from ..core import Communicator
    ap = argparse.ArgumentParser()
    ap.add_argument("--transport", choices=("inproc", "mp"), default=None,
                    help="the ranks' transport (default: REPRO_TRANSPORT, "
                         "else inproc)")
    ap.add_argument("--dir", default=None,
                    help="directory for the job's files (default: a new "
                         "temporary one, removed at the end)")
    args = ap.parse_args(argv)
    tmp = args.dir or tempfile.mkdtemp(prefix="repro_mr_")
    comm = Communicator.from_env(4, transport=args.transport)
    try:
        out = run(comm, tmp)
    finally:
        comm.close()
        if args.dir is None:
            shutil.rmtree(tmp, ignore_errors=True)
    if not out["ok"]:
        print("mapreduce_wordcount: the resumed result differs from a clean "
              "run's", file=sys.stderr)
        return 1
    print("done")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
