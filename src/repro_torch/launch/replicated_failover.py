"""Kill-and-rebuild run: a replicated DHT keeps serving through rank death.

``python -m repro_torch.launch.replicated_failover`` -- the port of
``examples/replicated_failover.py``, host-only like it.  A
``storage_alloc_replication=2`` DHT takes inserts and syncs; one worker is
SIGKILLed (under ``REPRO_TRANSPORT=mp``; a simulated ``mark_dead``
otherwise, so the run also works in process), and the table must

* report the rank dead via ``Transport.probe`` / ``FailureDetector`` and
  its heartbeat monitor,
* keep serving every synced key and take more inserts through failover,
* rebuild the lost partition bit-exact from its replica onto a respawned
  worker (``comm.rebuild_rank``) and serve every key again.

Run:  PYTHONPATH=src python -m repro_torch.launch.replicated_failover
      REPRO_TRANSPORT=mp REPRO_NRANKS=4 PYTHONPATH=src \\
          python -m repro_torch.launch.replicated_failover

Keys are ``benchmarks/dht_bench.py``'s (uniform in [1, 2^40) from seed
0).  Exit code 1 if a check fails.  The ``__main__`` guard keeps it
spawn-safe: mp workers import this module.
"""

from __future__ import annotations

import argparse
import shutil
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

#: the rank whose worker is killed
VICTIM = 1
#: inserts before the kill and after it (the reference's)
N_KEYS, N_MORE = 300, 100


class FailoverError(RuntimeError):
    """A check of the run failed."""


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise FailoverError(msg)


def run(comm, directory, *, lv_entries: int = 1 << 10, keys: int = N_KEYS,
        more: int = N_MORE, log=print) -> dict:
    """The kill-and-rebuild run on ``comm`` (at least 2 ranks), with the
    table's files under ``directory``: ``lv_entries`` slots a rank,
    ``keys`` inserts before the kill of rank :data:`VICTIM`, ``more``
    after it.  Returns counts and times; raises :class:`FailoverError`
    when a check fails."""
    from ..core import DistributedHashTable, FailureDetector
    real_kill = comm.transport.kind == "mp"
    log(f"transport={comm.transport.kind} ranks={comm.size} "
        f"(kill={'SIGKILL' if real_kill else 'simulated'})")
    dht = DistributedHashTable(comm, lv_entries, info={
        "alloc_type": "storage",
        "storage_alloc_filename": str(Path(directory) / "dht.bin"),
    }, replication=2)
    out = {"transport": comm.transport.kind, "ranks": comm.size,
           "victim": VICTIM}
    try:
        win = dht.win
        _check(win.replication == 2, "the replication hint was not honoured")
        rng = np.random.default_rng(0)
        expect: dict[int, int] = {}
        t0 = time.perf_counter()
        for i, k in enumerate(rng.integers(1, 1 << 40, keys)):
            dht.insert(int(k), i, op="replace")
            expect[int(k)] = i
        out["insert_s"] = time.perf_counter() - t0
        out["inserts_per_s"] = keys / out["insert_s"]
        t0 = time.perf_counter()
        out["synced_bytes"] = dht.sync()  # every copy now holds the table
        out["sync_s"] = time.perf_counter() - t0
        log(f"inserted {keys} keys, synced {out['synced_bytes']} B "
            f"(x{win.replication} copies)")

        # -- kill a worker mid-traffic --------------------------------------
        if real_kill:
            comm.transport.kill_rank(VICTIM)
        else:
            comm.mark_dead(VICTIM)
        detector = FailureDetector(comm)
        dead = detector.poll()
        _check(dead == [VICTIM] and detector.monitor.dead() == [VICTIM],
               f"FailureDetector/HeartbeatMonitor report {dead} / "
               f"{detector.monitor.dead()}, not [{VICTIM}]")

        # -- continued service: zero lost synced keys, then more inserts ----
        t0 = time.perf_counter()
        lost = sum(1 for k, v in expect.items() if dht.lookup(k) != v)
        out["lookup_s"] = time.perf_counter() - t0
        out["lost_synced_keys"] = lost
        _check(lost == 0, f"failover lost {lost} synced keys")
        t0 = time.perf_counter()
        for i, k in enumerate(rng.integers(1 << 40, 1 << 41, more)):
            dht.insert(int(k), -i, op="replace")
            expect[int(k)] = -i
        out["more_insert_s"] = time.perf_counter() - t0
        out["more_inserts_per_s"] = more / out["more_insert_s"]
        _check(all(dht.lookup(k) == v for k, v in expect.items()),
               "a key is not served through failover")
        dht.sync()
        log(f"served {len(expect)} keys and {more} inserts through failover "
            "(0 synced keys lost)")

        # -- respawn + rebuild ----------------------------------------------
        t0 = time.perf_counter()
        out["rebuild_bytes"] = comm.rebuild_rank(VICTIM)
        out["rebuild_s"] = time.perf_counter() - t0
        _check(comm.probe(VICTIM), "the rebuilt rank did not come back")
        seg = win.segments[VICTIM]
        rep = win.replica_segs[(VICTIM, 1)]
        prim = np.asarray(comm.transport.get(seg, 0, seg.size))
        copy = np.asarray(comm.transport.get(rep, 0, seg.size))
        _check(np.array_equal(prim, copy),
               "the rebuilt partition differs from its replica")
        _check(all(dht.lookup(k) == v for k, v in expect.items()),
               "a key is not served after the rebuild")
        out["keys"] = len(expect)
        log(f"rebuilt rank {VICTIM} in {out['rebuild_s']:.2f} s "
            f"({out['rebuild_bytes']} B reconciled); the partition equals "
            "its replica and every key is served")
    finally:
        dht.free()
    return out


def main(argv=None) -> int:
    from ..core import Communicator
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=None,
                    help="directory for the table's files (default: a new "
                         "temporary one, removed at the end)")
    args = ap.parse_args(argv)
    directory = args.dir or tempfile.mkdtemp(prefix="repro_failover_")
    comm = Communicator.from_env(4)
    try:
        run(comm, directory)
    except FailoverError as e:
        print(f"replicated_failover: {e}", file=sys.stderr)
        return 1
    finally:
        comm.close()
        if args.dir is None:
            shutil.rmtree(directory, ignore_errors=True)
    print("done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
