"""Out-of-core DHT (paper §3.4): the table exceeds the memory budget.

``python -m repro_torch.launch.out_of_core_dht`` -- the port of
``examples/out_of_core_dht.py``, host-only like it, with the same results.
The combined window's ``factor='auto'`` pins what fits and spills the rest
behind the user-level page cache -- the application code never changes.
Neither does it change with the transport: under ``--transport mp`` (or
``REPRO_TRANSPORT=mp``) the four ranks are worker processes (segments
owned by them, RMA serviced by their progress threads) and the numbers
come out the same.  The ``__main__`` guard keeps it spawn-safe: mp
workers import this module.

Run:  PYTHONPATH=src python -m repro_torch.launch.out_of_core_dht
      PYTHONPATH=src python -m repro_torch.launch.out_of_core_dht --transport mp
"""

from __future__ import annotations

import argparse
import shutil
import tempfile
import time

import numpy as np

LV = 1 << 14          # 16k slots/rank -> ~7.9 MiB/rank with the heap
BUDGET = 1 << 20      # pretend each rank only has 1 MiB of memory


def run(comm, tmp: str, log=print) -> dict:
    """Fill the out-of-core table on ``comm`` (files under ``tmp``), sync
    it and probe random keys; prints what the example prints and returns
    the numbers, with ``found``: the first 100 inserted keys' counts as
    looked up after the sync."""
    from ..core import DistributedHashTable
    log(f"transport={comm.transport.kind} ranks={comm.size}")
    dht = DistributedHashTable(comm, LV, heap_factor=4, info={
        "alloc_type": "storage",
        "storage_alloc_filename": f"{tmp}/dht.bin",
        "storage_alloc_factor": "auto",          # spill beyond the budget
    }, memory_budget=BUDGET)
    out = {"transport": comm.transport.kind}
    try:
        seg = dht.win.segments[0]
        out["segment_kib"] = (seg.size >> 10, seg.mem_bytes >> 10,
                              seg.sto_bytes >> 10)
        log(f"per-rank segment: {seg.size >> 10} KiB "
            f"({seg.mem_bytes >> 10} KiB pinned, {seg.sto_bytes >> 10} KiB "
            "spilled)")

        rng = np.random.default_rng(0)
        n = int(LV * 4 * 0.8 * 0.25)
        keys = rng.integers(1, 1 << 48, n)
        t0 = time.perf_counter()
        for k in keys:
            dht.insert(int(k), 1, op="sum")
        dt = time.perf_counter() - t0
        out["inserted"], out["inserts_per_s"] = n, n / dt
        log(f"inserted {n} keys at {n / dt:.0f}/s (out-of-core)")

        t0 = time.perf_counter()
        out["flushed_bytes"] = dht.sync()
        out["sync_s"] = time.perf_counter() - t0
        log(f"checkpoint: {out['flushed_bytes'] >> 20} MiB flushed in "
            f"{out['sync_s']:.2f}s")

        out["hits"] = sum(dht.lookup(int(k)) is not None
                          for k in rng.integers(1, 1 << 48, 100))
        log(f"probe: {out['hits']}/100 random keys found (expected ~0 "
            "misses on inserted)")
        out["found"] = [dht.lookup(int(k)) for k in keys[:100]]
    finally:
        dht.free()
    return out


def main(argv=None) -> int:
    from ..core import Communicator
    ap = argparse.ArgumentParser()
    ap.add_argument("--transport", choices=("inproc", "mp"), default=None,
                    help="the ranks' transport (default: REPRO_TRANSPORT, "
                         "else inproc)")
    ap.add_argument("--dir", default=None,
                    help="directory for the table's files (default: a new "
                         "temporary one, removed at the end)")
    args = ap.parse_args(argv)
    tmp = args.dir or tempfile.mkdtemp(prefix="repro_ooc_")
    comm = Communicator.from_env(4, transport=args.transport)
    try:
        run(comm, tmp)
    finally:
        comm.close()
        if args.dir is None:
            shutil.rmtree(tmp, ignore_errors=True)
    print("done")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
