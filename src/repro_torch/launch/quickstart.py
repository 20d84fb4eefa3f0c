"""Quickstart: the MPI-windows-on-storage API in five minutes.

``python -m repro_torch.launch.quickstart`` -- the port of
``examples/quickstart.py``, host-only like it, with the same results:
four logical ranks in one process; a storage window with one-sided puts
and selective syncs (paper Listing 1), a combined memory + storage
allocation (Listing 2), the out-of-core ``factor='auto'`` split, a
tensor in a window updated block by block, and a one-sided DHT on
storage (paper §3.3).

Run:  PYTHONPATH=src python -m repro_torch.launch.quickstart [--dir DIR]

The files go under ``--dir`` (default: a new temporary directory, kept,
as the example keeps its own).
"""

from __future__ import annotations

import argparse
import tempfile

import numpy as np


def run(tmp: str, log=print) -> dict:
    """The five steps with their files under ``tmp``; prints what the
    example prints and returns the numbers."""
    from ..core import (Communicator, DistributedHashTable, Window,
                        WindowedPyTree)
    out = {}
    comm = Communicator(4)  # four logical ranks

    # -- 1. a storage window: same API as a memory window, hints decide the
    # tier
    info = {
        "alloc_type": "storage",                       # paper Listing 1
        "storage_alloc_filename": f"{tmp}/win.bin",
        "storage_alloc_unlink": "false",
    }
    win = Window.allocate(comm, 1 << 20, info=info)
    # one-sided ops: even ranks write into odd ranks' windows (Listing 1)
    for rank in range(0, comm.size, 2):
        for drank in range(1, comm.size, 2):
            k = np.asarray([rank + 42], np.int64)
            with win.locked(drank):   # scoped epoch: unlocks on every path
                win.put(k.view(np.uint8), drank, 0)
    out["rank1_sees"] = int(win.get(1, 0, 1, np.int64)[0])
    log("rank1 sees:", out["rank1_sees"])
    # persistence is explicit: put touches the page cache; sync flushes
    # dirty blocks (selective -- a second sync is free)
    out["first_sync"] = win.sync(1)
    log("first sync flushed:", out["first_sync"], "bytes")
    out["second_sync"] = win.sync(1)
    log("second sync flushed:", out["second_sync"], "bytes (already clean)")
    win.free()

    # -- 2. combined allocation: one address space, half memory half storage
    info = {
        "alloc_type": "storage",
        "storage_alloc_filename": f"{tmp}/combined.bin",
        "storage_alloc_factor": "0.5",                 # paper Listing 2
    }
    win = Window.allocate(comm, 1 << 20, info=info)
    win.put(np.full(1 << 20, 7, np.uint8), 0, 0)       # spans both tiers
    out["combined_ok"] = bool((win.get(0, 0, 1 << 20) == 7).all())
    log("combined read ok:", out["combined_ok"])
    win.free()

    # -- 3. out-of-core auto factor: spill exactly what exceeds the budget
    info["storage_alloc_factor"] = "auto"
    info["storage_alloc_filename"] = f"{tmp}/auto.bin"
    win = Window.allocate(comm, 1 << 20, info=info, memory_budget=1 << 18)
    seg = win.segments[0]
    out["auto_split_kib"] = (seg.mem_bytes >> 10, seg.sto_bytes >> 10)
    log(f"auto split: {seg.mem_bytes >> 10} KiB memory, "
        f"{seg.sto_bytes >> 10} KiB storage")
    win.free()

    # -- 4. tensors in windows -------------------------------------------
    tree = WindowedPyTree.from_tree(comm, {
        "weights": np.random.default_rng(0).standard_normal(
            (64, 64)).astype(np.float32),
    }, info={"alloc_type": "storage",
             "storage_alloc_filename": f"{tmp}/params.bin"})
    w = tree.array("weights")
    w.update_blocks(lambda blk: blk * 0.5)             # streamed, out-of-core
    out["tensor_mean"] = float(w.get().mean())
    log("windowed tensor mean:", out["tensor_mean"])
    tree.free()

    # -- 5. a one-sided DHT on storage (paper 3.3) -----------------------
    dht = DistributedHashTable(comm, 1 << 10, info={
        "alloc_type": "storage", "storage_alloc_filename": f"{tmp}/dht.bin"})
    for key in range(100):
        dht.insert(key, key * key)
    out["dht_7"] = dht.lookup(7)
    log("dht[7] =", out["dht_7"])
    out["dht_sync"] = dht.sync()
    log("checkpoint flushed:", out["dht_sync"], "bytes")
    dht.free()
    comm.close()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=None,
                    help="directory for the windows' files (default: a new "
                         "temporary one)")
    args = ap.parse_args(argv)
    tmp = args.dir or tempfile.mkdtemp(prefix="repro_quickstart_")
    run(tmp)
    print("quickstart done; files under", tmp)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
