#!/usr/bin/env python3
"""Time a checkpoint save and a cold restore through the storage window.

A ``CheckpointManager`` over ``Communicator(1)`` saves ``--tensors``
float32 tensors of ``--mb`` MB each (random from seed 0); a fresh
manager then opens the directory, so every page of the window is cold,
and ``restore()`` reads the tree back through ``CachedBacking.read`` and
checks each tensor's CRC.  The restored tree must equal the saved one.
Host code only; prints one JSON line.

    PYTHONPATH=src python scripts/time_restore.py --mb 32 --tensors 12
"""

import argparse
import json
import shutil
import tempfile
import time

import numpy as np

from repro_torch.ckpt import CheckpointManager
from repro_torch.core import Communicator


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mb", type=int, default=32)
    ap.add_argument("--tensors", type=int, default=12)
    ap.add_argument("--dir", default=None,
                    help="a directory for the checkpoint (default: a new "
                         "one under the temporary directory, removed after)")
    args = ap.parse_args()
    directory = args.dir or tempfile.mkdtemp(prefix="time_restore_")
    n = (args.mb << 20) // 4
    specs = {f"t{i}": ((n,), np.float32) for i in range(args.tensors)}
    rng = np.random.default_rng(0)
    tree = {k: rng.standard_normal(n, dtype=np.float32) for k in specs}
    try:
        comm = Communicator(1)
        cm = CheckpointManager(directory, comm, specs)
        t0 = time.perf_counter()
        cm.save(1, tree)
        save_s = time.perf_counter() - t0
        cm.close()
        comm.close()
        comm = Communicator(1)
        cm = CheckpointManager.open_for_restore(directory, comm, specs)
        t0 = time.perf_counter()
        res = cm.restore()
        restore_s = time.perf_counter() - t0
        equal = res is not None and all(
            np.array_equal(res.tree[k].view(np.uint32), v.view(np.uint32))
            for k, v in tree.items())
        cm.close()
        comm.close()
    finally:
        if args.dir is None:
            shutil.rmtree(directory, ignore_errors=True)
    nbytes = args.tensors * n * 4
    print(json.dumps({"tree_bytes": nbytes, "save_s": save_s,
                      "restore_s": restore_s,
                      "restore_bytes_per_s": nbytes / restore_s,
                      "equal": equal}))


if __name__ == "__main__":
    main()
