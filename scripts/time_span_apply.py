#!/usr/bin/env python3
"""Host cost of selective sync's span apply and flush, per span.

Writes ``--spans`` single-page spans, spread over ``--pages`` pages, into a
``repro_torch`` page cache (``CachedBacking``, everything resident, the
window's layout in phase 2 of ``chip_smoke.py``), then syncs, and prints
the microseconds a span write and a flushed run took.  Host code only: it
runs wherever the port imports (``--dir`` holds the scratch file, removed
at the end).

    PYTHONPATH=src python scripts/time_span_apply.py --pages 200000 \\
        --spans 10000 --dir /tmp
"""

import argparse
import os
import tempfile
import time

import numpy as np

from repro_torch.core import storage

PAGE = 4096


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pages", type=int, default=200_000)
    ap.add_argument("--spans", type=int, default=10_000)
    ap.add_argument("--dir", default=None)
    args = ap.parse_args()
    with tempfile.TemporaryDirectory(dir=args.dir) as d:
        b = storage.CachedBacking(os.path.join(d, "w.bin"), args.pages * PAGE)
        b.write(0, np.zeros(args.pages * PAGE, np.uint8))
        b.sync()
        pages = np.sort(np.random.default_rng(0).choice(
            args.pages, args.spans, replace=False))
        data = np.ones(PAGE, np.uint8)
        t0 = time.perf_counter()
        for p in pages:
            b.write(int(p) * PAGE, data)
        t1 = time.perf_counter()
        flushed = b.sync()
        t2 = time.perf_counter()
        b.close(unlink=True)
    print(f"{args.spans} spans over {args.pages} pages: "
          f"{(t1 - t0) / args.spans * 1e6:.1f} us a span write, "
          f"{(t2 - t1) / args.spans * 1e6:.1f} us a flushed run "
          f"({flushed} bytes)")


if __name__ == "__main__":
    main()
