"""The port's page cache against the JAX package's, operation for operation.

``repro_torch.core.storage`` is a copy of ``repro.core.storage`` with one
change: free cache slots are found in O(1) and first-touch bulk writes
allocate their slots at once, where the reference scans every slot per
page (O(pages^2) to first-touch a window, minutes for the 6 GB optimizer
window ``chip_smoke.py`` builds).  The same random traffic -- aligned and
unaligned writes, reads, masked and full syncs, with a cache small enough
to evict -- must give the same reads, dirty bitmaps, flushed bytes and
files.
"""

import numpy as np
import pytest

from repro.core import storage as jstorage
from repro_torch.core import storage as tstorage

PAGE = 4096


def _traffic(mod, path, seed, pages, cache_pages, compare_on_write):
    rng = np.random.default_rng(seed)
    size = pages * PAGE - 123  # ragged last page
    b = mod.CachedBacking(str(path), size, cache_bytes=cache_pages * PAGE,
                          compare_on_write=compare_on_write)
    out = []
    for step in range(60):
        kind = rng.integers(0, 5)
        off = int(rng.integers(0, size - 1))
        n = int(rng.integers(1, min(size - off, 5 * PAGE) + 1))
        if kind in (0, 1):
            if kind == 0:  # page-aligned bulk write
                off = off // PAGE * PAGE
                n = min(size - off, (n // PAGE + 1) * PAGE)
            b.write(off, rng.integers(0, 4, size=n, dtype=np.uint8))
        elif kind == 2:
            out.append(b.read(off, n).tobytes())
        elif kind == 3:
            mask = rng.random(b.tracker.num_blocks) < 0.5
            out.append(b.sync(mask=mask))
        else:
            out.append(b.sync())
        out.append(b.tracker._bits.tobytes())
    out += [b.bytes_flushed, b.evictions]
    b.close()
    return out + [path.read_bytes()]


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("cache_pages", [64, 7])
@pytest.mark.parametrize("compare_on_write", [False, True])
def test_cached_backing_matches_reference(tmp_path, seed, cache_pages,
                                          compare_on_write):
    ref = _traffic(jstorage, tmp_path / "ref.bin", seed, 48, cache_pages,
                   compare_on_write)
    port = _traffic(tstorage, tmp_path / "port.bin", seed, 48, cache_pages,
                    compare_on_write)
    assert port == ref


def test_first_touch_fills_slots_in_order(tmp_path):
    """A bulk first touch takes the lowest free slots, in block order, as
    the reference's per-page faults do."""
    b = tstorage.CachedBacking(str(tmp_path / "x.bin"), 32 * PAGE)
    b.write(8 * PAGE, np.ones(4 * PAGE, np.uint8))
    b.write(0, np.ones(2 * PAGE, np.uint8))
    assert b._slot_of[8:12].tolist() == [0, 1, 2, 3]
    assert b._slot_of[0:2].tolist() == [4, 5]
    assert b._used == 6
    b.close(unlink=True)
