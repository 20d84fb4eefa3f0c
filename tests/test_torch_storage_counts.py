"""The page cache's running counts: the dirty count and the free-slot cursor.

``DirtyTracker`` keeps the number of dirty blocks as it sets and clears
bits, and ``CachedBacking`` hands out free cache slots from a cursor, so a
write costs what it writes: the reference sums the whole bitmap after every
write (through ``dirty_fraction``) and scans every slot when a bulk write
allocates.  Here random operations -- aligned and unaligned writes, reads,
masked and full syncs, restores, evictions through a small cache and
forced flushes through ``dirty_ratio`` -- must keep ``dirty_count`` equal
to the bitmap's population at every step, and give the JAX package's
bitmaps, flushed bytes and file bytes.
"""

import numpy as np
import pytest

from repro.core import storage as jstorage
from repro_torch.core import storage as tstorage

PAGE = 4096


def _ops(mod, path, seed, *, pages, cache_pages, dirty_ratio, check):
    """Random traffic on ``mod.CachedBacking``; ``check(b)`` after each
    operation.  Returns every step's bitmap and read, then the counters and
    the file's bytes."""
    rng = np.random.default_rng(seed)
    size = pages * PAGE - 77  # ragged last page
    b = mod.CachedBacking(str(path), size, cache_bytes=cache_pages * PAGE,
                          dirty_ratio=dirty_ratio)
    out = []
    for _ in range(80):
        kind = int(rng.integers(0, 7))
        off = int(rng.integers(0, size - 1))
        n = int(rng.integers(1, min(size - off, 6 * PAGE) + 1))
        if kind <= 1:
            if kind == 0:  # page-aligned: the bulk path
                off = off // PAGE * PAGE
                n = min(size - off, (n // PAGE + 1) * PAGE)
            b.write(off, rng.integers(0, 5, size=n, dtype=np.uint8))
        elif kind == 2:
            out.append(b.read(off, n).tobytes())
        elif kind == 3:
            out.append(b.sync(mask=rng.random(b.tracker.num_blocks) < 0.4))
        elif kind == 4:
            out.append(b.sync())
        elif kind == 5:  # a failed flush re-marks what it took
            b.tracker.restore(rng.random(b.tracker.num_blocks) < 0.1)
        else:  # a device diff ORed into the bitmap
            b.tracker.mark_blocks(rng.random(b.tracker.num_blocks + 3) < 0.2)
        check(b)
        out.append(b.tracker._bits.tobytes())
    out += [b.bytes_flushed, b.evictions]
    b.close()
    return out + [path.read_bytes()]


def _count_is_population(b):
    assert b.tracker.dirty_count == int(b.tracker._bits.sum())
    assert b.tracker.dirty_fraction == pytest.approx(
        b.tracker.dirty_count / b.tracker.num_blocks)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("cache_pages,dirty_ratio", [(64, 1.0), (6, 1.0),
                                                     (64, 0.3), (9, 0.2)])
def test_dirty_count_follows_the_bitmap(tmp_path, seed, cache_pages,
                                        dirty_ratio):
    port = _ops(tstorage, tmp_path / "port.bin", seed, pages=40,
                cache_pages=cache_pages, dirty_ratio=dirty_ratio,
                check=_count_is_population)
    ref = _ops(jstorage, tmp_path / "ref.bin", seed, pages=40,
               cache_pages=cache_pages, dirty_ratio=dirty_ratio,
               check=lambda b: None)
    assert port == ref


@pytest.mark.parametrize("seed", range(3))
def test_tracker_count_under_every_bit_operation(seed):
    """mark, mark_blocks, both branches of snapshot_and_clear, restore and
    clear_block, against the bitmap's population after each."""
    rng = np.random.default_rng(seed)
    t = tstorage.DirtyTracker(100 * 512 - 5, 512)
    for _ in range(300):
        kind = int(rng.integers(0, 6))
        if kind == 0:
            off = int(rng.integers(0, t.size))
            t.mark(off, int(rng.integers(0, 3000)))
        elif kind == 1:
            t.mark_blocks(rng.random(int(rng.integers(1, 120))) < 0.3)
        elif kind == 2:
            t.snapshot_and_clear()
        elif kind == 3:
            t.snapshot_and_clear(rng.random(t.num_blocks) < 0.5)
        elif kind == 4:
            t.restore(rng.random(t.num_blocks) < 0.05)
        else:
            t.clear_block(int(rng.integers(0, t.num_blocks)))
        assert t.dirty_count == int(t._bits.sum())


class _NoSum(np.ndarray):
    """A bitmap that fails when summed whole."""

    def sum(self, *args, **kwargs):
        raise AssertionError("the whole bitmap was summed")


class _SlotGuard(np.ndarray):
    """Records the widest comparison made on the slot -> block table."""

    widest = 0

    def __lt__(self, other):
        _SlotGuard.widest = max(_SlotGuard.widest, self.size)
        return np.asarray(self) < other


def test_span_writes_scan_neither_bitmap_nor_slots(tmp_path):
    """Single-page writes (the selective sync's spans) read the dirty
    fraction without summing the bitmap, and bulk first touches take their
    slots without comparing the whole slot table."""
    pages = 256
    b = tstorage.CachedBacking(str(tmp_path / "w.bin"), pages * PAGE,
                               dirty_ratio=0.5)
    b.tracker._bits = b.tracker._bits.view(_NoSum)
    b._block_of = b._block_of.view(_SlotGuard)
    _SlotGuard.widest = 0
    for p in range(0, 64, 4):  # bulk first touches of 4 pages each
        b.write(p * PAGE, np.full(4 * PAGE, p, np.uint8))
    assert _SlotGuard.widest <= 4
    assert b._slot_of[:8].tolist() == [0, 1, 2, 3, 4, 5, 6, 7]
    for p in range(64, 128, 2):  # page-spread single-page spans
        b.write(p * PAGE, np.full(PAGE, 1, np.uint8))
    assert b.tracker.dirty_count == 64 + 32
    b.tracker._bits = np.asarray(b.tracker._bits)
    assert b.tracker.dirty_count == int(b.tracker._bits.sum())
    assert b.sync() == (64 + 32) * PAGE
    assert b.tracker.dirty_count == 0
    b.close(unlink=True)
