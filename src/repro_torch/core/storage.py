"""Storage backings for windows: files, "block devices", striped files.

The paper implements MPI storage windows with ``mmap(MAP_SHARED)`` and leans
on the OS page cache (vm.dirty_ratio et al.) for write-back.  Its §6 future
work proposes "a user-level memory-mapped I/O mechanism to provide
full control of storage allocations from the MPI implementation" -- that is
what ``CachedBacking`` implements: an explicit, bounded software page cache
with a dirty bitmap, a configurable dirty ratio, and a background write-back
thread (the analogue of ``vm.dirty_writeback_centisecs``).

``MmapBacking`` is the paper's original mechanism (np.memmap / OS page
cache), kept both as a baseline and for the mmap-faithful benchmarks.

Both expose the same interface:
    read(offset, nbytes) -> np.ndarray[uint8]
    write(offset, data)
    sync(full=False)        # selective: only dirty blocks, like MPI_Win_sync
    close(unlink=False, discard=False)

Striping (the Lustre hints ``striping_factor`` / ``striping_unit``) is
handled by ``StripedFile``, which splits the byte space across N sub-files
in round-robin stripe units -- functionally identical to how an MPI
implementation maps a window onto Lustre OSTs.
"""

from __future__ import annotations

import collections
import os
import threading
import time

import numpy as np

__all__ = [
    "DEFAULT_PAGE_SIZE",
    "DirtyTracker",
    "StripedFile",
    "MmapBacking",
    "CachedBacking",
    "WritebackPool",
    "dirty_runs",
    "mark_span",
    "make_backing",
]

DEFAULT_PAGE_SIZE = 4096


def dirty_runs(bits: np.ndarray) -> list[tuple[int, int]]:
    """Contiguous [start, end) runs of set bits in a boolean mask."""
    bits = np.asarray(bits, dtype=bool)
    if not bits.any():
        return []
    idx = np.flatnonzero(bits)
    splits = np.flatnonzero(np.diff(idx) > 1)
    starts = np.concatenate(([idx[0]], idx[splits + 1]))
    ends = np.concatenate((idx[splits] + 1, [idx[-1] + 1]))
    return list(zip(starts.tolist(), ends.tolist()))


def mark_span(mask: np.ndarray, lo: int, hi: int, page_size: int) -> None:
    """Set the block-mask bits covering byte range [lo, hi).

    Floor/ceil to ``page_size`` blocks; a negative ``lo`` is clamped to 0
    and the slice end clamps to the mask length, so callers can pass spans
    that overhang either edge (combined-window translation, device diffs
    padded past the last block).
    """
    if hi <= max(lo, 0):
        return
    mask[max(lo, 0) // page_size: -(-hi // page_size)] = True


class DirtyTracker:
    """Block-granular dirty bitmap.

    This is the bookkeeping behind *selective synchronization*: the paper's
    ``MPI_Win_sync`` "may return immediately if the pages are already
    synchronized with storage" -- we flush only blocks whose bit is set.
    The bitmap layout is shared with the CUDA ``dirty_diff`` kernel so a
    device-side diff can feed the same tracker.
    """

    def __init__(self, size: int, page_size: int = DEFAULT_PAGE_SIZE):
        if size < 0:
            raise ValueError("size must be >= 0")
        if page_size <= 0:
            raise ValueError("page_size must be > 0")
        self.size = size
        self.page_size = page_size
        self.num_blocks = max(1, -(-size // page_size)) if size else 0
        self._bits = np.zeros(self.num_blocks, dtype=bool)
        # running count of set bits: every method that sets or clears bits
        # keeps it, so dirty_count costs O(1) where the reference sums the
        # whole bitmap (after every write, through dirty_fraction)
        self._count = 0
        self._lock = threading.Lock()

    @property
    def dirty_count(self) -> int:
        return self._count

    @property
    def dirty_fraction(self) -> float:
        return self.dirty_count / self.num_blocks if self.num_blocks else 0.0

    def block_range(self, offset: int, nbytes: int) -> tuple[int, int]:
        if nbytes <= 0:
            return (0, 0)
        return (offset // self.page_size, -(-(offset + nbytes) // self.page_size))

    def mark(self, offset: int, nbytes: int) -> None:
        b0, b1 = self.block_range(offset, nbytes)
        with self._lock:
            run = self._bits[b0:b1]
            self._count += run.size - int(np.count_nonzero(run))
            run[:] = True

    def _normalize(self, mask: np.ndarray) -> np.ndarray:
        """Clip/pad a block mask to ``num_blocks`` booleans.

        Extra trailing bits (a device diff padded past the last block) are
        ignored; a short mask leaves the uncovered tail unselected.  This
        tolerant normalization is for *internal* masks (device diffs,
        mirror/replica bookkeeping): user-supplied masks are length-checked
        at the window boundary (``Window._validate_mask`` raises on
        mismatch) before they ever reach a tracker, so a short mask cannot
        silently skip a dirty tail.
        """
        mask = np.asarray(mask, dtype=bool).ravel()
        out = np.zeros(self.num_blocks, dtype=bool)
        n = min(len(mask), self.num_blocks)
        out[:n] = mask[:n]
        return out

    def mark_blocks(self, mask: np.ndarray) -> None:
        """OR a boolean block mask into the bitmap (device-diff path)."""
        m = self._normalize(mask)
        with self._lock:
            self._count += int(np.count_nonzero(m & ~self._bits))
            self._bits |= m

    def clear_block(self, block: int) -> None:
        """Clear one block's bit (its page was written back)."""
        with self._lock:
            if self._bits[block]:
                self._bits[block] = False
                self._count -= 1

    def is_dirty(self, block: int) -> bool:
        return bool(self._bits[block])

    def snapshot_and_clear(self, mask: np.ndarray | None = None) -> np.ndarray:
        """Atomically take the dirty set and reset it (start of a sync epoch).

        With ``mask``, only ``dirty AND mask`` blocks are taken (and only
        those are cleared): blocks dirty outside the mask stay dirty for a
        later sync, and clean blocks inside the mask are never selected --
        the intersection rule behind ``flush_async(mask=...)``.
        """
        with self._lock:
            if mask is None:
                out = self._bits.copy()
                self._bits[:] = False
                self._count = 0
            else:
                m = self._normalize(mask)
                out = self._bits & m
                self._bits &= ~m
                self._count -= int(np.count_nonzero(out))
        return out

    def masked_dirty_count(self, mask: np.ndarray) -> int:
        """Number of blocks both dirty and selected by ``mask``."""
        m = self._normalize(mask)
        with self._lock:
            return int((self._bits & m).sum())

    def restore(self, mask: np.ndarray) -> None:
        """Re-mark blocks (used if a flush fails mid-way)."""
        self.mark_blocks(mask)

    def dirty_runs(self, mask: np.ndarray | None = None) -> list[tuple[int, int]]:
        """Contiguous [start_block, end_block) runs of dirty blocks."""
        return dirty_runs(self._bits if mask is None else mask)


class StripedFile:
    """A byte space striped across ``striping_factor`` files.

    Logical offset -> stripe = offset // unit; file = stripe % factor;
    in-file offset = (stripe // factor) * unit + offset % unit.
    With factor == 1 this degenerates to a single plain file.
    """

    def __init__(self, path: str, size: int, *, striping_factor: int = 1,
                 striping_unit: int = 1 << 20, file_perm: int = 0o644,
                 offset: int = 0):
        self.path = path
        self.size = size
        self.factor = max(1, int(striping_factor))
        self.unit = max(1, int(striping_unit))
        self.base_offset = offset
        self._paths: list[str] = (
            [path] if self.factor == 1
            else [f"{path}.stripe{i}" for i in range(self.factor)]
        )
        self._fds: list[int] = []
        self._open(file_perm)

    def _open(self, perm: int) -> None:
        per_file = self._per_file_len()
        for i, p in enumerate(self._paths):
            d = os.path.dirname(os.path.abspath(p))
            os.makedirs(d, exist_ok=True)
            fd = os.open(p, os.O_RDWR | os.O_CREAT, perm)
            # Paper: ftruncate guarantees the mapping has enough associated
            # storage space (writing beyond the last page would segfault).
            need = per_file[i] + (self.base_offset if self.factor == 1 else 0)
            if os.fstat(fd).st_size < need:
                os.ftruncate(fd, need)
            self._fds.append(fd)

    def _per_file_len(self) -> list[int]:
        if self.factor == 1:
            return [self.size]
        lens = [0] * self.factor
        full, rem = divmod(self.size, self.unit)
        for s in range(full):
            lens[s % self.factor] += self.unit
        if rem:
            lens[full % self.factor] += rem
        # convert stripe counts into byte lengths per file: computed above
        return lens

    def _segments(self, offset: int, nbytes: int):
        """Yield (fd_index, file_offset, length, buf_offset) covering the range."""
        pos, out_pos = offset, 0
        end = offset + nbytes
        while pos < end:
            stripe = pos // self.unit
            in_stripe = pos % self.unit
            length = min(self.unit - in_stripe, end - pos)
            if self.factor == 1:
                yield 0, self.base_offset + pos, length, out_pos
            else:
                fidx = stripe % self.factor
                foff = (stripe // self.factor) * self.unit + in_stripe
                yield fidx, foff, length, out_pos
            pos += length
            out_pos += length

    def pread(self, offset: int, nbytes: int) -> bytes:
        buf = bytearray(nbytes)
        for fidx, foff, length, bpos in self._segments(offset, nbytes):
            chunk = os.pread(self._fds[fidx], length, foff)
            buf[bpos:bpos + len(chunk)] = chunk
            if len(chunk) < length:  # hole past EOF reads as zeros
                buf[bpos + len(chunk):bpos + length] = b"\0" * (length - len(chunk))
        return bytes(buf)

    def pread_into(self, offset: int, buf: np.ndarray) -> None:
        """Fill the uint8 array ``buf`` from ``offset``, as :meth:`pread`
        (a hole past EOF reads as zeros), without an intermediate copy."""
        mv = memoryview(buf).cast("B")
        for fidx, foff, length, bpos in self._segments(offset, buf.nbytes):
            got = os.preadv(self._fds[fidx], [mv[bpos:bpos + length]], foff)
            if got < length:
                buf[bpos + got:bpos + length] = 0

    def pwrite(self, offset: int, data: bytes | memoryview) -> None:
        mv = memoryview(data)
        for fidx, foff, length, bpos in self._segments(offset, len(mv)):
            os.pwrite(self._fds[fidx], mv[bpos:bpos + length], foff)

    def fsync(self) -> None:
        for fd in self._fds:
            os.fsync(fd)

    def close(self, unlink: bool = False) -> None:
        for fd in self._fds:
            try:
                os.close(fd)
            except OSError:
                pass
        self._fds = []
        if unlink:
            for p in self._paths:
                try:
                    os.unlink(p)
                except FileNotFoundError:
                    pass


class _BackingBase:
    """Shared dirty-tracking plumbing."""

    def __init__(self, size: int, page_size: int):
        self.size = size
        self.page_size = page_size
        self.tracker = DirtyTracker(size, page_size)
        self.closed = False
        self.sync_count = 0
        self.bytes_flushed = 0

    def _check(self, offset: int, nbytes: int) -> None:
        if self.closed:
            raise RuntimeError("backing is closed")
        if offset < 0 or offset + nbytes > self.size:
            raise IndexError(
                f"access [{offset}, {offset + nbytes}) outside window of {self.size} bytes")

    def dirty_bytes(self, mask: np.ndarray | None = None) -> int:
        """Upper bound on bytes a sync() would flush right now (whole pages).

        With ``mask``, counts only blocks that are both dirty and selected
        (the bytes ``sync(mask=...)`` would flush).
        """
        if mask is None:
            return self.tracker.dirty_count * self.page_size
        return self.tracker.masked_dirty_count(mask) * self.page_size


class MmapBacking(_BackingBase):
    """The paper's original mechanism: memory-mapped file I/O.

    A single np.memmap covers [offset, offset+size) of the target file; the
    OS page cache does the caching; ``sync`` msyncs -- selectively, by
    flushing only dirty block ranges via a re-sliced memmap flush.
    """

    def __init__(self, path: str, size: int, *, offset: int = 0,
                 page_size: int = DEFAULT_PAGE_SIZE, file_perm: int = 0o644,
                 striping_factor: int = 1, striping_unit: int = 1 << 20):
        super().__init__(size, page_size)
        if striping_factor != 1:
            raise ValueError("MmapBacking does not stripe; use CachedBacking")
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        fd = os.open(path, os.O_RDWR | os.O_CREAT, file_perm)
        try:
            if os.fstat(fd).st_size < offset + size:
                os.ftruncate(fd, offset + size)  # paper: ftruncate before mmap
        finally:
            os.close(fd)
        self.path = path
        self.offset = offset
        self._mm = np.memmap(path, dtype=np.uint8, mode="r+",
                             offset=offset, shape=(size,))

    def read(self, offset: int, nbytes: int) -> np.ndarray:
        self._check(offset, nbytes)
        return np.array(self._mm[offset:offset + nbytes])

    def view(self, offset: int, nbytes: int) -> np.ndarray:
        """Zero-copy load/store view (the window's ``baseptr``)."""
        self._check(offset, nbytes)
        return self._mm[offset:offset + nbytes]

    def write(self, offset: int, data) -> None:
        data = np.asarray(data, dtype=np.uint8).ravel()
        self._check(offset, data.nbytes)
        self._mm[offset:offset + data.nbytes] = data
        self.tracker.mark(offset, data.nbytes)

    def mark_dirty(self, offset: int, nbytes: int) -> None:
        self.tracker.mark(offset, nbytes)

    def sync(self, full: bool = False, mask: np.ndarray | None = None) -> int:
        """msync; returns bytes flushed.  Selective unless ``full``.

        ``mask`` restricts the flush to ``dirty AND mask`` blocks (the
        device-diff intersection rule); blocks dirty outside the mask stay
        dirty.  If the msync fails, the taken blocks are re-marked so a
        retry replays them (never skips).
        """
        if self.closed:
            raise RuntimeError("backing is closed")
        self.sync_count += 1
        if full:
            self._mm.flush()
            self.tracker.snapshot_and_clear()
            self.bytes_flushed += self.size
            return self.size
        take = self.tracker.snapshot_and_clear(mask=mask)
        flushed = 0
        for b0, b1 in dirty_runs(take):
            lo = b0 * self.page_size
            hi = min(b1 * self.page_size, self.size)
            # np.memmap.flush() flushes the whole map; emulate ranged msync
            # by flushing once at the end -- but count selective bytes.
            flushed += hi - lo
        if flushed:
            try:
                self._mm.flush()
            except BaseException:
                self.tracker.restore(take)  # replay, never skip
                raise
        self.bytes_flushed += flushed
        return flushed

    def close(self, unlink: bool = False, discard: bool = False) -> None:
        if self.closed:
            return
        if not discard:
            self._mm.flush()
        # release the mapping (munmap)
        del self._mm
        self.closed = True
        if unlink:
            try:
                os.unlink(self.path)
            except FileNotFoundError:
                pass


class CachedBacking(_BackingBase):
    """User-level page cache over a (possibly striped) file.

    Implements the paper's §6 future work.  Pages are ``page_size`` blocks;
    a bounded pool of cache slots holds resident blocks with second-chance
    (clock) eviction; writes mark blocks dirty; eviction of a dirty block
    writes it back first.  A background flusher thread emulates
    ``vm.dirty_writeback_centisecs``; ``dirty_ratio`` bounds the dirty
    fraction before writes force a flush (``vm.dirty_ratio``).
    """

    def __init__(self, path: str, size: int, *, offset: int = 0,
                 page_size: int = DEFAULT_PAGE_SIZE, cache_bytes: int | None = None,
                 dirty_ratio: float = 1.0, writeback_interval: float | None = None,
                 file_perm: int = 0o644, striping_factor: int = 1,
                 striping_unit: int = 1 << 20, compare_on_write: bool = False):
        super().__init__(size, page_size)
        # compare_on_write: a write whose bytes equal the cached content does
        # not dirty the block -- the host-side analogue of the CUDA
        # ``dirty_diff`` kernel.  Makes selective sync effective even when a
        # caller rewrites the whole window (e.g. double-buffered checkpoints).
        self.compare_on_write = compare_on_write
        self.file = StripedFile(path, size, striping_factor=striping_factor,
                                striping_unit=striping_unit, file_perm=file_perm,
                                offset=offset)
        nblocks = self.tracker.num_blocks
        if cache_bytes is None:
            cache_bytes = size  # default: cache everything (pure write-back)
        self.capacity = max(1, min(nblocks, cache_bytes // page_size)) if nblocks else 0
        self._slots = np.zeros((self.capacity, page_size), dtype=np.uint8)
        self._slot_of = np.full(nblocks, -1, dtype=np.int64)   # block -> slot
        self._block_of = np.full(self.capacity, -1, dtype=np.int64)  # slot -> block
        self._refbit = np.zeros(self.capacity, dtype=bool)
        self._clock = 0
        self._used = 0
        self.dirty_ratio = dirty_ratio
        self._io_lock = threading.RLock()
        self.faults = 0
        self.evictions = 0
        self._flusher: "_Flusher | None" = None
        if writeback_interval:
            self._flusher = _Flusher(self, writeback_interval)
            self._flusher.start()

    # -- slot management ---------------------------------------------------
    def _evict_one(self) -> int:
        """Clock eviction; returns a freed slot index."""
        while True:
            s = self._clock
            self._clock = (self._clock + 1) % self.capacity
            if self._block_of[s] < 0:
                return s
            if self._refbit[s]:
                self._refbit[s] = False
                continue
            blk = int(self._block_of[s])
            if self.tracker.is_dirty(blk):
                self._writeback_block(blk, s)
            self._slot_of[blk] = -1
            self._block_of[s] = -1
            self._used -= 1
            self.evictions += 1
            return s

    def _writeback_block(self, blk: int, slot: int) -> None:
        lo = blk * self.page_size
        hi = min(lo + self.page_size, self.size)
        self.file.pwrite(lo, self._slots[slot, : hi - lo].tobytes())
        self.tracker.clear_block(blk)
        self.bytes_flushed += hi - lo

    def _fault_in(self, blk: int, *, load: bool = True) -> int:
        s = int(self._slot_of[blk])
        if s >= 0:
            self._refbit[s] = True
            return s
        s = self._evict_one() if self._used >= self.capacity else self._free_slot()
        if load:
            lo = blk * self.page_size
            hi = min(lo + self.page_size, self.size)
            data = self.file.pread(lo, hi - lo)
            self._slots[s, : hi - lo] = np.frombuffer(data, dtype=np.uint8)
            if hi - lo < self.page_size:
                self._slots[s, hi - lo:] = 0
            self.faults += 1
        self._slot_of[blk] = s
        self._block_of[s] = blk
        self._refbit[s] = True
        self._used += 1
        return s

    def _free_slot(self) -> int:
        # Slots fill in index order and an evicted slot is reused at once,
        # so the lowest free slot is normally slot ``_used``: O(1) instead
        # of the reference's scan of every slot per fault, which makes
        # first-touching a window of P pages cost O(P^2).
        free = self._free_slots(1)
        return self._evict_one() if len(free) == 0 else int(free[0])

    def _free_slots(self, n: int) -> np.ndarray:
        """The ``n`` lowest free slots (fewer if fewer are free).  Slots
        are only freed by an eviction that refills the slot at once, so the
        used slots are ``[0, _used)`` and the lowest free ones follow: a
        cursor, not a scan of every slot (the reference's rule, without
        its cost).  The scan stays for a pool that breaks that pattern."""
        s = self._used
        if s + n <= self.capacity and (self._block_of[s:s + n] < 0).all():
            return np.arange(s, s + n)
        return np.flatnonzero(self._block_of < 0)[:n]

    def _fault_in_bulk(self, b0: int, b1: int) -> bool:
        """Load every missing block of ``[b0, b1)`` with one ``pread`` per
        run of consecutive missing blocks (at most 64 MB a read), into the
        lowest free slots in block order: the slots, contents and
        ``faults`` that :meth:`_fault_in` gives block by block.  Returns
        False, having done nothing, when they do not all fit in free slots
        (the per-block path then evicts as the reference does)."""
        missing = np.flatnonzero(self._slot_of[b0:b1] < 0) + b0
        if missing.size == 0:
            return True
        if self._used + missing.size > self.capacity:
            return False
        free = self._free_slots(missing.size)
        if free.size < missing.size:
            return False
        ps = self.page_size
        run_pages = max(1, (64 << 20) // ps)
        # [i, j) index runs of missing blocks, each cut to run_pages
        cuts = np.flatnonzero(np.diff(missing) != 1) + 1
        for i, j in zip(np.r_[0, cuts], np.r_[cuts, missing.size]):
            for i0 in range(int(i), int(j), run_pages):
                i1 = min(i0 + run_pages, int(j))
                lo = int(missing[i0]) * ps
                hi = min(int(missing[i1 - 1] + 1) * ps, self.size)
                dst = free[i0:i1]
                if dst[-1] - dst[0] == dst.size - 1:  # consecutive slots
                    rows = self._slots[dst[0]:dst[-1] + 1]
                    self.file.pread_into(lo, rows.reshape(-1)[:hi - lo])
                    rows.reshape(-1)[hi - lo:] = 0  # a ragged last block
                    continue
                data = np.frombuffer(self.file.pread(lo, hi - lo),
                                     dtype=np.uint8)
                full = data.size // ps
                self._slots[dst[:full]] = data[:full * ps].reshape(full, ps)
                if full < dst.size:  # the file's ragged last block
                    self._slots[dst[full], :data.size - full * ps] = \
                        data[full * ps:]
                    self._slots[dst[full], data.size - full * ps:] = 0
        self._slot_of[missing] = free
        self._block_of[free] = missing
        self._refbit[free] = True
        self._used += missing.size
        self.faults += missing.size
        return True

    # -- public interface ---------------------------------------------------
    def read(self, offset: int, nbytes: int) -> np.ndarray:
        self._check(offset, nbytes)
        out = np.empty(nbytes, dtype=np.uint8)
        with self._io_lock:
            b0, b1 = self.tracker.block_range(offset, nbytes)
            # fast path: fault the missing blocks in by runs (a restore's
            # cold window: one pread a run, not one a page), then one gather
            if nbytes and self._fault_in_bulk(b0, b1):
                slots = self._slot_of[b0:b1]
                lo = offset - b0 * self.page_size
                s0 = int(slots[0])
                if (slots == np.arange(s0, s0 + slots.size)).all():
                    rows = self._slots[s0:s0 + slots.size]  # one memcpy
                else:
                    rows = self._slots[slots]
                out[:] = rows.reshape(-1)[lo:lo + nbytes]
                self._refbit[slots] = True
                return out
            pos = offset
            opos = 0
            for blk in range(b0, b1):
                lo = blk * self.page_size
                s = self._fault_in(blk)
                off_in = pos - lo
                length = min(self.page_size - off_in, nbytes - opos)
                out[opos:opos + length] = self._slots[s, off_in:off_in + length]
                pos += length
                opos += length
        return out

    def _write_bulk(self, offset: int, data: np.ndarray) -> bool:
        """Vectorized full-page span write; False if preconditions fail."""
        nbytes = data.nbytes
        b0, b1 = offset // self.page_size, (offset + nbytes) // self.page_size
        if not ((self._slot_of[b0:b1] >= 0).all()
                or self._used + int((self._slot_of[b0:b1] < 0).sum())
                <= self.capacity):
            return False
        # allocate every missing slot at once (no load: full-block
        # overwrite); the check above guarantees there is room for them
        missing = np.flatnonzero(self._slot_of[b0:b1] < 0) + b0
        if missing.size:
            free = self._free_slots(missing.size)
            self._slot_of[missing] = free
            self._block_of[free] = missing
            self._used += missing.size
        slots = self._slot_of[b0:b1]
        self._slots[slots] = data.reshape(-1, self.page_size)
        self._refbit[slots] = True
        self.tracker.mark(offset, nbytes)
        return True

    def _write_slow(self, offset: int, data: np.ndarray) -> None:
        nbytes = data.nbytes
        b0, b1 = self.tracker.block_range(offset, nbytes)
        pos, dpos = offset, 0
        for blk in range(b0, b1):
            lo = blk * self.page_size
            off_in = pos - lo
            length = min(self.page_size - off_in, nbytes - dpos)
            full_block = off_in == 0 and length == self.page_size
            # A full-block overwrite need not read the old contents --
            # unless we must compare against them.
            s = self._fault_in(blk, load=(not full_block)
                               or self.compare_on_write)
            src = data[dpos:dpos + length]
            if self.compare_on_write and np.array_equal(
                    self._slots[s, off_in:off_in + length], src):
                pos += length
                dpos += length
                continue  # unchanged bytes: leave the block clean
            self._slots[s, off_in:off_in + length] = src
            self.tracker.mark(pos, length)
            pos += length
            dpos += length

    def write(self, offset: int, data) -> None:
        data = np.asarray(data, dtype=np.uint8).ravel()
        nbytes = data.nbytes
        self._check(offset, nbytes)
        ps = self.page_size
        with self._io_lock:
            # split into [head | page-aligned bulk | tail]: the bulk span is
            # one vectorized scatter instead of a python loop per page
            a = -(-offset // ps) * ps
            b = (offset + nbytes) // ps * ps
            done = False
            if not self.compare_on_write and b - a >= ps:
                if self._write_bulk(a, data[a - offset: b - offset]):
                    if a > offset:
                        self._write_slow(offset, data[: a - offset])
                    if offset + nbytes > b:
                        self._write_slow(b, data[b - offset:])
                    done = True
            if not done:
                self._write_slow(offset, data)
            # vm.dirty_ratio: too many dirty pages => synchronous flush.
            if self.tracker.dirty_fraction > self.dirty_ratio:
                self._flush_locked()

    def sync(self, full: bool = False, mask: np.ndarray | None = None) -> int:
        """Selective flush of dirty blocks (MPI_Win_sync).  Returns bytes.

        "May return immediately if the pages are already synchronized": a
        clean window skips both the write-back and the fsync.

        ``mask`` (boolean, tracker-block coordinates) intersects with the
        dirty bitmap: only ``dirty AND mask`` blocks flush, dirty blocks
        outside the mask *stay dirty* for a later sync, and clean blocks in
        the mask cost nothing.  This is the device-diff path: a CUDA
        ``dirty_diff`` bitmap restricts write-back without host compares.
        """
        if self.closed:
            raise RuntimeError("backing is closed")
        with self._io_lock:
            self.sync_count += 1
            n = self._flush_locked(full=full, mask=mask)
            if n:
                try:
                    self.file.fsync()
                except BaseException:
                    # fsync failure: durability of the just-written blocks is
                    # unknown -- conservatively re-dirty the whole window so a
                    # retry replays everything (never skips).
                    self.tracker.mark(0, self.size)
                    raise
            return n

    def _flush_locked(self, full: bool = False,
                      mask: np.ndarray | None = None) -> int:
        take = self.tracker.snapshot_and_clear(mask=mask)
        if full:
            take[:] = True
        flushed = 0
        try:
            for b0, b1 in dirty_runs(take):
                # coalesce the run: gather resident slots, one pwrite per span
                slots = self._slot_of[b0:b1]
                resident = slots >= 0
                if resident.all() and b1 * self.page_size <= self.size:
                    # written from the cache itself where the run's slots
                    # are consecutive (as a whole-window put leaves them),
                    # else from one gathered copy: a run can be the window
                    s0 = int(slots[0])
                    if (np.diff(slots) == 1).all():
                        buf = self._slots[s0:s0 + len(slots)].reshape(-1)
                    else:
                        buf = self._slots[slots].reshape(-1)
                    self.file.pwrite(b0 * self.page_size, buf)
                    flushed += buf.nbytes
                    continue
                for blk in range(b0, b1):
                    s = int(self._slot_of[blk])
                    lo = blk * self.page_size
                    hi = min(lo + self.page_size, self.size)
                    if s >= 0:
                        self.file.pwrite(lo, self._slots[s, : hi - lo].tobytes())
                        flushed += hi - lo
        except BaseException:
            # A mid-flush failure must not lose the taken blocks: re-mark
            # everything we took (re-flushing the already-written prefix on
            # retry is harmless) so the next sync replays, never skips.
            self.tracker.restore(take)
            raise
        self.bytes_flushed += flushed
        return flushed

    def mark_dirty(self, offset: int, nbytes: int) -> None:
        self.tracker.mark(offset, nbytes)

    def close(self, unlink: bool = False, discard: bool = False) -> None:
        if self.closed:
            return
        if self._flusher is not None:
            self._flusher.stop()
        with self._io_lock:
            if not discard:
                self._flush_locked()
                self.file.fsync()
            self.closed = True
        self.file.close(unlink=unlink)


class _Flusher(threading.Thread):
    """Background write-back (vm.dirty_writeback_centisecs analogue).

    This is what lets checkpoint I/O overlap with compute: dirty blocks
    trickle out while the training step runs, so the synchronous part of
    ``MPI_Win_sync`` only covers the still-dirty remainder.
    """

    def __init__(self, backing: CachedBacking, interval: float):
        super().__init__(daemon=True, name="repro-writeback")
        self.backing = backing
        self.interval = interval
        # NB: must not be named ``_stop`` -- that shadows a Thread internal
        # that join() calls, breaking every join on this thread.
        self._stop_evt = threading.Event()

    def run(self) -> None:
        while not self._stop_evt.wait(self.interval):
            try:
                with self.backing._io_lock:
                    if not self.backing.closed:
                        self.backing._flush_locked()
            except Exception:  # pragma: no cover - best-effort flusher
                pass

    def stop(self) -> None:
        self._stop_evt.set()
        self.join(timeout=5.0)


class _Ticket:
    """Completion handle for one :class:`WritebackPool` task.

    Low-level primitive: the window layer wraps tickets in MPI-style
    ``Request`` objects.  ``result``/``exception`` are valid once ``done()``.
    """

    __slots__ = ("_event", "_fn", "key", "nbytes", "sample", "result",
                 "exception", "_next")

    def __init__(self, fn, key, nbytes: int = 0, sample: bool = False):
        self._event = threading.Event()
        self._fn = fn
        self.key = key
        self.nbytes = int(nbytes)  # in-flight byte charge (backpressure)
        self.sample = sample  # count toward the flush-throughput EWMA
        self.result = None
        self.exception: BaseException | None = None
        self._next: "_Ticket | None" = None  # same-key successor (FIFO chain)

    def done(self) -> bool:
        return self._event.is_set()

    def wait(self, timeout: float | None = None) -> bool:
        return self._event.wait(timeout)


class WritebackPool:
    """Per-window background write-back thread pool.

    The engine behind the nonblocking one-sided layer: deferred RMA
    operations (rput/rget/raccumulate) and asynchronous flushes run here, off
    the caller's thread, so storage latency overlaps with compute -- the
    paper's answer to the 55-90% storage penalty.  Flush tasks go through
    ``CachedBacking.sync``/``_flush_locked``, which already coalesces dirty
    pages into one batched sequential ``pwrite`` per contiguous run.

    Ordering contract: tasks submitted with the same ``key`` (we key by
    target rank) execute in submission order -- a flush queued after an rput
    to the same rank persists that rput's bytes.  Tasks with different keys
    may run concurrently across ``workers`` threads.  A pending same-key
    predecessor defers the successor's enqueue to the predecessor's
    completion, so a slow rank never occupies more than one worker.

    Backpressure (bounded in-flight bytes): with ``max_inflight_bytes`` set
    (the *high watermark*), ``submit`` of a task carrying ``nbytes`` blocks
    the calling thread whenever admitting it would push the queued in-flight
    total past the high mark, and resumes only once completions drain the
    total to the *low watermark* (default ``high // 2``, hysteresis against
    thrashing).  This is how a slow disk throttles ``rput``/``flush_async``
    producers instead of growing the request queue without limit (the
    engineering answer to the paper's >90% Lustre write degradation: bounded
    memory, bounded tail latency).  One submission larger than the high mark
    is admitted only alone (in-flight total == its own size), so a single
    oversized flush cannot deadlock.  Stats (``stats()``): submitted/
    completed task and byte counters, ``stalls``/``stall_seconds``, and the
    ``max_inflight_bytes`` high-water mark actually observed.

    Adaptive watermarks: the pool always tracks an EWMA of the *observed
    flush throughput* (bytes/second over tasks submitted with
    ``sample=True`` -- the disk-bound flushes, not the memcpy-fast rputs).
    When ``max_inflight_bytes`` is **not** given but ``target_latency`` is,
    the high watermark is sized from that measurement instead of a static
    hint: ``high = ~2 x (ewma_throughput x target_latency)`` (2x headroom so
    steady-state production at disk speed never stalls; floored at 1 MiB),
    with ``low = high // 2`` hysteresis, re-derived as each sampled flush
    completes.  The queue is unbounded until the first measurement.  The
    chosen value is exposed by ``stats()['high_watermark']``.
    """

    #: EWMA smoothing for the flush-throughput estimate (per completed task)
    EWMA_ALPHA = 0.3
    #: adaptive high watermark = HEADROOM * throughput * target_latency
    ADAPTIVE_HEADROOM = 2.0
    #: never adapt the high watermark below this
    ADAPTIVE_FLOOR = 1 << 20

    def __init__(self, workers: int = 2, name: str = "repro-async-wb", *,
                 max_inflight_bytes: int | None = None,
                 low_watermark: int | None = None,
                 target_latency: float | None = None):
        self.workers = max(1, int(workers))
        if max_inflight_bytes is not None and max_inflight_bytes <= 0:
            raise ValueError("max_inflight_bytes must be > 0 (or None)")
        if target_latency is not None and target_latency <= 0:
            raise ValueError("target_latency must be > 0 (or None)")
        self.max_inflight_bytes = max_inflight_bytes
        if low_watermark is None:
            low_watermark = (max_inflight_bytes // 2
                             if max_inflight_bytes is not None else 0)
        if max_inflight_bytes is not None and not (
                0 <= low_watermark <= max_inflight_bytes):
            raise ValueError("low_watermark must be in [0, max_inflight_bytes]")
        self.low_watermark = low_watermark
        self.target_latency = target_latency
        # an explicit static bound wins; adaptive sizing needs a latency goal
        self._adaptive = (max_inflight_bytes is None
                          and target_latency is not None)
        self._ewma_bps: float | None = None
        # sampled tasks currently executing: a task sharing the disk with k
        # others observes ~1/k of the aggregate bandwidth, so its per-task
        # rate is scaled back up by the concurrency seen at its start
        self._running_samples = 0
        self._inflight_bytes = 0
        self._counters = {
            "submitted": 0, "completed": 0,
            "submitted_bytes": 0, "completed_bytes": 0,
            "stalls": 0, "stall_seconds": 0.0,
            "max_inflight_bytes": 0,
        }
        self._cond = threading.Condition()
        self._runq: collections.deque[_Ticket] = collections.deque()
        self._tails: dict = {}  # key -> newest pending ticket for that key
        self._pending = 0
        self._shutdown = False
        self._threads = []
        for i in range(self.workers):
            t = threading.Thread(target=self._worker, daemon=True,
                                 name=f"{name}-{i}")
            t.start()
            self._threads.append(t)

    def begin_flush_sample(self) -> int:
        """Mark the start of an externally timed flush I/O region; returns
        the sampled-flush concurrency to pass to :meth:`end_flush_sample`.

        The window layer uses this pair instead of ``submit(sample=True)``
        so the timed region covers only the storage I/O -- an exclusive
        flush's wait for the target's window lock must not deflate the
        throughput estimate.
        """
        with self._cond:
            self._running_samples += 1
            return self._running_samples

    def end_flush_sample(self, nbytes: int, seconds: float,
                         concurrency: int) -> None:
        """Close a :meth:`begin_flush_sample` region and feed the EWMA
        (``nbytes <= 0`` -- nothing flushed, or the flush failed -- only
        decrements the concurrency)."""
        with self._cond:
            self._running_samples -= 1
            if nbytes > 0:
                self._observe_throughput(
                    max(1, concurrency) * nbytes / max(seconds, 1e-6))

    @property
    def bounded(self) -> bool:
        """True when in-flight byte charges matter: a static high watermark
        is set, or adaptive sizing will derive one.  Callers whose charge
        is expensive to estimate (a cross-process dirty_bytes query) can
        skip it entirely for an unbounded pool."""
        return self.max_inflight_bytes is not None or self._adaptive

    def submit(self, fn, key=None, nbytes: int = 0,
               force: bool = False, sample: bool = False) -> _Ticket:
        """Queue ``fn`` for background execution; returns its ticket.

        ``nbytes`` is the task's in-flight byte charge (an rput's payload, a
        flush's estimated dirty bytes).  With backpressure configured, a
        submission that would exceed the high watermark blocks here until
        completions drain in-flight bytes to the low watermark.

        ``force`` skips the stall (the bytes are still charged): used by
        callers that must not block -- e.g. a thread submitting from inside
        its own window-lock epoch, where draining may require tasks blocked
        on (or queued behind a writer blocked on) that very lock (stalling
        would deadlock).

        ``sample`` marks the task as a storage flush whose observed
        bytes/second should feed the adaptive-watermark EWMA (rputs are
        page-cache memcpys and would inflate the estimate).
        """
        t = _Ticket(fn, key, nbytes, sample=sample)
        with self._cond:
            if self._shutdown:
                raise RuntimeError("writeback pool is shut down")
            if (not force
                    and self.max_inflight_bytes is not None and t.nbytes > 0
                    and self._inflight_bytes > 0
                    and self._inflight_bytes + t.nbytes
                    > self.max_inflight_bytes):
                # Past the high mark: stall until drained to the low mark
                # (or far enough for an oversized task to fit alone).
                self._counters["stalls"] += 1
                t0 = time.monotonic()
                while True:
                    # re-derive each wake-up: adaptive completions may move
                    # the watermarks while we wait
                    target = max(0, min(self.max_inflight_bytes - t.nbytes,
                                        self.low_watermark))
                    if self._inflight_bytes <= target:
                        break
                    self._cond.wait()
                    if self._shutdown:
                        raise RuntimeError("writeback pool is shut down")
                self._counters["stall_seconds"] += time.monotonic() - t0
            self._inflight_bytes += t.nbytes
            self._counters["submitted"] += 1
            self._counters["submitted_bytes"] += t.nbytes
            if self._inflight_bytes > self._counters["max_inflight_bytes"]:
                self._counters["max_inflight_bytes"] = self._inflight_bytes
            self._pending += 1
            if key is not None:
                prev = self._tails.get(key)
                self._tails[key] = t
                if prev is not None and not prev.done():
                    prev._next = t  # runs when prev completes (FIFO per key)
                    return t
            self._runq.append(t)
            self._cond.notify()
        return t

    def _worker(self) -> None:
        while True:
            with self._cond:
                while not self._runq and not self._shutdown:
                    self._cond.wait()
                if not self._runq and self._shutdown:
                    return
                t = self._runq.popleft()
                is_sample = t.sample and t.nbytes > 0
                if is_sample:
                    self._running_samples += 1
                concurrency = self._running_samples
            t0 = time.monotonic()
            try:
                t.result = t._fn()
            except BaseException as e:  # surfaced at Request.wait()
                t.exception = e
            dt = time.monotonic() - t0
            with self._cond:
                t._event.set()
                self._pending -= 1
                self._inflight_bytes -= t.nbytes
                self._counters["completed"] += 1
                self._counters["completed_bytes"] += t.nbytes
                if is_sample:
                    self._running_samples -= 1
                    if t.exception is None:
                        self._observe_throughput(
                            max(1, concurrency) * t.nbytes / max(dt, 1e-6))
                if t.key is not None:
                    if t._next is not None:
                        self._runq.append(t._next)
                    if self._tails.get(t.key) is t:
                        del self._tails[t.key]
                self._cond.notify_all()

    def _observe_throughput(self, bps: float) -> None:
        """EWMA-update the flush-throughput estimate (under ``_cond``) and,
        in adaptive mode, re-derive the watermarks from it.  ``bps`` is the
        task's observed rate scaled by the sampled-task concurrency at its
        start -- an estimate of the *aggregate* disk bandwidth, so the 2x
        headroom survives multi-worker pools."""
        a = self.EWMA_ALPHA
        self._ewma_bps = bps if self._ewma_bps is None else \
            a * bps + (1 - a) * self._ewma_bps
        if self._adaptive:
            high = max(self.ADAPTIVE_FLOOR,
                       int(self.ADAPTIVE_HEADROOM * self._ewma_bps
                           * self.target_latency))
            self.max_inflight_bytes = high
            self.low_watermark = high // 2
            self._cond.notify_all()  # stalled submitters re-check the marks

    def stats(self) -> dict:
        """Snapshot of the backpressure/throughput counters.

        ``high_watermark``/``low_watermark`` are the currently *chosen*
        bounds (static hint, adaptively derived, or None = unbounded);
        ``ewma_bytes_per_s`` is the observed flush throughput behind the
        adaptive choice.
        """
        with self._cond:
            out = dict(self._counters)
            out["inflight_bytes"] = self._inflight_bytes
            out["pending"] = self._pending
            out["high_watermark"] = self.max_inflight_bytes
            out["low_watermark"] = self.low_watermark
            out["ewma_bytes_per_s"] = self._ewma_bps
            out["adaptive"] = self._adaptive
            out["target_latency"] = self.target_latency
            return out

    def drain(self) -> None:
        """Block until every submitted task (including chained ones) is done."""
        with self._cond:
            while self._pending:
                self._cond.wait()

    def shutdown(self) -> None:
        """Drain, then stop the workers.  The pool cannot be reused."""
        self.drain()
        with self._cond:
            self._shutdown = True
            self._cond.notify_all()
        for th in self._threads:
            th.join(timeout=5.0)


def make_backing(path: str, size: int, *, mechanism: str = "cached", **kw):
    """Factory.  ``mechanism``: "cached" (user-level page cache, default)
    or "mmap" (the paper's original OS-page-cache mechanism)."""
    if mechanism == "mmap":
        kw.pop("cache_bytes", None)
        kw.pop("dirty_ratio", None)
        kw.pop("writeback_interval", None)
        kw.pop("compare_on_write", None)
        return MmapBacking(path, size, **kw)
    if mechanism == "cached":
        return CachedBacking(path, size, **kw)
    raise ValueError(f"unknown backing mechanism {mechanism!r}")
