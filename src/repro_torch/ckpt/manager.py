"""Transparent checkpoint/restart via storage windows.

The counterpart of ``repro.ckpt.manager``.  Trees may hold torch tensors on
any device (or numpy arrays): staging copies each to the host, since the
CRC needs every byte there, and diffs it in numpy, as the reference does.
The host copy is private to the manager, so it is also the window's new
snapshot.  A bfloat16 slot (an offload-mode parameter) is carried by name
and item size (:func:`repro_torch.convert.dtype_matches`) and its bytes
cross through an int16 view; the manifest writes the reference's dtype
strings (``numpy.dtype.str``: ``"<f4"``, and ``"<V2"`` for bfloat16, which
is what ``ml_dtypes.bfloat16`` reports), so window files and manifests are
byte-identical to the reference's for the same saves.

Implements the paper's fault-tolerance recipe end to end:

* Training state lives in a :class:`WindowedPyTree` whose backing is a
  storage window (user-level page cache, selective sync).
* A checkpoint is paper Listing 4: exclusive lock + ``MPI_Win_sync``.
  The sync is *selective*: only pages whose bytes changed since the
  window's last checkpoint get flushed (snapshot-diff staging, below).
* **Double buffering** (paper §4, "use two MPI storage windows and swap
  them on each checkpoint"): checkpoints alternate between window A and
  window B, so a crash mid-sync can never corrupt the last good version.
* A manifest (JSON, written atomically via rename) records step, target
  window and per-slot CRC32; restore validates CRCs and falls back to the
  previous manifest if the newest one is torn or mismatched.
* ``save_async`` overlaps the flush with compute: the puts land in the page
  cache synchronously (cheap memcpy), then the expensive storage flush rides
  the window's background :class:`~repro_torch.core.storage.WritebackPool` as a
  ``sync_async`` request whose completion hook commits the manifest.
  ``wait()`` joins the request before the next checkpoint swaps buffers, so
  the flush runs concurrently with the training step in between.
* **Snapshot-diff staging**: the manager keeps a host copy of each window's last-checkpointed bytes and
  page-diffs the new state against it.  Each slot is staged as a *shard*:
  its changed pages become byte spans and the per-slot page masks OR-merge
  into one window mask, shipped together through the transport's masked
  span-write primitive (``Window.sync(spans=...)``) -- apply + selective
  flush in a single operation, one control-channel round trip per rank
  under the multiprocess transport; the host-side twin of
  ``Window.sync_shards_from_device``.  If a flush fails, the snapshot for
  that window is invalidated and the backing re-marks the taken blocks, so
  the retry replays a full put + unmasked flush (replay, never skip); the
  manifest hook only ever runs after a *successful* flush, so a crash
  mid-save can never commit a manifest ahead of its data.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
import zlib
from typing import Any, Mapping

import numpy as np
import torch

from ..convert import dtype_matches, dtype_name
from ..core.comm import Communicator
from ..core.offload import WindowedPyTree
from ..core.storage import dirty_runs, mark_span
from ..core.window import Request

__all__ = ["CheckpointManager", "RestoreResult"]

_MANIFEST = "manifest.json"
_MANIFEST_PREV = "manifest.prev.json"


@dataclasses.dataclass
class RestoreResult:
    step: int
    tree: dict[str, np.ndarray]
    manifest: dict[str, Any]
    fell_back: bool = False


def _crc(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).reshape(-1).view(np.uint8))


def _stored(name: str) -> np.dtype:
    """The numpy dtype a slot of dtype ``name`` stores (bfloat16: its
    uint16 bits, as :class:`~repro_torch.core.offload.WindowedPyTree`)."""
    return np.dtype(np.uint16) if name == "bfloat16" else np.dtype(name)


def _dtype_str(name: str) -> str:
    """The reference manifest's dtype string (``numpy.dtype.str``)."""
    return "<V2" if name == "bfloat16" else np.dtype(name).str


def _host_copy(value, name: str) -> np.ndarray:
    """``value`` (a tensor on any device, or an array) as a private,
    contiguous host array of slot dtype ``name``'s stored type: the
    reference's ``np.ascontiguousarray(value, dtype)``, copied."""
    if isinstance(value, torch.Tensor):
        t = value.detach()
        if not dtype_matches(t.dtype, name):
            t = t.to(getattr(torch, name))
        if name == "bfloat16":
            t = t.view(torch.int16)
        return t.to("cpu", copy=True).numpy().view(_stored(name))
    arr = np.asarray(value)
    if name == "bfloat16":
        if arr.dtype.itemsize != 2 or arr.dtype.name not in (
                "bfloat16", "uint16", "int16"):
            raise TypeError("a bfloat16 slot takes bfloat16 tensors or bits "
                            f"(a 2-byte array), got {arr.dtype}")
        return np.array(arr, order="C").view(np.uint16)
    return np.array(arr, dtype=_stored(name), order="C")


class CheckpointManager:
    """A/B double-buffered, selectively-synced checkpoints for a pytree."""

    def __init__(self, directory: str, comm: Communicator,
                 specs: Mapping[str, tuple[tuple[int, ...], Any]], *,
                 rank: int | None = None, double_buffer: bool = True,
                 replication: int = 1):
        """``replication=k`` passes the ``storage_alloc_replication`` hint
        to both checkpoint windows: every save's flush then mirrors the
        changed pages to k-1 replica ranks *before* the manifest commits
        (the window's sync/flush epoch means k durable copies), and a
        ``restore`` whose primary rank died reads transparently from a
        replica -- the checkpoint survives rank death without a restart.
        Requires ``comm.size >= k`` (clamped otherwise, like every hint).
        """
        self.directory = directory
        self.comm = comm
        # SPMD wiring: by default each process checkpoints its own rank's
        # segment (the communicator's env-bootstrapped identity)
        self.rank = comm.rank if rank is None else rank
        # dtypes by name: torch, numpy or "bfloat16" (no numpy type here)
        self.specs = {k: (tuple(v[0]), dtype_name(v[1]))
                      for k, v in specs.items()}
        os.makedirs(directory, exist_ok=True)
        self.names = ["a", "b"] if double_buffer else ["a"]
        self.windows: dict[str, WindowedPyTree] = {}
        # each window's last-checkpointed bytes (host copies): each save
        # page-diffs against them and puts/flushes only changed pages
        self._snapshots: dict[str, dict[str, np.ndarray]] = {}
        for name in self.names:
            info = {
                "alloc_type": "storage",
                "storage_alloc_filename": os.path.join(directory, f"ckpt_{name}.bin"),
            }
            if replication > 1:
                info["storage_alloc_replication"] = str(replication)
            self.windows[name] = WindowedPyTree.allocate(
                comm, self.specs, info, rank=self.rank)
        self._turn = 0
        self.saves = 0
        self.bytes_flushed_total = 0
        # one record per committed save: step, target, bytes flushed, and
        # its milliseconds split into the host copy of the tree (device to
        # host for tensors on a card), staging (CRC + page diff + spans) and
        # the flush (for save_async: submission to commit, overlapping the
        # caller's next steps)
        self.records: list[dict] = []
        # one record per restore() that found a checkpoint: step, whether
        # it fell back to the previous manifest, milliseconds
        self.restore_records: list[dict] = []
        self._pending: Request | None = None
        self._pending_target: str | None = None

    # -- manifest -------------------------------------------------------------
    def _manifest_path(self, prev: bool = False) -> str:
        """Rank 0 keeps the historical names (``manifest.json``), so a
        single-controller checkpoint restores unchanged; SPMD ranks > 0 each
        commit their own ``manifest.r<rank>.json`` beside it -- per-rank
        save cadences stay independent and the union of files is identical
        whether the same workload ran single-controller or SPMD."""
        if self.rank == 0:
            name = _MANIFEST_PREV if prev else _MANIFEST
        else:
            name = (f"manifest.r{self.rank}.prev.json" if prev
                    else f"manifest.r{self.rank}.json")
        return os.path.join(self.directory, name)

    def _write_manifest(self, step: int, target: str,
                        crcs: dict[str, int]) -> None:
        m = {
            "step": step,
            "target": target,
            "layout": {"slots": {
                k: {"shape": list(s.shape), "dtype": _dtype_str(s.dtype),
                    "offset": s.offset}
                for k, s in self.windows[target].slots.items()}},
            "crc": crcs,
            "nranks": self.comm.size,
        }
        path = self._manifest_path()
        if os.path.exists(path):
            os.replace(path, self._manifest_path(prev=True))
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(m, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)  # atomic commit

    # -- save -----------------------------------------------------------------
    def _page_size(self, wt: WindowedPyTree) -> int:
        seg = wt.win.segments[self.rank]
        tracker = getattr(seg, "tracker", None)
        if tracker is not None:
            return tracker.page_size
        # remote segments (mp transport) carry the owner's page size as an
        # attribute; last resort is the layout's page constant
        return getattr(seg, "page_size", None) or WindowedPyTree.PAGE

    @staticmethod
    def _page_diff(new: np.ndarray, old: np.ndarray, ps: int) -> np.ndarray:
        """Per-page changed flags between two equal-length uint8 buffers."""
        nb = -(-new.nbytes // ps) if new.nbytes else 0
        changed = np.zeros(nb, dtype=bool)
        whole = (new.nbytes // ps) * ps
        if whole:
            changed[: whole // ps] = np.any(
                new[:whole].reshape(-1, ps) != old[:whole].reshape(-1, ps),
                axis=1)
        if new.nbytes > whole:  # last partial page
            changed[-1] = not np.array_equal(new[whole:], old[whole:])
        return changed

    def _stage(self, target: str, wt: WindowedPyTree,
               tree: Mapping[str, Any]) -> tuple[dict[str, int],
                                                 np.ndarray | None,
                                                 list | None, dict]:
        """Diff ``tree`` against the last checkpoint; returns
        (crcs, flush mask, changed spans, staging milliseconds).

        With a snapshot of the window's last checkpoint available, each
        slot is a *shard*: its changed pages become ``(offset, bytes)``
        spans and the per-slot page masks merge into one window mask --
        the sync/flush then ships spans + mask through the transport's
        masked span-write primitive (one round trip per rank on remote
        transports), applying them to the page cache and flushing in a
        single operation.  Without a snapshot every slot is put in full
        here and (None, None) means "flush everything dirty".
        """
        snap = self._snapshots.get(target)
        ps = self._page_size(wt)
        seg = wt.win.segments[self.rank]
        mask = (np.zeros(-(-seg.size // ps), dtype=bool)
                if snap is not None else None)
        spans: list | None = [] if snap is not None else None
        crcs: dict[str, int] = {}
        new_snap: dict[str, np.ndarray] = {}
        t_start = time.perf_counter()
        copy_s = 0.0
        for k in sorted(self.specs):
            # a private host copy: device tensors are copied here, before
            # save_async returns, so a later step cannot change the bytes
            t0 = time.perf_counter()
            arr = _host_copy(tree[k], self.specs[k][1])
            copy_s += time.perf_counter() - t0
            crcs[k] = _crc(arr)
            # span payloads slice the manager-owned copy, so a caller
            # mutating its tree before the flush runs cannot corrupt the
            # staged bytes
            raw = new_snap[k] = arr.reshape(-1).view(np.uint8)
            if snap is not None:
                slot = wt.slots[k]
                for b0, b1 in dirty_runs(self._page_diff(raw, snap[k], ps)):
                    lo, hi = b0 * ps, min(b1 * ps, raw.nbytes)
                    spans.append((slot.offset + lo, raw[lo:hi]))
                    mark_span(mask, slot.offset + lo, slot.offset + hi, ps)
            else:
                wt.put(k, arr)
        self._snapshots[target] = new_snap
        total_s = time.perf_counter() - t_start
        return crcs, mask, spans, {"copy_ms": copy_s * 1e3,
                                   "stage_ms": (total_s - copy_s) * 1e3}

    def _record(self, step: int, target: str, flushed: int,
                flush_ms: float, times: dict) -> None:
        self.records.append({"step": step, "target": target,
                             "bytes": flushed, **times,
                             "flush_ms": flush_ms})

    def _checked_stage(self, target: str, wt: WindowedPyTree,
                       tree: Mapping[str, Any]):
        """_stage, but a failure mid-staging (e.g. ENOSPC on a full put's
        cache-eviction write) invalidates the window's snapshot: the page
        cache may now hold a mix of old and new pages, so the next save
        must replay a full put + unmasked flush rather than diff against a
        snapshot that no longer describes the cache.  (Span-apply failures
        at flush time are handled the same way by save()/wait().)"""
        try:
            return self._stage(target, wt, tree)
        except BaseException:
            self._snapshots.pop(target, None)
            raise

    def save(self, step: int, tree: Mapping[str, Any]) -> int:
        """Synchronous checkpoint.  Returns bytes flushed (selective)."""
        self.wait()
        target = self.names[self._turn % len(self.names)]
        self._turn += 1
        wt = self.windows[target]
        crcs, mask, spans, times = self._checked_stage(target, wt, tree)
        t0 = time.perf_counter()
        # Paper Listing 4: exclusive lock prevents remote access during sync.
        wt.win.lock(self.rank, exclusive=True)
        try:
            flushed = wt.sync(mask=mask, spans=spans)
        except BaseException:
            # The snapshot now disagrees with the cache/disk: drop it so
            # the retry replays a full put + unmasked flush (never skips).
            self._snapshots.pop(target, None)
            raise
        finally:
            wt.win.unlock(self.rank)
        self._write_manifest(step, target, crcs)
        self.saves += 1
        self.bytes_flushed_total += flushed
        self._record(step, target, flushed,
                     (time.perf_counter() - t0) * 1e3, times)
        return flushed

    def save_async(self, step: int, tree: Mapping[str, Any]) -> Request:
        """Stage the state, then flush + commit on the write-back pool.

        Staging computes the snapshot diff synchronously (cheap memory
        compares): the changed pages of every slot become spans merged
        under one window mask.  The flush request (exclusive lock, paper
        Listing 4) then ships spans + mask through the masked span-write
        primitive -- apply + selective flush in one operation, one
        control-channel round trip per rank on remote transports -- and
        its completion hook commits the manifest.  The hook runs only
        after a successful flush, so the manifest can never get ahead of
        its data.  Errors surface at ``wait()``.
        """
        self.wait()
        target = self.names[self._turn % len(self.names)]
        self._turn += 1
        wt = self.windows[target]
        crcs, mask, spans, times = self._checked_stage(target, wt, tree)
        t0 = time.perf_counter()

        def _commit(flushed: int) -> None:
            # Runs on the write-back thread after a successful flush; the
            # manifest only ever names fully-persisted data.
            self._write_manifest(step, target, crcs)
            self.saves += 1
            self.bytes_flushed_total += flushed
            self._record(step, target, flushed,
                         (time.perf_counter() - t0) * 1e3, times)

        self._pending = wt.sync_async(exclusive=True, on_complete=_commit,
                                      mask=mask, spans=spans)
        self._pending_target = target
        return self._pending

    def wait(self) -> None:
        if self._pending is not None:
            req, self._pending = self._pending, None
            target, self._pending_target = self._pending_target, None
            try:
                req.wait()
            except BaseException:
                # Failed flush: the window's snapshot no longer reflects
                # disk; invalidate so the next save to it replays in full.
                self._snapshots.pop(target, None)
                raise

    # -- restore ----------------------------------------------------------------
    def _try_restore(self, manifest_path: str) -> RestoreResult | None:
        if not os.path.exists(manifest_path):
            return None
        try:
            with open(manifest_path) as f:
                m = json.load(f)
        except (json.JSONDecodeError, OSError):
            return None
        target = m["target"]
        if target not in self.windows:
            return None
        wt = self.windows[target]
        tree: dict[str, np.ndarray] = {}
        for k in sorted(self.specs):
            arr = wt.get(k)
            if _crc(arr) != m["crc"].get(k):
                return None  # torn/corrupt slot
            tree[k] = arr
        return RestoreResult(step=int(m["step"]), tree=tree, manifest=m)

    def restore(self) -> RestoreResult | None:
        """Latest valid checkpoint, falling back A->B via the prev manifest."""
        t0 = time.perf_counter()
        res = self._try_restore(self._manifest_path())
        if res is None:
            res = self._try_restore(self._manifest_path(prev=True))
            if res is not None:
                res.fell_back = True
        if res is not None:
            self.restore_records.append({
                "step": res.step, "fell_back": res.fell_back,
                "ms": (time.perf_counter() - t0) * 1e3})
        return res

    # -- teardown -----------------------------------------------------------------
    def close(self, unlink: bool = False) -> None:
        """Join the pending save and free both windows and the snapshots.
        A failed pending flush (e.g. a crashed owning rank) re-raises here,
        but only after every window has been freed -- teardown must not
        leak segments or worker-side state behind the error."""
        errors: list[BaseException] = []
        self._snapshots.clear()  # host copies of whole trees
        try:
            self.wait()
        except BaseException as e:
            errors.append(e)
        for wt in self.windows.values():
            wt.win.hints = dataclasses.replace(wt.win.hints, unlink=unlink) \
                if unlink else wt.win.hints
            try:
                wt.free()
            except BaseException as e:
                errors.append(e)
        if errors:
            raise errors[0]

    @classmethod
    def open_for_restore(cls, directory: str, comm: Communicator,
                         specs: Mapping[str, tuple[tuple[int, ...], Any]],
                         **kw) -> "CheckpointManager":
        """Re-open a checkpoint directory after a crash/restart.

        Window allocation maps the existing files; restore() then validates.
        """
        return cls(directory, comm, specs, **kw)
