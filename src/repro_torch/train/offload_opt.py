"""Out-of-core AdamW: optimizer state + master weights in storage windows.

The counterpart of ``repro.train.offload_opt``.  This is the paper's §3.4
applied to training state: the f32 master copy and both Adam moments live in
a storage window (``factor='auto'`` with a memory budget pins what fits in
host memory and spills the rest through the user-level page cache).  The
update streams window blocks: fetch -> Adam math in numpy -> put back, with
``rget`` prefetch of block ``i+1`` and ``rput`` write-behind of block ``i``
(per-rank FIFO makes the write-behind safe).  Every ``sync()`` is a
selective flush, so the same windows double as the checkpoint.

Selective write-behind: parameters missing from ``grads`` are skipped
outright, and a block whose gradient and both moments are all-zero with no
weight decay is a provable no-op whose write-behind is skipped too; the
walk accumulates a window-block *touched mask* for
``sync(touched_only=True)``.

When the authoritative master copy lives *on the card*,
``sync_masters_from_device`` persists it without a host round trip of the
full state: each parameter is a shard, the ``diff_pack`` CUDA kernel
compacts its changed pages on the device, and one bitmap plus one payload
transfer per sync carry the changed pages and their merged mask to the
window's page cache, which flushes only those pages.
"""

from __future__ import annotations

import numpy as np

from ..convert import dtype_matches, dtype_name, to_host_f32
from ..core.comm import Communicator
from ..core.offload import WindowedPyTree
from ..core.storage import mark_span
from ..core.window import Request
from .optimizer import AdamWConfig, cosine_schedule

__all__ = ["OutOfCoreAdamW"]


class OutOfCoreAdamW:
    def __init__(self, comm: Communicator, param_shapes: dict, directory: str,
                 cfg: AdamWConfig, *, memory_budget: int | None = None,
                 block_bytes: int = 1 << 22, writeback_interval: float | None = None):
        self.cfg = cfg
        self.step = 0
        specs = {}
        for k, (shape, _) in param_shapes.items():
            specs[f"master/{k}"] = (tuple(shape), np.float32)
            specs[f"m/{k}"] = (tuple(shape), np.float32)
            specs[f"v/{k}"] = (tuple(shape), np.float32)
        info = {
            "alloc_type": "storage",
            "storage_alloc_filename": f"{directory}/optstate.bin",
        }
        if memory_budget is not None:
            info["storage_alloc_factor"] = "auto"
        # rank-local: each rank walks (and checkpoints) its own partition
        # of the optimizer window -- under SPMD every rank runs this same
        # code against its own segment, not rank 0's
        self.state = WindowedPyTree.allocate(
            comm, specs, info, rank=comm.rank, memory_budget=memory_budget,
            block_bytes=block_bytes, writeback_interval=writeback_interval)
        self.param_keys = sorted(param_shapes)
        self._initialized = False
        # window-block mask of pages some update wrote since the last sync
        seg = self.state.win.segments[self.state.rank]
        tracker = getattr(seg, "tracker", None)
        self._page_size = tracker.page_size if tracker is not None else 4096
        self._touched: np.ndarray | None = None
        self.blocks_skipped = 0  # provable no-op blocks (stats)

    def _mark_touched(self, lo: int, hi: int) -> None:
        if self._touched is None:
            seg = self.state.win.segments[self.state.rank]
            self._touched = np.zeros(-(-seg.size // self._page_size),
                                     dtype=bool)
        mark_span(self._touched, lo, hi, self._page_size)

    def initialize(self, params: dict) -> None:
        """Seed master weights from the params (tensors on any device, f32
        or bf16); zero moments."""
        for k in self.param_keys:
            p = to_host_f32(params[k])
            self.state.put(f"master/{k}", p)
            self.state.put(f"m/{k}", np.zeros_like(p))
            self.state.put(f"v/{k}", np.zeros_like(p))
        self._initialized = True

    def update(self, grads: dict, *, grad_scale: float = 1.0,
               prefetch: bool = True, skip_clean: bool = True) -> dict:
        """Streamed blockwise AdamW.  grads: tensors on any device (bf16
        ok).  Returns the new f32 params dict (numpy) to push to the device
        -- only for the keys present in ``grads`` (sparse/MoE updates skip
        the rest).

        With ``prefetch`` (default), block ``i+1`` of all three state arrays
        is fetched with ``rget`` while block ``i``'s math runs, and block
        writes go out as ``rput`` write-behind; the walk waits for the
        write-behind before returning, so callers observe fully-applied
        state.  Results are bit-identical to the synchronous walk.

        ``skip_clean`` elides the write-behind of provable no-op blocks
        (zero gradient, zero moments, no decay on the tensor), keeping
        their window pages clean for the selective sync.
        """
        cfg = self.cfg
        # the update runs on the host, so the schedule does too
        lr = float(cosine_schedule(cfg, self.step, device="cpu"))
        self.step += 1
        t = self.step
        b1c = 1 - cfg.b1 ** t
        b2c = 1 - cfg.b2 ** t
        out = {}
        for k in self.param_keys:
            if k not in grads:  # sparse update: untouched expert/tensor
                continue
            g_full = to_host_f32(grads[k]).ravel() * grad_scale
            wa_m = self.state.array(f"m/{k}")
            wa_v = self.state.array(f"v/{k}")
            wa_p = self.state.array(f"master/{k}")
            new_p = np.empty_like(g_full)
            off = 0
            decay = cfg.weight_decay if _decayable(k) else 0.0
            nblocks = wa_p.num_blocks

            def fetch(i):
                return (wa_m.read_block_async(i), wa_v.read_block_async(i),
                        wa_p.read_block_async(i))

            pending_writes: list[Request] = []
            nxt = fetch(0) if prefetch and nblocks else None
            for i in range(nblocks):
                if prefetch:
                    rm, rv, rp = nxt
                    nxt = fetch(i + 1) if i + 1 < nblocks else None
                    m, v, p = rm.wait(), rv.wait(), rp.wait()
                else:
                    m = wa_m.read_block(i)
                    v = wa_v.read_block(i)
                    p = wa_p.read_block(i)
                g = g_full[off: off + p.size]
                if (skip_clean and decay == 0.0 and not g.any()
                        and not m.any() and not v.any()):
                    # provable no-op: m,v stay zero and p is unchanged --
                    # skip the write-behind, leave the pages clean
                    self.blocks_skipped += 1
                    new_p[off: off + p.size] = p
                    off += p.size
                    continue
                m = cfg.b1 * m + (1 - cfg.b1) * g
                v = cfg.b2 * v + (1 - cfg.b2) * g * g
                upd = (m / b1c) / (np.sqrt(v / b2c) + cfg.eps) + decay * p
                p = p - lr * upd
                if prefetch:
                    pending_writes += [wa_m.write_block_async(i, m),
                                       wa_v.write_block_async(i, v),
                                       wa_p.write_block_async(i, p)]
                else:
                    wa_m.write_block(i, m)
                    wa_v.write_block(i, v)
                    wa_p.write_block(i, p)
                for wa in (wa_m, wa_v, wa_p):
                    self._mark_touched(*wa.block_byte_span(i))
                new_p[off: off + p.size] = p
                off += p.size
            Request.waitall(pending_writes)
            shape = self.state.slots[f"master/{k}"].shape
            out[k] = new_p.reshape(shape)
        return out

    def sync_masters_from_device(self, masters: dict, snapshot: dict, *,
                                 blocking: bool = True,
                                 impl: str | None = None):
        """Persist device-resident master weights with one merged-mask flush.

        ``masters``/``snapshot`` map parameter names to same-shape float32
        tensors on one device: the new values and the last-persisted ones.
        Each named tensor is one *shard* at its ``master/<name>`` slot
        offset; the per-shard ``diff_pack`` bitmaps are OR-merged into a
        single window mask and only the changed pages cross device->host
        (one bitmap and one payload transfer) -- then spans + mask ride the
        transport's masked span-write primitive to the owning rank.  Names
        absent from ``masters`` are untouched (sparse/MoE updates).
        ``impl`` is ``Window.sync_shards_from_device``'s route: ``None``
        (packed) or ``'ref'`` (one transfer per changed span).

        Returns bytes flushed (``blocking=True``, default) or the flush's
        :class:`Request`.
        """
        shards = []
        for k in self.param_keys:
            if k not in masters:
                continue
            slot = self.state.slots[f"master/{k}"]
            for name, arr in (("masters", masters[k]),
                              ("snapshot", snapshot[k])):
                if not dtype_matches(arr.dtype, slot.dtype):
                    raise ValueError(
                        f"{name}[{k!r}] must be {slot.dtype} to match the "
                        f"window layout, got {dtype_name(arr.dtype)}")
            shards.append((masters[k], snapshot[k], slot.offset))
        if not shards:
            return 0 if blocking else None
        return self.state.win.sync_shards_from_device(
            self.state.rank, shards, blocking=blocking, impl=impl)

    def sync(self, *, touched_only: bool = False) -> int:
        """Selective flush of the optimizer window (checkpoint).

        ``touched_only`` narrows the flush to the window blocks updates have
        written since the last sync (the write-behind mask intersected with
        the host dirty bitmap); blocks dirtied by other writers stay dirty
        for a later full sync.
        """
        if touched_only:
            mask, self._touched = self._touched, None
            if mask is None:
                return 0  # nothing touched since the last sync
            try:
                return self.state.sync(mask=mask)
            except BaseException:
                # the backing re-marked the taken blocks; restore the mask
                # too so a touched_only retry replays them (never skips)
                if self._touched is None:
                    self._touched = mask
                else:
                    self._touched |= mask
                raise
        n = self.state.sync()
        self._touched = None  # only after a successful full flush
        return n

    def masters(self) -> dict:
        return {k: self.state.get(f"master/{k}") for k in self.param_keys}

    def free(self) -> None:
        self.state.free()


def _decayable(name: str) -> bool:
    leaf = name.split("/")[-1]
    return not ("norm" in leaf or leaf.startswith("b")
                or leaf in ("A_log", "D", "dt_bias", "lam"))
