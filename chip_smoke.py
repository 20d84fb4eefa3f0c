#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It puts ``src`` on ``sys.path`` itself, builds the CUDA kernels from
``src/repro_torch/csrc`` (one ``nvcc`` per source, all started together,
into ``build/repro_torch``), and then:

* phase 1 holds each kernel against its plain PyTorch version on the card:
  ``dirty_blocks`` and ``dirty_pack`` over float32, bfloat16, int8 and int32,
  aligned, odd and ragged block geometries, 0%, 8% page-spread and 100%
  dirty blocks, an unchanged all-NaN block and an unaligned view.  Flags,
  ``count`` and ``packed[:count]`` must be bit-identical (tolerance: none),
  here and again on every tensor of phase 2 at its own shape.
* phase 2 drives the main path, ``OutOfCoreAdamW.sync_masters_from_device``,
  over the internlm2-1.8b parameter tree at full widths (depth cut to 2
  layers) with float32 masters on the card: three syncs (8% of every
  tensor's pages touched page-spread; ``lm_head`` and every norm rewritten;
  no change).  After each, the flushed bytes must equal the changed pages
  times the page size, the window file read back with ``np.fromfile`` must
  equal the masters, the window's transfer counters must show one bitmap
  transfer per sync, one payload transfer per sync that changed a byte and
  no per-span transfer, and both kernels must have launched.

Diagnostics go to earlier lines of standard output: the card's name and
power limit (``nvidia-smi``), build times, per-sync times, and one JSON line
``{"kernels": [...]}`` with each kernel's time, launches, bound, plain-
version and library times.  The last line is
``{"ok": true, "device": {...}}``.  Any failed check raises, so the exit
code is not 0 and no such line is printed; the same holds when CUDA is not
available or the package is missing.
"""

from __future__ import annotations

import dataclasses
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

PAGE = 4096
DIRTY_FRAC = 0.08            # page-spread traffic of benchmarks/selective_sync.py
HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory (NVIDIA data sheet)
SMOKE_LAYERS = 2             # depth cut of internlm2-1.8b (24 layers)
WORKDIR = ROOT / "build" / "chip_smoke"

KERNELS = {
    "dirty_diff": {"source": "src/repro_torch/csrc/dirty_diff.cu",
                   "replaces": "src/repro/kernels/dirty_diff.py:77"},
    "diff_pack": {"source": "src/repro_torch/csrc/pack_diff.cu",
                  "replaces": "src/repro/kernels/pack_diff.py:84"},
}


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


# -- the main path (phase 2), shared with tests/test_torch_slice.py ----------

def smoke_config(n_layers: int = SMOKE_LAYERS, **widths):
    """internlm2-1.8b with its depth cut (and, for CPU tests, its widths)."""
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("internlm2-1.8b"),
                               n_layers=n_layers, **widths)


def make_masters(cfg, seed: int, device) -> dict[str, torch.Tensor]:
    """float32 master weights of ``param_specs(cfg)``, random from ``seed``
    (normal, std 0.02), made on ``device``."""
    from repro_torch.convert import resolve_device
    from repro_torch.models import param_specs
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return {k: torch.randn(s.shape, generator=gen, device=dev,
                           dtype=torch.float32) * 0.02
            for k, s in sorted(param_specs(cfg).items())}


def mutation_plan(shapes: dict, seed: int) -> list[dict]:
    """The three syncs' changes: ``{name: flat element indices}`` where one
    element is bumped by 1.0, or ``{name: None}`` where the whole tensor is.

    1. DIRTY_FRAC of each tensor's pages, page-spread, first element of each;
    2. ``lm_head`` and every norm in full (a dense change on a subset);
    3. nothing."""
    rng = np.random.default_rng(seed)
    spread = {}
    per_page = PAGE // 4
    for k in sorted(shapes):
        n = int(np.prod(shapes[k]))
        pages = -(-n // per_page)
        pick = rng.choice(pages, size=int(pages * DIRTY_FRAC), replace=False)
        spread[k] = np.sort(pick) * per_page
    dense = {k: None for k in sorted(shapes)
             if k == "lm_head" or "norm" in k.split("/")[-1]}
    return [spread, dense, {}]


def apply_mutation(tree: dict, change: dict) -> None:
    """Apply one sync's changes in place (torch tensors or numpy arrays)."""
    for k, idx in change.items():
        flat = tree[k].reshape(-1)
        if idx is None:
            flat += 1.0
        else:
            flat[idx] += 1.0


def changed_pages(slots: dict, shapes: dict, change: dict) -> int:
    """Pages of the optimizer window a change touches, from the indices."""
    pages = set()
    for k, idx in change.items():
        off = slots[f"master/{k}"].offset
        if idx is None:
            nbytes = int(np.prod(shapes[k])) * 4
            pages.update(range(off // PAGE, -(-(off + nbytes) // PAGE)))
        else:
            pages.update(((off + np.asarray(idx) * 4) // PAGE).tolist())
    return len(pages)


def read_back_equal(path: Path, slots: dict, masters: dict) -> bool:
    """The window file at each master slot equals the masters' bytes."""
    for k, t in masters.items():
        slot = slots[f"master/{k}"]
        disk = np.fromfile(path, dtype=np.float32, count=t.numel(),
                           offset=slot.offset)
        host = t.detach().to("cpu").numpy().reshape(-1)
        if not np.array_equal(disk.view(np.uint32), host.view(np.uint32)):
            return False
    return True


class _Timed:
    """Wall time of a callable, summed over calls (seconds)."""

    def __init__(self, fn):
        self.fn = fn
        self.seconds = 0.0

    def __call__(self, *a, **kw):
        t0 = time.perf_counter()
        try:
            return self.fn(*a, **kw)
        finally:
            self.seconds += time.perf_counter() - t0


def run_main_path(cfg, *, device, directory: Path, seed: int = 0,
                  on_sync=None, log=print) -> dict:
    """Phase 2: ``OutOfCoreAdamW`` over ``param_specs(cfg)`` with masters on
    ``device``; three ``sync_masters_from_device`` calls, each checked.

    ``on_sync(i, change, masters, snapshot)`` runs after sync ``i`` and
    before the snapshot takes the new masters.  Returns the counts and
    per-sync records."""
    from repro_torch.configs import get_config
    from repro_torch.core import Communicator
    from repro_torch.kernels import dirty_diff, pack_diff
    from repro_torch.models import param_specs
    from repro_torch.train import AdamWConfig, OutOfCoreAdamW

    dev = torch.device(device)
    specs = param_specs(cfg)
    shapes = {k: s.shape for k, s in specs.items()}
    nparams = sum(int(np.prod(s)) for s in shapes.values())
    full = get_config(cfg.name).n_layers
    log(f"reduced: n_layers {full}->{cfg.n_layers} (run time limit); "
        f"{nparams} parameters in {len(shapes)} tensors, "
        f"{nparams * 4} bytes of float32 masters on {dev}, "
        f"{nparams * 12} bytes of optimizer window")
    masters = make_masters(cfg, seed, dev)
    comm = Communicator(1)
    opt = OutOfCoreAdamW(comm, {k: (s, np.float32) for k, s in shapes.items()},
                         str(directory), AdamWConfig())
    path = Path(directory) / "optstate.bin"
    records = []
    try:
        t0 = time.perf_counter()
        opt.initialize(masters)
        opt.sync()  # clean baseline on disk
        log(f"initialize + full sync: {time.perf_counter() - t0:.3f} s")
        snapshot = {k: v.clone() for k, v in masters.items()}
        slots = opt.state.slots
        timed = _Timed(comm.transport.write_spans_masked)
        comm.transport.write_spans_masked = timed
        plan = mutation_plan(shapes, seed)
        launches = {"dirty_diff": 0, "diff_pack": 0}
        for i, change in enumerate(plan):
            apply_mutation(masters, change)
            want = changed_pages(slots, shapes, change) * PAGE
            timed.seconds = 0.0
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            # count only the main path's launches: 0 just before, read
            # just after (the measurements in on_sync launch too)
            dirty_diff.launches = 0
            pack_diff.launches = 0
            t0 = time.perf_counter()
            flushed = opt.sync_masters_from_device(masters, snapshot)
            sync_s = time.perf_counter() - t0
            launches["dirty_diff"] += dirty_diff.launches
            launches["diff_pack"] += pack_diff.launches
            st = dict(opt.state.win.device_sync_stats())
            rec = {"sync": i + 1, "flushed_bytes": flushed,
                   "expected_bytes": want, "sync_ms": sync_s * 1e3,
                   "flush_ms": timed.seconds * 1e3,
                   "dirty_diff_launches": dirty_diff.launches,
                   "diff_pack_launches": pack_diff.launches,
                   "stats": st}
            check(flushed == want,
                  f"sync {i + 1}: flushed {flushed} bytes, changed pages "
                  f"give {want}")
            check(read_back_equal(path, slots, masters),
                  f"sync {i + 1}: window file differs from the masters")
            check(st["bitmap_transfers"] == st["syncs"] == i + 1,
                  f"sync {i + 1}: one bitmap transfer per sync: {st}")
            with_change = sum(1 for c in plan[:i + 1] if c)
            check(st["payload_transfers"] == with_change,
                  f"sync {i + 1}: one payload transfer per changed sync: {st}")
            check(st["span_transfers"] == 0,
                  f"sync {i + 1}: per-span transfers on the packed route: {st}")
            if dev.type == "cuda":
                check(rec["dirty_diff_launches"] > 0
                      and rec["diff_pack_launches"] > 0,
                      f"sync {i + 1}: kernels not launched: {rec}")
            if on_sync is not None:
                on_sync(i, change, masters, snapshot)
            for k in change:
                snapshot[k].copy_(masters[k])
            records.append(rec)
            log("sync " + json.dumps({k: v for k, v in rec.items()
                                      if k != "stats"}))
    finally:
        opt.free()
        comm.close()
    return {"records": records, "launches": launches, "nparams": nparams}


# -- phase 1: kernels against their plain versions ----------------------------

def _case(dtype, n: int, block_elems: int, pattern: str, gen, rng, dev):
    """A (cur, snap) pair of ``n`` elements with the given dirty pattern
    (data from the torch generator ``gen``, dirty blocks from ``rng``)."""
    if dtype.is_floating_point:
        snap = (torch.randn(n, generator=gen, device=dev) * 4).to(dtype)
    else:
        info = torch.iinfo(dtype)
        snap = torch.randint(max(info.min, -1000), min(info.max, 1000), (n,),
                             generator=gen, device=dev, dtype=dtype)
    cur = snap.clone()
    nblocks = -(-n // block_elems)
    if pattern == "nan":
        # an unchanged all-NaN block stays clean; block 2 changes
        cur[block_elems:2 * block_elems] = float("nan")
        snap[block_elems:2 * block_elems] = float("nan")
        cur[2 * block_elems] += 1
        return cur, snap
    if pattern == "sparse":
        dirty = rng.choice(nblocks, size=max(1, int(nblocks * DIRTY_FRAC)),
                           replace=False)
    elif pattern == "all":
        dirty = np.arange(nblocks)
    else:
        dirty = np.arange(0)
    idx = np.minimum(dirty * block_elems + dirty % block_elems, n - 1)
    cur[torch.from_numpy(idx).to(dev)] += 1
    return cur, snap


def phase1(dev, log=print) -> float:
    """Every kernel against its plain version, bit for bit; returns the
    largest absolute difference seen (0 when they agree)."""
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=dev).manual_seed(1)
    rng = np.random.default_rng(1)
    ncases = 0
    worst = 0.0
    geoms = [(1024, 1024 * 300), (1000, 1000 * 250 + 123), (37, 37 * 4001)]
    for dtype in (torch.float32, torch.bfloat16, torch.int8, torch.int32):
        for block_elems, n in geoms:
            pats = ["clean", "sparse", "all"]
            if dtype.is_floating_point:
                pats.append("nan")
            for pattern in pats:
                cur, snap = _case(dtype, n, block_elems, pattern, gen, rng,
                                  dev)
                for c, s in ((cur, snap), (cur[1:], snap[1:])):  # + unaligned
                    worst = max(worst, _compare(ops, ref, c, s, block_elems))
                    torch.cuda.synchronize(dev)
                    ncases += 1
    log(f"phase 1: {ncases} cases, dirty_blocks and dirty_pack bit-identical "
        "to their plain versions")
    return worst


def _compare(ops, ref, cur, snap, block_elems) -> float:
    c2 = ops.padded_rows(cur, block_elems)
    s2 = ops.padded_rows(snap, block_elems)
    want_flags = ref.dirty_diff_ref(c2, s2)
    flags = ops.dirty_blocks(cur, snap, block_elems=block_elems)
    check(torch.equal(flags, want_flags),
          f"dirty_blocks != plain version ({cur.dtype}, {block_elems})")
    pf, packed, count = ops.dirty_pack(cur, snap, block_elems=block_elems)
    rf, rpacked, rcount = ref.diff_pack_ref(c2, s2)
    check(torch.equal(pf, rf), "dirty_pack flags != plain version")
    check(torch.equal(count, rcount), "dirty_pack count != plain version")
    k = int(rcount.item())
    got = packed[:k].reshape(-1).view(torch.uint8)
    want = rpacked[:k].reshape(-1).view(torch.uint8)
    check(torch.equal(got, want), f"dirty_pack rows != plain version "
          f"({cur.dtype}, {block_elems}, {k} rows)")
    return float((got.int() - want.int()).abs().max()) if k else 0.0


# -- measurements ----------------------------------------------------------------

def cuda_ms(fn, reps: int = 5) -> float:
    """Mean milliseconds of ``fn`` on the card's clock (CUDA events), after
    one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def measure_sync(masters: dict, snapshot: dict, block_elems: int) -> dict:
    """Each kernel against its plain version at the main path's shapes (bit
    for bit), then kernel, copy, plain-version and library times over one
    sync's shard set (every master tensor against its snapshot)."""
    from repro_torch.kernels import ops, ref
    pairs = [(masters[k], snapshot[k]) for k in sorted(masters)]
    worst = max(_compare(ops, ref, c, s, block_elems) for c, s in pairs)
    rows = [(ops.padded_rows(c, block_elems), ops.padded_rows(s, block_elems))
            for c, s in pairs]
    n_bytes = sum(c.numel() * c.element_size() for c, _ in pairs)
    nblocks = sum(c2.shape[0] for c2, _ in rows)
    out = {"bytes": n_bytes, "blocks": nblocks, "max_abs_err": worst}
    out["dirty_diff_ms"] = cuda_ms(lambda: [
        ops.dirty_blocks(c, s, block_elems=block_elems) for c, s in pairs])
    out["diff_pack_ms"] = cuda_ms(lambda: [
        ops.dirty_pack(c, s, block_elems=block_elems) for c, s in pairs])
    out["dirty_diff_plain_ms"] = cuda_ms(lambda: [
        ref.dirty_diff_ref(c2, s2) for c2, s2 in rows])
    out["diff_pack_plain_ms"] = cuda_ms(lambda: [
        ref.diff_pack_ref(c2, s2) for c2, s2 in rows])
    out["dirty_diff_library_ms"] = cuda_ms(lambda: [
        (c2 != s2).view(c2.shape[0], -1).any(1) for c2, s2 in rows])
    packs = [ops.dirty_pack(c, s, block_elems=block_elems) for c, s in pairs]
    out["diff_pack_library_ms"] = cuda_ms(lambda: [
        c2[f.bool()] for (c2, _), (f, _, _) in zip(rows, packs)])
    flags = [f for f, _, _ in packs]
    ks = [int(f.sum()) for f in flags]
    parts = [p[:k].view(torch.uint8).reshape(-1)
             for (_, p, _), k in zip(packs, ks) if k]
    out["dirty_blocks"] = sum(ks)
    out["dirty_bytes"] = sum(k * block_elems * c.element_size()
                             for (c, _), k in zip(pairs, ks))
    out["bitmap_copy_ms"] = host_ms(lambda: torch.cat(flags).cpu())
    out["payload_copy_ms"] = (host_ms(lambda: torch.cat(parts).cpu())
                              if parts else 0.0)
    # bounds: each input read once, each output written once
    out["dirty_diff_bound_ms"] = (2 * n_bytes + 4 * nblocks) \
        / HBM_BYTES_PER_S * 1e3
    out["diff_pack_bound_ms"] = (2 * n_bytes + 4 * nblocks
                                 + out["dirty_bytes"] + 4) \
        / HBM_BYTES_PER_S * 1e3
    return out


def gpu_line() -> str:
    smi = shutil.which("nvidia-smi")
    check(smi is not None, "nvidia-smi not found")
    return subprocess.run(
        [smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs one GPU",
              file=sys.stderr)
        return 2
    from repro_torch.kernels import _build

    dev = torch.device("cuda", 0)
    card = gpu_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} "
          "device(s)")
    t0 = time.perf_counter()
    built = _build.build(["dirty_diff", "pack_diff"])
    for name, b in built.items():
        print(f"built {name} in {b['seconds']:.2f} s -> {b['path']}")
        for line in b["log"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")
    print(f"build wall: {time.perf_counter() - t0:.2f} s")

    worst = phase1(dev)

    shutil.rmtree(WORKDIR, ignore_errors=True)
    WORKDIR.mkdir(parents=True)
    cfg = smoke_config()
    block_elems = PAGE // 4
    measured = {}

    def on_sync(i, change, masters, snapshot):
        m = measure_sync(masters, snapshot, block_elems)
        print(f"sync {i + 1} times ({card}): " + json.dumps(m))
        measured[i] = m

    try:
        result = run_main_path(cfg, device=dev, directory=WORKDIR,
                               on_sync=on_sync)
    finally:
        shutil.rmtree(WORKDIR, ignore_errors=True)
    launches = result["launches"]
    check(all(v > 0 for v in launches.values()),
          f"a kernel of the main path never launched: {launches}")
    worst = max([worst] + [v["max_abs_err"] for v in measured.values()])
    m = measured[0]  # the 8% page-spread sync: the main traffic
    kernels = []
    for name in ("dirty_diff", "diff_pack"):
        kernels.append({
            "name": name, "route": "cuda", **KERNELS[name],
            "launches": launches[name], "max_abs_err": worst,
            "ms": m[f"{name}_ms"], "plain_ms": m[f"{name}_plain_ms"],
            "bound_ms": m[f"{name}_bound_ms"], "bound_by": "bytes",
            "library_ms": m[f"{name}_library_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
