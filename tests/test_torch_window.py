"""The PyTorch package's windows against the JAX package's, call for call.

Each scenario runs once through ``repro.core`` (the reference, on the CPU)
and once through ``repro_torch.core`` with CPU tensors, on the same numpy
inputs made from a seed.  The scenarios mirror
``tests/test_selective_sync.py`` (mask intersection rules, device sync on
both routes, sharded merged masks, validation).  What must match: every
returned byte count, the window files byte for byte, the error raised, and
``device_sync_stats()``.  Routes: the port's packed route (``impl=None``)
runs the plain ``diff_pack_ref`` on CPU tensors and is held to the
reference's fused kernel in interpret mode; the per-span route
(``impl='ref'``) to the reference's per-span route.
"""

import types

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro_torch.core as tcore
from repro_torch.convert import tree_from_numpy

PAGE = 4096
PAGES = 16


def _to_torch(a):
    return tree_from_numpy({"a": np.asarray(a)}, device="cpu")["a"]


PKGS = {
    "ref": types.SimpleNamespace(core=jcore, dev=jnp.asarray,
                                 routes={"packed": "interpret", "span": "ref"}),
    "port": types.SimpleNamespace(core=tcore, dev=_to_torch,
                                  routes={"packed": None, "span": "ref"}),
}


def info(d, name="w.bin", **extra):
    return {"alloc_type": "storage",
            "storage_alloc_filename": str(d / name), **extra}


def _mask(*blocks, n=PAGES):
    m = np.zeros(n, dtype=bool)
    for b in blocks:
        m[b] = True
    return m


def _err(fn) -> str:
    """Name of the exception ``fn`` raises (the classes differ by package)."""
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the name is what is compared
        return type(e).__name__
    return "no error"


def both(tmp_path, scenario, **kw):
    """Run ``scenario(pkg, dir, **kw)`` through both packages; their
    results must be equal.  Returns the port's."""
    out = {}
    for name, pkg in PKGS.items():
        d = tmp_path / name
        d.mkdir()
        out[name] = scenario(pkg, d, **kw)
    assert out["port"] == out["ref"]
    return out["port"]


def _read(d, name="w.bin") -> bytes:
    return (d / name).read_bytes()


# -- mask intersection rules ----------------------------------------------------

def _masked_intersection(pkg, d):
    win = pkg.core.Window.allocate(pkg.core.Communicator(1), PAGES * PAGE,
                                   info=info(d))
    for pg in (1, 3, 5):
        win.put(np.full(16, pg + 1, np.uint8), 0, pg * PAGE)
    out = [win.sync(0, mask=_mask(3, 7)), _read(d), win.dirty_bytes(0),
           win.sync(0), _read(d)]
    win.free()
    return out


def test_masked_sync_flushes_only_intersection(tmp_path):
    out = both(tmp_path, _masked_intersection)
    assert out[0] == PAGE and out[2] == 2 * PAGE and out[3] == 2 * PAGE


def _flush_async_after_rput(pkg, d):
    win = pkg.core.Window.allocate(pkg.core.Communicator(1), PAGES * PAGE,
                                   info=info(d))
    win.rput(np.full(PAGE, 9, np.uint8), 0, 2 * PAGE)
    req = win.flush_async(0, mask=_mask(2))
    out = [type(req).__name__, req.wait(timeout=10.0), _read(d)]
    win.free()
    return out


def test_masked_flush_async_ordered_after_rput(tmp_path):
    assert both(tmp_path, _flush_async_after_rput)[:2] == ["Request", PAGE]


def _mask_requires_rank(pkg, d):
    win = pkg.core.Window.allocate(pkg.core.Communicator(2), PAGES * PAGE,
                                   info=info(d))
    out = [_err(lambda: win.sync(None, mask=_mask(0))),
           _err(lambda: win.flush_async(mask=_mask(0)))]
    win.free()
    dyn = pkg.core.Window.create_dynamic(pkg.core.Communicator(1))
    dyn.attach(0, pkg.core.alloc_mem(PAGE, info=info(d, "d.bin")))
    out.append(_err(lambda: dyn.flush_async(0, mask=_mask(0, n=1))))
    dyn.free()
    return out + [_read(d, "w.bin.0"), _read(d, "w.bin.1")]


def test_mask_requires_rank_and_non_dynamic(tmp_path):
    assert both(tmp_path, _mask_requires_rank)[:3] == ["WindowError"] * 3


def _memory_mask_noop(pkg, d):
    win = pkg.core.Window.allocate(pkg.core.Communicator(1), PAGES * PAGE)
    win.put(np.full(8, 3, np.uint8), 0, 0)
    out = win.sync(0, mask=_mask(0))
    win.free()
    return out


def test_mask_on_memory_window_is_noop(tmp_path):
    assert both(tmp_path, _memory_mask_noop) == 0


def _wrong_length(pkg, d):
    win = pkg.core.Window.allocate(pkg.core.Communicator(1), PAGES * PAGE,
                                   info=info(d))
    win.put(np.full(16, 1, np.uint8), 0, (PAGES - 1) * PAGE)
    out = [_err(lambda: win.sync(0, mask=np.ones(PAGES - 1, bool))),
           _err(lambda: win.sync(0, mask=np.ones(PAGES + 3, bool))),
           _err(lambda: win.flush_async(0, mask=np.ones(2, bool))),
           _err(lambda: win.sync(0, mask=np.ones(2, bool),
                                 spans=[(15 * PAGE, np.ones(16, np.uint8))])),
           win.dirty_bytes(0)]
    m2 = np.zeros((4, PAGES // 4), bool)
    m2[3, 3] = True
    out += [win.sync(0, mask=m2), win.dirty_bytes(0), _read(d)]
    win.free()
    return out


def test_mask_wrong_length_raises(tmp_path):
    out = both(tmp_path, _wrong_length)
    assert out[:4] == ["WindowError"] * 4 and out[4:7] == [PAGE, PAGE, 0]


def _wrong_length_combined(pkg, d):
    win = pkg.core.Window.allocate(
        pkg.core.Communicator(1), PAGES * PAGE,
        info=info(d, "c.bin", storage_alloc_factor="0.5"))
    win.put(np.full(16, 2, np.uint8), 0, 10 * PAGE)
    out = [win.flavor, _err(lambda: win.sync(0, mask=np.ones(8, bool))),
           win.sync(0, mask=np.ones(PAGES, bool))]
    win.free()
    return out + [_read(d, "c.bin")]


def test_mask_wrong_length_raises_combined(tmp_path):
    assert both(tmp_path, _wrong_length_combined)[:3] == [
        "combined", "WindowError", PAGE]


def _combined_offsets(pkg, d):
    win = pkg.core.Window.allocate(
        pkg.core.Communicator(1), PAGES * PAGE,
        info=info(d, "c.bin", storage_alloc_factor="0.5"))
    win.put(np.full(32, 7, np.uint8), 0, 10 * PAGE)
    win.put(np.full(32, 8, np.uint8), 0, 12 * PAGE)
    out = [win.sync(0, mask=_mask(10)), win.dirty_bytes(0),
           win.sync(0, mask=_mask(0, 3, 7)), win.sync(0)]
    win.free()
    return out + [_read(d, "c.bin")]


def test_combined_mask_offset_translation(tmp_path):
    assert both(tmp_path, _combined_offsets)[:4] == [PAGE, PAGE, 0, PAGE]


# -- sync_from_device ---------------------------------------------------------------

def _ships_changed_pages(pkg, d, route):
    win = pkg.core.Window.allocate(pkg.core.Communicator(1), PAGES * PAGE,
                                   info=info(d))
    snap = np.arange(PAGES * PAGE // 4, dtype=np.float32)
    win.put(snap, 0, 0)
    win.sync(0)
    backing = win.segments[0].backing
    base = backing.bytes_flushed
    cur = snap.copy()
    cur[(PAGE // 4) * 4 + 1] += 1.0
    cur[(PAGE // 4) * 11] += 2.0
    req = win.sync_from_device(0, pkg.dev(cur), pkg.dev(snap),
                               impl=pkg.routes[route])
    out = [req.wait(timeout=10.0), backing.bytes_flushed - base, _read(d),
           win.dirty_bytes(0), dict(win.device_sync_stats())]
    win.free()
    return out


@pytest.mark.parametrize("route", ["packed", "span"])
def test_sync_from_device_ships_and_flushes_only_changed_pages(tmp_path,
                                                               route):
    out = both(tmp_path, _ships_changed_pages, route=route)
    assert out[:2] == [2 * PAGE, 2 * PAGE] and out[3] == 0


def _all_clean(pkg, d, route):
    win = pkg.core.Window.allocate(pkg.core.Communicator(1), PAGES * PAGE,
                                   info=info(d))
    snap = np.arange(PAGES * PAGE // 4, dtype=np.float32)
    win.put(snap, 0, 0)
    win.sync(0)
    out = [win.sync_from_device(0, pkg.dev(snap), pkg.dev(snap),
                                blocking=True, impl=pkg.routes[route]),
           dict(win.device_sync_stats())]
    win.free()
    return out


@pytest.mark.parametrize("route", ["packed", "span"])
def test_sync_from_device_all_clean_is_free(tmp_path, route):
    assert both(tmp_path, _all_clean, route=route)[0] == 0


def _unaligned_disp(pkg, d, route):
    win = pkg.core.Window.allocate(pkg.core.Communicator(1), PAGES * PAGE,
                                   info=info(d))
    disp = PAGE + 100
    n = 4 * PAGE // 4
    snap = np.arange(n, dtype=np.float32)
    win.put(snap, 0, disp)
    win.sync(0)
    cur = snap.copy()
    cur[0] += 1.0
    cur[-1] += 1.0
    flushed = win.sync_from_device(0, pkg.dev(cur), pkg.dev(snap),
                                   target_disp=disp, blocking=True,
                                   impl=pkg.routes[route])
    out = [flushed, _read(d), dict(win.device_sync_stats())]
    win.free()
    return out


@pytest.mark.parametrize("route", ["packed", "span"])
def test_sync_from_device_unaligned_disp_conservative(tmp_path, route):
    flushed, disk, _ = both(tmp_path, _unaligned_disp, route=route)
    assert flushed >= 2 * PAGE
    cur = np.arange(PAGE, dtype=np.float32)
    cur[0] += 1.0
    cur[-1] += 1.0
    got = np.frombuffer(disk, np.uint8)[PAGE + 100: PAGE + 100 + PAGE * 4]
    assert (got.view(np.float32) == cur).all()


def _dirty_mask_feeds_flush(pkg, d):
    win = pkg.core.Window.allocate(pkg.core.Communicator(1), PAGES * PAGE,
                                   info=info(d))
    snap = np.zeros(PAGES * PAGE // 4, np.float32)
    cur = snap.copy()
    cur[(PAGE // 4) * 6 + 7] = 5.0
    mask = win.device_dirty_mask(0, pkg.dev(cur), pkg.dev(snap))
    win.put(cur, 0, 0)
    out = [mask.tolist(), win.sync(0, mask=mask), win.dirty_bytes(0)]
    win.free()
    return out


def test_device_dirty_mask_feeds_flush(tmp_path):
    out = both(tmp_path, _dirty_mask_feeds_flush)
    assert out == [_mask(6).tolist(), PAGE, (PAGES - 1) * PAGE]


# -- sharded device state: merged masks, one flush ----------------------------------

def _merged_masks(pkg, d, route):
    win = pkg.core.Window.allocate(pkg.core.Communicator(1), PAGES * PAGE,
                                   info=info(d))
    a_snap = np.zeros(3 * PAGE // 4, np.float32)
    b_snap = np.ones(4 * PAGE // 4, np.float32)
    win.put(a_snap, 0, 0)
    win.put(b_snap, 0, 8 * PAGE)
    win.sync(0)
    backing = win.segments[0].backing
    base = backing.bytes_flushed
    a_cur = a_snap.copy()
    a_cur[(PAGE // 4) + 1] = 5.0
    b_cur = b_snap.copy()
    b_cur[0] = 6.0
    b_cur[-1] = 7.0
    req = win.sync_shards_from_device(
        0, [(pkg.dev(a_cur), pkg.dev(a_snap), 0),
            (pkg.dev(b_cur), pkg.dev(b_snap), 8 * PAGE)],
        impl=pkg.routes[route])
    out = [req.wait(timeout=30.0), backing.bytes_flushed - base, _read(d),
           win.dirty_bytes(0), dict(win.device_sync_stats())]
    win.free()
    return out


@pytest.mark.parametrize("route", ["packed", "span"])
def test_sync_shards_from_device_merges_masks(tmp_path, route):
    out = both(tmp_path, _merged_masks, route=route)
    assert out[:2] == [3 * PAGE, 3 * PAGE] and out[3] == 0


def _shard_validation(pkg, d):
    win = pkg.core.Window.allocate(pkg.core.Communicator(1), PAGES * PAGE,
                                   info=info(d))
    a = np.zeros(PAGE // 4, np.float32)
    out = [_err(lambda: win.sync_shards_from_device(0, [], blocking=True)),
           _err(lambda: win.sync_shards_from_device(
               0, [(pkg.dev(a), pkg.dev(a.astype(np.int32)), 0)],
               blocking=True)),
           _err(lambda: win.sync_shards_from_device(
               0, [(pkg.dev(a), pkg.dev(a[:-1]), 0)], blocking=True))]
    b = np.zeros(2 * PAGE // 4, np.float32)
    c = np.ones(PAGE // 4, np.float32)
    out.append(_err(lambda: win.sync_shards_from_device(
        0, [(pkg.dev(b), pkg.dev(b), 0), (pkg.dev(c), pkg.dev(c), PAGE)],
        blocking=True)))
    # adjacent (touching, not overlapping) regions stay legal
    out.append(win.sync_shards_from_device(
        0, [(pkg.dev(b), pkg.dev(b), 0), (pkg.dev(c), pkg.dev(c), 2 * PAGE)],
        blocking=True))
    win.free()
    return out


def test_sync_shards_validation_and_overlap(tmp_path):
    assert both(tmp_path, _shard_validation) == ["WindowError"] * 4 + [0]


def _packed_single_transfer(pkg, d, route):
    win = pkg.core.Window.allocate(pkg.core.Communicator(1), PAGES * PAGE,
                                   info=info(d))
    a_snap = np.zeros(4 * PAGE // 4, np.float32)
    b_snap = np.ones(4 * PAGE // 4, np.float32)
    win.put(a_snap, 0, 0)
    win.put(b_snap, 0, 8 * PAGE)
    win.sync(0)
    a_cur = a_snap.copy()
    a_cur[1] = 5.0
    a_cur[3 * PAGE // 4 + 7] = 6.0
    b_cur = b_snap.copy()
    b_cur[PAGE // 4] = 7.0
    shards = [(pkg.dev(a_cur), pkg.dev(a_snap), 0),
              (pkg.dev(b_cur), pkg.dev(b_snap), 8 * PAGE)]
    n = win.sync_shards_from_device(0, shards, impl=pkg.routes[route],
                                    blocking=True)
    out = [n, dict(win.device_sync_stats()), _read(d)]
    win.free()
    return out


def test_sync_shards_packed_single_transfer(tmp_path):
    n, st, disk = both(tmp_path, _packed_single_transfer, route="packed")
    assert n == 3 * PAGE
    assert st == {"syncs": 1, "payload_transfers": 1, "bitmap_transfers": 1,
                  "span_transfers": 0, "payload_bytes": 3 * PAGE,
                  "logical_bytes": 3 * PAGE}


def test_sync_shards_span_route_same_bytes(tmp_path):
    """The per-span route moves the same bytes, one transfer per span."""
    (tmp_path / "p").mkdir()
    (tmp_path / "s").mkdir()
    packed = both(tmp_path / "p", _packed_single_transfer, route="packed")
    span = both(tmp_path / "s", _packed_single_transfer, route="span")
    assert span[1]["span_transfers"] == 3 and span[1]["payload_transfers"] == 0
    assert span[0] == packed[0] and span[2] == packed[2]


# -- dtypes: bf16 and int8 shards, ragged lengths --------------------------------

def _dtype_shards(pkg, d, route, dtype):
    rng = np.random.default_rng(7)
    win = pkg.core.Window.allocate(pkg.core.Communicator(1), PAGES * PAGE,
                                   info=info(d))
    if dtype == "bfloat16":
        bits = rng.integers(0, 1 << 15, size=5 * PAGE // 2 - 3,
                            dtype=np.uint16)
        snap = bits.view(ml_dtypes.bfloat16)
        cur_bits = bits.copy()
        cur_bits[[0, PAGE // 2 * 3 + 11, bits.size - 1]] ^= 1
        cur = cur_bits.view(ml_dtypes.bfloat16)
    else:
        snap = rng.integers(-100, 100, size=5 * PAGE - 7, dtype=np.int8)
        cur = snap.copy()
        cur[[PAGE + 1, 4 * PAGE + 5]] += 1
    disp = 6 * PAGE
    win.put(snap.view(np.uint8), 0, disp)
    win.sync(0)
    n = win.sync_from_device(0, pkg.dev(cur), pkg.dev(snap), target_disp=disp,
                             blocking=True, impl=pkg.routes[route])
    out = [n, dict(win.device_sync_stats()), _read(d)]
    win.free()
    return out


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
@pytest.mark.parametrize("route", ["packed", "span"])
def test_sync_from_device_dtypes(tmp_path, route, dtype):
    n, st, disk = both(tmp_path, _dtype_shards, route=route, dtype=dtype)
    assert n > 0 and st["logical_bytes"] > 0


# -- what this package refuses ------------------------------------------------

def test_replicated_window_refused(tmp_path):
    comm = tcore.Communicator(2)
    with pytest.raises(tcore.WindowError, match="ROADMAP"):
        tcore.Window.allocate(comm, PAGE, info=info(
            tmp_path, storage_alloc_replication="2"))
    # advisory like the reference: clamped to the communicator size, so a
    # one-rank window keeps its single copy
    one = tcore.Window.allocate(tcore.Communicator(1), PAGE, info=info(
        tmp_path, "one.bin", storage_alloc_replication="2"))
    one.free()


@pytest.mark.parametrize("kind", ["mp", "tcp", "ranklocal"])
def test_unported_transports_raise(kind):
    """Of the JAX package's backends only tcp is still unported: it raises
    naming the ROADMAP item.  mp and ranklocal build working
    communicators whose windows round-trip bytes."""
    if kind == "tcp":
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tcore.Communicator(2, transport=kind)
        return
    comm = tcore.Communicator(2, transport=kind)
    try:
        assert comm.transport.kind == kind
        rank = comm.rank  # ranklocal hosts only its own partition
        with tcore.Window.allocate(comm, PAGE) as win:
            win.put(np.full(8, 5, np.uint8), rank, 0)
            assert (win.get(rank, 0, 8) == 5).all()
    finally:
        comm.close()


def test_unknown_impl_raises(tmp_path):
    win = tcore.Window.allocate(tcore.Communicator(1), PAGE, info=info(tmp_path))
    a = torch.zeros(PAGE // 4)
    with pytest.raises(tcore.WindowError, match="impl"):
        win.sync_from_device(0, a, a, impl="interpret")
    win.free()


def test_wire_stats_schema_matches_reference():
    want = jcore.Communicator(1).transport.wire_stats_snapshot()
    assert tcore.Communicator(1).transport.wire_stats_snapshot() == want


# -- bfloat16 slots in windowed trees -----------------------------------------

def _tree_specs(bf16):
    return {"k": ((3, 5, 7), bf16), "a": ((11,), "float32"),
            "pos": ((), "int32")}


@pytest.mark.parametrize("bf16", ["bfloat16", torch.bfloat16])
def test_windowed_tree_bf16_slots_match_reference(tmp_path, bf16):
    """A bfloat16 slot is carried by name and item size: the layout (offsets,
    total) and the window file equal the reference's, which stores bf16
    through ml_dtypes; ``get`` returns the bits as uint16."""
    rng = np.random.default_rng(3)
    bits = rng.integers(0, 1 << 15, size=(3, 5, 7), dtype=np.uint16)
    a = rng.standard_normal(11).astype(np.float32)
    want_slots, want_total = jcore.WindowedPyTree.layout(
        _tree_specs(ml_dtypes.bfloat16))
    slots, total = tcore.WindowedPyTree.layout(_tree_specs(bf16))
    assert total == want_total
    assert {k: (s.offset, s.nbytes) for k, s in slots.items()} == \
        {k: (s.offset, s.nbytes) for k, s in want_slots.items()}
    files = []
    for name, core, spec, kbits in (
            ("ref.bin", jcore, ml_dtypes.bfloat16, bits.view(ml_dtypes.bfloat16)),
            ("port.bin", tcore, bf16, bits)):
        wt = core.WindowedPyTree.allocate(
            core.Communicator(1), _tree_specs(spec), info(tmp_path, name))
        wt.put("k", kbits)
        wt.put("a", a)
        wt.put("pos", np.asarray(7, np.int32))
        flushed = wt.sync()
        if core is tcore:
            got = wt.get("k")
            assert got.dtype == np.uint16 and (got == bits).all()
            assert wt.manifest()["slots"]["k"]["dtype"] == "bfloat16"
            assert tcore.WindowedPyTree.slots_from_manifest(
                wt.manifest()) == wt.slots
            with pytest.raises(TypeError, match="bfloat16"):
                wt.put("k", bits.astype(np.float32))
        wt.free()
        files.append((flushed, (tmp_path / name).read_bytes()))
    assert files[0] == files[1]
