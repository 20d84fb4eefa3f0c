"""The port's transports against the JAX package's in-process reference.

The conformance half of ``tests/test_transport.py`` runs on the port's
``inproc`` and ``mp`` transports (4 ranks; the ``mp`` world is 4 spawned
worker processes, started once for the module) and every scenario also
runs through ``repro.core`` on its in-process transport with the same
numpy inputs made from a seed.  What must match is exact: returned values
and byte counts, errors, and the window files byte for byte.  The device
syncs take CPU tensors on the port (the kernels' plain versions) and
``jax.numpy`` arrays on the reference.

The rest covers what only real processes or the bootstrap can show: one
``wsync`` message per device sync, shared-memory windows, worker kill,
probe and respawn, recovery from the storage files under another
transport, the env bootstrap, ``ranklocal`` files, a checkpoint whose
owner dies mid-save, and that a spawned worker never loads ``torch``.
"""

import json
from pathlib import Path
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro_torch.core as tcore
from repro_torch.core.mapreduce import wordcount_map

PAGE = 4096
REF = SimpleNamespace(core=jcore, dev=jnp.asarray)
PORT = SimpleNamespace(core=tcore, dev=lambda a: torch.from_numpy(np.array(a)))

_WORLDS: dict = {}


@pytest.fixture(scope="module", autouse=True)
def _bounded_waits():
    """Every reply wait on a worker is bounded: a hung channel fails its
    test within a minute instead of eating the suite's clock."""
    mp = pytest.MonkeyPatch()
    mp.setenv("REPRO_MP_TIMEOUT", "60")
    mp.setenv("REPRO_MP_PROBE_TIMEOUT", "5")
    yield
    for comm in _WORLDS.values():
        comm.close()
    _WORLDS.clear()
    mp.undo()


def world(kind: str):
    """The module's one 4-rank communicator per backend (spawning worker
    processes per test would dominate the suite's runtime)."""
    if kind not in _WORLDS:
        _WORLDS[kind] = tcore.Communicator(4, transport=kind)
    return _WORLDS[kind]


@pytest.fixture(scope="module", params=["inproc", "mp"])
def comm4(request):
    return world(request.param)


def storage_info(d, name="w.bin"):
    return {"alloc_type": "storage", "storage_alloc_filename": str(d / name)}


def against_ref(tmp_path, comm, scenario, **kw):
    """``scenario(pkg, comm, dir, **kw)`` on the port's ``comm`` and on the
    reference's in-process 4-rank world; results must be equal.  Returns
    the port's."""
    ref_comm = jcore.Communicator(4)
    try:
        want = scenario(REF, ref_comm, _mkdir(tmp_path / "ref"), **kw)
    finally:
        ref_comm.close()
    got = scenario(PORT, comm, _mkdir(tmp_path / "run"), **kw)
    assert got == want
    return got


def _mkdir(d: Path) -> Path:
    d.mkdir(parents=True, exist_ok=True)
    return d


def _files(d: Path) -> dict:
    return {p.name: p.read_bytes() for p in sorted(d.iterdir())}


# -- one-sided conformance ----------------------------------------------------

def _memory_put_get(pkg, comm, d):
    with pkg.core.Window.allocate(comm, 1024) as win:
        for r in range(comm.size):
            win.put(np.full(16, r + 1, np.uint8), r, 8 * r)
        return [win.get(r, 0, 64).tobytes() for r in range(comm.size)]


def test_memory_window_put_get(comm4, tmp_path):
    got = against_ref(tmp_path, comm4, _memory_put_get)
    assert got[2][16:32] == bytes([3]) * 16


def _storage_put_get_sync(pkg, comm, d):
    with pkg.core.Window.allocate(comm, 8192, info=storage_info(d)) as win:
        data = np.arange(256, dtype=np.int64)
        win.put(data.view(np.uint8), 3, 64)
        out = [bool((win.get(3, 64, 256, np.int64) == data).all()),
               win.dirty_bytes(3), win.sync(3), win.dirty_bytes(3),
               win.sync(3)]
    return out, _files(d)


def test_storage_window_put_get_sync(comm4, tmp_path):
    (ok, dirty, flushed, after, again), files = against_ref(
        tmp_path, comm4, _storage_put_get_sync)
    assert ok and dirty > 0 and flushed > 0 and after == 0 and again == 0
    raw = np.frombuffer(files["w.bin.3"], np.uint8)
    assert (raw[64:64 + 256 * 8].view(np.int64) == np.arange(256)).all()


def _accumulates(pkg, comm, d):
    out = {}
    for op in ["sum", "prod", "min", "max", "band", "bor", "replace"]:
        with pkg.core.Window.allocate(comm, 64) as win:
            win.put(np.array([12], np.int64).view(np.uint8), 2, 0)
            win.accumulate(np.array([7], np.int64), 2, 0, op=op)
            out[op] = int(win.get(2, 0, 1, np.int64)[0])
    return out


def test_accumulate_parity(comm4, tmp_path):
    got = against_ref(tmp_path, comm4, _accumulates)
    assert got == {"sum": 19, "prod": 84, "min": 7, "max": 12, "band": 4,
                   "bor": 15, "replace": 7}


def _fetch_ops(pkg, comm, d):
    with pkg.core.Window.allocate(comm, 64) as win:
        win.put(np.array([100], np.int64).view(np.uint8), 0, 0)
        old = int(win.get_accumulate(np.array([5], np.int64), 0, 0, "sum")[0])
        fetched = int(win.fetch_and_op(1, 0, 0, "sum"))
        win.put(np.array([-1], np.int64).view(np.uint8), 3, 0)
        swaps = [int(win.compare_and_swap(10, -1, 3, 0)),
                 int(win.compare_and_swap(20, -1, 3, 0))]
        return (old, fetched, int(win.get(0, 0, 1, np.int64)[0]), swaps,
                int(win.get(3, 0, 1, np.int64)[0]))


def test_get_accumulate_fetch_op_and_cas(comm4, tmp_path):
    got = against_ref(tmp_path, comm4, _fetch_ops)
    assert got == (100, 105, 106, [-1, 10], 10)


def _rput_rget(pkg, comm, d):
    with pkg.core.Window.allocate(comm, 4096, info=storage_info(d)) as win:
        reqs = [win.rput(np.full(64, r + 1, np.uint8), r, 0)
                for r in range(comm.size)]
        for r in reqs:
            r.wait(timeout=30.0)
        got = [win.rget(r, 0, 64).wait(timeout=30.0).tobytes()
               for r in range(comm.size)]
        flushed = win.flush_async(2).wait(timeout=30.0)
    return got, flushed, _files(d)


def test_rput_rget_flush_pipeline(comm4, tmp_path):
    got, flushed, _ = against_ref(tmp_path, comm4, _rput_rget)
    assert got == [bytes([r + 1]) * 64 for r in range(4)] and flushed > 0


# -- collectives ----------------------------------------------------------------

def test_barrier_ordering(comm4):
    before = comm4.barrier_count
    with tcore.Window.allocate(comm4, 64) as win:
        for r in range(comm4.size):
            win.put(np.full(8, 42, np.uint8), r, 0)
        comm4.barrier()
        for r in range(comm4.size):
            assert (win.get(r, 0, 8) == 42).all()
    assert comm4.barrier_count >= before + 1


def test_allreduce_bcast_parity(comm4):
    ref = jcore.Communicator(4)
    vals = [1.5, -2.0, 7.25, 3.0]
    mat = [np.full(3, r, np.int64) for r in range(4)]
    for c in (comm4, ref):
        assert [c.allreduce(vals, op) for op in ("sum", "max", "min")] \
            == [9.75, 7.25, -2.0]
        np.testing.assert_array_equal(c.allreduce(mat, "sum"),
                                      np.full(3, 6, np.int64))
        assert c.allreduce(5.0) == 5.0
        assert c.bcast(42) == 42
        assert c.bcast({"k": [1, 2, 3]}, root=2) == {"k": [1, 2, 3]}
        for bad in ([1, 2], list(range(5))):
            with pytest.raises(ValueError, match="contribution per rank"):
                c.allreduce(bad, "sum")
        with pytest.raises(ValueError):
            c.bcast(1, root=4)
    ref.close()


def test_split_translated_ranks(comm4):
    sub = comm4.split(color=1, ranks=[1, 3])
    assert (sub.size, sub.color, sub.parent_ranks) == (2, 1, (1, 3))
    assert sub.translate_rank(0) == 1 and sub.translate_rank(1) == 3
    assert sub.group_rank(3) == 1 and sub.group_rank(0) is None
    with tcore.Window.allocate(sub, 128) as win:
        assert sub.active_windows() == 1
        assert comm4.active_windows() == 0
        win.put(np.full(4, 9, np.uint8), 1, 0)
        assert (win.get(1, 0, 4) == 9).all()
    assert sub.allreduce([10, 20], "sum") == 30
    assert sub.split(color=0, ranks=[1]).parent_ranks == (3,)
    for bad in ([], [0, 0], [0, comm4.size]):
        with pytest.raises(ValueError):
            comm4.split(0, bad)
    sub.close()


# -- applications: same tables and files as the reference ---------------------

def _dht_fill(pkg, comm, d):
    dht = pkg.core.DistributedHashTable(comm, 128,
                                        info=storage_info(d, "dht.bin"))
    rng = np.random.default_rng(7)
    for k in rng.integers(1, 1 << 40, 200):
        dht.insert(int(k), 1, op="sum")
    items = sorted(dht.items())
    flushed = dht.sync()
    dht.free()
    return items, flushed, _files(d)


def test_dht_results_match_reference(comm4, tmp_path):
    items, _, files = against_ref(tmp_path, comm4, _dht_fill)
    assert len(items) == 200 and len(files) == 4


def _mapreduce(pkg, comm, d):
    rng = np.random.default_rng(3)
    words = "alpha beta gamma delta epsilon zeta".split()
    tasks = [" ".join(rng.choice(words, 60)) for _ in range(8)]
    mr = pkg.core.MapReduce1S(comm, 1 << 8, info=storage_info(d, "mr.bin"))
    mr.run(tasks)
    out = (mr.result(), mr.completed_tasks(), mr.ckpt_count)
    mr.free()
    return out, _files(d)


def test_mapreduce_results_match_reference(comm4, tmp_path):
    (result, done, ckpts), files = against_ref(tmp_path, comm4, _mapreduce)
    assert done == ckpts == 8 and sum(result.values()) == 8 * 60
    assert len(files) == 8  # table and progress, one file per rank each


# -- masked selective sync: same bytes flushed --------------------------------

def _page_mask(*blocks, n=16):
    m = np.zeros(n, dtype=bool)
    m[list(blocks)] = True
    return m


def _masked_sync(pkg, comm, d, *, blocking):
    win = pkg.core.Window.allocate(comm, 16 * PAGE,
                                   info=storage_info(d, "m.bin"))
    try:
        for pg in (1, 3, 5):
            win.put(np.full(32, pg + 1, np.uint8), 2, pg * PAGE)
        if blocking:
            masked = win.sync(2, mask=_page_mask(3, 7))
        else:
            masked = win.flush_async(2, mask=_page_mask(3, 7)).wait(
                timeout=30.0)
        return masked, win.sync(2), _files(d)
    finally:
        win.free()


@pytest.mark.parametrize("blocking", [True, False], ids=["sync", "flush_async"])
def test_masked_sync_bytes_parity(comm4, tmp_path, blocking):
    masked, rest, files = against_ref(tmp_path, comm4, _masked_sync,
                                      blocking=blocking)
    assert (masked, rest) == (PAGE, 2 * PAGE)
    disk = files["m.bin.2"]
    assert (disk[3 * PAGE], disk[5 * PAGE]) == (4, 6)


def test_mask_length_validated(comm4, tmp_path):
    with tcore.Window.allocate(comm4, 16 * PAGE,
                               info=storage_info(tmp_path, "v.bin")) as win:
        with pytest.raises(tcore.WindowError, match="blocks"):
            win.sync(1, mask=np.ones(15, bool))
        with pytest.raises(tcore.WindowError, match="blocks"):
            win.flush_async(1, mask=np.ones(17, bool))


def _device_sync(pkg, comm, d, *, blocking):
    win = pkg.core.Window.allocate(comm, 16 * PAGE,
                                   info=storage_info(d, "d.bin"))
    try:
        snap = np.arange(16 * PAGE // 4, dtype=np.float32)
        win.put(snap, 1, 0)
        win.sync(1)
        cur = snap.copy()
        cur[(PAGE // 4) * 4 + 1] += 1.0   # page 4
        cur[(PAGE // 4) * 11] += 2.0      # page 11
        res = win.sync_from_device(1, pkg.dev(cur), pkg.dev(snap),
                                   blocking=blocking)
        flushed = res if blocking else res.wait(timeout=30.0)
        return flushed, win.dirty_bytes(1), _files(d)
    finally:
        win.free()


@pytest.mark.parametrize("blocking", [True, False], ids=["sync", "flush_async"])
def test_sync_from_device_remote_owner_parity(comm4, tmp_path, blocking):
    flushed, dirty, files = against_ref(tmp_path, comm4, _device_sync,
                                        blocking=blocking)
    assert (flushed, dirty) == (2 * PAGE, 0)


def _count_calls(transport):
    """Record ``(rank, op)`` of every control-channel call and post."""
    calls, posts = [], []
    orig_call, orig_post = transport._call, transport._post

    def call(rank, msg):
        calls.append((rank, msg[0]))
        return orig_call(rank, msg)

    def post(rank, msg):
        posts.append((rank, msg[0]))
        return orig_post(rank, msg)

    transport._call, transport._post = call, post

    def restore():
        transport._call, transport._post = orig_call, orig_post
    return calls, posts, restore


@pytest.mark.parametrize("sharded", [False, True], ids=["one", "shards"])
def test_sync_from_device_one_wsync_mp(tmp_path, sharded):
    """Under mp the whole device-sync epilogue -- spans, mask, masked flush
    -- is a single ``wsync`` control-channel message to the target rank,
    for one tensor or several shards at different displacements."""
    comm = world("mp")
    win = tcore.Window.allocate(comm, 16 * PAGE, info=storage_info(tmp_path))
    try:
        snap = np.arange(16 * PAGE // 4, dtype=np.float32)
        win.put(snap, 3, 0)
        win.sync(3)
        cur = snap.copy()
        cur[0] += 1.0
        cur[-1] += 1.0
        calls, posts, restore = _count_calls(comm.transport)
        try:
            if sharded:
                half = snap.size // 2
                flushed = win.sync_shards_from_device(3, [
                    (torch.from_numpy(cur[:half]),
                     torch.from_numpy(snap[:half]), 0),
                    (torch.from_numpy(cur[half:]),
                     torch.from_numpy(snap[half:]), half * 4)],
                    blocking=True)
            else:
                flushed = win.sync_from_device(3, torch.from_numpy(cur),
                                               torch.from_numpy(snap),
                                               blocking=True)
        finally:
            restore()
        assert flushed == 2 * PAGE
        assert calls == [(3, "wsync")] and posts == []
        disk = np.fromfile(tmp_path / "w.bin.3", np.float32)
        assert np.array_equal(disk.view(np.uint32), cur.view(np.uint32))
    finally:
        win.free()


def _shards(pkg, comm, d):
    win = pkg.core.Window.allocate(comm, 16 * PAGE,
                                   info=storage_info(d, "s.bin"))
    try:
        a_snap = np.zeros(2 * PAGE // 4, np.float32)       # pages 0-1
        b_snap = np.ones(4 * PAGE // 4, np.float32)        # pages 8-11
        win.put(a_snap, 0, 0)
        win.put(b_snap, 0, 8 * PAGE)
        win.sync(0)
        a_cur = a_snap.copy()
        a_cur[3] = 7.0                                     # page 0
        b_cur = b_snap.copy()
        b_cur[-1] = -1.0                                   # page 11
        flushed = win.sync_shards_from_device(
            0, [(pkg.dev(a_cur), pkg.dev(a_snap), 0),
                (pkg.dev(b_cur), pkg.dev(b_snap), 8 * PAGE)], blocking=True)
        return flushed, win.dirty_bytes(0), _files(d)
    finally:
        win.free()


def test_sync_shards_merged_mask_parity(comm4, tmp_path):
    flushed, dirty, files = against_ref(tmp_path, comm4, _shards)
    assert (flushed, dirty) == (2 * PAGE, 0)
    disk = np.frombuffer(files["s.bin.0"], np.float32)
    assert (disk[3], disk[12 * PAGE // 4 - 1]) == (7.0, -1.0)


# -- request aggregation / notified access ------------------------------------

def _batched_fifo(pkg, comm, d):
    win = pkg.core.Window.allocate(comm, 4096, info=storage_info(d, "agg.bin"))
    try:
        reqs = [win.rput(np.full(64, 1, np.uint8), 2, 0),
                win.raccumulate(np.full(8, 2, np.int64), 2, 0)]
        mid = win.rget(2, 0, 64)  # sees put+acc, NOT the overwrite
        reqs.append(win.rput(np.full(64, 9, np.uint8), 2, 0))
        win.flush(2)
        mid_val = mid.wait(timeout=30.0).tobytes()
        final = win.get(2, 0, 64).tobytes()
        win.sync(2)
        for r in reqs:
            r.wait(timeout=30.0)
        return mid_val, final, _files(d)
    finally:
        win.free()


def test_batched_ops_fifo_parity(comm4, tmp_path):
    mid, final, _ = against_ref(tmp_path, comm4, _batched_fifo)
    assert (np.frombuffer(mid, np.int64) == 0x0101010101010101 + 2).all()
    assert final == bytes([9]) * 64


def test_batched_ops_one_round_trip_mp(tmp_path):
    """N small rputs to one target cost exactly ONE posted message, and
    their flush ONE completion read; a train holding a get ships as one
    replying ``opbatch``."""
    comm = world("mp")
    win = tcore.Window.allocate(comm, 4096, info=storage_info(tmp_path))
    try:
        calls, posts, restore = _count_calls(comm.transport)
        try:
            reqs = [win.rput(np.full(8, i, np.uint8), 3, 8 * i)
                    for i in range(32)]
            win.flush(3)
            assert all(r.test() for r in reqs)
            assert posts == [(3, "opbatch_nb")]
            assert calls == [(3, "notify_read")]
            calls.clear(), posts.clear()
            win.rput(np.full(8, 7, np.uint8), 3, 0)
            assert (win.rget(3, 8, 8).wait(timeout=30.0) == 1).all()
            assert posts == [] and calls == [(3, "opbatch")]
        finally:
            restore()
        win.flush(3)
        assert (win.get(3, 0, 8) == 7).all()
    finally:
        win.free()


def test_notified_post_error_surfaces_at_flush(comm4, tmp_path):
    win = tcore.Window.allocate(comm4, 4096, info=storage_info(tmp_path))
    try:
        bad = win.rput(np.ones(16, np.uint8), 1, 4096)  # out of range
        ok = win.rput(np.full(8, 5, np.uint8), 1, 0)
        with pytest.raises(IndexError):
            win.flush(1)
        ok.wait(timeout=10.0)
        assert bad.test()
        assert (win.get(1, 0, 8) == 5).all()
    finally:
        win.free()


# -- the wire codec on the channel --------------------------------------------

def test_wire_stats_schema_on_every_backend(comm4, tmp_path):
    want_keys = set(jcore.Communicator(1).transport.wire_stats_snapshot())
    snap = comm4.transport.wire_stats_snapshot()
    assert set(snap) == want_keys
    if comm4.transport.kind == "inproc":
        assert comm4.transport.codec_policy is None
        assert snap == jcore.Communicator(1).transport.wire_stats_snapshot()
    else:
        assert comm4.transport.codec_policy is not None


def _codec_case(pkg, comm, d):
    win = pkg.core.Window.allocate(comm, 16 * PAGE, info=storage_info(d))
    try:
        data = np.zeros(4 * PAGE, np.uint8)            # pages 0-3, mostly 0
        data[::512] = 7
        win.sync(0, mask=_page_mask(0, 1, 2, 3), spans=[(0, data)])
        for i in range(16):
            win.rput(np.zeros(1024, np.uint8), 0, 8 * PAGE + i * 1024)
        win.flush(0)
        win.sync(0)
    finally:
        win.free()
    return _files(d)


def test_mp_codec_shrinks_wire_and_disk_is_exact(tmp_path):
    """Under mp a compressible masked-span flush and a zero-filled op train
    cross the channel encoded (wire <= half of logical); the owner decodes
    before applying, so the files equal the reference's raw path."""
    comm = tcore.Communicator(1, transport="mp")
    try:
        ref = jcore.Communicator(1)
        want = _codec_case(REF, ref, _mkdir(tmp_path / "ref"))
        ref.close()
        assert _codec_case(PORT, comm, _mkdir(tmp_path / "run")) == want
        ws = comm.transport.wire_stats_snapshot()
        assert ws["spans_encoded_msgs"] >= 1 and ws["ops_encoded_msgs"] >= 1
        assert ws["spans_wire_bytes"] * 2 <= ws["spans_logical_bytes"], ws
        assert ws["ops_wire_bytes"] * 2 <= ws["ops_logical_bytes"], ws
    finally:
        comm.close()


# -- mp-only behaviour -------------------------------------------------------

def test_mp_memory_window_is_shared_memory():
    comm = world("mp")
    with tcore.Window.allocate(comm, 256) as win:
        view = win.baseptr(1)
        view[3] = 77
        assert win.get(1, 3, 1)[0] == 77
        win.accumulate(np.array([1], np.uint8), 1, 3, op="sum")
        assert view[3] == 78
        del view  # release the mapping before free() closes the shm
    with pytest.raises(tcore.WindowError, match="in-process transport"):
        tcore.Window.create_dynamic(comm)


def _worker_pids(transport) -> list[int]:
    return [p.pid for p in transport._procs]


def test_spawned_worker_never_loads_torch(tmp_path):
    """The workers' import chain is numpy and the standard library: their
    address space maps numpy's extension modules and nothing of torch."""
    comm = world("mp")
    with tcore.Window.allocate(comm, PAGE,
                               info=storage_info(tmp_path)) as win:
        win.put(np.ones(8, np.uint8), 1, 0)  # the worker built a segment
        for pid in _worker_pids(comm.transport):
            maps = Path(f"/proc/{pid}/maps").read_text()
            assert "numpy" in maps  # the check sees the worker's imports
            assert "torch" not in maps, f"worker {pid} loaded torch"


def _mr_tasks():
    rng = np.random.default_rng(11)
    words = "one two three four five six seven".split()
    tasks = [" ".join(rng.choice(words, 50)) for _ in range(8)]
    expect = {}
    for t in tasks:
        for k, v in wordcount_map(t).items():
            expect[k] = expect.get(k, 0) + v
    return tasks, expect


def test_mp_worker_kill_detected_and_recovery(tmp_path):
    """Kill a rank's worker mid-run: operations against it fail loudly, its
    un-synced page cache is lost, and a fresh world over the same files
    resumes from the last checkpoint -- under mp, and under the
    reference's inproc transport, which reads the port's files."""
    tasks, expect = _mr_tasks()
    comm = tcore.Communicator(4, transport="mp")
    mr = tcore.MapReduce1S(comm, 1 << 8, info=storage_info(tmp_path, "mr.bin"))
    my0 = mr._tasks_of(0, len(tasks))
    for pos in range(2):
        for k, v in wordcount_map(tasks[my0[pos]]).items():
            mr.table.insert(k, v, op="sum")
        mr._commit_task(0, pos)
    mr._drain_ckpt()
    assert mr.completed_tasks() == 2

    comm.transport.kill_rank(1)
    assert comm.transport.probe(1) is False
    assert comm.probe(1) is False and 1 in comm.dead_ranks
    with pytest.raises(tcore.TransportError, match="unreachable"):
        mr.table.win.get(1, 0, 8)
    with pytest.raises(tcore.TransportError):
        comm.close()
    assert not any(p.is_alive() for p in comm.transport._procs)

    ref = jcore.MapReduce1S(jcore.Communicator(4), 1 << 8,
                            info=storage_info(tmp_path, "mr.bin"),
                            resume=True)
    assert ref.completed_tasks() == 2  # the port's progress, read by JAX's
    ref.free()
    comm2 = tcore.Communicator(4, transport="mp")
    mr2 = tcore.MapReduce1S(comm2, 1 << 8,
                            info=storage_info(tmp_path, "mr.bin"), resume=True)
    assert mr2.completed_tasks() == 2
    mr2.run(tasks)
    assert mr2.result() == expect
    mr2.free()
    comm2.close()


def test_mp_probe_and_respawn(tmp_path):
    comm = tcore.Communicator(2, transport="mp")
    try:
        t = comm.transport
        assert t.probe(0) and t.probe(1)
        with pytest.raises(tcore.TransportError, match="refusing"):
            t.respawn_rank(1)  # alive and responsive
        t.kill_rank(1)
        assert not t.probe(1) and t.probe(0)
        t.respawn_rank(1)
        assert t.probe(1)
        with tcore.Window.allocate(comm, PAGE,
                                   info=storage_info(tmp_path)) as win:
            win.put(np.full(16, 4, np.uint8), 1, 0)
            assert win.sync(1) > 0
        assert (np.fromfile(tmp_path / "w.bin.1", np.uint8)[:16] == 4).all()
        with pytest.raises(ValueError, match="outside"):
            t.probe(2)
    finally:
        comm.close()
    assert not any(p.is_alive() for p in comm.transport._procs)


def test_mp_free_after_worker_death_idempotent(tmp_path):
    comm = tcore.Communicator(2, transport="mp")
    win = tcore.Window.allocate(comm, 4096, info=storage_info(tmp_path))
    win.put(np.full(16, 8, np.uint8), 1, 0)
    comm.transport.kill_rank(1)
    with pytest.raises(tcore.TransportError):
        win.free()
    assert win.freed
    win.free()  # idempotent: the error does not replay
    assert comm.active_windows() == 0
    comm.close()
    assert not any(p.is_alive() for p in comm.transport._procs)


def test_channel_framing_interoperates_with_connection():
    """The bounded-chunk reads and writes keep ``Connection``'s framing:
    each side reads what the other's stock ``send`` wrote, for messages
    far larger than one chunk."""
    import multiprocessing
    import threading

    from repro_torch.core.transport import multiproc
    payload = np.random.default_rng(0).integers(
        0, 256, 3 * multiproc._IO_CHUNK + 5, dtype=np.uint8).tobytes()
    a, b = multiprocessing.Pipe(duplex=True)
    got = []
    for send, recv in ((multiproc._send, lambda c: c.recv()),
                       (lambda c, m: c.send(m), multiproc._recv)):
        reader = threading.Thread(target=lambda: got.append(recv(b)))
        reader.start()
        send(a, ("put", 7, payload))
        reader.join(timeout=30)
    assert got == [("put", 7, payload)] * 2
    a.close()
    with pytest.raises(EOFError):
        multiproc._recv(b)
    b.close()


def test_kill_rank_refused_without_worker_processes():
    with pytest.raises(tcore.TransportError, match="no worker process"):
        tcore.Communicator(2).transport.kill_rank(1)


def test_spmd_program_execution_not_ported():
    from repro_torch.core.transport.multiproc import _worker_main
    with pytest.raises(NotImplementedError, match="A14"):
        _worker_main(None, 0, spmd={})


def test_seg_meta_and_service_errors(tmp_path):
    """A memory segment advertises no storage tier (no backpressure charge
    a sync could drain), a storage one its size; sync/wsync against a
    segment with no sync() name the op in a TransportError."""
    from repro_torch.core.hints import WindowHints
    from repro_torch.core.transport.local import _make_segment, _MemorySegment
    from repro_torch.core.transport.multiproc import (_RemoteSegment,
                                                      _SegmentService,
                                                      _seg_meta)
    meta = _seg_meta(_MemorySegment(256))
    assert (meta["kind"], meta["sto_bytes"]) == ("memory", 0)
    seg = _RemoteSegment(SimpleNamespace(_call=lambda rank, msg: None),
                         0, 1, meta)
    seg.write(0, np.ones(64, np.uint8))
    assert not seg.has_storage and seg.dirty_bytes_estimate() == 0

    sto = _make_segment(8192, WindowHints.from_info(
        storage_info(tmp_path, "meta.bin")), 0, 1, shared_file=False,
        memory_budget=None, mechanism="cached", page_size=4096,
        cache_bytes=None, writeback_interval=None)
    try:
        meta = _seg_meta(sto)
        assert (meta["kind"], meta["sto_bytes"], meta["page_size"]) \
            == ("storage", 8192, 4096)
    finally:
        sto.close(unlink=True)

    svc = _SegmentService(0)
    svc.segments[7] = SimpleNamespace(kind="memory", size=64,
                                      write=lambda o, d: None)
    with pytest.raises(tcore.TransportError, match="'sync'.*memory window"):
        svc.execute(("sync", 7, False, None))
    with pytest.raises(tcore.TransportError, match="'wsync'.*memory window"):
        svc.execute(("wsync", 7, [], None))


# -- checkpoint crash-replay under mp -----------------------------------------

def _manifest_step(d) -> int:
    with open(d / "manifest.json") as f:
        return int(json.load(f)["step"])


def test_checkpoint_owner_death_never_commits_manifest(tmp_path):
    """A save whose owning worker is SIGKILLed fails loudly without
    committing its manifest; a cold restart under inproc restores the
    previous checkpoint intact (the manifest is never ahead of data)."""
    from repro_torch.ckpt import CheckpointManager
    comm = tcore.Communicator(1, transport="mp")
    specs = {"w": ((1 << 14,), np.float32)}
    cm = CheckpointManager(str(tmp_path), comm, specs, double_buffer=False)
    w1 = torch.from_numpy(np.random.default_rng(4).standard_normal(
        1 << 14).astype(np.float32))
    cm.save(5, {"w": w1})
    assert _manifest_step(tmp_path) == 5
    comm.transport.kill_rank(0)
    req = cm.save_async(6, {"w": w1 * 2})
    with pytest.raises(tcore.TransportError):
        req.wait(timeout=30.0)
    assert _manifest_step(tmp_path) == 5
    with pytest.raises(tcore.TransportError):
        cm.close()
    comm.close()
    cm2 = CheckpointManager.open_for_restore(str(tmp_path),
                                             tcore.Communicator(1), specs,
                                             double_buffer=False)
    r = cm2.restore()
    assert r is not None and not r.fell_back and r.step == 5
    assert torch.equal(torch.as_tensor(r.tree["w"]), w1)
    cm2.close()


# -- bootstrap ---------------------------------------------------------------

def test_env_bootstrap_worker_rank_is_ranklocal(monkeypatch):
    """mp spawns a fresh world, so it is driver-only: asking for it from a
    nonzero rank raises; the worker rank gets a rank-local view."""
    monkeypatch.setenv("REPRO_TRANSPORT", "mp")
    monkeypatch.setenv("REPRO_NRANKS", "2")
    monkeypatch.setenv("REPRO_RANK", "1")
    with pytest.raises(ValueError, match="driver-only"):
        tcore.Communicator.from_env()
    monkeypatch.setenv("REPRO_TRANSPORT", "inproc")
    comm = tcore.Communicator.from_env()
    assert (comm.transport.kind, comm.size, comm.rank) == ("ranklocal", 2, 1)
    comm.close()
    monkeypatch.setenv("REPRO_TRANSPORT", "mp")
    monkeypatch.setenv("REPRO_RANK", "0")
    comm = tcore.Communicator.from_env()
    try:
        assert (comm.transport.kind, comm.size) == ("mp", 2)
    finally:
        comm.close()


def test_rank_outside_size_and_inproc_default(monkeypatch):
    for rank in (5, -1):
        with pytest.raises(ValueError, match="outside communicator"):
            tcore.Communicator(4, rank=rank)
    monkeypatch.delenv("REPRO_TRANSPORT", raising=False)
    monkeypatch.delenv("REPRO_NRANKS", raising=False)
    comm = tcore.Communicator.from_env(3)
    assert comm.transport.kind == "inproc" and comm.size == 3
    comm.close()


def test_make_transport_errors_name_backends_env_and_roadmap():
    from repro_torch.core.transport import make_transport
    with pytest.raises(ValueError) as ei:
        make_transport(2, 0, "rdma")
    for word in ("inproc", "mp", "ranklocal", "tcp", "REPRO_TRANSPORT",
                 "REPRO_NRANKS", "REPRO_RANK", "REPRO_HOSTS"):
        assert word in str(ei.value)
    for rank in (0, 1):
        with pytest.raises(NotImplementedError, match="ROADMAP.*A1"):
            make_transport(2, rank, "tcp")


def test_env_hosts_and_timeouts(tmp_path, monkeypatch):
    from repro.core.transport import ENV_TIMEOUTS as J_TIMEOUTS
    from repro_torch.core.transport import (ENV_TIMEOUTS, env_hosts,
                                            env_timeout_s)
    monkeypatch.delenv("REPRO_HOSTS", raising=False)
    monkeypatch.delenv("REPRO_RENDEZVOUS", raising=False)
    assert env_hosts() is None
    monkeypatch.setenv("REPRO_HOSTS", "10.0.0.1:7000, 10.0.0.2:7000")
    assert env_hosts() == ["10.0.0.1:7000", "10.0.0.2:7000"]
    monkeypatch.delenv("REPRO_HOSTS")
    rv = tmp_path / "roster"
    rv.write_text("# fleet\nhostA:9001\n\nhostB:9002\n")
    monkeypatch.setenv("REPRO_RENDEZVOUS", str(rv))
    assert env_hosts() == ["hostA:9001", "hostB:9002"]
    # the knobs this package reads have the reference's names and defaults
    assert all(J_TIMEOUTS[k] == v for k, v in ENV_TIMEOUTS.items())
    monkeypatch.setenv("REPRO_MP_TIMEOUT", "7.5")
    assert env_timeout_s("REPRO_MP_TIMEOUT") == 7.5
    monkeypatch.setenv("REPRO_MP_TIMEOUT", "soon")
    with pytest.raises(ValueError, match="REPRO_MP_TIMEOUT"):
        env_timeout_s("REPRO_MP_TIMEOUT")
    with pytest.raises(KeyError):
        env_timeout_s("REPRO_NOPE_TIMEOUT")


# -- ranklocal ---------------------------------------------------------------

def _partition_writes(win, rank):
    data = np.random.default_rng(rank).integers(0, 256, 3 * PAGE,
                                                dtype=np.uint8)
    win.put(data, rank, 100 * rank)
    win.accumulate(np.array([rank + 1], np.int64), rank, 0, "sum")


def test_ranklocal_files_identical_to_inproc(tmp_path):
    """n independent rank-local processes' windows give exactly the files
    of one in-process driver writing every partition (and the JAX
    package's); a cross-rank op raises, replication clamps to one copy."""
    n = 3
    info = storage_info(tmp_path / "inproc")
    _mkdir(tmp_path / "inproc")
    drv = tcore.Window.allocate(tcore.Communicator(n), 4 * PAGE, info=info)
    for r in range(n):
        _partition_writes(drv, r)
    drv.sync()
    drv.free()
    _mkdir(tmp_path / "ref")
    jwin = jcore.Window.allocate(jcore.Communicator(n), 4 * PAGE,
                                 info=storage_info(tmp_path / "ref"))
    for r in range(n):
        _partition_writes(jwin, r)
    jwin.sync()
    jwin.free()

    _mkdir(tmp_path / "local")
    for r in range(n):
        comm = tcore.Communicator(n, rank=r, transport="ranklocal")
        win = tcore.Window.allocate(comm, 4 * PAGE, info=dict(
            storage_info(tmp_path / "local"), storage_alloc_replication="2"))
        assert [s is not None for s in win.segments] == [i == r
                                                        for i in range(n)]
        _partition_writes(win, r)
        with pytest.raises(tcore.TransportError, match="rank-local"):
            win.get((r + 1) % n, 0, 8)
        assert win.sync() > 0
        win.free()
        comm.close()
    want = _files(tmp_path / "inproc")
    assert sorted(want) == [f"w.bin.{r}" for r in range(n)]
    assert _files(tmp_path / "local") == want == _files(tmp_path / "ref")
