"""Replicated storage windows in the port, against the JAX package.

The 20 tests of ``tests/test_resilience.py`` run on ``repro_torch``: the
in-process half simulates rank death with ``comm.mark_dead``, the mp half
SIGKILLs real worker processes.  Where the same numpy puts, syncs, deaths
and rebuilds can run in both packages, the scenario runs through
``repro.core`` on its in-process transport too, and what must match is
exact: returned values (flushed and rebuilt byte counts, DHT items, a
restored checkpoint) and the primary and replica files byte for byte.  A
scenario whose writes before a death are all synced gives the same files
whether the death is simulated or a real kill, so the mp scenarios are
held to the reference's in-process run.  Device syncs take CPU tensors on
the port (the kernels' plain versions) and ``jax.numpy`` arrays on the
reference.
"""

from pathlib import Path
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.ckpt import CheckpointManager as JCheckpointManager
from repro_torch import core as tcore
from repro_torch.ckpt import CheckpointManager
from repro_torch.core import (Communicator, FailureDetector,
                              ReplicaPlacement, Window, WindowError)
from repro_torch.core.hints import HintError, WindowHints
from repro_torch.runtime.fault import HeartbeatMonitor

PAGE = 4096
REF = SimpleNamespace(core=jcore, ckpt=JCheckpointManager,
                      dev=jnp.asarray)
PORT = SimpleNamespace(core=tcore, ckpt=CheckpointManager,
                       dev=lambda a: torch.from_numpy(np.array(a)))


@pytest.fixture(autouse=True)
def _bounded_waits(monkeypatch):
    """A hung worker channel fails its test within a minute."""
    monkeypatch.setenv("REPRO_MP_TIMEOUT", "60")
    monkeypatch.setenv("REPRO_MP_PROBE_TIMEOUT", "5")


def rep_info(d: Path, k=2, name="w.bin"):
    return {"alloc_type": "storage",
            "storage_alloc_filename": str(d / name),
            "storage_alloc_replication": str(k)}


def _files(d: Path) -> dict:
    return {p.name: p.read_bytes() for p in sorted(d.iterdir())
            if p.is_file()}


def simulated(comm, rank):
    comm.mark_dead(rank)


def sigkill(comm, rank):
    """A real death: the worker is killed, nothing is marked -- the next
    operation (or probe) against it finds out."""
    comm.transport.kill_rank(rank)


def against_ref(tmp_path, scenario, nranks, *, transport="inproc", **kw):
    """``scenario(pkg, comm, dir, kill, **kw)`` through the reference (its
    in-process world, deaths simulated) and through the port (``transport``;
    under ``mp`` deaths are real kills).  Results and files must be equal;
    returns the port's results."""
    out = {}
    for name, pkg, kind in (("ref", REF, "inproc"), ("port", PORT, transport)):
        d = tmp_path / name
        d.mkdir()
        comm = pkg.core.Communicator(nranks, transport=kind)
        try:
            out[name] = scenario(pkg, comm, d,
                                 sigkill if kind == "mp" else simulated, **kw)
        finally:
            comm.close()
        out[name + "_files"] = _files(d)
    assert out["port"] == out["ref"]
    assert out["port_files"] == out["ref_files"]
    return out["port"]


# -- placement ----------------------------------------------------------------

def test_placement_chain_order():
    p = ReplicaPlacement(4, 3)
    assert p.holders(0) == (0, 1, 2)
    assert p.holders(3) == (3, 0, 1)
    assert p.replicas(2) == (3, 0)
    # inverse rotation: every rank hosts exactly k-1 copies
    for h in range(4):
        assert len(p.held_by(h)) == 2
        for q in p.held_by(h):
            assert h in p.holders(q)
    assert p.copy_index(3, 0) == 1 and p.copy_index(3, 3) == 0
    with pytest.raises(ValueError, match="holds no copy"):
        p.copy_index(0, 3)


def test_placement_matches_reference():
    def table(cls):
        out = []
        for n in range(1, 6):
            for k in range(1, n + 1):
                p = cls(n, k)
                out.append([(p.holders(r), p.replicas(r), p.held_by(r))
                            for r in range(n)])
        return out
    assert table(ReplicaPlacement) == table(jcore.ReplicaPlacement)


def test_placement_validation():
    with pytest.raises(ValueError):
        ReplicaPlacement(2, 3)  # k > nranks
    with pytest.raises(ValueError):
        ReplicaPlacement(4, 0)
    with pytest.raises(ValueError):
        ReplicaPlacement(4, 2).holders(4)


# -- hint parsing -------------------------------------------------------------

def test_replication_hint_parsing():
    h = WindowHints.from_info({"alloc_type": "storage",
                               "storage_alloc_filename": "/tmp/x",
                               "storage_alloc_replication": "3"})
    assert h.replication == 3
    assert WindowHints.from_info(None).replication == 1
    for bad in ("0", "-1", "two"):
        with pytest.raises(HintError):
            WindowHints.from_info({"alloc_type": "storage",
                                   "storage_alloc_filename": "/tmp/x",
                                   "storage_alloc_replication": bad})


def test_replication_advisory_clamps_and_ignores(tmp_path):
    # memory windows ignore the hint (replicas must be durable)
    comm = Communicator(4)
    with Window.allocate(comm, 256,
                         info={"storage_alloc_replication": "2"}) as win:
        assert win.replication == 1 and not win.replicated
    # k is clamped to the communicator size (advisory, like every hint)
    solo = Communicator(1)
    with Window.allocate(solo, 256, info=rep_info(tmp_path, k=3)) as win:
        assert win.replication == 1
    solo.close()
    comm.close()


# -- mirroring ----------------------------------------------------------------

def _mirror_on_sync(pkg, comm, d, kill):
    win = pkg.core.Window.allocate(comm, 8192, info=rep_info(d, k=2))
    data = np.arange(512, dtype=np.int64)
    win.put(data.view(np.uint8), 3, 256)
    # before the sync nothing is mirrored (and nothing persisted)
    assert np.fromfile(str(d / "w.bin.rep1.3"), np.uint8).sum() == 0
    flushed = win.sync(3)
    raw = np.fromfile(str(d / "w.bin.rep1.3"), dtype=np.uint8)
    assert (raw[256:256 + data.nbytes].view(np.int64) == data).all()
    again = win.sync(3)  # clean window, nothing to re-mirror
    win.free()
    return flushed, again


def test_sync_mirrors_written_spans_to_replica_files(tmp_path):
    flushed, again = against_ref(tmp_path, _mirror_on_sync, 4)
    assert flushed > 0 and again == 0


def _flush_async_epoch(pkg, comm, d, kill):
    win = pkg.core.Window.allocate(comm, 4096, info=rep_info(d, k=2))
    win.rput(np.full(4096, 7, np.uint8), 0, 0).wait()
    n = win.flush_async(0).wait()
    win.flush(0)  # epoch boundary: k durable copies
    rep = np.fromfile(str(d / "w.bin.rep1.0"), dtype=np.uint8)
    assert (rep == 7).all()
    win.free()
    return n


def test_flush_async_epoch_means_k_durable_copies(tmp_path):
    assert against_ref(tmp_path, _flush_async_epoch, 2) > 0


def _mirror_failure(pkg, comm, d, kill):
    win = pkg.core.Window.allocate(comm, 4096, info=rep_info(d, k=2))
    comm.mark_dead(1)  # rank 0's only replica holder is down
    win.put(np.full(64, 5, np.uint8), 0, 0)
    out = [win.sync(0)]  # primary durable; mirror degraded
    out.append(win._mirror_pending[0].dirty_count)  # spans stay pending
    comm.mark_alive(1)
    out.append(win.sync(0))  # no new dirty data, but the mirror replays
    out.append(win._mirror_pending[0].dirty_count)
    rep = np.fromfile(str(d / "w.bin.rep1.0"), dtype=np.uint8)
    assert (rep[:64] == 5).all()
    win.free()
    return out


def test_mirror_failure_remarks_spans(tmp_path):
    """A mirror with no live replica target keeps the spans pending
    (replay, never skip): they mirror on the next sync."""
    flushed, pending, again, after = against_ref(tmp_path, _mirror_failure, 2)
    assert flushed > 0 and pending > 0 and again == 0 and after == 0


# -- failover (simulated, in-process) -----------------------------------------

def _failover_rebuild(pkg, comm, d, kill):
    win = pkg.core.Window.allocate(comm, 8192, info=rep_info(d, k=2))
    data = np.arange(1024, dtype=np.int64)
    win.put(data.view(np.uint8), 1, 0)
    win.sync(1)
    comm.mark_dead(1)
    # reads serve every synced byte from the replica
    assert (win.get(1, 0, 1024, np.int64) == data).all()
    # writes land on the acting replica, atomics included
    win.put(np.full(8, 9, np.uint8), 1, 8192 - 8)
    win.accumulate(np.asarray([100], np.int64), 1, 0, op="sum")
    assert win.get(1, 0, 1, np.int64)[0] == data[0] + 100
    assert win.compare_and_swap(-5, data[1] + 0, 1, 8, np.int64) == data[1]
    win.sync(1)
    # rebuild reconciles the (stale) primary from the acting replica
    copied = win.rebuild_rank(1)
    assert 1 not in comm.dead_ranks
    assert win.get(1, 0, 1, np.int64)[0] == data[0] + 100
    assert win.get(1, 8, 1, np.int64)[0] == -5
    assert (win.get(1, 8192 - 8, 8) == 9).all()
    win.free()
    return copied


def test_failover_reads_writes_and_rebuild(tmp_path):
    assert against_ref(tmp_path, _failover_rebuild, 4) > 0


def _device_failover(pkg, comm, d, kill):
    """The device-mask path routes through the acting holder like put():
    with the primary dead, the changed spans and the masked flush land on
    the replica -- whether the death was marked or is found by the op."""
    win = pkg.core.Window.allocate(comm, 16 * PAGE, info=rep_info(d, k=2))
    elems = 16 * PAGE // 4
    state = np.random.default_rng(7).standard_normal(elems).astype(
        np.float32)
    win.put(state, 0, 0)
    win.sync(0)  # k durable copies of the baseline
    kill(comm, 0)
    # a real kill is not observed yet: the sync below must find it
    assert (0 in comm.dead_ranks) == (kill is simulated)
    cur = state.copy()
    cur[(PAGE // 4) * 2 + 1] += 1.0   # page 2
    cur[(PAGE // 4) * 9 + 5] += 1.0   # page 9
    out = [win.sync_from_device(0, pkg.dev(cur), pkg.dev(state),
                                blocking=True)]
    assert 0 in comm.dead_ranks  # marked, or discovered by the op itself
    # the acting replica holds (and persisted) the change...
    assert (win.get(0, 0, elems, np.float32) == cur).all()
    rep = np.fromfile(str(d / "w.bin.rep1.0"), np.float32)
    assert (rep == cur).all()
    # ...and the primary's file stayed at the old epoch (it is dead)
    prim = np.fromfile(str(d / "w.bin.0"), np.float32)
    assert (prim == state).all()
    # the nonblocking variant takes the same route (a pool task)
    cur2 = cur.copy()
    cur2[(PAGE // 4) * 11] += 1.0     # page 11
    out.append(win.sync_from_device(0, pkg.dev(cur2), pkg.dev(cur))
               .wait(timeout=30.0))
    rep = np.fromfile(str(d / "w.bin.rep1.0"), np.float32)
    assert (rep == cur2).all()
    # rebuild: the primary takes exactly the three changed pages back
    out.append(comm.rebuild_rank(0))
    prim = np.fromfile(str(d / "w.bin.0"), np.float32)
    assert (prim == cur2).all()
    win.free()
    return out


@pytest.mark.parametrize("transport", ["inproc", "mp"])
def test_sync_from_device_failover(tmp_path, transport):
    """Inproc: the primary marked dead.  mp: its worker SIGKILLed and
    nothing marked, so the TransportError surfaces *inside* the masked span
    write, which fails over and replays the whole span set on the replica
    (never a partial epoch).  Both equal the reference's run."""
    flushed, flushed2, copied = against_ref(
        tmp_path, _device_failover, 2, transport=transport)
    assert (flushed, flushed2, copied) == (2 * PAGE, PAGE, 3 * PAGE)


def test_failover_exhausted_raises(tmp_path):
    comm = Communicator(4)
    win = Window.allocate(comm, 1024, info=rep_info(tmp_path, k=2))
    comm.mark_dead(0)
    comm.mark_dead(1)  # both holders of partition 0 are gone
    with pytest.raises(WindowError, match="no live holder"):
        win.get(0, 0, 8)
    comm.mark_alive(0)
    comm.mark_alive(1)
    win.free()
    comm.close()


def test_unreplicated_windows_unchanged(tmp_path):
    """No hint, no behavior change: a marked-dead rank on an unreplicated
    inproc window still serves (inproc segments cannot actually die)."""
    comm = Communicator(2)
    win = Window.allocate(comm, 1024, info={
        "alloc_type": "storage",
        "storage_alloc_filename": str(tmp_path / "plain.bin")})
    assert not win.replicated and win.replica_segs == {}
    comm.mark_dead(1)
    win.put(np.full(8, 3, np.uint8), 1, 0)  # routes to the primary, as ever
    assert (win.get(1, 0, 8) == 3).all()
    win.free()
    comm.close()


def _dht_failover(pkg, comm, d, kill, n_keys, extra, victim):
    """Inserts, a durability point, a death, service through failover (all
    synced keys served, more inserts), a rebuild, and the table again."""
    dht = pkg.core.DistributedHashTable(comm, 64, info={
        "alloc_type": "storage",
        "storage_alloc_filename": str(d / "dht.bin")}, replication=2)
    expect = {int(k): i for i, k in enumerate(
        np.random.default_rng(5).integers(1, 1 << 40, n_keys))}
    for k, v in expect.items():
        dht.insert(k, v, op="replace")
    dht.sync()
    kill(comm, victim)
    hb = HeartbeatMonitor(comm.size)
    assert FailureDetector(comm, hb).poll(0) == [victim]
    assert hb.dead() == [victim]
    assert all(dht.lookup(k) == v for k, v in expect.items())
    for k in list(expect)[:extra]:  # writes through failover
        dht.insert(k, expect[k] + 1, op="replace")
        expect[k] += 1
    more = {int(k): -i for i, k in enumerate(
        np.random.default_rng(10).integers(1 << 40, 1 << 41, extra))}
    for k, v in more.items():
        dht.insert(k, v, op="replace")
    expect.update(more)
    assert all(dht.lookup(k) == v for k, v in expect.items())
    dht.sync()
    copied = comm.rebuild_rank(victim)
    assert comm.probe(victim) is True
    win = dht.win
    size = win.segments[victim].size
    prim = np.asarray(comm.transport.get(win.segments[victim], 0, size))
    rep = np.asarray(comm.transport.get(win.replica_segs[(victim, 1)], 0,
                                        size))
    assert (prim == rep).all()  # bit-exact partition
    assert all(dht.lookup(k) == v for k, v in expect.items())
    items = sorted(dht.items())
    assert items == sorted(expect.items())
    dht.free()
    return copied, items


def test_dht_failover_inproc(tmp_path):
    copied, _ = against_ref(tmp_path, _dht_failover, 4, n_keys=150,
                            extra=20, victim=2)
    assert copied > 0


@pytest.mark.parametrize("n", [2, 3])
def test_ckpt_manager_replicated_restore_survives_rank_death(tmp_path, n):
    """The saving rank dies: the manifest's data is still restorable,
    served from the replica -- equal to the reference's restore."""
    def run(pkg, comm, d, kill):
        specs = {"w": ((2048,), np.float32), "b": ((3, 5), np.float32)}
        cm = pkg.ckpt(str(d), comm, specs, replication=2)
        rng = np.random.default_rng(0)
        tree = {k: rng.standard_normal(s).astype(np.float32)
                for k, (s, _) in specs.items()}
        cm.save(1, tree)
        tree["w"][7] += 1.0
        cm.save(2, tree)
        kill(comm, 0)
        r = cm.restore()
        assert r is not None and r.step == 2
        assert all((r.tree[k] == tree[k]).all() for k in tree)
        got = (r.step, {k: v.tobytes() for k, v in sorted(r.tree.items())})
        comm.mark_alive(0)
        cm.close()
        return got

    against_ref(tmp_path, run, n)


def test_detector_feeds_monitor_inproc():
    comm = Communicator(3)
    hb = HeartbeatMonitor(3)
    fd = FailureDetector(comm, hb)
    assert fd.poll(0) == []
    assert hb.dead() == []  # every rank beaten
    comm.mark_dead(2)
    assert fd.poll(1) == [2]
    assert hb.dead() == [2]
    comm.close()


# -- multiprocess: the acceptance path ----------------------------------------

def test_mp_probe_detects_sigkill():
    comm = Communicator(2, transport="mp")
    try:
        assert comm.probe(1) is True
        comm.transport.kill_rank(1)
        assert comm.probe(1) is False
        assert 1 in comm.dead_ranks  # probe marked it for failover routing
    finally:
        comm.close()


def test_mp_sigkill_failover_and_bitexact_rebuild(tmp_path):
    """REPRO_TRANSPORT=mp + storage_alloc_replication=2, one worker
    SIGKILLed mid-workload: probe and HeartbeatMonitor report the rank
    dead, DHT reads and writes keep succeeding with zero lost synced data,
    and the respawned worker rebuilds bit-exact -- with the reference's
    items, rebuild byte count and files."""
    copied, items = against_ref(tmp_path, _dht_failover, 4, transport="mp",
                                n_keys=120, extra=40, victim=1)
    assert copied > 0 and len(items) == 160


def test_mp_window_failover_zero_lost_synced_bytes(tmp_path):
    comm = Communicator(3, transport="mp")
    try:
        win = Window.allocate(comm, 16384, info=rep_info(tmp_path, k=2))
        synced = np.random.default_rng(1).integers(
            0, 255, 16384).astype(np.uint8)
        win.put(synced, 2, 0)
        win.sync(2)
        win.put(np.full(64, 200, np.uint8), 2, 0)  # un-synced overwrite
        comm.transport.kill_rank(2)
        # the un-synced page cache is lost (paper failure model); every
        # synced byte survives, served from the replica
        got = win.get(2, 0, 16384)
        assert (got == synced).all()
        win.free()
    finally:
        comm.close()


def test_replica_reads_spread_across_live_holders(tmp_path):
    """Reads of a synced replicated partition rotate across its live
    holders; an un-mirrored write pins reads to the acting holder until the
    next sync (read-your-writes), and a single live holder serves alone."""
    comm = Communicator(2)
    win = Window.allocate(comm, 8192, info=rep_info(tmp_path, k=2))
    try:
        win.put(np.full(64, 5, np.uint8), 0, 0)
        win.sync(0)  # mirrored: both holders now carry the bytes
        served = []
        orig = comm.transport.get

        def counting(seg, off, n):
            served.append(id(seg))
            return orig(seg, off, n)

        comm.transport.get = counting
        try:
            for _ in range(6):
                assert (win.get(0, 0, 64) == 5).all()
            assert len(set(served)) == 2  # both holders served traffic
            win.put(np.full(64, 6, np.uint8), 0, 0)
            served.clear()
            for _ in range(4):
                assert (win.get(0, 0, 64) == 6).all()
            assert len(set(served)) == 1
            win.sync(0)  # mirror the 6s, then lose the primary
            comm.mark_dead(0)
            served.clear()
            for _ in range(4):
                assert (win.get(0, 0, 64) == 6).all()
            assert len(set(served)) == 1  # only the replica is left
        finally:
            comm.transport.get = orig
        win.free()
    finally:
        comm.close()


def test_mp_notified_completion_failover_replay(tmp_path):
    """A posted (notified) train whose holder is SIGKILLed before the
    completion read is replayed on the next live replica at the flush
    boundary -- replay-never-skip for the aggregation hot path."""
    comm = Communicator(4, transport="mp")
    try:
        win = Window.allocate(comm, 8192, info=rep_info(tmp_path, k=2))
        data = np.full(64, 42, np.uint8)
        win.rput(data, 0, 0).wait()  # posted to rank 0 (local completion)
        comm.transport.kill_rank(0)
        win.flush(0)  # completion read fails -> mark dead -> replay on 1
        assert 0 in comm.dead_ranks
        assert (win.get(0, 0, 64) == data).all()  # replica serves them
        win.free()
    finally:
        comm.close()


def test_mp_mirror_and_rebuild_move_one_train_a_chunk(tmp_path):
    """Page-spread writes (one run a page) mirror as one train of gets
    off the acting holder and one posted train of puts to the replica, and
    the rebuild writes a chunk's differing runs as one train: round trips
    a chunk, not a run (the JAX package sends one get, post or put a run;
    bytes and files are the same, as the parity tests above hold)."""
    comm = Communicator(2, transport="mp")
    try:
        win = Window.allocate(comm, 64 * PAGE, info=rep_info(tmp_path))
        ops = []
        t = comm.transport
        call, post = t._call, t._post
        t._call = lambda r, m: (ops.append((r, m[0])), call(r, m))[1]
        t._post = lambda r, m: (ops.append((r, m[0])), post(r, m))[1]
        try:
            for p in range(1, 64, 6):  # 11 runs of one page
                win.put(np.full(8, p, np.uint8), 0, p * PAGE)
            ops.clear()
            win.sync(0)
            assert ops == [(0, "sync"), (0, "opbatch"), (1, "opbatch_nb"),
                           (1, "notify_read"), (1, "sync")]
            t.kill_rank(0)
            for p in range(2, 64, 6):  # onto the replica, rank 0 dead
                win.put(np.full(8, p, np.uint8), 0, p * PAGE)
            win.sync(0)
            ops.clear()
            assert comm.rebuild_rank(0) == 11 * PAGE
            to_rank0 = [op for r, op in ops if r == 0]
            assert to_rank0.count("opbatch") == 1 and "put" not in to_rank0
        finally:
            t._call, t._post = call, post
        win.free()
    finally:
        comm.close()
