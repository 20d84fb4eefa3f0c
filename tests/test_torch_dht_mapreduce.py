"""The port's DHT and MapReduce against the JAX package's, byte for byte.

The paper's two applications (§3.3/§3.4 and §3.5.2) run through
``repro_torch.core`` on its ``inproc`` and ``mp`` transports and through
``repro.core`` on its in-process transport, with the same keys and tasks
made from a seed.  Memory, storage, combined and out-of-core windows;
restart from the storage files, across packages too.  What must match is
exact: ``items()`` in table order (so placement, CAS chaining and the heap
counter agree), lookups, checkpoint counts, every local volume's bytes and
the window files.
"""

from pathlib import Path

import numpy as np
import pytest

import repro.core as jcore
import repro.core.mapreduce as jmr
import repro_torch.core as tcore
import repro_torch.core.mapreduce as tmr

_WORLDS: dict = {}


@pytest.fixture(scope="module", autouse=True)
def _worlds():
    mp = pytest.MonkeyPatch()
    mp.setenv("REPRO_MP_TIMEOUT", "60")
    yield
    for comm in _WORLDS.values():
        comm.close()
    _WORLDS.clear()
    mp.undo()


def world(kind: str, size: int):
    """One communicator per (backend, size) for the module: mp worlds are
    spawned once."""
    if (kind, size) not in _WORLDS:
        _WORLDS[kind, size] = tcore.Communicator(size, transport=kind)
    return _WORLDS[kind, size]


KINDS = ["inproc", "mp"]


def storage_info(d: Path, name: str, **extra):
    return {"alloc_type": "storage", "storage_alloc_filename": str(d / name),
            **extra}


def _files(d: Path) -> dict:
    return {p.name: p.read_bytes() for p in sorted(d.iterdir())}


WINDOWS = {
    "memory": (lambda d: None, None),
    "storage": (lambda d: storage_info(d, "s.bin"), None),
    "combined": (lambda d: storage_info(d, "c.bin",
                                        storage_alloc_factor="0.5"), None),
    # §3.4: a memory budget far below the table (1/8 of a local volume)
    "out_of_core": (lambda d: storage_info(d, "o.bin",
                                           storage_alloc_factor="auto"),
                    64 * 24 // 8),
}


def _dht_run(core, comm, d: Path, window: str):
    make_info, budget = WINDOWS[window]
    dht = core.DistributedHashTable(comm, 64, info=make_info(d),
                                    memory_budget=budget)
    rng = np.random.default_rng(2)
    for k in rng.integers(1, 1000, 300):
        dht.insert(int(k), 1, op="sum")
    dht.insert(424242, 5)
    dht.insert(424242, 9)  # replace
    out = {"items": dht.items(),
           "lookups": [dht.lookup(int(k)) for k in range(0, 1000, 37)],
           "missing": dht.lookup(10 ** 9),
           "heap": [dht.heap_used(r) for r in range(comm.size)],
           "conflicts": dht.insert_conflicts,
           "volumes": [dht.win.get(r, 0, dht.segment_bytes).tobytes()
                       for r in range(comm.size)]}
    out["flushed"] = dht.sync()
    dht.free()
    out["files"] = _files(d)
    return out


@pytest.mark.parametrize("window", sorted(WINDOWS))
@pytest.mark.parametrize("kind", KINDS)
def test_dht_matches_reference(tmp_path, kind, window):
    (tmp_path / "ref").mkdir()
    (tmp_path / "run").mkdir()
    ref_comm = jcore.Communicator(4)
    want = _dht_run(jcore, ref_comm, tmp_path / "ref", window)
    ref_comm.close()
    got = _dht_run(tcore, world(kind, 4), tmp_path / "run", window)
    assert got == want
    counts = {}
    for k in np.random.default_rng(2).integers(1, 1000, 300):
        counts[int(k)] = counts.get(int(k), 0) + 1
    counts[424242] = 9
    assert dict(got["items"]) == counts
    assert got["heap"] != [0, 0, 0, 0]  # chains were built
    assert (len(got["files"]) == 4) == (window != "memory")


@pytest.mark.parametrize("kind", KINDS)
def test_dht_resume_across_packages(tmp_path, kind):
    """A table synced by the port reopens (``resume=True``) under the JAX
    package with the same items, and the other way round."""
    info = storage_info(tmp_path, "r.bin")
    rng = np.random.default_rng(5)
    keys = [int(k) for k in rng.integers(1, 1 << 40, 150)]
    dht = tcore.DistributedHashTable(world(kind, 4), 32, info=info)
    for k in keys:
        dht.insert(k, 3, op="sum")
    items = dht.items()
    dht.sync()
    dht.free()
    ref_comm = jcore.Communicator(4)
    back = jcore.DistributedHashTable(ref_comm, 32, info=info, resume=True)
    assert back.items() == items
    back.insert(keys[0], 1, op="sum")
    items2 = back.items()
    back.sync()
    back.free()
    ref_comm.close()
    again = tcore.DistributedHashTable(world(kind, 4), 32, info=info,
                                       resume=True)
    assert again.items() == items2
    again.free()


def test_dht_errors_match_reference():
    for core in (jcore, tcore):
        with pytest.raises(ValueError, match="lv_entries"):
            core.DistributedHashTable(core.Communicator(1), 0)
        dht = core.DistributedHashTable(core.Communicator(1), 1,
                                        heap_factor=1)
        with pytest.raises(ValueError, match="sentinel"):
            dht.insert(-(2 ** 62), 1)
        dht.insert(1, 1)
        dht.insert(2, 1)  # one heap entry: the chain is full
        with pytest.raises(RuntimeError, match="heap exhausted"):
            dht.insert(3, 1)
        dht.free()


def test_word_keys_match_reference():
    rng = np.random.default_rng(0)
    words = ["the", "The", "cat's", "x", "naïve", "42"] + [
        "".join(rng.choice(list("abcdefghij"), 6)) for _ in range(50)]
    assert [tmr.stable_word_key(w) for w in words] \
        == [jmr.stable_word_key(w) for w in words]
    text = " ".join(words) + " the cat and the hat"
    assert tmr.wordcount_map(text) == jmr.wordcount_map(text)
    parts = [tmr.wordcount_map(" ".join(rng.choice(words, 40)))
             for _ in range(5)]
    assert tmr.wordcount_reduce(parts) == jmr.wordcount_reduce(parts)


def _tasks(seed: int, n: int, words: int = 60):
    rng = np.random.default_rng(seed)
    vocab = "alpha beta gamma delta epsilon zeta eta theta".split()
    return [" ".join(rng.choice(vocab, words)) for _ in range(n)]


def _mr_run(core, comm, d: Path, *, checkpoint: bool):
    tasks = _tasks(3, 9)
    mr = core.MapReduce1S(comm, 128, info=storage_info(d, "mr.bin"),
                          checkpoint=checkpoint)
    mr.run(tasks)
    out = (mr.result(), mr.completed_tasks(), mr.ckpt_count)
    mr.free()
    return out, _files(d)


@pytest.mark.parametrize("checkpoint", [True, False], ids=["ckpt", "noft"])
@pytest.mark.parametrize("kind", KINDS)
def test_mapreduce_matches_reference(tmp_path, kind, checkpoint):
    (tmp_path / "ref").mkdir()
    (tmp_path / "run").mkdir()
    ref_comm = jcore.Communicator(3)
    want = _mr_run(jcore, ref_comm, tmp_path / "ref", checkpoint=checkpoint)
    ref_comm.close()
    got = _mr_run(tcore, world(kind, 3), tmp_path / "run",
                  checkpoint=checkpoint)
    assert got == want
    (result, done, ckpts), files = got
    assert result == tmr.wordcount_reduce(
        tmr.wordcount_map(t) for t in _tasks(3, 9))
    assert done == 9 and ckpts == (9 if checkpoint else 0)
    assert len(files) == 6  # table and progress, one file per rank each


def _mr_restart(core, comm, d: Path):
    """Rank 0 commits its first 3 tasks, then the job 'crashes' and a new
    MapReduce1S over the same files resumes and finishes."""
    tasks = [f"w{i} common common" for i in range(12)]
    info = storage_info(d, "r.bin")
    mr = core.MapReduce1S(comm, 128, info=info)
    my0 = mr._tasks_of(0, len(tasks))
    for pos in range(3):
        for k, v in core.wordcount_map(tasks[my0[pos]]).items():
            mr.table.insert(k, v, op="sum")
        mr._commit_task(0, pos)
    mr._drain_ckpt()
    done_before = mr.completed_tasks()
    mr.free()
    mr2 = core.MapReduce1S(comm, 128, info=info, resume=True)
    resumed_at = mr2.completed_tasks()
    mr2.run(tasks)
    # not ckpt_bytes: the overlapped flushes race the next task's inserts,
    # so how the bytes split between checkpoints depends on timing
    out = (done_before, resumed_at, mr2.result(), mr2.ckpt_count)
    mr2.free()
    return out, _files(d)


@pytest.mark.parametrize("kind", KINDS)
def test_mapreduce_restart_resumes(tmp_path, kind):
    (tmp_path / "ref").mkdir()
    (tmp_path / "run").mkdir()
    ref_comm = jcore.Communicator(2)
    want = _mr_restart(jcore, ref_comm, tmp_path / "ref")
    ref_comm.close()
    got = _mr_restart(tcore, world(kind, 2), tmp_path / "run")
    assert got == want
    (before, resumed, result, ckpts), _ = got
    assert before == resumed == 3 and ckpts == 12 - 3
    assert result == tmr.wordcount_reduce(
        tmr.wordcount_map(f"w{i} common common") for i in range(12))


@pytest.mark.parametrize("kind", KINDS)
def test_mapreduce_checkpoint_is_incremental(tmp_path, kind):
    """Selective sync: per-task checkpoint bytes << full table size."""
    mr = tcore.MapReduce1S(world(kind, 2), 1 << 12,
                           info=storage_info(tmp_path, "i.bin"))
    mr.run(["tiny task"] * 6)
    assert 0 < mr.ckpt_bytes < 2 * mr.table.segment_bytes * 2
    mr.free()
