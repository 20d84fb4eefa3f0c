"""The port's SPMD origin conformance (the rank-symmetric contract).

The port of ``tests/test_spmd.py``.  Three guarantees, each load-bearing
for the multi-origin layer:

* **Parity**: the same checkpoint workload run driver-origin (inproc,
  rank-0 identity) and SPMD (every rank its own origin) leaves
  byte-identical rank-0 window files and an identical ``manifest.json``
  -- the port's driver-origin run's and the JAX package's -- and the SPMD
  ranks' extra partitions restore under *driver-style* rank-local
  communicators, so a crashed SPMD job recovers under either bootstrap.
* **Accounting**: under SPMD each rank issues its own data-path operations
  while the launcher issues zero.
* **Resilience**: SIGKILL one SPMD rank mid-run; ``rebuild_rank``
  re-enters the application function on the respawn, which restores from
  its own manifest and resumes exactly.  The victim is held after its
  first commit by a file gate that the test creates only after the kill
  (the reference's test sleeps between saves instead, and is flaky under
  load); every wait of the launcher and of the gate is bounded.

Workload functions are module-level so the spawn start method can pickle
them by reference.
"""

from __future__ import annotations

import os
import signal
import time

import numpy as np
import pytest

import repro.core as jcore
from repro_torch.core import Communicator

_N = 3
_STEPS = (1, 2, 3)
_SPECS = {"w": ((64,), np.float32), "b": ((8,), np.float32)}
_WAIT_S = 120.0


def _tree(rank: int, step: int) -> dict[str, np.ndarray]:
    """Deterministic per-(rank, step) state: parity must come from the
    machinery, not from luck with rng seeding."""
    return {"w": np.arange(64, dtype=np.float32) + 100.0 * rank + step,
            "b": np.full(8, 10.0 * rank + step, np.float32)}


def _parity_workload(comm, directory: str, manager=None) -> dict:
    if manager is None:
        from repro_torch.ckpt import CheckpointManager as manager
    mgr = manager(directory, comm, _SPECS)
    for step in _STEPS:
        mgr.save(step, _tree(comm.rank, step))
    mgr.close()
    snap = getattr(comm.transport, "stats_snapshot", None)
    return {"rank": comm.rank, "stats": snap() if snap else None}


def _until(cond, what: str, timeout: float = _WAIT_S) -> None:
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, f"{what} within {timeout}s"
        time.sleep(0.02)


def _resume_workload(comm, directory: str, gate: str, victim: int,
                     steps: int = 8) -> dict:
    """Saves steps from the restored one on; rank ``victim`` waits after
    its first committed save until ``gate`` exists."""
    from repro_torch.ckpt import CheckpointManager
    mgr = CheckpointManager(directory, comm, _SPECS)
    res = mgr.restore()
    start = res.step if res is not None else 0
    for step in range(start + 1, steps + 1):
        mgr.save(step, _tree(comm.rank, step))
        if comm.rank == victim:
            _until(lambda: os.path.exists(gate), f"gate {gate}")
    mgr.close()
    return {"rank": comm.rank, "resumed_from": start}


def _run_spmd(workload, *args):
    from repro_torch.core.transport.spmd import SpmdLauncher
    launcher = SpmdLauncher(_N, workload, args)
    try:
        results = launcher.wait(timeout=_WAIT_S)
        return launcher, sorted(results, key=lambda r: r["rank"])
    finally:
        launcher.shutdown()


@pytest.fixture(autouse=True)
def _bounded_waits(monkeypatch):
    monkeypatch.setenv("REPRO_MP_TIMEOUT", "60")


@pytest.fixture(scope="module")
def spmd_parity(tmp_path_factory):
    """One SPMD parity run shared by the parity + accounting tests."""
    d = str(tmp_path_factory.mktemp("spmd"))
    launcher, results = _run_spmd(_parity_workload, d)
    return d, launcher, results


def test_parity_with_driver_origin(spmd_parity, tmp_path):
    from repro.ckpt import CheckpointManager as JManager
    d_spmd, _, _ = spmd_parity
    runs = {}
    for name, comm, manager in (
            ("port", Communicator(_N, transport="inproc"), None),
            ("ref", jcore.Communicator(_N), JManager)):
        runs[name] = str(tmp_path / name)
        _parity_workload(comm, runs[name], manager)
        comm.close()

    # rank 0's window files and the committed manifests (step, target,
    # layout, crc, nranks -- nothing in them may depend on who issued the
    # ops): byte-identical across origin modes and packages
    for name in ("ckpt_a.bin.0", "ckpt_b.bin.0", "manifest.json",
                 "manifest.prev.json"):
        want = open(os.path.join(d_spmd, name), "rb").read()
        for run, d in runs.items():
            got = open(os.path.join(d, name), "rb").read()
            assert got == want, f"{name} differs between SPMD and {run}"
    # SPMD ranks > 0 commit their own manifests beside rank 0's
    for r in range(1, _N):
        assert os.path.exists(os.path.join(d_spmd, f"manifest.r{r}.json"))


def test_spmd_partitions_restore_under_driver_mode(spmd_parity):
    """Cross-mode recovery: every SPMD rank's checkpoint restores under a
    driver-style rank-local communicator reading the same directory."""
    from repro_torch.ckpt import CheckpointManager
    d_spmd, _, _ = spmd_parity
    last = _STEPS[-1]
    for r in range(_N):
        comm = Communicator(_N, rank=r,
                            transport="inproc" if r == 0 else "ranklocal")
        mgr = CheckpointManager(d_spmd, comm, _SPECS)
        res = mgr.restore()
        assert res is not None and res.step == last
        want = _tree(r, last)
        for k in _SPECS:
            np.testing.assert_array_equal(np.asarray(res.tree[k]), want[k])
        mgr.close()
        comm.close()


def test_per_rank_accounting(spmd_parity):
    """Each rank is a real origin: its own data-path ops, its own window
    partition -- and the launcher issued zero data-path operations."""
    _, launcher, results = spmd_parity
    assert [r["rank"] for r in results] == list(range(_N))
    for r in results:
        stats = r["stats"]
        assert stats is not None
        # every rank allocated and wrote its own partition locally
        assert stats["local"]["alloc"] > 0
        assert stats["local"]["put"] > 0
        # and took part in the collective rounds (alloc gather, barriers)
        assert stats["rounds"] > 0
        assert set(stats["wire"]) == set(
            jcore.Communicator(1).transport.wire_stats_snapshot())
    assert launcher.data_ops() == 0
    assert set(launcher.op_counts) <= {"ping", "shutdown"}


def test_kill_one_rank_resumes_exactly(tmp_path):
    from repro_torch.core.transport.spmd import SpmdLauncher
    d = str(tmp_path / "resume")
    os.makedirs(d)
    victim = 1
    gate = str(tmp_path / "gate")
    launcher = SpmdLauncher(_N, _resume_workload, (d, gate, victim))
    try:
        # the victim commits its first manifest, then waits at the gate
        _until(lambda: os.path.exists(
            os.path.join(d, f"manifest.r{victim}.json")),
            "victim never checkpointed")
        os.kill(launcher._procs[victim].pid, signal.SIGKILL)
        _until(lambda: not launcher.probe(victim),
               "victim still probes live")
        open(gate, "w").close()
        launcher.rebuild_rank(victim)
        results = sorted(launcher.wait(timeout=_WAIT_S),
                         key=lambda r: r["rank"])
        # the respawn re-entered the application, restored its own
        # manifest, and resumed from exactly its first commit
        assert results[victim]["resumed_from"] == 1
        for r in range(_N):
            if r != victim:
                assert results[r]["resumed_from"] == 0
        assert launcher.data_ops() == 0
        assert launcher.respawns[victim] == 1
    finally:
        launcher.shutdown()
    # every rank ends at the last step, the victim's partition included
    from repro_torch.ckpt import CheckpointManager
    for r in range(_N):
        comm = Communicator(_N, rank=r,
                            transport="inproc" if r == 0 else "ranklocal")
        mgr = CheckpointManager(d, comm, _SPECS)
        res = mgr.restore()
        assert res.step == 8
        np.testing.assert_array_equal(np.asarray(res.tree["w"]),
                                      _tree(r, 8)["w"])
        mgr.close()
        comm.close()


def test_stale_channel_keeps_the_respawned_rank_attached():
    """The coordinator reads a dead rank's end of file late, after
    ``rebuild_rank`` attached the respawn's channel (a loaded host): the
    new channel must stay, and the respawned rank's next round must
    complete.  The dropped channel is closed by the coordinator's own
    loop, never while the loop may still read it (its fd would go to the
    new channel)."""
    import multiprocessing as mp
    from repro_torch.core.transport.multiproc import _recv, _send
    from repro_torch.core.transport.spmd import _Coordinator
    coord = _Coordinator(2)
    ranks = {0: mp.Pipe(duplex=True)}
    coord.attach(0, ranks[0][0])
    old, old_child = mp.Pipe(duplex=True)
    coord.attach(1, old)
    coord.mark_dead(1)                      # rebuild_rank drops it ...
    assert not old.closed
    ranks[1] = mp.Pipe(duplex=True)
    coord.attach(1, ranks[1][0])            # ... and attaches the respawn
    old_child.close()
    coord._on_eof(1, old)                   # the stale end of file, late
    assert coord._conns[1] is ranks[1][0] and 1 not in coord._excluded
    coord.start()
    try:
        for r, (_, child) in ranks.items():
            _send(child, ("round", r, (0, 1), 0, f"from {r}"))
        for r, (_, child) in ranks.items():
            assert child.poll(_WAIT_S), f"rank {r} got no reply"
            assert _recv(child) == ("ok", {0: "from 0", 1: "from 1"})
        assert old.closed
    finally:
        coord.stop()
