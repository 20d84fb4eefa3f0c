"""SPMD training with mid-run rank death and exact resume.

The port of ``examples/spmd_train_resume.py``.  It drives the same path as
``python -m repro_torch.launch.train --spmd``: N worker ranks each run the
Trainer themselves on ``--device`` (their own device diffs, their own
window writes, their own checkpoint manifests) while this process is only
a launcher/monitor.  Two failures are exercised:

1. **Rank death**: one rank is SIGKILLed after its first checkpoint
   commits; ``rebuild_rank`` respawns it, and the respawn re-enters the
   application entry point, restores from its *own* manifest, and resumes
   from that step -- survivors never restart.
2. **Whole-job death**: a second launcher over the same checkpoint
   directory must resume every rank exactly at the last committed step.

The victim is held at a known step by a file gate, not by timing: once its
first checkpoint has committed it waits for a file that this process
creates only after the SIGKILL, so the respawn passes straight through.
Every rank draws the same data from the same seed, so the ranks must end
with the same final loss and the same newest checkpoint partition, bit for
bit.  Exits nonzero if any rank restarted from scratch or at another step,
if the ranks differ, or if the launcher issued any data-path operation.

    PYTHONPATH=src python -m repro_torch.launch.spmd_train_resume --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import filecmp
import json
import os
import shutil
import signal
import sys
import tempfile
import time

from ..configs import get_config
from .train import _spmd_entry

NRANKS = 2
VICTIM = 1
STEPS_1 = 6   # first job: killed partway, finishes after respawn
STEPS_2 = 10  # second job: must resume at step 6, not step 0
#: bound of every wait in the drill (a rank at its gate, the launcher for
#: a manifest, a death or the ranks' results)
WAIT_S = 600.0


def train_opts(steps: int, ckpt_dir: str, device: str = "cuda",
               **over) -> dict:
    """``launch.train``'s options for one job of the drill (the smoke
    internlm2-1.8b config unless ``over`` says otherwise)."""
    opts = {"arch": "internlm2-1.8b", "smoke": True, "steps": steps,
            "batch": 2, "seq": 32, "microbatches": 1, "lr": 3e-4,
            "ckpt_dir": ckpt_dir, "ckpt_every": 2, "mode": "fused",
            "compression": False, "probe_interval": 0.3, "device": device}
    opts.update(over)
    return opts


def _until(cond, what: str, timeout: float = WAIT_S) -> None:
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise TimeoutError(f"{what} within {timeout:.0f}s")
        time.sleep(0.02)


def drill_entry(comm, opts: dict, *, gate: str | None = None,
                victim: int = VICTIM, n_layers: int | None = None) -> dict:
    """``launch.train._spmd_entry`` for the drill.  With ``gate`` set, rank
    ``victim`` waits after the step that follows its first checkpoint,
    once that checkpoint's manifest has committed, until the file ``gate``
    exists.  ``n_layers`` cuts the config's depth (widths stay).  The
    summary adds the launches of each kernel module this rank imported."""
    cfg = None
    if n_layers is not None:
        cfg = dataclasses.replace(get_config(opts["arch"],
                                             smoke=opts["smoke"]),
                                  n_layers=n_layers)

    def hold(trainer, step, rec):
        if gate is None or comm.rank != victim or step != opts["ckpt_every"]:
            return
        trainer.ckpt.wait()  # the first save's manifest is committed
        _until(lambda: os.path.exists(gate), f"rank {victim}: gate {gate}")

    summary = _spmd_entry(comm, opts, cfg=cfg, on_step=hold)
    summary["kernel_launches"] = {
        name.rsplit(".", 1)[1]: mod.launches
        for name, mod in sorted(sys.modules.items())
        if name.startswith("repro_torch.kernels.")
        and hasattr(mod, "launches")}
    return summary


def _manifest(directory: str, rank: int) -> str:
    name = "manifest.json" if rank == 0 else f"manifest.r{rank}.json"
    return os.path.join(directory, name)


def _same_ranks(results: list[dict], directory: str, job: str) -> None:
    """Every rank ends with rank 0's final loss and newest checkpoint
    partition: its step and bytes.  Not its target: a respawned rank's
    manager saves to A first, as a fresh one does, so the victim's saves
    alternate out of step with the survivors'."""
    ref = results[0]
    with open(_manifest(directory, 0)) as f:
        m0 = json.load(f)
    for res in results[1:]:
        r = res["rank"]
        if res["final_loss"] != ref["final_loss"]:
            raise RuntimeError(f"{job}: rank {r}'s final loss "
                               f"{res['final_loss']!r} differs from rank "
                               f"0's {ref['final_loss']!r}")
        with open(_manifest(directory, r)) as f:
            m = json.load(f)
        if m["step"] != m0["step"]:
            raise RuntimeError(f"{job}: rank {r}'s newest checkpoint is "
                               f"step {m['step']}, rank 0's {m0['step']}")
        a = os.path.join(directory, f"ckpt_{m0['target']}.bin.0")
        b = os.path.join(directory, f"ckpt_{m['target']}.bin.{r}")
        if not filecmp.cmp(a, b, shallow=False):
            raise RuntimeError(f"{job}: {b} differs from {a}")


def run(opts1: dict, opts2: dict, *, nranks: int = NRANKS,
        victim: int = VICTIM, n_layers: int | None = None, log=print,
        on_spawn=lambda rank, pid: None) -> dict:
    """Both jobs of the drill over ``opts1["ckpt_dir"]`` (job 1 with
    ``opts1``, job 2 with ``opts2``).  ``on_spawn(rank, pid)`` is called for
    each rank process started (the respawn too).  Returns each job's
    per-rank summaries, the respawn's seconds and the launchers' data
    operations; raises on any failed check."""
    from ..core.transport.spmd import SpmdLauncher
    d = opts1["ckpt_dir"]
    first = opts1["ckpt_every"]
    gate = os.path.join(d, f"gate.r{victim}")
    out = {}

    # -- job 1: kill one rank after its first checkpoint, respawn -------------
    start = time.monotonic()
    launcher = SpmdLauncher(nranks, drill_entry, (opts1,),
                            {"gate": gate, "victim": victim,
                             "n_layers": n_layers})
    try:
        out["spawn_s"] = time.monotonic() - start
        for r in range(nranks):
            on_spawn(r, launcher._procs[r].pid)
        _until(lambda: os.path.exists(_manifest(d, victim)),
               f"rank {victim} committed no checkpoint")
        os.kill(launcher._procs[victim].pid, signal.SIGKILL)
        _until(lambda: not launcher.probe(victim),
               f"rank {victim} still probes live after SIGKILL")
        log(f"killed rank {victim} after its first checkpoint")
        open(gate, "w").close()
        t0 = time.monotonic()
        launcher.rebuild_rank(victim)
        out["respawn_s"] = time.monotonic() - t0
        on_spawn(victim, launcher._procs[victim].pid)
        results = sorted(launcher.wait(timeout=WAIT_S),
                         key=lambda res: res["rank"])
        out["job1_s"] = time.monotonic() - start
        out["job1"] = results
        out["job1_data_ops"] = launcher.data_ops()
    finally:
        launcher.shutdown()
    resumed = results[victim]["resumed_from"]
    if resumed != first:
        raise RuntimeError(f"the respawned rank resumed from {resumed}, not "
                           f"from its first checkpoint at step {first}: "
                           f"{results[victim]}")
    for res in results:
        if res["rank"] != victim and res["resumed_from"] is not None:
            raise RuntimeError(f"survivor rank {res['rank']} restarted: "
                               f"{res}")
    if out["job1_data_ops"]:
        raise RuntimeError("the launcher issued data-path ops")
    _same_ranks(results, d, "job 1")
    log(f"rank {victim} resumed from step {resumed} after SIGKILL")

    # -- job 2: whole-job restart resumes every rank exactly ------------------
    t0 = time.monotonic()
    launcher = SpmdLauncher(nranks, drill_entry, (opts2,),
                            {"n_layers": n_layers})
    try:
        for r in range(nranks):
            on_spawn(r, launcher._procs[r].pid)
        results = sorted(launcher.wait(timeout=WAIT_S),
                         key=lambda res: res["rank"])
        out["job2_s"] = time.monotonic() - t0
        out["job2"] = results
        out["job2_data_ops"] = launcher.data_ops()
    finally:
        launcher.shutdown()
    for res in results:
        if res["resumed_from"] != opts1["steps"]:
            raise RuntimeError(f"rank {res['rank']} resumed at "
                               f"{res['resumed_from']}, expected "
                               f"{opts1['steps']}")
    if out["job2_data_ops"]:
        raise RuntimeError("the launcher issued data-path ops")
    _same_ranks(results, d, "job 2")
    log(f"whole-job restart: all {nranks} ranks resumed exactly at step "
        f"{opts1['steps']}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="where every rank's Trainer allocates (default "
                         "cuda)")
    args = ap.parse_args(argv)
    d = tempfile.mkdtemp(prefix="repro_torch_spmd_resume_")
    try:
        run(train_opts(STEPS_1, d, args.device),
            train_opts(STEPS_2, d, args.device),
            log=lambda m: print(m, flush=True))
    finally:
        shutil.rmtree(d, ignore_errors=True)
    print("spmd_train_resume: PASS", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
