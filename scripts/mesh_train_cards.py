"""Train on a mesh of four cards with the sequence split over "model",
beside one card's plain run of the same model and batches.

One process a card under ``torch.distributed.run`` (NCCL, every rank on
one host).  ``RUNS``: internlm2-1.8b and whisper-base under multi-pod
``train_rules(tp=False)`` on a (1, 1, 4) ``("pod", "data", "model")``
mesh (token parallelism: each rank computes its quarter of every
sequence, the keys and values gathered over the positions), and
internlm2-1.8b under ``train_rules(seq_shard=True)`` on a (1, 4)
``("data", "model")`` mesh (tensor parallelism with the residual stream
split along its positions between the regions).  Each at its published
widths, each layer loop cut to 2 repeats, in float32, random parameters
from seed 0 (``init_params``), ``BATCH`` sequences of ``SEQ`` positions a
step from ``SyntheticLM``, ``STEPS`` fused steps of ``Trainer``; then
each rank trains the same model on the same batches plainly on its own
card.  Rank 0 prints one JSON line a run: the largest relative
difference of a step's loss from the plain run's over every rank, each
rank's peak device bytes (``max_memory_allocated``, reset before each
run) and median step ms (the trainer's step time, host clock after the
loss is read), for the mesh and the plain run.  Exit 1 if a difference
reaches 1e-5.

    python -m torch.distributed.run --nproc-per-node 4 \\
        scripts/mesh_train_cards.py
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")  # every rank on one host

# (arch, mesh shape, mesh axes, train_rules keywords)
RUNS = (
    ("internlm2-1.8b", (1, 1, 4), ("pod", "data", "model"), {"tp": False}),
    ("whisper-base", (1, 1, 4), ("pod", "data", "model"), {"tp": False}),
    ("internlm2-1.8b", (1, 4), ("data", "model"), {"seq_shard": True}),
)
LAYERS, BATCH, SEQ, STEPS, LIMIT = 2, 2, 4096, 3, 1e-5


def config(arch: str, smoke: bool = False):
    """``arch`` at its published widths (the reduced ones with ``smoke``),
    each layer loop at ``LAYERS`` repeats, float32."""
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    cfg = get_config(arch, smoke=smoke)
    cfg = dryrun.at_depth(cfg, {k: min(n, LAYERS) for k, n in
                                dryrun.depth_loops(cfg).items()})
    return dataclasses.replace(cfg, dtype="float32", param_dtype="float32")


def train(cfg, device, *, batch: int, seq: int, mesh=None,
          rules=None) -> dict:
    """``STEPS`` fused steps from seed 0's parameters and ``SyntheticLM``'s
    batches (on ``mesh`` under ``rules``, or plainly): the losses, the
    step times and the peak device bytes (on a card)."""
    import torch

    from repro_torch.data import SyntheticLM, make_batch_iter
    from repro_torch.runtime.sharding import use_rules
    from repro_torch.train import AdamWConfig, TrainConfig, Trainer

    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    tr = Trainer(cfg, AdamWConfig(warmup_steps=1, total_steps=STEPS),
                 TrainConfig(steps=STEPS, log_every=0), device=device,
                 mesh=mesh, rules=rules)
    ds = SyntheticLM(cfg, batch=batch, seq=seq)
    if mesh is None:
        tr.run(make_batch_iter(ds))
    else:
        with use_rules(rules, mesh):
            tr.run(make_batch_iter(ds))
    out = {"losses": [m["loss"] for m in tr.metrics_log],
           "step_ms": [m["time"] * 1e3 for m in tr.metrics_log]}
    if device.type == "cuda":
        out["peak_device_bytes"] = torch.cuda.max_memory_allocated(device)
    tr.close()
    return out


def run(device, *, smoke: bool = False, batch: int = BATCH,
        seq: int = SEQ) -> list[dict]:
    """Every run of ``RUNS`` on this process's rank of the default process
    group, then the plain run; returns rank 0's records (the others
    return ``[]``)."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.runtime.sharding import (mesh_shape, sharding_report,
                                              train_rules)

    records = []
    for arch, shape, axes, kw in RUNS:
        cfg = config(arch, smoke)
        mesh = make_mesh(shape, axes, device=device.type)
        rules = train_rules(len(axes) == 3, **kw)
        ruled = train(cfg, device, batch=batch, seq=seq, mesh=mesh,
                      rules=rules)
        plain = train(cfg, device, batch=batch, seq=seq)
        err = max(abs(a - b) / abs(b) for a, b in zip(ruled["losses"],
                                                      plain["losses"]))
        mine = {"max_rel_err": err,
                "mesh_step_ms": statistics.median(ruled["step_ms"][1:]),
                "plain_step_ms": statistics.median(plain["step_ms"][1:]),
                "mesh_peak_device_bytes": ruled.get("peak_device_bytes"),
                "plain_peak_device_bytes": plain.get("peak_device_bytes")}
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, mine)
        rec = {"arch": cfg.name, "n_layers": cfg.n_layers,
               "mesh": mesh_shape(mesh), "rules": rules.name, **kw,
               "batch": batch, "seq": seq, "steps": STEPS,
               "losses": ruled["losses"], "plain_losses": plain["losses"],
               "max_rel_err": max(m["max_rel_err"] for m in every),
               "per_rank": {k: [m[k] for m in every] for k in mine
                            if k != "max_rel_err"},
               "sharding_report": dict(sharding_report()),
               "device": (torch.cuda.get_device_name(device)
                          if device.type == "cuda" else "cpu")}
        if dist.get_rank() == 0:
            records.append(rec)
            print(json.dumps(rec), flush=True)
    return records


def main() -> int:
    import torch
    import torch.distributed as dist

    if not torch.cuda.is_available():
        print("mesh_train_cards: CUDA is not available", file=sys.stderr)
        return 2
    dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl")
    try:
        records = run(dev)
        worst = torch.tensor(max([r["max_rel_err"] for r in records]
                                 or [0.0]), device=dev)
        dist.all_reduce(worst, op=dist.ReduceOp.MAX)
    finally:
        dist.destroy_process_group()
    return 0 if float(worst) < LIMIT else 1


if __name__ == "__main__":
    sys.exit(main())
