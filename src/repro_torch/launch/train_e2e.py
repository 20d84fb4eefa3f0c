"""End-to-end training run: an LM with windowed checkpoints, kill, restart.

The port of ``examples/train_e2e.py``: synthetic data pipeline -> train
step -> AdamW -> transparent A/B checkpointing into storage windows ->
kill -> restart -> bit-exact continuation, on ``--device`` (the card
unless ``--device cpu``).  With ``--kill-at N`` the restarted run repeats
the steps from the last checkpoint to N, and their losses are compared bit
for bit with the first run's: printed, and a difference, or no step to
compare, exits with code 1.  The comparison needs a fresh checkpoint
directory: by default each run makes its own under ``$TMPDIR`` and
removes it at the end, and a ``--ckpt-dir`` that already holds a manifest
is refused with ``--kill-at``.  The run uses deterministic algorithms
(``CUBLAS_WORKSPACE_CONFIG`` is set before CUDA starts), without which the
card's backward passes accumulate with atomics and a repeated step can
differ in its last bits.

    PYTHONPATH=src python -m repro_torch.launch.train_e2e --device cpu \\
        --steps 20 --ckpt-every 5 --kill-at 12
    PYTHONPATH=src python -m repro_torch.launch.train_e2e --params 100m \\
        --steps 300
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import shutil
import sys
import tempfile

import numpy as np
import torch

from ..configs import get_config
from ..data import SyntheticLM
from ..models import param_specs
from ..models.config import ModelConfig
from ..train import AdamWConfig, TrainConfig, Trainer


def model_100m() -> ModelConfig:
    """~100M-parameter dense LM (internlm2-style blocks)."""
    return dataclasses.replace(
        get_config("internlm2-1.8b"),
        name="dense-100m", n_layers=10, d_model=640, n_heads=10,
        n_kv_heads=2, head_dim=64, d_ff=2560, vocab=32000, remat="none")


def model_tiny() -> ModelConfig:
    return get_config("internlm2-1.8b", smoke=True)


class _Stream:
    """The dataset's batches from step ``start`` on."""

    def __init__(self, ds: SyntheticLM, start: int = 0):
        self.ds = ds
        self.step = start

    def __next__(self):
        b = self.ds.batch_at(self.step)
        self.step += 1
        return b


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--params", choices=("tiny", "100m"), default="tiny")
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: a new one under "
                         "$TMPDIR, removed at the end)")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--kill-at", type=int, default=0,
                    help="simulate a crash after N steps, then restart")
    ap.add_argument("--mode", choices=("fused", "offload"), default="fused")
    ap.add_argument("--compression", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.kill_at and args.kill_at % args.ckpt_every == 0:
        print("--kill-at at a checkpoint step repeats no step after the "
              "restart: pick one between checkpoints", file=sys.stderr)
        return 2
    if args.ckpt_dir is None:
        args.ckpt_dir = tempfile.mkdtemp(prefix="repro_torch_train_e2e_")
        made = True
    elif args.kill_at and os.path.exists(os.path.join(args.ckpt_dir,
                                                      "manifest.json")):
        print(f"{args.ckpt_dir} holds a checkpoint: --kill-at needs a fresh "
              "directory", file=sys.stderr)
        return 2
    else:
        made = False
    # exact repeats on the card; cuBLAS reads this when it makes its
    # handle, at the first matrix product
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        return _train(args)
    finally:
        torch.use_deterministic_algorithms(deterministic)
        if made:
            shutil.rmtree(args.ckpt_dir, ignore_errors=True)


def _train(args) -> int:
    cfg = model_100m() if args.params == "100m" else model_tiny()
    n_params = sum(int(np.prod(s.shape)) for s in param_specs(cfg).values())
    print(f"model {cfg.name}: {n_params / 1e6:.1f}M params")

    opt = AdamWConfig(lr=3e-4, warmup_steps=20, total_steps=args.steps)
    tc = TrainConfig(steps=args.steps, microbatches=1, mode=args.mode,
                     ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                     ckpt_async=True, compression=args.compression,
                     log_every=5)
    ds = SyntheticLM(cfg, batch=args.batch, seq=args.seq, microbatches=1)

    if not args.kill_at:
        tr = Trainer(cfg, opt, tc, device=args.device)
        tr.run(_Stream(ds))
        losses = [m["loss"] for m in tr.metrics_log]
        print(f"loss: {losses[0]:.3f} -> {losses[-1]:.3f}")
        tr.close()
        return 0
    print(f"-- phase 1: training to step {args.kill_at}, then 'crash' --")
    tr = Trainer(cfg, opt, tc, device=args.device)
    tr.run(_Stream(ds), stop_after=args.kill_at)
    tr.close()
    print("-- crash! restarting from the window checkpoint --")
    tr2 = Trainer(cfg, opt, tc, device=args.device)
    start = (args.kill_at // args.ckpt_every) * args.ckpt_every
    tr2.run(_Stream(ds, start))
    print(f"resumed at step {start}, finished at {args.steps}")
    first = {m["step"]: m["loss"] for m in tr.metrics_log}
    again = [(m["step"], m["loss"]) for m in tr2.metrics_log
             if m["step"] in first]
    tr2.close()
    if not again:
        print("no step of phase 1 was repeated after the restart: nothing "
              "compared")
        return 1
    same = all(loss == first[s] for s, loss in again)
    print(f"steps {start}-{args.kill_at - 1} after the restart: losses "
          f"{'bit-identical' if same else 'DIFFER from'} phase 1's")
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
