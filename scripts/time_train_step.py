"""Time the training step of ``chip_smoke.py``'s phases 6, 6b and 6c on one
card: the mean loss and gradients over the microbatches
(``Trainer.loss_and_grads``), then the global norm and AdamW, at each
phase's config (full widths, its depth cut), batch and sequence, under
deterministic algorithms as the phases run.  ``--src`` picks the tree whose
``repro_torch`` is timed, so that two trees can be compared in one run on
one card (call it for each, in turns: A, B, B, A).  Prints one JSON line:
per phase the step times (ms, host clock after a synchronise), their
median, and the step's device ops and device ms from ``torch.profiler``.

    python3 scripts/time_train_step.py [--src src] [--steps 5]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

# phase: (arch, layers, microbatches), chip_smoke.py's TRAIN_PHASES
PHASES = {"6": ("internlm2-1.8b", 2, 2), "6b": ("mamba2-2.7b", 2, 1),
          "6c": ("recurrentgemma-2b", 3, 2)}
BATCH, SEQ = 2, 4096  # sequences a microbatch, positions (chip_smoke TRAIN)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default="src")
    ap.add_argument("--steps", type=int, default=5)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.src))
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import init_params, param_specs
    from repro_torch.train import (AdamWConfig, TrainConfig, Trainer,
                                   adamw_update, global_norm, init_opt_state)

    if not torch.cuda.is_available():
        print("time_train_step: needs a GPU", file=sys.stderr)
        return 2
    torch.use_deterministic_algorithms(True)
    dev = torch.device("cuda")
    out = {"src": args.src, "device": torch.cuda.get_device_name(0)}
    for phase, (arch, layers, mb) in PHASES.items():
        cfg = dataclasses.replace(get_config(arch), n_layers=layers)
        params = init_params(param_specs(cfg), 0, device=dev)
        opt_cfg = AdamWConfig()
        trainer = Trainer(cfg, opt_cfg, TrainConfig(microbatches=mb),
                          device=dev)
        rng = np.random.default_rng(0)
        batch = {k: torch.from_numpy(rng.integers(
            0, cfg.vocab, (mb, BATCH, SEQ), dtype=np.int32)).to(dev)
            for k in ("inputs", "targets")}
        opt = init_opt_state(params)

        def step():
            nonlocal params, opt
            _, grads = trainer.loss_and_grads(params, batch)
            params, opt, _ = adamw_update(params, grads, opt, opt_cfg,
                                          gnorm=global_norm(grads))

        step()  # warm-up
        torch.cuda.synchronize()
        ms = []
        for _ in range(args.steps):
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            step()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.self_device_time_total > 0]
        out[phase] = {
            "arch": arch, "layers": layers, "microbatches": mb, "ms": ms,
            "median_ms": float(np.median(ms)),
            "device_ops": int(sum(e.count for e in events)),
            "device_ms": sum(e.self_device_time_total for e in events) / 1e3}
        del params, opt, trainer, batch
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
