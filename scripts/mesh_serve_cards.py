"""Serve five archs on a mesh of four cards under their serving rules,
beside one card's plain run of the same model.

One process a card under ``torch.distributed.run`` (NCCL), the production
mesh at ``REPRO_MESH_OVERRIDE``'s shape.  Each of ``ARCHS`` at its
published widths, each layer loop cut to 2 repeats, in float32 with
float32 caches and random parameters from seed 0
(``chip_smoke.model_params``): every rank takes its ``explicit_spec``
blocks of the parameters, the cache and the prompt's rows under the
dry-run's rules for the arch (``launch.dryrun.serving_rules``) and runs
``chip_smoke.greedy_serve`` (a 1020-token prompt, 12 greedy steps across
the tail merge at 1024, a 2048-position cache); then it runs its own rows
through the plain model on its card.  Rank 0 prints one JSON line an arch:
the largest relative difference of a call's logits (the vocabulary blocks
gathered over "model") from the plain run's over every rank and call,
whether every greedy token agreed, and the mesh's and the plain run's
prefill and mean decode-step wall ms (the slowest rank's, of the second of
two turns, mesh then plain, the first warming up).  Exit 1 if a
difference reaches 1e-4 or a token differs.  The kernels are built before:
``python -c "import chip_smoke as cs; from repro_torch.kernels import
_build; _build.build(cs.BUILD)"``.

    REPRO_MESH_OVERRIDE=2x2 python -m torch.distributed.run \\
        --nproc-per-node 4 scripts/mesh_serve_cards.py
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")  # every rank on one host

ARCHS = ("internlm2-1.8b", "gemma-7b", "mamba2-2.7b", "recurrentgemma-2b",
         "whisper-base")
LAYERS, BATCH, PROMPT, CACHE_LEN, STEPS, LIMIT = 2, 4, 1020, 2048, 12, 1e-4


def _config(arch: str):
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    cfg = get_config(arch)
    cfg = dryrun.at_depth(cfg, {k: min(n, LAYERS) for k, n in
                                dryrun.depth_loops(cfg).items()})
    return dataclasses.replace(cfg, dtype="float32", param_dtype="float32")


def main() -> int:
    import numpy as np
    import torch
    import torch.distributed as dist

    import chip_smoke
    from repro_torch.convert import exact_float32
    from repro_torch.launch.dryrun import serving_rules
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import cast_params, init_cache_specs, param_specs
    from repro_torch.runtime.partition import gather, model_axis
    from repro_torch.runtime.sharding import (NamedSharding, explicit_spec,
                                              mesh_shape, use_rules)

    if not torch.cuda.is_available():
        print("mesh_serve_cards: CUDA is not available", file=sys.stderr)
        return 2
    dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    torch.cuda.set_device(dev)
    exact_float32()
    dist.init_process_group("nccl")
    mesh = make_production_mesh(device="cuda")

    def slowest(v: float) -> float:
        t = torch.tensor(v, dtype=torch.float64, device=dev)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return float(t)

    failed = False
    for arch in ARCHS:
        cfg = _config(arch)
        rules = serving_rules(arch, False)
        enc_len = cfg.enc_seq if cfg.is_encdec else 0
        specs = param_specs(cfg)
        cspecs = init_cache_specs(cfg, BATCH, CACHE_LEN, enc_len)
        params = cast_params(cfg, chip_smoke.model_params(cfg, 0, dev))
        rng = np.random.default_rng(0)
        raw = {"inputs": torch.from_numpy(rng.integers(
            0, cfg.vocab, size=(BATCH, PROMPT))).to(dev)}
        axes = {"inputs": ("batch", None)}
        if cfg.is_encdec:
            raw["frames"] = torch.from_numpy(rng.standard_normal(
                (BATCH, enc_len, cfg.d_model)).astype(np.float32)
            ).to(dev)
            axes["frames"] = ("batch", None, None)

        def block(ax, t, ctx):
            spec = explicit_spec(ax, t.shape, rules, mesh, ctx)
            return NamedSharding(mesh, spec).local_slice(t).contiguous()

        blocks = {k: block(specs[k].axes, v, k) for k, v in params.items()}
        batch = {k: block(axes[k], v, k) for k, v in raw.items()}
        rows = batch["inputs"].shape[0]  # this rank's
        kw = dict(steps=STEPS, cache_len=CACHE_LEN, enc_len=enc_len)
        err, same = 0.0, True
        for _ in range(2):  # the second pair's walls: the first warms up
            cache = {k: block(s.axes, torch.zeros(s.shape, device=dev), k)
                     for k, s in cspecs.items()}
            with use_rules(rules, mesh):
                ruled = chip_smoke.greedy_serve(cfg, blocks, batch, cache,
                                                **kw)
                ruled["logits"] = [
                    x if x.shape[-1] == cfg.vocab
                    else gather(x, -1, model_axis()) for x in ruled["logits"]]
            cache = {k: torch.zeros((s.shape[0], rows, *s.shape[2:]),
                                    device=dev) for k, s in cspecs.items()}
            plain = chip_smoke.greedy_serve(cfg, params, batch, cache, **kw)
            del cache
            err = max([err] + [float((a - b).abs().max() / b.abs().max())
                               for a, b in zip(ruled["logits"],
                                               plain["logits"])])
            same &= all(torch.equal(a, b) for a, b in zip(ruled["tokens"],
                                                          plain["tokens"]))
        rec = {"arch": cfg.name, "n_layers": cfg.n_layers,
               "mesh": mesh_shape(mesh), "rules": rules.name,
               "prompt": PROMPT, "max_len": CACHE_LEN, "steps": STEPS,
               "max_rel_err": slowest(err),
               "tokens_equal": slowest(0.0 if same else 1.0) == 0.0,
               "mesh_prefill_ms": slowest(ruled["prefill_ms"]),
               "mesh_step_ms": slowest(ruled["step_ms"]),
               "plain_prefill_ms": slowest(plain["prefill_ms"]),
               "plain_step_ms": slowest(plain["step_ms"]),
               "device": torch.cuda.get_device_name(dev)}
        failed |= not (rec["max_rel_err"] < LIMIT and rec["tokens_equal"])
        if dist.get_rank() == 0:
            print(json.dumps(rec), flush=True)
        del params, blocks
        torch.cuda.empty_cache()
    dist.destroy_process_group()
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
