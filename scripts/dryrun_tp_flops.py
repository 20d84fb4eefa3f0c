#!/usr/bin/env python3
"""The JAX package's FLOPs a device of the train_4k step on the 2x4 mesh.

For each ``--arch``, ``repro.perf.hlo_analysis.analyze_hlo`` over the
reference's train_4k cell compiled on a 2x4 ``("data", "model")`` mesh
(eight forced host devices, ``Auto`` mesh axes, its ``_ELEMENTWISE``
emptied so that it counts products and reductions; a subprocess).  The
port's own products of the cell come from its dry-run's records
(``flop_terms["products"]``: ``REPRO_DRYRUN_DEVICES=8
REPRO_MESH_OVERRIDE=2x4 python -m repro_torch.launch.dryrun --all --shape
train_4k``).  One JSON line per arch.

    PYTHONPATH=src python scripts/dryrun_tp_flops.py --arch mamba2-2.7b \\
        qwen2-72b
"""

import argparse
import json
import os
import subprocess
import sys

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")

_REFERENCE = r'''
import json, sys
import repro.launch.dryrun as rd  # sets XLA_FLAGS before jax
import jax
import numpy as np
from jax.sharding import AxisType, Mesh
import repro.perf.hlo_analysis as ha
from repro.runtime.sharding import use_rules


def make_production_mesh(multi_pod=False):
    devs = np.array(jax.devices()[:8]).reshape(2, 4)
    return Mesh(devs, ("data", "model"), axis_types=(AxisType.Auto,) * 2)


rd.make_production_mesh = make_production_mesh
ha._ELEMENTWISE.clear()
step, args, in_sh, out_sh, rules, mesh, meta = rd.build_cell(
    sys.argv[1], "train_4k", multi_pod=False)
with use_rules(rules, mesh), mesh:
    c = jax.jit(step, in_shardings=in_sh, out_shardings=out_sh).lower(
        *args).compile()
print(json.dumps(ha.analyze_hlo(c.as_text()).flops))
'''


def reference_flops(arch: str) -> float:
    env = {k: v for k, v in os.environ.items() if not k.startswith("REPRO_")}
    env.update(PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", _REFERENCE, arch], env=env,
                         capture_output=True, text=True, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", nargs="+",
                    default=["mamba2-2.7b", "qwen2-72b"])
    args = ap.parse_args()
    for arch in args.arch:
        print(json.dumps({"arch": arch, "shape": "train_4k",
                          "reference_flops_2x4": reference_flops(arch)}),
              flush=True)


if __name__ == "__main__":
    main()
