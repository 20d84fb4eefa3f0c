#!/usr/bin/env python3
"""Time the attention and SSD-scan kernels of a checkout at the prefill shapes.

For comparing two trees in one call on one card (parent, change, change,
parent): ``--src`` names the ``src`` directory whose ``repro_torch`` is
timed (its kernels are built into that checkout's ``build/``), by this
checkout's ``chip_smoke.py`` measurements, ``measure_attention`` and
``measure_ssd``: the same inputs and CUDA-event timing, at internlm2-1.8b's
and recurrentgemma-2b's attention prefill shapes and mamba2-2.7b's scan.
Prints one JSON line: the card (``nvidia-smi`` name and power limit) and,
per shape and dtype, the kernel that ``ops`` dispatches to with its
milliseconds in each of ``--rounds`` rounds.  Needs one CUDA device.

    python scripts/time_attention_scan.py --src src --rounds 3
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs  # puts this checkout's src on sys.path
    sys.path.insert(0, str(Path(args.src).resolve()))  # ahead of it
    import torch
    from repro_torch.kernels import ops
    from repro_torch.serve import exact_float32

    exact_float32()  # as chip_smoke.py: float32 plain products stay float32
    dev = torch.device("cuda", 0)
    out = {"card": cs.gpu_line(), "src": args.src}
    for dtype in (torch.bfloat16, torch.float32):
        cases = {
            "attention d128": ("flash_attention", lambda: cs.measure_attention(
                dev, dtype=dtype)),
            "attention d256": ("flash_attention", lambda: cs.measure_attention(
                dev, cs.ATTN_RG, cs.RG_WINDOW, dtype=dtype)),
            "ssd_scan": ("ssd_scan", lambda: cs.measure_ssd(dev, dtype)),
        }
        for label, (op, measure) in cases.items():
            kernel = ops.kernel_module(op, dtype).__name__.rsplit(".", 1)[-1]
            key = f"{label} {str(dtype).removeprefix('torch.')} ({kernel})"
            out[key] = [measure()["ms"] for _ in range(args.rounds)]
    print(json.dumps(out))


if __name__ == "__main__":
    main()
