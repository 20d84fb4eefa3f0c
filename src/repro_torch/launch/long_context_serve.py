"""Long-context serving with window-backed resumable sessions.

``python -m repro_torch.launch.long_context_serve`` -- the port of
``examples/long_context_serve.py``, on ``--device`` (the card unless
``--device cpu``).  A recurrent (RG-LRU hybrid) model decodes with O(1)
state; the decode state lives in a *combined* storage window (factor 0.5:
half pinned, half behind the page cache).  The session survives an engine
restart -- the serving analogue of the paper's checkpoint/restart story:
6 tokens are served and the session persisted, the engine dropped, a
fresh engine loads the session and serves the rest, and the tokens must
equal one uninterrupted generation's (exit code 1 if not).

Parameters are random from ``--seed`` (``init_params``, made on the
device) and the prompt tokens come from numpy with the same seed;
:func:`run` takes any parameters and prompt (the tests hand it the
example's own).

Run:  PYTHONPATH=src python -m repro_torch.launch.long_context_serve [--device cpu]
"""

from __future__ import annotations

import argparse
import shutil
import sys
import tempfile

import numpy as np

ARCH = "recurrentgemma-2b"
B, PROMPT, STEPS, MAX_LEN = 2, 8, 12, 64
SAVE_AT = 6  # tokens served before the session is persisted


def run(cfg, params: dict, toks: np.ndarray, directory: str, *,
        device="cuda", log=print) -> dict:
    """The example's run of ``cfg`` with ``params`` on the (B, PROMPT)
    prompt ``toks``, the session window under ``directory``.  Prints what
    the example prints; returns the resumed and the uninterrupted tokens
    (B, STEPS), the bytes flushed and the resumed position."""
    from ..core import Communicator
    from ..models import init_cache_specs
    from ..serve import Engine, SessionStore
    store = SessionStore(Communicator(1), f"{directory}/session.bin",
                         init_cache_specs(cfg, B, MAX_LEN), factor="0.5")
    out = {}
    try:
        # -- serve 6 tokens, persist the session, drop the engine ----------
        eng = Engine(cfg, params, batch=B, max_len=MAX_LEN, session=store,
                     device=device)
        nxt = eng.prefill({"inputs": toks})
        seq = [nxt]
        for _ in range(SAVE_AT - 1):
            nxt = eng.step(nxt)
            seq.append(nxt)
        eng.generated = seq
        out["flushed"] = eng.save_session()
        log(f"session persisted ({out['flushed'] >> 10} KiB flushed), "
            "killing engine")
        del eng

        # -- a fresh engine resumes exactly where the old one stopped ------
        eng2 = Engine(cfg, params, batch=B, max_len=MAX_LEN, session=store,
                      device=device)
        eng2.load_session()
        out["resumed_at"] = eng2.pos
        log(f"resumed at position {eng2.pos}")
        for _ in range(STEPS - SAVE_AT):
            nxt = eng2.step(nxt)
            seq.append(nxt)
        out["resumed"] = np.stack(seq, axis=1)
        del eng2

        # -- reference: one uninterrupted generation -----------------------
        eng3 = Engine(cfg, params, batch=B, max_len=MAX_LEN, device=device)
        out["uninterrupted"] = eng3.generate({"inputs": toks}, STEPS)
    finally:
        store.free()
    out["exact"] = bool((out["resumed"] == out["uninterrupted"]).all())
    if out["exact"]:
        log("resumed generation is bit-exact:", out["resumed"][0].tolist())
    return out


def main(argv=None) -> int:
    from ..configs import get_config
    from ..models import init_params, param_specs
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dir", default=None,
                    help="directory for the session window (default: a new "
                         "temporary one, removed at the end)")
    args = ap.parse_args(argv)
    cfg = get_config(ARCH, smoke=True)
    params = init_params(param_specs(cfg), args.seed, device=args.device)
    toks = np.random.default_rng(args.seed).integers(
        0, cfg.vocab, size=(B, PROMPT)).astype(np.int32)
    directory = args.dir or tempfile.mkdtemp(prefix="repro_serve_")
    try:
        out = run(cfg, params, toks, directory, device=args.device)
    finally:
        if args.dir is None:
            shutil.rmtree(directory, ignore_errors=True)
    if not out["exact"]:
        print("long_context_serve: the resumed session's tokens differ from "
              "the uninterrupted run's", file=sys.stderr)
        return 1
    print("done")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
