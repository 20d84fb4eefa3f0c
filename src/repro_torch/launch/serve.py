"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id> [...]``.

Prefill + greedy decode with the batched engine on ``--device`` (the card
unless ``--device cpu``); ``--session`` persists the decode state into a
(combined) storage window so generation can resume after a restart.
Parameters are random from ``--seed`` (made on the device); prompt tokens
come from numpy with the same seed.  A VLM (llava-next-mistral-7b) also
takes ``img_tokens`` patch embeddings and an encoder-decoder model
(whisper-base) frame embeddings, ``enc_len`` of them (16 under
``--smoke``, the config's ``enc_seq`` otherwise), both normal bf16 from a
torch generator seeded with ``--seed``.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..configs import ARCHS, get_config
from ..core import Communicator
from ..models import init_cache_specs, init_params, param_specs
from ..serve import Engine, SessionStore


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--session", default=None,
                    help="path for a window-backed resumable session")
    ap.add_argument("--session-factor", default="0.5")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    params = init_params(param_specs(cfg), args.seed, device=args.device)
    enc_len = (16 if args.smoke else cfg.enc_seq) if cfg.is_encdec else 0
    session = None
    if args.session:
        session = SessionStore(
            Communicator(1), args.session,
            init_cache_specs(cfg, args.batch, args.max_len, enc_len),
            factor=args.session_factor)
    eng = Engine(cfg, params, batch=args.batch, max_len=args.max_len,
                 enc_len=enc_len, session=session, device=args.device)
    del params  # the engine holds its own cast copy
    toks = np.random.default_rng(args.seed).integers(
        0, cfg.vocab, size=(args.batch, args.prompt_len)).astype(np.int32)
    batch = {"inputs": toks}
    gen = torch.Generator().manual_seed(args.seed)
    if cfg.frontend == "vlm_stub":
        batch["patches"] = torch.randn(
            args.batch, cfg.img_tokens, cfg.d_model,
            generator=gen).to(torch.bfloat16)
    if cfg.is_encdec:
        batch["frames"] = torch.randn(
            args.batch, enc_len, cfg.d_model, generator=gen).to(
                torch.bfloat16)
    out = eng.generate(batch, args.steps)
    print("generated token ids (batch 0):", out[0].tolist())
    if session:
        print("session flushed:", eng.save_session(), "bytes")
        session.free()


if __name__ == "__main__":
    main()
