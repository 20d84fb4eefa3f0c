"""Data pipeline: deterministic synthetic corpus + window-backed shards.

The counterpart of ``repro.data.pipeline``: numpy only, so it is the
reference's code over this package's ``Window``.  Batches stay numpy; the
Trainer moves them to its device.

Two sources:

* ``SyntheticLM`` -- deterministic tokens derived from (seed, step, micro-
  batch, rank): restart-exact without any state, which the fault-injection
  tests rely on (a resumed run sees byte-identical batches).
* ``WindowBackedDataset`` -- the paper's "windows as parallel I/O" applied
  to input data: a tokenized corpus lives in a *shared-file* storage window
  (one file, per-rank offsets, striping hints honored); every rank reads
  its shard with one-sided ``get``s.  This replaces a POSIX/MPI-I/O reader
  with the same unified interface used for checkpoints.

``make_batch_iter`` adds background prefetch (double buffering) so host
I/O overlaps device compute -- the same overlap argument the paper makes
for storage windows.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np

from ..core.comm import Communicator
from ..core.window import Window
from ..models.config import ModelConfig

__all__ = ["SyntheticLM", "WindowBackedDataset", "make_batch_iter"]


class SyntheticLM:
    """Deterministic LM batches for any architecture: token inputs and
    shifted targets, and the frontends' inputs, drawn after the tokens
    from the same generator (the reference's order): a VLM's ``patches``
    (its ``seq`` counts them, the text is ``seq - img_tokens``) and an
    encoder-decoder model's ``frames`` (``seq`` of them), float32."""

    def __init__(self, cfg: ModelConfig, *, batch: int, seq: int,
                 microbatches: int = 1, seed: int = 0, rank: int = 0):
        self.cfg = cfg
        self.batch = batch
        self.seq = seq
        self.mb = microbatches
        self.seed = seed
        self.rank = rank

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.rank]))

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        cfg = self.cfg
        rng = self._rng(step)
        vlm = cfg.frontend == "vlm_stub"
        St = self.seq - cfg.img_tokens if vlm else self.seq
        shape = (self.mb, self.batch, St)
        toks = rng.integers(0, cfg.vocab, size=shape,
                            dtype=np.int64).astype(np.int32)
        # next-token objective: targets are inputs shifted left
        tgt = np.roll(toks, -1, axis=-1)
        tgt[..., -1] = -1  # no target for the last position
        out = {"inputs": toks, "targets": tgt}
        if vlm:
            out["patches"] = rng.standard_normal(
                (self.mb, self.batch, cfg.img_tokens, cfg.d_model),
                dtype=np.float32)
        if cfg.is_encdec:
            out["frames"] = rng.standard_normal(
                (self.mb, self.batch, self.seq, cfg.d_model),
                dtype=np.float32)
        return out

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class WindowBackedDataset:
    """Tokenized corpus in a shared-file storage window (paper §3.5.1).

    Layout: one int32 token stream per rank, written at per-rank offsets of
    a single shared file.  Reads are one-sided window ``get``s.
    """

    def __init__(self, comm: Communicator, path: str, tokens_per_rank: int,
                 *, striping_factor: int = 1, striping_unit: int = 1 << 20):
        self.comm = comm
        self.tokens_per_rank = tokens_per_rank
        info = {
            "alloc_type": "storage",
            "storage_alloc_filename": path,
            "striping_factor": str(striping_factor),
            "striping_unit": str(striping_unit),
        }
        self.win = Window.allocate(comm, tokens_per_rank * 4, info=info,
                                   shared_file=(striping_factor == 1))

    def write_corpus(self, rank: int, tokens: np.ndarray) -> None:
        tokens = np.ascontiguousarray(tokens[: self.tokens_per_rank], np.int32)
        self.win.put(tokens.view(np.uint8).ravel(), rank, 0)
        self.win.sync(rank)

    def read(self, rank: int, start_tok: int, n_tok: int) -> np.ndarray:
        start = (start_tok % max(1, self.tokens_per_rank - n_tok))
        return self.win.get(rank, start * 4, n_tok, np.int32)

    def batch_at(self, rank: int, step: int, batch: int, seq: int) -> dict:
        toks = np.stack([
            self.read(rank, (step * batch + b) * seq, seq) for b in range(batch)
        ])
        tgt = np.roll(toks, -1, axis=-1)
        tgt[:, -1] = -1
        return {"inputs": toks, "targets": tgt}

    def free(self) -> None:
        self.win.free()


def make_batch_iter(source, *, prefetch: int = 2) -> Iterator:
    """Background-thread prefetch wrapper (host I/O overlaps compute)."""
    q: queue.Queue = queue.Queue(maxsize=prefetch)
    stop = threading.Event()

    def worker():
        try:
            for item in source:
                if stop.is_set():
                    return
                q.put(item)
        finally:
            q.put(None)

    t = threading.Thread(target=worker, daemon=True, name="repro-prefetch")
    t.start()
    try:
        while True:
            item = q.get()
            if item is None:
                return
            yield item
    finally:
        stop.set()
