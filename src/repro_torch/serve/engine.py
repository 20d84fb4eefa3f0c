"""Batched serving engine with window-backed session persistence.

The counterpart of ``repro.serve.engine``: prefill + greedy decode of every
family (dense, MoE with GQA or MLA attention, SSM, RG-LRU hybrid, and the
frontends: a VLM's patch embeddings before the prompt, an encoder-decoder
model's frames encoded once in prefill) on one device.  The paper's
technique appears as :class:`SessionStore`: the whole decode state (KV
caches, position and the generated tokens) maps onto a *combined* storage
window -- ``factor`` says how much of it stays pinned in host memory and
how much spills to storage -- and a selective ``sync()`` makes a session
durable: an engine can be killed and reopened mid-generation and continue
exactly.  The window layout is the reference's, so both packages write the
same session file for the same state.
"""

from __future__ import annotations

import numpy as np
import torch

from ..convert import (exact_float32, resolve_device, tensor_from_stored,
                       tree_to_numpy)
from ..core.comm import Communicator
from ..core.offload import WindowedPyTree
from ..models import (cast_params, init_cache_specs, make_decode_fn,
                      make_prefill_fn, merge_tail)
from ..models.config import ModelConfig

__all__ = ["Engine", "SessionStore"]

TOKENS_OUT = 4096  # the generated-token ring of a session


class SessionStore:
    """Decode state in a (combined) storage window; selective sync."""

    def __init__(self, comm: Communicator, path: str, cache_specs: dict, *,
                 factor: str | float | None = None,
                 memory_budget: int | None = None):
        specs = {k: (tuple(v.shape), v.dtype) for k, v in cache_specs.items()}
        specs["pos"] = ((), "int32")
        specs["tokens_out"] = ((TOKENS_OUT,), "int32")
        info = {"alloc_type": "storage", "storage_alloc_filename": path}
        if factor is not None:
            info["storage_alloc_factor"] = str(factor)
        self.wt = WindowedPyTree.allocate(comm, specs, info,
                                          memory_budget=memory_budget)

    def save(self, cache: dict, pos: int, tokens: np.ndarray) -> int:
        """Put the cache (copied to the host one tensor at a time), the
        position and the tokens, then sync; returns the bytes flushed."""
        for k, v in cache.items():
            self.wt.put(k, tree_to_numpy({k: v})[k])
        self.wt.put("pos", np.asarray(pos, np.int32))
        buf = np.zeros(TOKENS_OUT, np.int32)
        buf[: len(tokens)] = tokens[:TOKENS_OUT]
        self.wt.put("tokens_out", buf)
        return self.wt.sync()

    def load(self, cache_specs: dict, device: str | torch.device = "cuda"):
        """``(cache on device, pos, tokens_out)`` as last saved."""
        cache = {k: tensor_from_stored(self.wt.get(k), spec.dtype, device)
                 for k, spec in cache_specs.items()}
        pos = int(self.wt.get("pos"))
        toks = self.wt.get("tokens_out")
        return cache, pos, toks

    def free(self):
        self.wt.free()


class Engine:
    """Prefill + greedy decode on ``device`` (``"cuda"`` unless the caller
    asks for another).  The parameters are moved there and cast to the
    compute dtype once, here; the cache is allocated once and written in
    place.  ``enc_len``: an encoder-decoder model's encoder context, the
    frames every prefill takes (the cross-attention cache's length)."""

    def __init__(self, cfg: ModelConfig, params: dict, *, batch: int,
                 max_len: int, enc_len: int = 0,
                 session: SessionStore | None = None,
                 device: str | torch.device = "cuda"):
        exact_float32()
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = cast_params(
            cfg, {k: v.to(self.device) for k, v in params.items()})
        self.batch = batch
        self.max_len = max_len
        if cfg.is_encdec and enc_len < 1:
            raise ValueError(f"{cfg.name} is an encoder-decoder model: give "
                             "the engine its encoder context, enc_len")
        self.enc_len = enc_len
        self.cache_specs = init_cache_specs(cfg, batch, max_len, enc_len)
        self._prefill = make_prefill_fn(cfg)
        self._decode = make_decode_fn(cfg)
        self.cache = {k: torch.zeros(v.shape, dtype=getattr(torch, v.dtype),
                                     device=self.device)
                      for k, v in self.cache_specs.items()}
        self.pos = 0
        self.generated: list[np.ndarray] = []
        self.session = session

    def _maybe_merge(self) -> None:
        """Before the step at a multiple of Tt, the full tail of a two-tier
        KV cache (MLA: its latent cache) moves to main[pos - Tt : pos]
        (:func:`~repro_torch.models.lm.merge_tail`)."""
        merge_tail(self.cache, self.pos)

    def _tokens(self, tokens, length: int | None = None) -> torch.Tensor:
        """Token ids from the caller as a (batch, n) int32 tensor on the
        device, checked on the host first (an index out of range would be
        a device fault on the card)."""
        a = np.asarray(tokens.cpu() if isinstance(tokens, torch.Tensor)
                       else tokens)
        if length is not None:
            a = a.reshape(self.batch, length)
        if a.ndim != 2 or a.shape[0] != self.batch:
            raise ValueError(f"tokens must be ({self.batch}, n), got {a.shape}")
        if a.size and (a.min() < 0 or a.max() >= self.cfg.vocab):
            raise ValueError(f"token ids must be in [0, {self.cfg.vocab})")
        return torch.from_numpy(a.astype(np.int32)).to(self.device)

    def _embeddings(self, batch_inputs: dict, key: str,
                    length: int) -> torch.Tensor:
        """A frontend's input, ``batch_inputs[key]`` (numpy or torch, any
        floating dtype), as a (batch, length, d_model) tensor on the
        device, its dtype kept (the model casts it)."""
        if key not in batch_inputs:
            raise ValueError(f"{self.cfg.name} takes {key!r} in prefill")
        a = batch_inputs[key]
        t = a if isinstance(a, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(a))
        want = (self.batch, length, self.cfg.d_model)
        if tuple(t.shape) != want or not t.is_floating_point():
            raise ValueError(f"{key} must be floating {want}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        return t.to(self.device)

    @staticmethod
    def _argmax(logits: torch.Tensor) -> np.ndarray:
        # like jnp.argmax, torch.argmax takes the first maximum
        return torch.argmax(logits[:, -1], dim=-1).cpu().numpy().astype(
            np.int32)

    def prefill(self, batch_inputs: dict) -> np.ndarray:
        """The prompt, ``batch_inputs["inputs"]`` (batch, S), through the
        model; a VLM also takes ``patches`` (batch, img_tokens, d_model),
        which take the first img_tokens positions, and an encoder-decoder
        model ``frames`` (batch, enc_len, d_model).  Returns the first
        greedy token of each request."""
        cfg = self.cfg
        batch = {"inputs": self._tokens(batch_inputs["inputs"])}
        length = batch["inputs"].shape[1]
        if cfg.frontend == "vlm_stub":
            batch["patches"] = self._embeddings(batch_inputs, "patches",
                                                cfg.img_tokens)
            length += cfg.img_tokens
        if cfg.is_encdec:
            batch["frames"] = self._embeddings(batch_inputs, "frames",
                                               self.enc_len)
        if not 1 <= length <= self.max_len:
            raise ValueError(f"prompt length {length} not in "
                             f"[1, {self.max_len}]")
        for t in self.cache.values():
            t.zero_()
        logits, _ = self._prefill(self.params, batch, self.cache)
        self.pos = length
        return self._argmax(logits)

    def decode_logits(self, tokens) -> torch.Tensor:
        """One decode step; returns the (batch, 1, vocab) logits."""
        if self.pos >= self.max_len:
            raise ValueError(f"the cache holds {self.max_len} positions")
        self._maybe_merge()  # amortized tail->main flush (two-tier cache)
        t = self._tokens(tokens, 1)
        logits, _ = self._decode(self.params, self.cache, t, self.pos)
        self.pos += 1
        return logits

    def step(self, tokens: np.ndarray) -> np.ndarray:
        return self._argmax(self.decode_logits(tokens))

    def generate(self, batch_inputs: dict, steps: int) -> np.ndarray:
        nxt = self.prefill(batch_inputs)
        out = [nxt]
        for _ in range(steps - 1):
            nxt = self.step(nxt)
            out.append(nxt)
        self.generated = out
        return np.stack(out, axis=1)  # (B, steps)

    # -- window-backed session persistence ------------------------------------
    def save_session(self) -> int:
        if self.session is None:
            raise ValueError("this engine has no SessionStore")
        toks = (np.stack(self.generated, axis=1).reshape(-1)
                if self.generated else np.zeros(0, np.int32))
        return self.session.save(self.cache, self.pos, toks)

    def load_session(self) -> None:
        if self.session is None:
            raise ValueError("this engine has no SessionStore")
        self.cache, self.pos, _ = self.session.load(self.cache_specs,
                                                    self.device)
        self.generated = []
