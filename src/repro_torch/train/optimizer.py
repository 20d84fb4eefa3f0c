"""AdamW with warmup-cosine schedule and global-norm clipping.

The counterpart of ``repro.train.optimizer``.  The reference computes in
float32 (jnp arrays with weakly typed Python scalars), so this module does
too, with each Python constant rounded to float32 where the reference
rounds it.  PyTorch's float32 ``cos`` and ``pow`` and XLA's can differ in
the last place, so the learning rate and the bias corrections may differ by
one float32 ulp from the reference's at some steps.

The scalars of a step (learning rate, bias corrections) are computed on the
host from the step count and enter the update as 0-d tensors on the
parameters' device.  A division by one is a true division there: PyTorch's
CUDA kernels multiply by the reciprocal of a host scalar divisor, and
``scalar / tensor`` is a reciprocal times the scalar on every device, which
the reference does not do.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Sequence

import numpy as np
import torch
import torch.distributed

from ..convert import resolve_device

__all__ = ["AdamWConfig", "cosine_schedule", "init_opt_state", "adamw_update",
           "global_norm"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1


def cosine_schedule(cfg: AdamWConfig, step,
                    device: str | torch.device = "cuda") -> torch.Tensor:
    """Learning rate at ``step`` as a 0-d float32 tensor on ``device``."""
    step = torch.tensor(step, dtype=torch.float32,
                        device=resolve_device(device))
    warm = torch.clamp((step + 1) / max(1, cfg.warmup_steps), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(1, cfg.total_steps - cfg.warmup_steps), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * t))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def global_norm(tree: Mapping[str, torch.Tensor], *,
                spans: Mapping[str, Sequence] | None = None) -> torch.Tensor:
    """The float32 norm over every tensor, the squares summed in sorted key
    order: the order of the reference's jitted step, which flattens the
    dict by key.  Insertion order would make the sum depend on how the
    dict was built (a restored tree's order is not a fresh one's), and so
    would the clipped update.

    Under a mesh, ``tree`` holds this rank's blocks, and ``spans`` maps
    each sharded tensor to the process groups of the mesh axes its block
    spans: its squares are summed over exactly those ranks (one all-reduce
    per set of groups, the tensors stacked in sorted key order), each whole
    tensor counted once, and the sum keeps the sorted order (at one rank
    the same bits as without a mesh)."""
    sq = {k: tree[k].float().square().sum() for k in tree}
    sets: dict[tuple, tuple[Sequence, list[str]]] = {}
    for k in sorted(spans or {}):
        sets.setdefault(tuple(map(id, spans[k])), (spans[k], []))[1].append(k)
    for groups, keys in sets.values():
        parts = torch.stack([sq[k] for k in keys])
        for g in groups:
            torch.distributed.all_reduce(parts, group=g)
        sq.update(zip(keys, parts.unbind(0)))
    return torch.sqrt(sum(sq[k] for k in sorted(tree)))


def init_opt_state(params: Mapping[str, torch.Tensor]) -> dict:
    dev = next(iter(params.values())).device
    return {
        "m": {k: torch.zeros(v.shape, dtype=torch.float32, device=v.device)
              for k, v in params.items()},
        "v": {k: torch.zeros(v.shape, dtype=torch.float32, device=v.device)
              for k, v in params.items()},
        "step": torch.zeros((), dtype=torch.int32, device=dev),
    }


def _decayable(name: str) -> bool:
    leaf = name.split("/")[-1]
    return not ("norm" in leaf or leaf.startswith("b")
                or leaf in ("A_log", "D", "dt_bias", "lam"))


def _f32(value, device) -> torch.Tensor:
    """A float32 value as a 0-d tensor on ``device`` (filled there: no
    host-to-device copy)."""
    return torch.full((), float(value), dtype=torch.float32, device=device)


@torch.no_grad()
def adamw_update(params, grads, state, cfg: AdamWConfig, *, gnorm=None):
    """One AdamW step on flat dicts.  Returns (params', state', stats); the
    inputs are not modified.  ``gnorm``: the gradients' global norm, when
    the caller computes it (under a mesh); by default ``global_norm``."""
    dev = state["step"].device
    t = int(state["step"])
    step = state["step"] + 1
    lr = _f32(cosine_schedule(cfg, t, device="cpu"), dev)
    gn = global_norm(grads) if gnorm is None else gnorm
    scale = (torch.clamp(_f32(cfg.clip_norm, dev)
                         / torch.clamp(gn, min=1e-12), max=1.0)
             if cfg.clip_norm else 1.0)
    n = np.float32(t + 1)
    b1c = _f32(np.float32(1) - np.float32(cfg.b1) ** n, dev)
    b2c = _f32(np.float32(1) - np.float32(cfg.b2) ** n, dev)
    new_p, new_m, new_v = {}, {}, {}
    for k, p in params.items():
        g = grads[k].float() * scale
        m = cfg.b1 * state["m"][k] + (1 - cfg.b1) * g
        v = cfg.b2 * state["v"][k] + (1 - cfg.b2) * g.square()
        upd = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        if cfg.weight_decay and _decayable(k):
            upd = upd + cfg.weight_decay * p.float()
        new_p[k] = (p.float() - lr * upd).to(p.dtype)
        new_m[k] = m
        new_v[k] = v
    return new_p, {"m": new_m, "v": new_v, "step": step}, {"lr": lr,
                                                           "gnorm": gn}
