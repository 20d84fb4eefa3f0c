"""AdamW configuration and the warmup-cosine learning-rate schedule.

The counterpart of ``repro.train.optimizer`` (``optimizer.py:16-34``),
trimmed to what the out-of-core optimizer uses.  The reference computes the
schedule in float32 (jnp arrays with weakly typed Python scalars), so this
one does too, with each Python constant rounded to float32 where the
reference rounds it.  PyTorch's float32 ``cos`` and XLA's can differ in the
last place, so the learning rate may differ by one float32 ulp from the
reference's at some steps.  ``adamw_update``, ``global_norm`` and
``init_opt_state`` wait for the Trainer slice.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..convert import resolve_device

__all__ = ["AdamWConfig", "cosine_schedule"]


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
