"""Training: the Trainer with window checkpoints, on-device AdamW, and the
out-of-core AdamW whose state lives in storage windows."""

from .loop import TrainConfig, Trainer
from .offload_opt import OutOfCoreAdamW
from .optimizer import (AdamWConfig, adamw_update, cosine_schedule,
                        global_norm, init_opt_state)

__all__ = ["OutOfCoreAdamW", "AdamWConfig", "cosine_schedule", "TrainConfig",
           "Trainer", "adamw_update", "global_norm", "init_opt_state"]
