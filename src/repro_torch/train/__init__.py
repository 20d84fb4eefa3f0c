"""Training state in storage windows: the out-of-core AdamW.

``OutOfCoreAdamW`` (:mod:`.offload_opt`) and the schedule it uses
(:mod:`.optimizer`).  The Trainer and the fused on-device AdamW are a later
slice of this package.
"""

from .offload_opt import OutOfCoreAdamW
from .optimizer import AdamWConfig, cosine_schedule

__all__ = ["OutOfCoreAdamW", "AdamWConfig", "cosine_schedule"]
