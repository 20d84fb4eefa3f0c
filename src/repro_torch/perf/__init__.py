"""The port's cost model: :mod:`.op_analysis` counts FLOPs, bytes,
collectives, kernel launches and memory of a program op by op (the
counterpart of ``repro.perf``)."""

from .op_analysis import (CostReport, OpCounter, active_counter, extrapolate,
                          record_launch, storage_bytes)

__all__ = ["CostReport", "OpCounter", "active_counter", "extrapolate",
           "record_launch", "storage_bytes"]
