"""Parameter specs: shape + dtype + logical sharding axes, all in one place.

The counterpart of ``repro.models.spec``, trimmed to the spec itself: every
model declares its parameters as a flat ``dict[str, ParamSpec]`` (names are
"/"-joined paths; scan groups stack a leading "layers" axis).  Dtypes are
names (``"float32"``, ``"bfloat16"``), as in the reference; parameter
initialization waits for the dense-model slice.
"""

from __future__ import annotations

import dataclasses
from typing import Any

__all__ = ["ParamSpec"]


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    dtype: Any
    axes: tuple[str | None, ...]  # logical axes, len == len(shape)
    init: str = "fan_in"          # fan_in | zeros | ones | embed | small

    def __post_init__(self):
        if len(self.axes) != len(self.shape):
            raise ValueError(f"axes {self.axes} rank != shape {self.shape}")

    def stack(self, reps: int) -> "ParamSpec":
        """Add a leading scan ("layers") axis."""
        return ParamSpec((reps,) + self.shape, self.dtype,
                         ("layers",) + self.axes, self.init)
