"""Parameter specs: shape + dtype + logical sharding axes, all in one place.

The counterpart of ``repro.models.spec``: every model declares its
parameters as a flat ``dict[str, ParamSpec]`` (names are "/"-joined paths;
scan groups stack a leading "layers" axis).  Dtypes are names
(``"float32"``, ``"bfloat16"``), as in the reference.  From the spec dict
come real initialized parameters (:func:`init_params`); the reference's
``ShapeDtypeStruct`` stand-ins belong to the dry-run (ROADMAP queue A).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np
import torch

__all__ = ["ParamSpec", "init_params", "sub", "add_prefix"]


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


def _fan_in(spec: ParamSpec) -> int:
    """Fan-in for init stddev; skips the stacked layers axis."""
    shape = spec.shape
    if spec.axes and spec.axes[0] == "layers":
        shape = shape[1:]
    if len(shape) >= 2:
        return int(np.prod(shape[:-1]))
    return max(1, shape[0] if shape else 1)


def init_params(specs: Mapping[str, ParamSpec], seed: int, *,
                device: str | torch.device = "cuda",
                dtype_override: Any | None = None,
                block=None) -> dict[str, torch.Tensor]:
    """Deterministic per-name initialization of a spec dict, on ``device``.

    The reference's init kinds and scales: zeros, ones, normal × 0.02
    (``embed``), × 1e-4 (``small``) and × fan_in^-0.5 (``fan_in``), drawn
    in float32 and cast.  Each name draws from its own generator, seeded
    from ``seed`` and the name's sorted index (the reference folds the
    index into its key).  The numbers differ from ``jax.random``'s, so
    parity tests feed both packages the same numpy parameters.
    ``block(name, tensor)``, when given, takes each tensor as it is made
    and its result is kept (a mesh rank's block of it), so no more than one
    whole tensor exists at a time.
    """
    from ..convert import resolve_device  # convert imports nothing of models
    dev = resolve_device(device)
    out: dict[str, torch.Tensor] = {}
    for i, name in enumerate(sorted(specs)):
        spec = specs[name]
        dt = getattr(torch, str(dtype_override or spec.dtype))
        keep = block or (lambda _, t: t)
        if spec.init == "zeros":
            out[name] = keep(name, torch.zeros(spec.shape, dtype=dt,
                                               device=dev))
            continue
        if spec.init == "ones":
            out[name] = keep(name, torch.ones(spec.shape, dtype=dt,
                                              device=dev))
            continue
        std = {"embed": 0.02, "small": 1e-4}.get(spec.init)
        if std is None:  # fan_in
            std = _fan_in(spec) ** -0.5
        gen = torch.Generator(device=dev).manual_seed(
            (seed * 1_000_003 + i) % (1 << 63))
        w = torch.randn(spec.shape, generator=gen, device=dev,
                        dtype=torch.float32)
        # scaled in place: no second float32 tensor of the full size (an
        # expert stack of llama4-maverick is 21.5 GB in float32)
        out[name] = keep(name, w.mul_(std).to(dt))
        del w
    return out


def sub(tree: Mapping[str, Any], prefix: str) -> dict[str, Any]:
    """View of a flat dict under ``prefix/`` with the prefix stripped."""
    p = prefix + "/"
    return {k[len(p):]: v for k, v in tree.items() if k.startswith(p)}


def add_prefix(tree: Mapping[str, Any], prefix: str) -> dict[str, Any]:
    return {f"{prefix}/{k}": v for k, v in tree.items()}
