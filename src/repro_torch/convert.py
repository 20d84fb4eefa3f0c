"""Numpy <-> torch trees, dtype names, and the device rule.

State crosses between the two packages of this repository as numpy arrays:
the JAX package's parameter and optimizer trees are flat ``{name: ndarray}``
dicts.  :func:`tree_from_numpy` turns such a tree into tensors on a device,
:func:`tree_to_numpy` turns tensors back.  bfloat16 has no numpy dtype of
its own (the JAX package uses ``ml_dtypes.bfloat16``, which this package
does not import), so it crosses through a same-width int16 view in both
directions: the bits never go through float32.

Dtypes are matched by name and item size (:func:`dtype_matches`), which
works for bfloat16 on both sides without a numpy bfloat16 type.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

__all__ = ["dtype_name", "dtype_matches", "resolve_device", "to_host_f32",
           "tree_from_numpy", "tree_to_numpy"]


def dtype_name(dtype: Any) -> str:
    """``"float32"``, ``"bfloat16"``, ... for a torch or numpy dtype."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return np.dtype(dtype).name


def _itemsize(dtype: Any) -> int:
    if isinstance(dtype, torch.dtype):
        return dtype.itemsize
    return np.dtype(dtype).itemsize


def dtype_matches(a: Any, b: Any) -> bool:
    """True when two dtypes (torch or numpy, in any mix) are the same type:
    the same name and the same item size."""
    return dtype_name(a) == dtype_name(b) and _itemsize(a) == _itemsize(b)


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point allocates on; ``"cuda"`` unless the caller
    asks for another.  Raises when CUDA is asked for and absent: nothing in
    this package falls back to the CPU on its own."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available; pass "
            "device='cpu' to run on the CPU")
    return dev


def _is_bf16(a: np.ndarray) -> bool:
    return a.dtype.name == "bfloat16" and a.dtype.itemsize == 2


def tree_from_numpy(tree: Mapping[str, Any],
                    device: str | torch.device = "cuda") -> dict:
    """``{name: ndarray}`` -> ``{name: tensor}`` on ``device`` (copies).

    A bfloat16 array (``ml_dtypes.bfloat16``, any numpy dtype named
    ``bfloat16``) becomes a ``torch.bfloat16`` tensor with the same bits."""
    dev = resolve_device(device)
    out = {}
    for k, v in tree.items():
        a = np.array(v, order="C")  # a private, writable copy
        if _is_bf16(a):
            t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(a)
        out[k] = t.to(dev)
    return out


def tree_to_numpy(tree: Mapping[str, torch.Tensor]) -> dict:
    """``{name: tensor}`` -> ``{name: ndarray}`` on the host (copies).

    bfloat16 tensors come back as their bits, a ``uint16`` array; a caller
    with ``ml_dtypes`` views it as ``ml_dtypes.bfloat16``."""
    out = {}
    for k, t in tree.items():
        t = t.detach()
        if t.dtype == torch.bfloat16:
            bits = t.view(torch.int16).to("cpu", copy=True).numpy()
            out[k] = bits.view(np.uint16)
        else:
            out[k] = t.to("cpu", copy=True).numpy()
    return out


def to_host_f32(x: torch.Tensor) -> np.ndarray:
    """A tensor on any device as a float32 numpy array on the host (bf16
    widens exactly)."""
    return x.detach().to("cpu", torch.float32).numpy()
