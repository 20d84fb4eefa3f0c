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
:func:`exact_float32` keeps float32 products in float32 on the card, for
the serving engine and the trainer alike.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

__all__ = ["dtype_name", "dtype_matches", "exact_float32", "params_from_numpy",
           "resolve_device", "tensor_from_stored", "to_host_f32",
           "tree_from_numpy", "tree_to_numpy"]


def exact_float32() -> None:
    """Float32 products stay float32 on the card.  TF32 keeps about three
    decimal digits, which would break the float32 parity with the
    reference (PyTorch turns TF32 off for matmul but on for cuDNN by
    default; both are set here, for the whole process)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def dtype_name(dtype: Any) -> str:
    """``"float32"``, ``"bfloat16"``, ... for a torch or numpy dtype, or a
    name (``"bfloat16"`` needs no numpy type)."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    if isinstance(dtype, str) and dtype == "bfloat16":
        return dtype
    return np.dtype(dtype).name


def _itemsize(dtype: Any) -> int:
    if isinstance(dtype, torch.dtype):
        return dtype.itemsize
    if isinstance(dtype, str) and dtype == "bfloat16":
        return 2
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


def tensor_from_stored(a: np.ndarray, dtype: Any,
                       device: str | torch.device = "cuda") -> torch.Tensor:
    """An array read back from a window slot of ``dtype`` -- a bfloat16
    slot stores its bits as ``uint16`` -- as a tensor of that dtype on
    ``device``.  ``a`` is the caller's private copy (``Window.get`` returns
    one): on the CPU the tensor shares its memory, so a restored tree is
    not held twice on the host."""
    a = np.asarray(a, order="C")
    if dtype_name(dtype) == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(resolve_device(device))


def params_from_numpy(cfg, tree: Mapping[str, Any],
                      device: str | torch.device = "cuda") -> dict:
    """A JAX parameter tree (``{name: ndarray}``, bf16 as ``ml_dtypes``
    arrays) as tensors on ``device``, after checking it against
    ``param_specs(cfg)``: the same names, and for each the shape and dtype
    of its spec.  Raises ``ValueError`` on any mismatch."""
    from .models import param_specs  # models imports this module
    specs = param_specs(cfg)
    missing, extra = sorted(set(specs) - set(tree)), sorted(set(tree) - set(specs))
    if missing or extra:
        raise ValueError(f"parameter names differ from param_specs: missing "
                         f"{missing}, unexpected {extra}")
    for name, spec in specs.items():
        a = np.asarray(tree[name])
        if tuple(a.shape) != tuple(spec.shape) or not dtype_matches(
                a.dtype, spec.dtype):
            raise ValueError(f"{name}: {a.shape} {dtype_name(a.dtype)}, but "
                             f"the spec is {spec.shape} {spec.dtype}")
    return tree_from_numpy(tree, device)
