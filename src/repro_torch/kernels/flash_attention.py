"""Attention on the card in float32: the ``flash_attention`` CUDA kernel.

The counterpart of the JAX package's ``flash_attention_tpu`` for float32
inputs (``csrc/flash_attention.cu``, float32 FMAs on the CUDA cores, which
the float32 limit of 2e-5 needs): the GQA attention forward with a causal,
sliding-window or full mask, keys at or past ``t_actual`` masked, an f32
online softmax with finite -1e30 masking, and key tiles outside the mask
skipped.  It is the earlier float32 design, on no path since float32
inputs go to :mod:`.flash_attention_tc32` (the tensor cores); it stays as a
comparator that ``chip_smoke.py`` holds to its plain version and times
beside its successor.  The kernel reads
its inputs through their strides, so a (B,S,H,d) tensor viewed as
(B,H,S,d) is read in place, and it masks ragged lengths itself: nothing is
padded or copied.  Its plain PyTorch version is
:func:`repro_torch.kernels.ref.flash_attention_ref`.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["D_MAX", "flash_attention_cuda", "launches"]

#: kernel launches made by :func:`flash_attention_cuda` (a run that must
#: show it went through the kernel sets this to 0 before and reads it after)
launches = 0

#: the largest head dimension the kernel takes
D_MAX = 256

_SIGNATURES = {
    "flash_attention_launch": (
        [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 21
        + [ctypes.c_float, ctypes.c_void_p], ctypes.c_int),
}

_GRID_YZ = 65535  # largest grid y and z: heads and batch


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool, window: int | None, scale: float,
                         t_actual: int) -> torch.Tensor:
    """q: (B,H,S,d); k/v: (B,K,T,d) float32 CUDA tensors, the last dimension
    contiguous, any other strides.  Returns (B,H,S,d) float32, with q's
    strides where q is dense.  The caller
    (:func:`repro_torch.kernels.ops.flash_attention`) has checked shapes,
    ``window`` and ``t_actual``.  Launches on the current stream and does
    not synchronise."""
    global launches
    B, H, S, d = q.shape
    K, T = k.shape[1], k.shape[2]
    if v.shape[3] != d:
        raise ValueError(f"the CUDA-core comparator takes one head dimension "
                         f"for q, k and v, got d {d} and dv {v.shape[3]}: a "
                         "value head dimension unlike the query's goes to "
                         "the tensor-core kernels")
    if not (q.is_cuda and q.device == k.device == v.device):
        raise ValueError("flash_attention_cuda takes q, k, v on one CUDA "
                         f"device, got {q.device}, {k.device}, {v.device}")
    if not q.dtype == k.dtype == v.dtype == torch.float32:
        raise ValueError("the CUDA-core kernel takes float32, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if d > D_MAX:
        raise ValueError(f"head dimension {d} > {D_MAX}, which the kernel "
                         "does not take")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("the kernel needs the head dimension contiguous")
    if B > _GRID_YZ or H > _GRID_YZ:
        raise ValueError(f"batch {B} or heads {H} exceed one CUDA grid")
    out = torch.empty_like(q)  # q's strides when q is dense
    if out.numel() == 0:
        return out
    lib = _build.library("flash_attention", _SIGNATURES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, H, S, T, d, H // K,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *out.stride()[:3],
            int(causal), 0 if window is None else window, t_actual,
            scale, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention: CUDA error {err} at launch")
    launches += 1
    return out
