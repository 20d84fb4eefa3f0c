"""Attention on the card in bfloat16: the ``flash_attention_tc`` CUDA kernel.

The counterpart of the JAX package's ``flash_attention_tpu`` for bfloat16
inputs (``csrc/flash_attention_tc.cu``): the same GQA forward as
:mod:`.flash_attention` (causal, sliding-window or full masks, ``t_actual``,
an f32 online softmax with finite -1e30 masking, tiles outside the mask
skipped, strides read in place), with both products on the tensor cores:
Q.K^T in bf16 with float32 accumulation, the score scaled after it, and P.V
with P split into two bf16 parts, so the output stays within float32
rounding.  It takes any head dimensions up to :data:`D_MAX`, a value head
dimension unlike the query's (MLA's prefill: d 192, dv 128) and any strides
(rows that are not whole aligned 16-byte chunks load element by element).
It serves every attention layer's bf16 prefill; float32 inputs go to
:mod:`.flash_attention_tc32`.  Its plain PyTorch version is
:func:`repro_torch.kernels.ref.flash_attention_ref`.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..perf.op_analysis import record_launch
from . import _build

__all__ = ["D_MAX", "attended_pairs", "count_launch",
           "flash_attention_tc_cuda", "launches", "out_like", "work"]

#: kernel launches made by :func:`flash_attention_tc_cuda` (a run that must
#: show it went through the kernel sets this to 0 before and reads it after)
launches = 0

#: the largest head dimension the kernel takes
D_MAX = 256

_SIGNATURES = {
    "flash_attention_tc_launch": (
        [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 22
        + [ctypes.c_float, ctypes.c_void_p], ctypes.c_int),
}

_GRID_YZ = 65535  # largest grid y and z: heads and batch


def attended_pairs(S: int, T: int, *, causal: bool, window: int | None,
                   t_actual: int) -> int:
    """(query, key) pairs the mask keeps, queries and keys both from
    position 0: keys below ``t_actual``, at or before the query if
    ``causal``, fewer than ``window`` positions behind it if given."""
    i = np.arange(S, dtype=np.int64)
    lo = np.zeros(S, np.int64) if window is None else \
        np.maximum(0, i - window + 1)
    hi = np.minimum(i, t_actual - 1) if causal else \
        np.full(S, t_actual - 1, np.int64)
    return int(np.maximum(0, hi - lo + 1).sum())


def work(B: int, H: int, K: int, S: int, T: int, d: int, dv: int, *,
         causal: bool, window: int | None, t_actual: int,
         itemsize: int) -> tuple[int, int]:
    """(FLOP, bytes) of one launch, the least work of the function: both
    products over the attended pairs only, 2·B·H·(d + dv) a pair, and q, k,
    v read and the output written once (``itemsize`` bytes an element).
    The bounds of ``chip_smoke.py`` and the dry-run's counts both read
    this; the float32 kernel does the same work."""
    pairs = attended_pairs(S, T, causal=causal, window=window,
                           t_actual=t_actual)
    return (2 * B * H * (d + dv) * pairs,
            itemsize * (B * H * S * d + B * K * T * (d + dv) + B * H * S * dv))


def count_launch(name: str, q, k, v, *, causal: bool, window: int | None,
                 t_actual: int) -> None:
    """A launch on meta tensors: counted (:func:`work`), nothing run."""
    B, H, S, d = q.shape
    K, T, dv = k.shape[1], k.shape[2], v.shape[3]
    record_launch(name, *work(B, H, K, S, T, d, dv, causal=causal,
                              window=window, t_actual=t_actual,
                              itemsize=q.element_size()))


def out_like(q: torch.Tensor, dv: int) -> torch.Tensor:
    """An empty (B,H,S,dv) tensor laid out as q is: its dimensions in the
    order of q's strides (the model hands the kernel (B,S,H,d) storage
    seen through a transpose, and gets (B,S,H,dv) storage back), the last
    one contiguous.  ``torch.empty_like(q)`` where dv = d."""
    order = sorted(range(3), key=lambda i: -q.stride(i)) + [3]
    shape = [q.shape[i] for i in order[:3]] + [dv]
    out = q.new_empty(shape)
    return out.permute(*[order.index(i) for i in range(4)])


def flash_attention_tc_cuda(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, causal: bool,
                            window: int | None, scale: float,
                            t_actual: int) -> torch.Tensor:
    """q: (B,H,S,d), k: (B,K,T,d), v: (B,K,T,dv) bfloat16 CUDA tensors,
    the last dimension contiguous, any other strides, d and dv up to
    :data:`D_MAX`.  Returns (B,H,S,dv) bfloat16, laid out as q
    (:func:`out_like`).  The caller
    (:func:`repro_torch.kernels.ops.flash_attention`) has checked shapes,
    ``window`` and ``t_actual``.  Launches on the current stream and does
    not synchronise."""
    global launches
    B, H, S, d = q.shape
    K, T, dv = k.shape[1], k.shape[2], v.shape[3]
    if not ((q.is_cuda or q.is_meta) and q.device == k.device == v.device):
        raise ValueError("flash_attention_tc_cuda takes q, k, v on one CUDA "
                         f"device, got {q.device}, {k.device}, {v.device}")
    if not q.dtype == k.dtype == v.dtype == torch.bfloat16:
        raise ValueError("the tensor-core kernel takes bfloat16, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if max(d, dv) > D_MAX:
        raise ValueError(f"head dimensions {d}, {dv}: more than {D_MAX}, "
                         "which the kernel does not take")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("the kernel needs the head dimension contiguous")
    if B > _GRID_YZ or H > _GRID_YZ:
        raise ValueError(f"batch {B} or heads {H} exceed one CUDA grid")
    out = out_like(q, dv)
    if out.stride(-1) != 1:
        raise ValueError("the output's head dimension must be contiguous")
    if out.numel() == 0:
        return out
    if q.is_meta:  # the dry-run: the same checks and buffers, no launch
        count_launch("flash_attention_tc", q, k, v, causal=causal,
                     window=window, t_actual=t_actual)
        return out
    lib = _build.library("flash_attention_tc", _SIGNATURES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.flash_attention_tc_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, H, S, T, d, dv, H // K,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *out.stride()[:3],
            int(causal), 0 if window is None else window, t_actual,
            scale, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_tc: CUDA error {err} at launch")
    launches += 1
    return out
