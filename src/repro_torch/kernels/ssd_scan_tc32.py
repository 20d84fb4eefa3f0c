"""The Mamba-2 SSD scan on the card for float32 inputs: ``ssd_scan_tc32``.

The counterpart of the JAX package's ``ssd_scan_tpu`` for float32 x, Bm and
C (``csrc/ssd_scan_tc32.cu``): :mod:`.ssd_scan_tc`'s three passes (chunk-
local states, a short sequential pass over the chunks, then each chunk's
output) with every product on the tensor cores as a float32-accurate
product: both operands split into TF32 hi + lo, three TF32 products each,
which the float32 limit of 1e-4 needs.  It runs the scan of every Mamba-2
layer's float32 prefill (the float32 gate) and returns the final state
too; bfloat16 inputs go to :mod:`.ssd_scan_tc`.  :mod:`.ssd_scan` (the CUDA
cores) is the earlier design, kept as a comparator.  The wrapper allocates
the chunk states' scratch.  Its plain PyTorch version is
:func:`repro_torch.kernels.ref.ssd_scan_ref`.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .ssd_scan_tc import count_launch

__all__ = ["CHUNK", "N_MAX", "P_MAX", "launches", "ssd_scan_tc32_cuda"]

#: launches of the kernel (its three passes) made by
#: :func:`ssd_scan_tc32_cuda` (a run that must show it went through the
#: kernel sets this to 0 before and reads it after)
launches = 0

#: the largest state size and head dimension the kernel takes
N_MAX = 128
P_MAX = 64

#: positions per chunk (the kernel's constant L)
CHUNK = 64

_SIGNATURES = {
    "ssd_scan_tc32_launch": (
        [ctypes.c_void_p] * 10 + [ctypes.c_int64] * 20
        + [ctypes.c_void_p], ctypes.c_int),
}

_GRID_YZ = 65535  # largest grid y and z: heads and batch


def ssd_scan_tc32_cuda(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                       Bm: torch.Tensor, C: torch.Tensor):
    """x: (B,H,S,P); dt: (B,H,S); A: (H,); Bm/C: (B,H,S,N), float32 CUDA
    tensors on one device, x, Bm and C with their last dimension
    contiguous, any other strides (0 included); N <= :data:`N_MAX`, P <=
    :data:`P_MAX`.  Returns ``(y (B,H,S,P) float32, h (B,H,N,P)
    float32)``; y is dense in x's order of dimensions.  The caller
    (:func:`repro_torch.kernels.ops.ssd_scan`) has checked the shapes.
    Launches on the current stream and does not synchronise."""
    global launches
    B, H, S, P = x.shape
    N = Bm.shape[-1]
    if not ((x.is_cuda or x.is_meta) and x.device == dt.device == A.device
            == Bm.device == C.device):
        raise ValueError("ssd_scan_tc32_cuda takes its tensors on one CUDA "
                         f"device, got {x.device}, {dt.device}, {A.device}, "
                         f"{Bm.device}, {C.device}")
    if not x.dtype == Bm.dtype == C.dtype == dt.dtype == A.dtype \
            == torch.float32:
        raise ValueError("the float32 tensor-core kernel takes float32, got "
                         f"{x.dtype}, {Bm.dtype}, {C.dtype}, {dt.dtype}, "
                         f"{A.dtype}")
    if N > N_MAX or P > P_MAX:
        raise ValueError(f"state size {N} or head dimension {P} exceeds "
                         f"{N_MAX} / {P_MAX}, which the kernel takes")
    if any(t.stride(-1) != 1 for t in (x, Bm, C)):
        raise ValueError("the kernel needs the last dimension of x, Bm and C "
                         "contiguous")
    if B > _GRID_YZ or H > _GRID_YZ:
        raise ValueError(f"batch {B} or heads {H} exceed one CUDA grid")
    y = torch.empty_like(x, dtype=torch.float32)  # dense, x's dimension order
    if y.numel() == 0:
        return y, torch.zeros((B, H, N, P), dtype=torch.float32,
                              device=x.device)
    nc = -(-S // CHUNK)
    h = torch.empty((B, H, N, P), dtype=torch.float32, device=x.device)
    states = torch.empty((B, H, nc, N, P), dtype=torch.float32,
                         device=x.device)
    hin = torch.empty((B, H, nc, N_MAX * P_MAX), dtype=torch.float32,
                      device=x.device)
    decay = torch.empty((B, H, nc), dtype=torch.float32, device=x.device)
    if x.is_meta:  # the dry-run: the same checks and buffers, no launch
        count_launch("ssd_scan_tc32", x, Bm)
        return y, h
    A = A.contiguous()
    lib = _build.library("ssd_scan_tc32", _SIGNATURES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ssd_scan_tc32_launch(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            C.data_ptr(), y.data_ptr(), h.data_ptr(), states.data_ptr(),
            hin.data_ptr(), decay.data_ptr(), B, H, S, N, P,
            *x.stride()[:3], *dt.stride(), *Bm.stride()[:3], *C.stride()[:3],
            *y.stride()[:3], stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan_tc32: CUDA error {err} at launch")
    launches += 1
    return y, h
