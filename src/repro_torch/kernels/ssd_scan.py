"""The Mamba-2 SSD scan on the card in float32: the ``ssd_scan`` CUDA kernel.

The counterpart of the JAX package's ``ssd_scan_tpu`` for float32 x, Bm
and C (``csrc/ssd_scan.cu``, float32 FMAs on the CUDA cores): the chunked
SSD scan with the (N,P) state carried across chunks in float32.  It is the
earlier float32 design, on no path since float32 inputs go to
:mod:`.ssd_scan_tc32` (the tensor cores); it stays as a comparator that
``chip_smoke.py`` holds to its plain version and times beside its
successor.  It also returns the final
state, which the TPU kernel drops and the decode cache needs.  The kernel
reads its inputs through their strides (x as a view of the model's (B,S,H,P)
activations, Bm and C broadcast over heads with a head stride of 0) and
masks a ragged last chunk itself: nothing is padded or copied.  Its plain
PyTorch version is :func:`repro_torch.kernels.ref.ssd_scan_ref`.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["CHUNK", "N_MAX", "P_MAX", "launches", "ssd_scan_cuda"]

#: kernel launches made by :func:`ssd_scan_cuda` (a run that must show it
#: went through the kernel sets this to 0 before and reads it after)
launches = 0

#: the largest state size and head dimension the kernel takes
N_MAX = 128
P_MAX = 64

#: positions per chunk of the kernel (``kL`` in ``csrc/ssd_scan.cu``)
CHUNK = 64

_SIGNATURES = {
    "ssd_scan_launch": (
        [ctypes.c_void_p] * 7 + [ctypes.c_int64] * 20
        + [ctypes.c_void_p], ctypes.c_int),
}

_GRID_Y = 65535  # largest grid y: batch


def ssd_scan_cuda(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                  Bm: torch.Tensor, C: torch.Tensor):
    """x: (B,H,S,P); dt: (B,H,S); A: (H,); Bm/C: (B,H,S,N), CUDA tensors on
    one device.  x, Bm and C are float32 with
    their last dimension contiguous, any other strides (0 included); dt and
    A are float32.  Returns ``(y (B,H,S,P) float32, h (B,H,N,P) float32)``;
    y is dense in x's order of dimensions (the model's (B,S,H,P) storage
    for its view of it).  The caller
    (:func:`repro_torch.kernels.ops.ssd_scan`) has checked the shapes.
    Launches on the current stream and does not synchronise."""
    global launches
    B, H, S, P = x.shape
    N = Bm.shape[-1]
    if not (x.is_cuda and x.device == dt.device == A.device == Bm.device
            == C.device):
        raise ValueError("ssd_scan_cuda takes its tensors on one CUDA device, "
                         f"got {x.device}, {dt.device}, {A.device}, "
                         f"{Bm.device}, {C.device}")
    if not x.dtype == Bm.dtype == C.dtype == torch.float32:
        raise ValueError("the CUDA-core kernel takes float32 x, Bm, C, got "
                         f"{x.dtype}, {Bm.dtype}, {C.dtype}")
    if not (dt.dtype == A.dtype == torch.float32):
        raise ValueError(f"dt and A must be float32, got {dt.dtype}, {A.dtype}")
    if N > N_MAX or P > P_MAX:
        raise ValueError(f"state size {N} or head dimension {P} exceeds "
                         f"{N_MAX} / {P_MAX}, which the kernel takes")
    if any(t.stride(-1) != 1 for t in (x, Bm, C)):
        raise ValueError("the kernel needs the last dimension of x, Bm and C "
                         "contiguous")
    if B > _GRID_Y:
        raise ValueError(f"batch {B} exceeds one CUDA grid")
    y = torch.empty_like(x, dtype=torch.float32)  # dense, x's dimension order
    if y.numel() == 0:
        return y, torch.zeros((B, H, N, P), dtype=torch.float32,
                              device=x.device)
    h = torch.empty((B, H, N, P), dtype=torch.float32, device=x.device)
    A = A.contiguous()
    lib = _build.library("ssd_scan", _SIGNATURES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ssd_scan_launch(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            C.data_ptr(), y.data_ptr(), h.data_ptr(), B, H, S, N, P,
            *x.stride()[:3], *dt.stride(), *Bm.stride()[:3], *C.stride()[:3],
            *y.stride()[:3], stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan: CUDA error {err} at launch")
    launches += 1
    return y, h
