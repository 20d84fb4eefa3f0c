"""Compression entry points: lossy gradient quantization + lossless wire codec.

The counterpart of ``repro.runtime.compress``.  Two distinct compression
families live behind this module:

* **Lossy** int8 gradient quantization with error feedback (below), as the
  Trainer uses it.
* **Lossless** span/op-train wire codec (re-exported from
  ``repro_torch.core.codec``) used by the mp transport to cut
  control-channel bytes: zero-run suppression, byte RLE, and byte-shuffle
  + RLE, selected per message by a roofline-driven ``CodecPolicy``.  See
  ``repro_torch/core/codec.py`` for the wire format and threshold
  heuristic.

Error feedback keeps the quantization residual locally and re-injects it
next step, which preserves convergence (Karimireddy et al.).  The float32
arithmetic is the reference's, operation for operation; ``torch.round``
rounds half to even, as ``jnp.round`` does, so both packages give the same
bits.
"""

from __future__ import annotations

from typing import Mapping

import torch

from ..core.codec import (CODEC_NAMES, CODEC_RAW, CODEC_RLE, CODEC_SHUF_RLE,
                          CODEC_ZRLE, CodecPolicy, decode_bytes, decode_ops,
                          decode_spans, encode_bytes, encode_ops,
                          encode_spans)

__all__ = ["quantize_int8", "dequantize_int8", "init_error_feedback",
           "compress_with_feedback",
           # lossless wire codec (shared entry points; impl in core/codec.py)
           "CODEC_NAMES", "CODEC_RAW", "CODEC_RLE", "CODEC_SHUF_RLE",
           "CODEC_ZRLE", "CodecPolicy", "encode_bytes", "decode_bytes",
           "encode_spans", "decode_spans", "encode_ops", "decode_ops"]


def quantize_int8(x: torch.Tensor, axis: int | None = None):
    """Symmetric per-tensor (or per-axis) int8 quantization; returns (q,
    scale) with a float32 scale."""
    xf = x.float()
    amax = (xf.abs().amax() if axis is None
            else xf.abs().amax(dim=axis, keepdim=True))
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def init_error_feedback(params: Mapping[str, torch.Tensor]
                        ) -> dict[str, torch.Tensor]:
    return {k: torch.zeros(v.shape, dtype=torch.float32, device=v.device)
            for k, v in params.items()}


def compress_with_feedback(grads: Mapping[str, torch.Tensor],
                           ef: Mapping[str, torch.Tensor]):
    """g_hat = Q(g + e);  e' = g + e - g_hat.  Returns (g_hat, e')."""
    new_g, new_e = {}, {}
    for k, g in grads.items():
        corrected = g.float() + ef[k]
        q, s = quantize_int8(corrected)
        g_hat = dequantize_int8(q, s)
        new_g[k] = g_hat.to(g.dtype)
        new_e[k] = corrected - g_hat
    return new_g, new_e
