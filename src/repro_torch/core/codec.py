"""Lossless span/op-train wire codec for the remote transport backends.

This package's own copy of ``repro.core.codec``: the wire format, the
codec choice and the policy are the reference's, byte for byte, so a blob
encoded by either package decodes under the other.

Selective sync already ships only *changed* bytes; this module makes each
boundary crossing scale with the *entropy* of those bytes.  Origins encode
masked-span payloads and aggregated op trains before they enter the control
channel; the owner decodes before applying, so the on-disk layout stays
byte-identical to the uncompressed path (crash-recovery artifacts remain
cross-compatible, raw or encoded).  The in-process backends (``inproc``,
``ranklocal``, the ``mp`` transport's shared-memory handles) never encode:
there is no wire to save.

Wire format
-----------
An encoded message replaces the raw payload with a tagged tuple (the tuple
still rides the existing pickle channel, so no framing changes):

* spans:  ``("enc1",   codec_id, [(offset, nbytes), ...], blob)``
* ops:    ``("encops1", codec_id, stripped_ops,           blob)``

``stripped_ops`` is the op train with every ``("put", off, bytes)`` replaced
by ``("put", off, nbytes)``; the put payloads are concatenated in op order
and compressed into ``blob`` (non-put ops pass through untouched).  For
spans, the per-span payloads are concatenated in list order.  Raw fallback
is itself recorded in the header: ``codec_id == CODEC_RAW`` with ``blob``
holding the unmodified concatenation, so the receiver never guesses.

``blob`` is self-describing (all fields little-endian):

* byte 0: codec id
* ``CODEC_RAW``      (0): ``<Q`` orig_len, then the raw bytes.
* ``CODEC_ZRLE``     (1): zero-run suppression.  ``<Q`` orig_len, ``<H``
  granule, ``packbits`` bitmap of nonzero granules, then the nonzero
  granules back to back (last granule zero-padded; decode trims).
* ``CODEC_RLE``      (2): byte run-length.  ``<Q`` orig_len, ``<I`` nruns,
  ``nruns`` value bytes, ``nruns`` ``<u2`` run lengths (runs longer than
  65535 are split).
* ``CODEC_SHUF_RLE`` (3): byte shuffle then RLE.  ``<Q`` orig_len, ``<B``
  stride, ``<I`` nruns, values, lengths.  The first
  ``orig_len - orig_len % stride`` bytes are transposed ``(n/stride,
  stride) -> (stride, n/stride)`` before RLE -- a pure permutation, so the
  codec stays bit-exact for arbitrary payloads (NaN bit patterns included);
  it clusters the slowly-varying high bytes of fixed-width values into
  long runs.  The un-shuffled tail is appended before RLE.

Threshold heuristic (roofline)
------------------------------
Encoding only pays when the wire time it saves exceeds the CPU time it
costs.  ``CodecPolicy`` keeps two EWMAs -- measured codec throughput
(bytes/s, updated on every encode) and the achieved save ratio
``1 - wire/logical`` -- and encodes a message of ``n`` bytes only when

    predicted saving   n * save_ratio / wire_bps
  > predicted cost     n / encode_bps

i.e. ``save_ratio > wire_bps / encode_bps``.  On incompressible traffic the
save ratio decays toward zero and the policy stops encoding (raw list goes
out untagged, zero overhead) except for one probe message every
``probe_every`` sends, so a workload that turns compressible is re-detected.
Messages under ``min_bytes`` (``MIN_BYTES`` unless the caller says
otherwise) are never encoded; ``wire_bps`` is ``WIRE_BPS``.  ``REPRO_CODEC``
overrides: ``off`` disables encoding entirely, ``force`` skips the roofline
check (useful for deterministic benchmarks).
"""

from __future__ import annotations

import os
import struct
import threading
import time

import numpy as np

__all__ = [
    "CODEC_RAW", "CODEC_ZRLE", "CODEC_RLE", "CODEC_SHUF_RLE", "CODEC_NAMES",
    "CodecPolicy", "WireStats", "encode_bytes", "decode_bytes",
    "encode_spans", "decode_spans", "is_encoded_spans",
    "encode_ops", "decode_ops", "is_encoded_ops",
]

CODEC_RAW = 0
CODEC_ZRLE = 1
CODEC_RLE = 2
CODEC_SHUF_RLE = 3
CODEC_NAMES = {CODEC_RAW: "raw", CODEC_ZRLE: "zrle", CODEC_RLE: "rle",
               CODEC_SHUF_RLE: "shuf-rle"}

_SPANS_TAG = "enc1"
_OPS_TAG = "encops1"

_GRANULE = 64          # zero-suppression granule (bytes)
_STRIDE = 8            # byte-shuffle stride (covers f32/f64/int8..int64)
_MAX_RUN = 0xFFFF


def _as_u8(data) -> np.ndarray:
    if isinstance(data, np.ndarray):
        a = np.ascontiguousarray(data)
        return a.view(np.uint8).ravel()
    return np.frombuffer(data, np.uint8)


# ---------------------------------------------------------------- codecs

def _zrle_encode(u8: np.ndarray) -> bytes:
    n = u8.size
    pad = (-n) % _GRANULE
    if pad:
        u8 = np.concatenate([u8, np.zeros(pad, np.uint8)])
    rows = u8.reshape(-1, _GRANULE)
    nz = rows.any(axis=1)
    bitmap = np.packbits(nz)
    return (struct.pack("<BQH", CODEC_ZRLE, n, _GRANULE)
            + bitmap.tobytes() + rows[nz].tobytes())


def _zrle_decode(blob: bytes) -> np.ndarray:
    n, gran = struct.unpack_from("<QH", blob, 1)
    off = 11
    ngr = -(-n // gran) if n else 0
    nbm = (ngr + 7) // 8
    nz = np.unpackbits(np.frombuffer(blob, np.uint8, nbm, off),
                       count=ngr).astype(bool)
    off += nbm
    k = int(nz.sum())
    out = np.zeros(ngr * gran, np.uint8)
    if k:
        body = np.frombuffer(blob, np.uint8, k * gran, off)
        out.reshape(-1, gran)[nz] = body.reshape(-1, gran)
    return out[:n]


def _rle_runs(u8: np.ndarray):
    n = u8.size
    if n == 0:
        return np.zeros(0, np.uint8), np.zeros(0, "<u2")
    change = np.flatnonzero(np.diff(u8)) + 1
    starts = np.concatenate(([0], change))
    ends = np.concatenate((change, [n]))
    lens = (ends - starts).astype(np.int64)
    vals = u8[starts]
    if lens.max() > _MAX_RUN:
        reps = -(-lens // _MAX_RUN)
        vals = np.repeat(vals, reps)
        full = np.full(int(reps.sum()), _MAX_RUN, np.int64)
        full[np.cumsum(reps) - 1] = lens - (reps - 1) * _MAX_RUN
        lens = full
    return vals.astype(np.uint8), lens.astype("<u2")


def _rle_expand(vals: np.ndarray, lens: np.ndarray) -> np.ndarray:
    return np.repeat(vals, lens.astype(np.int64))


def _rle_encode(u8: np.ndarray) -> bytes:
    vals, lens = _rle_runs(u8)
    return (struct.pack("<BQI", CODEC_RLE, u8.size, vals.size)
            + vals.tobytes() + lens.tobytes())


def _rle_decode(blob: bytes) -> np.ndarray:
    n, nruns = struct.unpack_from("<QI", blob, 1)
    off = 13
    vals = np.frombuffer(blob, np.uint8, nruns, off)
    lens = np.frombuffer(blob, "<u2", nruns, off + nruns)
    out = _rle_expand(vals, lens)
    assert out.size == n
    return out


def _shuffle(u8: np.ndarray, stride: int) -> np.ndarray:
    m = (u8.size // stride) * stride
    head = u8[:m].reshape(-1, stride).T.ravel()
    return np.concatenate([head, u8[m:]]) if m < u8.size else head


def _unshuffle(u8: np.ndarray, stride: int) -> np.ndarray:
    m = (u8.size // stride) * stride
    head = u8[:m].reshape(stride, -1).T.ravel()
    return np.concatenate([head, u8[m:]]) if m < u8.size else head


def _shuf_rle_encode(u8: np.ndarray, shuffled: np.ndarray | None = None
                     ) -> bytes:
    if shuffled is None:
        shuffled = _shuffle(u8, _STRIDE)
    vals, lens = _rle_runs(shuffled)
    return (struct.pack("<BQBI", CODEC_SHUF_RLE, u8.size, _STRIDE, vals.size)
            + vals.tobytes() + lens.tobytes())


def _shuf_rle_decode(blob: bytes) -> np.ndarray:
    n, stride, nruns = struct.unpack_from("<QBI", blob, 1)
    off = 14
    vals = np.frombuffer(blob, np.uint8, nruns, off)
    lens = np.frombuffer(blob, "<u2", nruns, off + nruns)
    out = _unshuffle(_rle_expand(vals, lens), stride)
    assert out.size == n
    return out


def encode_bytes(data, codec: int | None = None) -> bytes:
    """Encode a byte payload into a self-describing blob.

    With ``codec=None``, cheap single-pass statistics (zero-granule count,
    run count) predict each candidate's size; the smallest actual encoding
    wins, and anything that cannot beat ~7/8 of the raw size falls back to
    ``CODEC_RAW`` (original bytes behind a 9-byte header).
    """
    u8 = _as_u8(data)
    n = u8.size
    if codec is not None:
        if codec == CODEC_ZRLE:
            return _zrle_encode(u8)
        if codec == CODEC_RLE:
            return _rle_encode(u8)
        if codec == CODEC_SHUF_RLE:
            return _shuf_rle_encode(u8)
        return struct.pack("<BQ", CODEC_RAW, n) + u8.tobytes()
    limit = n - (n >> 3)  # must beat 7/8 of raw
    best = None
    if n:
        pad = (-n) % _GRANULE
        ngr = (n + pad) // _GRANULE
        padded = np.concatenate([u8, np.zeros(pad, np.uint8)]) if pad else u8
        nz_granules = int(padded.reshape(-1, _GRANULE).any(axis=1).sum())
        if 11 + (ngr + 7) // 8 + nz_granules * _GRANULE < limit:
            best = _zrle_encode(u8)
        nruns = int(np.count_nonzero(np.diff(u8))) + 1
        if 13 + 3 * nruns < limit and (best is None or 13 + 3 * nruns < len(best)):
            cand = _rle_encode(u8)
            if best is None or len(cand) < len(best):
                best = cand
        if best is None and n >= _STRIDE * 4:
            # every run costs 3 bytes, so the shuffled run count bounds the
            # blob from below: runs that cannot beat the limit are never
            # built (on incompressible bytes their int64 arrays would take
            # many times the payload), and the choice stays the same
            shuffled = _shuffle(u8, _STRIDE)
            sruns = int(np.count_nonzero(np.diff(shuffled))) + 1
            if 14 + 3 * sruns < limit:
                cand = _shuf_rle_encode(u8, shuffled)
                if len(cand) < limit:
                    best = cand
    if best is not None and len(best) < limit:
        return best
    return struct.pack("<BQ", CODEC_RAW, n) + u8.tobytes()


def decode_bytes(blob) -> np.ndarray:
    """Inverse of :func:`encode_bytes`; returns a ``uint8`` array."""
    blob = bytes(blob) if not isinstance(blob, (bytes, bytearray)) else blob
    cid = blob[0]
    if cid == CODEC_RAW:
        n, = struct.unpack_from("<Q", blob, 1)
        return np.frombuffer(blob, np.uint8, n, 9)
    if cid == CODEC_ZRLE:
        return _zrle_decode(blob)
    if cid == CODEC_RLE:
        return _rle_decode(blob)
    if cid == CODEC_SHUF_RLE:
        return _shuf_rle_decode(blob)
    raise ValueError(f"unknown codec id {cid}")


# ---------------------------------------------------------------- policy

MIN_BYTES = 1024   # messages below this are never encoded
WIRE_BPS = 1e9     # the channel rate the roofline check assumes

class CodecPolicy:
    """Roofline-driven per-message encode decision + throughput telemetry.

    See the module docstring for the heuristic.  Thread-safe: remote
    segments on many progress threads share one policy per transport.
    """

    _ALPHA = 0.2

    def __init__(self, *, min_bytes: int = MIN_BYTES, probe_every: int = 32):
        mode = os.environ.get("REPRO_CODEC", "auto").lower()
        self.mode = mode if mode in ("off", "force", "auto") else "auto"
        self.min_bytes = int(min_bytes)
        self.wire_bps = WIRE_BPS
        self.probe_every = max(1, int(probe_every))
        self._encode_bps = 4e9   # optimistic until measured
        self._save_ratio = 0.5   # optimistic until measured
        self._sends = 0
        self._lock = threading.Lock()

    def should_encode(self, nbytes: int) -> bool:
        if self.mode == "off" or nbytes < self.min_bytes:
            return False
        if self.mode == "force":
            return True
        with self._lock:
            self._sends += 1
            if self._sends % self.probe_every == 0:
                return True
            return self._save_ratio > self.wire_bps / self._encode_bps

    def record(self, logical: int, wire: int, dt: float) -> None:
        if logical <= 0:
            return
        ratio = max(0.0, 1.0 - wire / logical)
        bps = logical / max(dt, 1e-9)
        with self._lock:
            a = self._ALPHA
            self._save_ratio += a * (ratio - self._save_ratio)
            self._encode_bps += a * (bps - self._encode_bps)

    def snapshot(self) -> dict:
        with self._lock:
            return {"mode": self.mode, "save_ratio": self._save_ratio,
                    "encode_bps": self._encode_bps, "sends": self._sends}


class WireStats:
    """Logical-vs-wire byte telemetry for an encoding transport.

    ``logical`` bytes are what the application shipped (span/put payload
    sizes before encoding); ``wire`` bytes are what actually entered the
    control channel.  Raw-fallback messages count into both with
    ``wire == logical``.  Thread-safe (progress/flush threads share one
    instance per transport).
    """

    _KEYS = ("spans_logical_bytes", "spans_wire_bytes", "spans_msgs",
             "spans_encoded_msgs", "ops_logical_bytes", "ops_wire_bytes",
             "ops_msgs", "ops_encoded_msgs")

    def __init__(self):
        self._lock = threading.Lock()
        self._c = {k: 0 for k in self._KEYS}

    def add(self, kind: str, logical: int, wire: int, encoded: bool) -> None:
        with self._lock:
            self._c[f"{kind}_logical_bytes"] += int(logical)
            self._c[f"{kind}_wire_bytes"] += int(wire)
            self._c[f"{kind}_msgs"] += 1
            if encoded:
                self._c[f"{kind}_encoded_msgs"] += 1

    def snapshot(self) -> dict:
        with self._lock:
            out = dict(self._c)
        out["logical_bytes"] = (out["spans_logical_bytes"]
                                + out["ops_logical_bytes"])
        out["wire_bytes"] = out["spans_wire_bytes"] + out["ops_wire_bytes"]
        return out


# ------------------------------------------------------- message helpers

def encode_spans(spans, policy: CodecPolicy | None):
    """Masked-span payload -> encoded wire tuple, or ``None`` to send raw.

    ``spans`` is the raw wire payload ``[(offset, bytes-like), ...]``.
    Returns ``(payload, logical_bytes, wire_bytes)``; ``payload is None``
    means the policy declined and the caller ships the raw list.
    """
    bufs = [_as_u8(d) for _, d in spans]
    logical = int(sum(b.size for b in bufs))
    if policy is None or not policy.should_encode(logical):
        return None, logical, logical
    t0 = time.perf_counter()
    blob = encode_bytes(np.concatenate(bufs) if bufs else
                        np.zeros(0, np.uint8))
    policy.record(logical, len(blob), time.perf_counter() - t0)
    meta = [(int(off), int(b.size)) for (off, _), b in zip(spans, bufs)]
    return (_SPANS_TAG, blob[0], meta, blob), logical, len(blob)


def is_encoded_spans(payload) -> bool:
    return (isinstance(payload, tuple) and len(payload) == 4
            and payload[0] == _SPANS_TAG)


def decode_spans(payload):
    """Encoded wire tuple -> raw span list ``[(offset, uint8 array)]``."""
    _, _cid, meta, blob = payload
    data = decode_bytes(blob)
    out, off = [], 0
    for o, ln in meta:
        out.append((o, data[off:off + ln]))
        off += ln
    return out


def encode_ops(ops, policy: CodecPolicy | None):
    """Wire-form op train -> encoded tuple, or ``None`` to send raw.

    Only ``put`` payload bytes are compressed (they dominate aggregated
    trains); get/acc/gacc/cas ops pass through verbatim inside the header.
    Returns ``(payload, logical_bytes, wire_bytes)`` like
    :func:`encode_spans`; ``logical_bytes`` counts put bytes only.
    """
    bufs, stripped = [], []
    for op in ops:
        if op[0] == "put":
            b = _as_u8(op[2])
            bufs.append(b)
            stripped.append(("put", op[1], int(b.size)))
        else:
            stripped.append(op)
    logical = int(sum(b.size for b in bufs))
    if policy is None or not bufs or not policy.should_encode(logical):
        return None, logical, logical
    t0 = time.perf_counter()
    blob = encode_bytes(np.concatenate(bufs))
    policy.record(logical, len(blob), time.perf_counter() - t0)
    return (_OPS_TAG, blob[0], stripped, blob), logical, len(blob)


def is_encoded_ops(payload) -> bool:
    return (isinstance(payload, tuple) and len(payload) == 4
            and payload[0] == _OPS_TAG)


def decode_ops(payload):
    """Encoded op-train tuple -> raw wire-form op list."""
    _, _cid, stripped, blob = payload
    data = decode_bytes(blob)
    out, off = [], 0
    for op in stripped:
        if op[0] == "put":
            ln = op[2]
            out.append(("put", op[1], data[off:off + ln].tobytes()))
            off += ln
        else:
            out.append(op)
    return out
