"""Runtime RMA sanitizer: shadow-state checking for window transports.

``REPRO_SANITIZE=1`` makes :func:`repro_torch.core.transport.make_transport`
wrap the built backend in a :class:`WindowSanitizer` -- a transparent
proxy that mirrors the *epoch* state the transport itself never
validates: which byte ranges of each segment are covered by
posted-but-unconfirmed op trains (``op_batch(..., defer=True)`` returned
``None``), and which segments have been freed.  Against that shadow
state it checks the MPI RMA access rules the paper's storage-window
model inherits:

``put-put-conflict``
    a blocking put / masked span write / new train overlapping bytes
    covered by a *different* posted train in the same epoch (in-train
    overlap is NOT flagged: a train is one batch applied in list order
    under one service-lock acquisition, so its internal order is
    defined -- see ``test_batched_ops_fifo_parity``).
``put-get-no-flush``
    a blocking get (or in-batch read op) overlapping a posted train's
    write set with no intervening ``op_complete``/``barrier`` -- the
    read can observe pre-train bytes.
``atomic-in-train``
    an atomic (``accumulate``/``get_accumulate``/``compare_and_swap``)
    overlapping a posted train: atomicity is only guaranteed against
    other atomics, not against an un-flushed bulk train.
``use-after-free``
    any one-sided op on a segment whose ``close()`` already ran.
``flush-order``
    ``seg.close()`` or transport ``shutdown()`` while posted trains are
    still unconfirmed -- completion (and its deferred errors) must be
    observed before teardown (errors-at-flush discipline).

Completion points that clear a segment's pending trains: a successful
*or failing* ``op_complete`` (failover replays the train via a replying
``op_batch``, which leaves no shadow residue) and ``barrier`` (the
documented whole-world completion point -- channel-FIFO under mp).

The three data-hazard checks (``put-put-conflict``, ``put-get-no-flush``,
``atomic-in-train``) enforce the *portable* MPI model, where a posted
train's application at the target is unordered with respect to later
one-sided ops.  Every current backend is stronger: it declares
``Transport.ordered_channels`` -- all traffic from one origin to one
target rides a single FIFO channel, so a later op applies strictly after
every earlier posted train (this is exactly what makes the conformance
suite's rput -> wait -> rget pipeline well-defined without a flush).  On
such transports the data hazards cannot occur and the checks are
skipped; set ``REPRO_SANITIZE_PORTABLE=1`` to enforce the portable model
anyway and flag code that would break on a reordering fabric.
``use-after-free`` and ``flush-order`` are checked everywhere --
channel ordering never excuses an unobserved epoch.

``REPRO_SANITIZE_MODE=record`` appends structured findings instead of
raising; ``REPRO_SANITIZE_JSON=path`` dumps them at interpreter exit in
the ``run.py --json`` report shape.  The proxy deliberately does NOT
subclass :class:`Transport` (class attributes would mask delegation and
monkeypatched ``_call``/``_post`` channels must keep landing on the
inner backend); it is registered as a virtual subclass instead so
``isinstance`` checks hold.

This is the JAX package's ``repro.analysis.sanitizer``, rule for rule, over
this package's transports.  Its findings are :class:`Finding` records of
the same shape as ``rmalint``'s (the linter itself needs no copy: its
default paths already cover this package).
"""

from __future__ import annotations

import atexit
import dataclasses
import json
import os
import threading

import numpy as np

from ..core.transport.base import Transport

__all__ = ["Finding", "SanitizerError", "WindowSanitizer", "maybe_sanitize",
           "sanitize_enabled", "sanitize_report", "FINDINGS"]


@dataclasses.dataclass
class Finding:
    """One sanitizer violation, JSON-serializable (``rmalint``'s record)."""

    rule: str
    severity: str
    path: str
    line: int
    col: int
    message: str

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def render(self) -> str:
        return (f"{self.path}:{self.line}:{self.col}: "
                f"{self.rule} [{self.severity}] {self.message}")


#: process-global findings across every sanitizer instance
FINDINGS: list[Finding] = []

_json_hook_registered = False


class SanitizerError(RuntimeError):
    """An RMA access-rule violation (deliberately NOT a TransportError:
    the window failover layer must never mistake a discipline violation
    for a dead rank and retry it on a replica)."""

    def __init__(self, finding: Finding):
        super().__init__(finding.render())
        self.finding = finding


def sanitize_enabled() -> bool:
    return os.environ.get("REPRO_SANITIZE", "").strip().lower() in (
        "1", "true", "yes", "on")


def sanitize_report() -> dict:
    """Machine-readable findings report, shaped like ``run.py --json``."""
    return {"tool": "sanitizer",
            "findings": [f.to_dict() for f in FINDINGS],
            "gates_passed": not FINDINGS}


def maybe_sanitize(transport):
    """Wrap ``transport`` when ``REPRO_SANITIZE=1`` (idempotent)."""
    global _json_hook_registered
    if not sanitize_enabled() or isinstance(transport, WindowSanitizer):
        return transport
    if os.environ.get("REPRO_SANITIZE_JSON") and not _json_hook_registered:
        _json_hook_registered = True

        def _dump():
            path = os.environ.get("REPRO_SANITIZE_JSON")
            if path:
                with open(path, "w") as f:
                    json.dump(sanitize_report(), f, indent=1)
                    f.write("\n")
        atexit.register(_dump)
    return WindowSanitizer(transport)


def _nbytes(data) -> int:
    if hasattr(data, "nbytes"):
        return int(data.nbytes)
    return len(data)


def _overlap(a, b) -> bool:
    return a[0] < b[1] and b[0] < a[1]


class _Shadow:
    """Shared shadow state (one per transport *world*: ``split`` children
    share it, so findings and segment lifetimes stay globally visible)."""

    def __init__(self, mode: str):
        self.lock = threading.RLock()
        self.mode = mode
        self.live: dict[int, object] = {}    # id(seg) -> seg (strong ref:
        self.freed: dict[int, object] = {}   # pins ids against reuse)
        self.pending: dict[int, list] = {}   # id(seg) -> [train write-ranges]
        self.findings: list[Finding] = []


class WindowSanitizer:
    """Transparent shadow-state checker around any :class:`Transport`.

    Unknown attributes (reads *and* writes) delegate to the inner
    backend, so conformance tests that monkeypatch ``transport._call``/
    ``transport._post`` or reach worker handles keep working unchanged.
    """

    _OWN = frozenset({"_inner", "_shadow", "_portable"})

    def __init__(self, inner, mode: str | None = None, _shadow=None):
        if mode is None:
            mode = os.environ.get(
                "REPRO_SANITIZE_MODE", "raise").strip().lower() or "raise"
        if mode not in ("raise", "record"):
            raise ValueError(
                f"REPRO_SANITIZE_MODE={mode!r}: must be 'raise' or 'record'")
        portable = (os.environ.get("REPRO_SANITIZE_PORTABLE", "")
                    .strip().lower() in ("1", "true", "yes", "on")
                    or not getattr(inner, "ordered_channels", False))
        object.__setattr__(self, "_inner", inner)
        object.__setattr__(self, "_shadow", _shadow or _Shadow(mode))
        object.__setattr__(self, "_portable", portable)

    # -- delegation --------------------------------------------------------
    def __getattr__(self, name):
        return getattr(object.__getattribute__(self, "_inner"), name)

    def __setattr__(self, name, value):
        if name in WindowSanitizer._OWN:
            object.__setattr__(self, name, value)
        else:
            setattr(object.__getattribute__(self, "_inner"), name, value)

    @property
    def inner(self):
        return object.__getattribute__(self, "_inner")

    @property
    def findings(self) -> list[Finding]:
        return self._shadow.findings

    # -- violation plumbing ------------------------------------------------
    def _violate(self, rule: str, message: str):
        sh = self._shadow
        f = Finding(rule=rule, severity="error",
                    path=f"runtime:{getattr(self.inner, 'kind', '?')}",
                    line=0, col=0, message=message)
        with sh.lock:
            sh.findings.append(f)
            FINDINGS.append(f)
        if sh.mode == "raise":
            raise SanitizerError(f)

    # -- segment lifecycle -------------------------------------------------
    def _track(self, seg):
        if seg is None:
            return
        sh = self._shadow
        with sh.lock:
            if id(seg) in sh.live:
                return
            # a re-allocation may legitimately hand back a fresh handle at
            # an id a freed handle once had; the strong ref in `freed`
            # prevents that, so an id collision here is a true re-track
            sh.freed.pop(id(seg), None)
            sh.live[id(seg)] = seg
        close = getattr(seg, "close", None)
        if callable(close):
            def _close(*a, **k):
                self._note_close(seg)
                return close(*a, **k)
            try:
                seg.close = _close
            except AttributeError:
                pass  # unpatchable handle (slots): frees go unobserved

    def _note_close(self, seg):
        sh = self._shadow
        with sh.lock:
            if id(seg) in sh.freed:
                return  # idempotent close
            trains = sh.pending.pop(id(seg), None)
            sh.live.pop(id(seg), None)
            sh.freed[id(seg)] = seg
        if trains:
            self._violate(
                "flush-order",
                f"segment freed with {len(trains)} posted op train(s) "
                "unconfirmed -- op_complete/flush must observe the epoch "
                "(and surface its deferred errors) before close()")

    def _check_live(self, seg, op: str):
        with self._shadow.lock:
            freed = id(seg) in self._shadow.freed
        if freed:
            self._violate(
                "use-after-free",
                f"{op} on a segment whose close() already ran")

    def _check_ranges(self, seg, ranges, rule: str, op: str):
        """Flag ``ranges`` overlapping any posted train's write set.

        Portable-model check only: on an ``ordered_channels`` transport
        this access serializes behind every posted train on the target's
        FIFO channel, so the hazard cannot occur (unless
        ``REPRO_SANITIZE_PORTABLE=1`` demands the portable discipline).
        """
        if not ranges or not self._portable:
            return
        sh = self._shadow
        with sh.lock:
            trains = list(sh.pending.get(id(seg), ()))
        for train in trains:
            for t in train:
                for r in ranges:
                    if _overlap(r, t):
                        self._violate(
                            rule,
                            f"{op} on bytes [{r[0]}, {r[1]}) overlapping "
                            f"posted un-flushed train write [{t[0]}, "
                            f"{t[1]}) in the same epoch -- flush/sync "
                            "first")
                        return  # one finding per offending call

    @staticmethod
    def _op_ranges(ops):
        """(write-ranges, read-ranges) of one wire-form op list."""
        wr, rd = [], []
        for o in ops:
            kind, off = o[0], int(o[1])
            if kind == "put":
                wr.append((off, off + _nbytes(o[2])))
            elif kind == "acc":
                wr.append((off, off + _nbytes(o[2])))
            elif kind == "get":
                rd.append((off, off + int(o[2])))
            elif kind == "gacc":
                n = _nbytes(o[2])
                wr.append((off, off + n))
                rd.append((off, off + n))
            elif kind == "cas":
                n = np.dtype(o[4]).itemsize
                wr.append((off, off + n))
                rd.append((off, off + n))
        return wr, rd

    def _clear_pending(self, seg=None):
        sh = self._shadow
        with sh.lock:
            if seg is None:
                sh.pending.clear()
            else:
                sh.pending.pop(id(seg), None)

    # -- checked transport surface ----------------------------------------
    def allocate_segments(self, size, hints, spec):
        segs = self.inner.allocate_segments(size, hints, spec)
        for s in segs:
            self._track(s)
        return segs

    def allocate_segment(self, rank, size, hints, spec, *, name_rank,
                         name_nranks):
        seg = self.inner.allocate_segment(
            rank, size, hints, spec, name_rank=name_rank,
            name_nranks=name_nranks)
        self._track(seg)
        return seg

    def put(self, seg, offset, data):
        self._check_live(seg, "put")
        self._check_ranges(seg, [(offset, offset + _nbytes(data))],
                           "put-put-conflict", "blocking put")
        return self.inner.put(seg, offset, data)

    def get(self, seg, offset, nbytes):
        self._check_live(seg, "get")
        self._check_ranges(seg, [(offset, offset + nbytes)],
                           "put-get-no-flush", "blocking get")
        return self.inner.get(seg, offset, nbytes)

    def write_spans_masked(self, seg, spans, mask):
        self._check_live(seg, "write_spans_masked")
        ranges = [(off, off + _nbytes(a)) for off, a in spans]
        self._check_ranges(seg, ranges, "put-put-conflict",
                           "masked span write")
        return self.inner.write_spans_masked(seg, spans, mask)

    def accumulate(self, seg, offset, data, op):
        self._check_live(seg, "accumulate")
        self._check_ranges(seg, [(offset, offset + _nbytes(data))],
                           "atomic-in-train", "atomic accumulate")
        return self.inner.accumulate(seg, offset, data, op)

    def get_accumulate(self, seg, offset, data, op):
        self._check_live(seg, "get_accumulate")
        self._check_ranges(seg, [(offset, offset + _nbytes(data))],
                           "atomic-in-train", "atomic get_accumulate")
        return self.inner.get_accumulate(seg, offset, data, op)

    def compare_and_swap(self, seg, offset, value, compare, dtype):
        self._check_live(seg, "compare_and_swap")
        n = np.dtype(dtype).itemsize
        self._check_ranges(seg, [(offset, offset + n)],
                           "atomic-in-train", "atomic compare_and_swap")
        return self.inner.compare_and_swap(seg, offset, value, compare, dtype)

    def op_batch(self, seg, ops, defer=False):
        self._check_live(seg, "op_batch")
        wr, rd = self._op_ranges(ops)
        self._check_ranges(seg, wr, "put-put-conflict", "op train write")
        self._check_ranges(seg, rd, "put-get-no-flush", "in-train read")
        res = self.inner.op_batch(seg, ops, defer=defer)
        if res is None:  # posted (notified access): now an epoch hazard
            sh = self._shadow
            with sh.lock:
                sh.pending.setdefault(id(seg), []).append(wr)
        return res

    def op_complete(self, seg):
        # a FAILING completion also clears the shadow epoch: the window
        # layer replays the train on a live replica via a replying
        # op_batch, which never re-enters the pending set
        try:
            return self.inner.op_complete(seg)
        finally:
            self._clear_pending(seg)

    def barrier(self):
        # the documented whole-world completion point (channel-FIFO
        # under mp: everything posted before the barrier has applied)
        try:
            return self.inner.barrier()
        finally:
            self._clear_pending()

    def split(self, color, ranks):
        sub = self.inner.split(color, ranks)
        return WindowSanitizer(sub, mode=self._shadow.mode,
                               _shadow=self._shadow)

    def shutdown(self):
        sh = self._shadow
        with sh.lock:
            stranded = sum(len(v) for v in sh.pending.values())
            sh.pending.clear()
        try:
            if stranded:
                self._violate(
                    "flush-order",
                    f"transport shutdown with {stranded} posted op "
                    "train(s) unconfirmed -- flush/sync before close")
        finally:
            self.inner.shutdown()  # workers must not leak on a violation


# comm.py gates passed-in transports on isinstance(t, Transport); the
# sanitizer must satisfy it without inheriting maskable class attributes
Transport.register(WindowSanitizer)
