"""The port's runtime RMA sanitizer against the JAX package's.

The sanitizer half of ``tests/test_analysis.py`` on ``repro_torch``: a
minimal deferring transport (one per package, the same code over each
package's ``Transport``) seeds each violation class, and every hazard
pattern runs through ``repro.analysis.WindowSanitizer`` and
``repro_torch.analysis.WindowSanitizer`` alike: both must report the same
findings (rule, severity, path and message), each once.  Then what only
the port can show: ``raise`` mode raises an error that is not the port's
``TransportError``, the report has the reference's shape, and the port's
real transports (``REPRO_SANITIZE=1`` through ``make_transport``) run
clean under inproc, mp and tcp.
"""

import threading
import types

import numpy as np
import pytest

import repro.analysis.sanitizer as jsan
import repro.core.transport.base as jbase
import repro_torch.analysis.sanitizer as tsan
import repro_torch.core as tcore
import repro_torch.core.transport.base as tbase
from repro_torch.analysis import SanitizerError, WindowSanitizer
from repro_torch.analysis.sanitizer import sanitize_report

PACKAGES = {"ref": (jsan, jbase), "port": (tsan, tbase)}


class _FakeSeg:
    """Bytearray-backed segment with the handle surface the base-class op
    appliers use (write/read/close)."""

    def __init__(self, size):
        self._buf = np.zeros(size, np.uint8)
        self.closed = False

    def write(self, offset, data):
        u8 = np.ascontiguousarray(data).view(np.uint8).reshape(-1)
        self._buf[offset:offset + u8.size] = u8

    def read(self, offset, nbytes):
        return self._buf[offset:offset + nbytes].copy()

    def close(self, **_kw):
        self.closed = True


def fake_transport(base, *, ordered=False, failing_complete=False):
    """A deterministic notified-access backend over ``base`` (a package's
    ``core.transport.base``): all-deferrable batches post (return None)
    like mp/tcp do, without spawning any process."""

    class Fake(base.Transport):
        kind = "fake"
        ordered_channels = ordered

        def __init__(self, size=2):
            super().__init__(size, 0)
            self.posted = 0

        def allocate_segments(self, size, hints, spec):
            return [_FakeSeg(size) for _ in range(self.size)]

        def op_batch(self, seg, ops, defer=False):
            if defer and ops and all(o[0] in base.DEFERRABLE_OPS
                                     for o in ops):
                self.posted += 1
                base.apply_op_batch(seg, ops)
                return None
            return base.apply_op_batch(seg, ops)

        def op_complete(self, seg):
            n, self.posted = self.posted, 0
            if failing_complete:
                raise base.TransportError("owner died before completion")
            return n

        def put(self, seg, offset, data):
            seg.write(offset, data)

        def get(self, seg, offset, nbytes):
            return seg.read(offset, nbytes)

        def write_spans_masked(self, seg, spans, mask):
            for off, d in spans:
                seg.write(off, d)
            return 0

        def accumulate(self, seg, offset, data, op):
            base.apply_accumulate(seg, offset, data, op)

        def get_accumulate(self, seg, offset, data, op):
            return base.apply_get_accumulate(seg, offset, data, op)

        def compare_and_swap(self, seg, offset, value, compare, dtype):
            return base.apply_compare_and_swap(seg, offset, value, compare,
                                               dtype)

        def barrier(self):
            pass

        def allreduce(self, value, op="sum"):
            return value

        def bcast(self, value, root=0):
            return value

        def split(self, color, ranks):
            return self

    return Fake()


@pytest.fixture(autouse=True)
def _clear_global_findings():
    for mod in (jsan, tsan):
        mod.FINDINGS.clear()
    yield
    for mod in (jsan, tsan):
        mod.FINDINGS.clear()


def _post_train(san, seg, off=0, n=8):
    arr = np.arange(n, dtype=np.uint8)
    assert san.op_batch(seg, [("put", off, arr)], defer=True) is None


def _data(n=8):
    return np.arange(n, dtype=np.uint8)


# each hazard pattern: (fake transport options, the calls, the rules it
# must report, in order).  The calls take (san, seg).
def _put_put(san, seg):
    _post_train(san, seg, off=0)
    _post_train(san, seg, off=4)   # overlaps [0, 8)


def _blocking_put(san, seg):
    _post_train(san, seg)
    san.put(seg, 4, _data())


def _blocking_get(san, seg):
    _post_train(san, seg)
    san.get(seg, 0, 8)


def _in_train_read(san, seg):
    _post_train(san, seg)
    san.op_batch(seg, [("get", 4, 4)])


def _masked_spans(san, seg):
    _post_train(san, seg)
    san.write_spans_masked(seg, [(2, _data(4))], None)


def _accumulate(san, seg):
    _post_train(san, seg)
    san.accumulate(seg, 0, np.asarray([1], np.int64), "sum")


def _get_accumulate(san, seg):
    _post_train(san, seg)
    san.get_accumulate(seg, 0, np.asarray([1], np.int64), "sum")


def _cas(san, seg):
    _post_train(san, seg)
    san.compare_and_swap(seg, 0, 1, 0, np.int32)


def _use_after_free(san, seg):
    seg.close()
    assert seg.closed  # the patched close still runs the real one
    san.put(seg, 0, _data())


def _free_pending(san, seg):
    _post_train(san, seg)
    seg.close()


def _shutdown_pending(san, seg):
    _post_train(san, seg)
    san.shutdown()


def _completion_points(san, seg):
    _post_train(san, seg)
    san.op_complete(seg)
    san.get(seg, 0, 8)            # flushed: reads are fine now
    _post_train(san, seg, off=16)
    san.barrier()                 # whole-world completion point
    san.put(seg, 16, _data())
    seg.close()


def _failing_completion(san, seg):
    # a failing op_complete clears the epoch too: the window layer replays
    # the train on a live replica through a replying op_batch
    _post_train(san, seg)
    with pytest.raises(Exception, match="owner died"):
        san.op_complete(seg)
    san.get(seg, 0, 8)
    seg.close()


def _clean(san, seg):
    _post_train(san, seg, off=0)
    _post_train(san, seg, off=32)          # disjoint train
    san.put(seg, 48, _data())              # disjoint blocking op
    res = san.op_batch(seg, [("put", 56, _data(4)), ("get", 56, 4)])
    assert isinstance(res, list)           # a replying batch
    san.op_complete(seg)


def _ordered(san, seg):
    # channel-FIFO completion: data hazards cannot occur and are skipped,
    # but the unobserved epoch at close is still a violation
    _post_train(san, seg)
    san.get(seg, 0, 8)
    seg.close()


PATTERNS = {
    "put_put_across_trains": ({}, _put_put, ["put-put-conflict"]),
    "blocking_put": ({}, _blocking_put, ["put-put-conflict"]),
    "blocking_get": ({}, _blocking_get, ["put-get-no-flush"]),
    "in_train_read": ({}, _in_train_read, ["put-get-no-flush"]),
    "masked_span_write": ({}, _masked_spans, ["put-put-conflict"]),
    "accumulate": ({}, _accumulate, ["atomic-in-train"]),
    "get_accumulate": ({}, _get_accumulate, ["atomic-in-train"]),
    "compare_and_swap": ({}, _cas, ["atomic-in-train"]),
    "use_after_free": ({}, _use_after_free, ["use-after-free"]),
    "free_with_pending_train": ({}, _free_pending, ["flush-order"]),
    "shutdown_with_pending_train": ({}, _shutdown_pending, ["flush-order"]),
    "completion_points": ({}, _completion_points, []),
    "failing_completion_clears": ({"failing_complete": True},
                                  _failing_completion, []),
    "clean_patterns": ({}, _clean, []),
    "ordered_channels": ({"ordered": True}, _ordered, ["flush-order"]),
}


def _findings(pkg: str, opts: dict, calls) -> list[tuple]:
    san_mod, base = PACKAGES[pkg]
    san = san_mod.WindowSanitizer(fake_transport(base, **opts),
                                  mode="record")
    seg = san.allocate_segments(64, None, {})[0]
    calls(san, seg)
    assert san_mod.FINDINGS == san.findings
    return [(f.rule, f.severity, f.path, f.message) for f in san.findings]


@pytest.mark.parametrize("name", list(PATTERNS))
def test_hazard_patterns_match_reference(name):
    opts, calls, rules = PATTERNS[name]
    got = _findings("port", opts, calls)
    assert got == _findings("ref", opts, calls)
    assert [f[0] for f in got] == rules  # each caught once


def test_portable_model_forced_on_ordered_transport(monkeypatch):
    """REPRO_SANITIZE_PORTABLE=1 enforces the portable MPI model even where
    the transport declares channel-FIFO completion."""
    monkeypatch.setenv("REPRO_SANITIZE_PORTABLE", "1")
    got = _findings("port", {"ordered": True}, _blocking_get)
    assert got == _findings("ref", {"ordered": True}, _blocking_get)
    assert [f[0] for f in got] == ["put-get-no-flush"]


def test_raise_mode_raises_without_transport_error():
    san = WindowSanitizer(fake_transport(tbase), mode="raise")
    seg = san.allocate_segments(64, None, {})[0]
    _post_train(san, seg)
    with pytest.raises(SanitizerError) as ei:
        san.get(seg, 0, 8)
    # NOT a TransportError: failover must never treat a discipline
    # violation as a dead rank and retry it on a replica
    assert not isinstance(ei.value, tcore.TransportError)
    assert ei.value.finding.rule == "put-get-no-flush"
    with pytest.raises(ValueError, match="REPRO_SANITIZE_MODE"):
        WindowSanitizer(fake_transport(tbase), mode="loud")


def test_report_shape_mirrors_reference():
    for pkg in ("ref", "port"):
        _findings(pkg, {}, _blocking_get)
    want, got = jsan.sanitize_report(), sanitize_report()
    assert set(got) == set(want) == {"tool", "findings", "gates_passed"}
    assert got["tool"] == "sanitizer" and got["gates_passed"] is False
    assert got["findings"] == want["findings"]
    (f,) = got["findings"]
    assert f["rule"] == "put-get-no-flush" and f["severity"] == "error"


def test_delegation_and_monkeypatch_transparency():
    inner = fake_transport(tbase)
    san = WindowSanitizer(inner, mode="record")
    assert isinstance(san, tbase.Transport)   # virtual subclass (comm.py)
    assert san.kind == "fake" and san.size == 2
    san.some_channel = "patched"              # unknown attrs land inside
    assert inner.some_channel == "patched"
    sub = san.split(0, [0, 1])
    assert isinstance(sub, WindowSanitizer)
    assert sub.findings is san.findings       # one shared shadow world


# -- the port's real transports run clean under the wrap ---------------------

@pytest.mark.parametrize("kind", ["inproc", "mp", "tcp"])
def test_sanitized_windows_clean(kind, monkeypatch, tmp_path):
    """``REPRO_SANITIZE=1`` wraps what ``make_transport`` builds; a memory
    window's put/get/rput/flush and a storage window's posted trains (one
    op_complete a flush), sync and free report nothing."""
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    monkeypatch.setenv("REPRO_MP_TIMEOUT", "60")
    monkeypatch.setenv("REPRO_TCP_TIMEOUT", "60")
    comm = tcore.Communicator(2, transport=kind)
    try:
        assert isinstance(comm.transport, WindowSanitizer)
        assert comm.transport.kind == kind
        win = tcore.Window.allocate(comm, 4096)
        data = np.arange(64, dtype=np.uint8)
        win.put(data, 1, 0)
        assert (win.get(1, 0, 64) == data).all()
        for i in range(8):
            win.rput(data, 1, 64 * (i + 1))
        win.flush(1)
        win.free()
        win = tcore.Window.allocate(comm, 4096, info={
            "alloc_type": "storage",
            "storage_alloc_filename": str(tmp_path / "san.bin")})
        small = np.arange(8, dtype=np.uint8)
        for _ in range(3):                       # several epochs
            for i in range(32):
                win.rput(small, 1, 8 * i)        # one posted train
            win.flush(1)
        assert (win.get(1, 0, 8) == small).all()
        win.sync(1)
        win.free()
        assert comm.transport.findings == []
    finally:
        comm.close()
    assert sanitize_report()["gates_passed"]


def test_localseg_construction_waits_for_service_lock():
    """The SPMD rank-local segment view must read the shared registry
    under the service lock (a peer server thread may be mid-alloc)."""
    from repro_torch.core.transport.multiproc import _SegmentService
    from repro_torch.core.transport.spmd import _LocalSeg

    svc = _SegmentService(0, use_shm=False)
    svc.segments[7] = types.SimpleNamespace(size=64)
    built = threading.Event()

    def build():
        _LocalSeg(svc, 7)
        built.set()

    with svc.lock:
        t = threading.Thread(target=build)
        t.start()
        # the building thread cannot finish while the lock is held,
        # however long it is given
        assert not built.wait(0.2), \
            "_LocalSeg read the registry without the service lock"
    t.join(timeout=5)
    assert built.is_set()
