"""The port's wire codec against the JAX package's, blob for blob.

Every payload is made with numpy from a seed.  For each one and each codec
choice (auto and the four forced ids) the port's ``encode_bytes`` must
return exactly the reference's bytes, and each package must decode the
other's blob back to the input.  The span and op-train tuples, the
roofline policy's decisions and the wire counters are held to the
reference the same way.  Tolerance: none -- every comparison is of bytes.
"""

import numpy as np
import pytest

import repro.core.codec as jcodec
import repro_torch.core.codec as tcodec

CODECS = [None, tcodec.CODEC_RAW, tcodec.CODEC_ZRLE, tcodec.CODEC_RLE,
          tcodec.CODEC_SHUF_RLE]


def _payloads() -> dict[str, bytes]:
    rng = np.random.default_rng(0)
    sparse = np.zeros(16384, np.uint8)
    for start in rng.integers(0, 16000, 12):
        sparse[start:start + int(rng.integers(1, 200))] = rng.integers(1, 255)
    pages = np.zeros(8192, np.uint8)
    pages[128:160] = 0xAB
    pages[4096:4100] = np.arange(4, dtype=np.uint8)
    floats = rng.standard_normal(1000).astype(np.float32)
    floats[::7] = np.nan
    floats[::11] = np.inf
    return {
        "empty": b"",
        "one": b"\x07",
        "short": b"abc123",
        "zeros": bytes(4096),
        "sparse": sparse.tobytes(),
        "hot_cachelines": pages.tobytes(),
        "nan_page": np.full(4096, np.nan, np.float32).tobytes(),
        "float_bits": floats.tobytes(),
        "masters": (rng.standard_normal(4096) * 0.02).astype(
            np.float32).tobytes(),
        "ramp": np.arange(3000, dtype=np.int64).tobytes(),
        "noise": rng.integers(0, 256, 65536, np.uint8).tobytes(),
        "long_runs": (b"\x07" * 200_000) + b"\x01\x02" + (b"\x00" * 70_000),
        "ragged_tail": rng.integers(0, 4, 1001, np.uint8).tobytes(),
    }


PAYLOADS = _payloads()


@pytest.mark.parametrize("codec", CODECS,
                         ids=lambda c: "auto" if c is None
                         else tcodec.CODEC_NAMES[c])
@pytest.mark.parametrize("name", sorted(PAYLOADS))
def test_blob_identical_and_cross_decodes(name, codec):
    data = PAYLOADS[name]
    blob = tcodec.encode_bytes(data, codec=codec)
    assert blob == jcodec.encode_bytes(data, codec=codec)
    if codec is not None:
        assert blob[0] == codec
    assert tcodec.decode_bytes(blob).tobytes() == data
    assert jcodec.decode_bytes(blob).tobytes() == data
    ref_blob = jcodec.encode_bytes(data, codec=codec)
    assert tcodec.decode_bytes(ref_blob).tobytes() == data


def test_incompressible_payload_builds_no_runs(monkeypatch):
    """Random float32 bytes (the masters of a selective sync) cannot beat
    7/8 of raw under any codec: auto returns the reference's raw blob
    without building a run array, which on a payload of hundreds of MB
    would take many times its size in int64 temporaries."""
    rng = np.random.default_rng(3)
    data = rng.standard_normal(1 << 18).astype(np.float32).tobytes()
    want = jcodec.encode_bytes(data)
    built = []
    real = tcodec._rle_runs
    monkeypatch.setattr(tcodec, "_rle_runs",
                        lambda u8: built.append(u8.size) or real(u8))
    blob = tcodec.encode_bytes(data)
    assert blob == want and blob[0] == tcodec.CODEC_RAW
    assert built == []
    # a payload where shuffle-RLE wins still builds it, byte for byte
    ramp = np.arange(1 << 15, dtype=np.int64).tobytes()
    assert tcodec.encode_bytes(ramp) == jcodec.encode_bytes(ramp)
    assert tcodec.encode_bytes(ramp)[0] == tcodec.CODEC_SHUF_RLE
    assert built


def test_auto_choice_matches_reference_on_every_payload():
    chosen = {n: tcodec.CODEC_NAMES[tcodec.encode_bytes(d)[0]]
              for n, d in PAYLOADS.items()}
    want = {n: jcodec.CODEC_NAMES[jcodec.encode_bytes(d)[0]]
            for n, d in PAYLOADS.items()}
    assert chosen == want
    # the selective-sync sweet spot shrinks; noise takes the 9-byte header
    assert chosen["zeros"] != "raw" and chosen["noise"] == "raw"
    assert len(tcodec.encode_bytes(PAYLOADS["noise"])) == 65536 + 9


def _force(pkg):
    p = pkg.CodecPolicy(min_bytes=1)
    p.mode = "force"
    return p


def _spans(seed: int):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(int(rng.integers(1, 8))):
        n = int(rng.integers(1, 512))
        buf = np.zeros(n, np.uint8)
        buf[rng.integers(0, n, max(1, n // 16))] = rng.integers(1, 255)
        out.append((int(rng.integers(0, 1 << 30)), buf.tobytes()))
    return out


@pytest.mark.parametrize("seed", range(4))
def test_spans_tuple_identical_and_cross_decodes(seed):
    spans = _spans(seed)
    enc, logical, wire = tcodec.encode_spans(spans, _force(tcodec))
    ref, rlogical, rwire = jcodec.encode_spans(spans, _force(jcodec))
    assert (enc, logical, wire) == (ref, rlogical, rwire)
    assert tcodec.is_encoded_spans(enc) and wire == len(enc[3])
    want = [(o, d) for o, d in spans]
    assert [(o, bytes(d)) for o, d in tcodec.decode_spans(ref)] == want
    assert [(o, bytes(d)) for o, d in jcodec.decode_spans(enc)] == want


def _ops(seed: int):
    rng = np.random.default_rng(seed)
    ops = []
    for i in range(10):
        kind = ("put", "get", "cas")[int(rng.integers(0, 3))]
        off = int(rng.integers(0, 1 << 20))
        if kind == "put" or i == 0:
            ops.append(("put", off, bytes(int(rng.integers(1, 256)))))
        elif kind == "get":
            ops.append(("get", off, int(rng.integers(1, 64))))
        else:
            ops.append(("cas", off, int(rng.integers(0, 9)),
                        int(rng.integers(0, 9))))
    return ops


@pytest.mark.parametrize("seed", range(4))
def test_ops_tuple_identical_and_cross_decodes(seed):
    ops = _ops(seed)
    enc = tcodec.encode_ops(ops, _force(tcodec))
    assert enc == jcodec.encode_ops(ops, _force(jcodec))
    payload = enc[0]
    assert tcodec.is_encoded_ops(payload)
    for dec in (tcodec.decode_ops, jcodec.decode_ops):
        got = dec(payload)
        assert [(*op[:2], bytes(op[2])) if op[0] == "put" else op
                for op in got] == ops


@pytest.mark.parametrize("pkg", [tcodec, jcodec], ids=["port", "ref"])
def test_zero_logical_bytes_ship_raw_even_when_forced(pkg):
    """Zero logical bytes are never encoded: under a forcing policy with
    ``min_bytes=1`` an empty span list, a list of empty spans and a train
    without put bytes all return ``None`` (the caller ships the raw
    list).  This is the reference's behaviour, and the port keeps it."""
    force = _force(pkg)
    assert pkg.encode_spans([], force) == (None, 0, 0)
    assert pkg.encode_spans([(0, b""), (64, b"")], force) == (None, 0, 0)
    assert pkg.encode_ops([("put", 0, b"")], force) == (None, 0, 0)
    assert pkg.encode_ops([("get", 0, 8)], force) == (None, 0, 0)


def test_policy_decisions_match_reference():
    """The roofline threshold and the probe cadence, decision for
    decision, with the EWMAs fed the same samples."""
    rng = np.random.default_rng(1)
    samples = [(int(n), int(n * r), float(t)) for n, r, t in zip(
        rng.integers(1, 1 << 20, 40), rng.random(40), rng.random(40) * 1e-3)]
    sizes = rng.integers(0, 1 << 16, 40)
    got, want = [], []
    for pkg, out in ((tcodec, got), (jcodec, want)):
        p = pkg.CodecPolicy(min_bytes=16, probe_every=5)
        p.mode = "auto"
        for (logical, wire, dt), n in zip(samples, sizes):
            out.append(p.should_encode(int(n)))
            p.record(logical, wire, dt)
        out.append(p.snapshot())
    assert got == want
    assert any(got[:-1]) and not all(got[:-1])


def test_policy_env_modes(monkeypatch):
    for mode, want in (("off", "off"), ("force", "force"), ("bogus", "auto")):
        monkeypatch.setenv("REPRO_CODEC", mode)
        assert tcodec.CodecPolicy().mode == jcodec.CodecPolicy().mode == want
    monkeypatch.setenv("REPRO_CODEC", "off")
    assert tcodec.encode_spans([(0, bytes(4096))],
                               tcodec.CodecPolicy())[0] is None


def test_wire_stats_match_reference():
    ws, ref = tcodec.WireStats(), jcodec.WireStats()
    for w in (ws, ref):
        w.add("spans", 1000, 100, True)
        w.add("ops", 500, 500, False)
        w.add("spans", 4096, 4096, False)
    assert ws.snapshot() == ref.snapshot()
    assert ws.snapshot()["logical_bytes"] == 5596
    assert ws.snapshot()["wire_bytes"] == 4696


def test_compress_reexports_the_codec():
    from repro_torch.runtime import compress
    for name in ("CodecPolicy", "encode_bytes", "decode_bytes",
                 "encode_spans", "decode_spans", "encode_ops", "decode_ops",
                 "CODEC_NAMES", "CODEC_RAW", "CODEC_ZRLE", "CODEC_RLE",
                 "CODEC_SHUF_RLE"):
        assert getattr(compress, name) is getattr(tcodec, name)
        assert name in compress.__all__
