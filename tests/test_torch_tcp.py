"""The port's joined tcp fleet (SPMD across machines, on loopback).

The port of ``tests/test_tcp.py``.  The spawned-fleet, driver-origin half
of the tcp backend rides the conformance suite in
``test_torch_transport.py``; this module covers what only a *joined* fleet
can show: externally launched processes that each ARE one rank,
bootstrapping from a ``REPRO_HOSTS`` roster, serving each other over
authenticated framed TCP, running collectives through the rank-0 round
board -- and leaving the files the JAX package's in-process transport
leaves for the same puts and syncs.

Fleet entry functions are module-level so the spawn start method can
pickle them by reference.
"""

from __future__ import annotations

import multiprocessing
import os
import socket
import threading

import numpy as np
import pytest

_NRANKS = 2


def _pick_ports(n: int) -> list[int]:
    socks = [socket.create_server(("127.0.0.1", 0)) for _ in range(n)]
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def _fills(rank: int):
    """Rank ``rank``'s puts: its own fill at 0, a mark on its peer at 128."""
    return ((rank, 0, np.full(64, rank + 1, np.uint8)),
            (1 - rank, 128, np.full(8, 0xB0 + rank, np.uint8)))


def _fleet_entry(rank: int, hosts: list[str], conn, base: str) -> None:
    """One externally launched fleet rank: env bootstrap, a storage window
    with one-sided traffic both ways, collectives, durable sync."""
    os.environ["REPRO_TRANSPORT"] = "tcp"
    os.environ["REPRO_HOSTS"] = ",".join(hosts)
    os.environ["REPRO_NRANKS"] = str(_NRANKS)
    os.environ["REPRO_RANK"] = str(rank)
    os.environ["REPRO_TCP_TIMEOUT"] = "60"
    try:
        from repro_torch.core import Communicator, Window

        comm = Communicator.from_env()
        out = {"kind": comm.transport.kind, "rank": comm.rank,
               "size": comm.size,
               "transport": type(comm.transport).__name__}
        peer = 1 - comm.rank
        win = Window.allocate(comm, 4096, info={
            "alloc_type": "storage",
            "storage_alloc_filename": os.path.join(base, "w.bin")})
        try:
            for target, off, data in _fills(comm.rank):
                win.put(data, target, off)
            comm.barrier()  # both ranks' puts are complete and visible
            out["peer_fill"] = int(win.get(peer, 0, 1)[0])
            out["from_peer"] = int(win.get(comm.rank, 128, 1)[0])
            out["sum"] = comm.allreduce(float(comm.rank + 1))
            out["bc"] = comm.bcast("root-says" if comm.rank == 0 else None,
                                   root=0)
            sub = comm.split(color=0, ranks=[0, 1])
            out["sub_sum"] = sub.allreduce(10.0 * (comm.rank + 1))
            sub.close()
            win.sync(comm.rank)
            out["net"] = comm.transport.net_stats_snapshot()
            comm.barrier()  # nobody frees while the peer still reads
        finally:
            win.free()
            comm.close()
        conn.send(("ok", out))
    except BaseException as e:  # surface the failure to the parent
        conn.send(("err", f"{type(e).__name__}: {e}"))
    finally:
        conn.close()


def test_tcp_joined_fleet_roster_bootstrap(tmp_path):
    """Two externally launched ranks join via REPRO_HOSTS, exchange
    one-sided traffic, agree on collectives, and leave the standard
    ``<file>.<rank>`` layout on disk: the JAX package's in-process files
    for the same puts and syncs, byte for byte."""
    import repro.core as jcore

    ctx = multiprocessing.get_context("spawn")
    hosts = [f"127.0.0.1:{p}" for p in _pick_ports(_NRANKS)]
    fleet = tmp_path / "fleet"
    fleet.mkdir()
    pipes, procs = [], []
    for r in range(_NRANKS):
        parent, child = ctx.Pipe()
        p = ctx.Process(target=_fleet_entry,
                        args=(r, hosts, child, str(fleet)),
                        name=f"fleet-{r}")
        p.start()
        child.close()
        pipes.append(parent)
        procs.append(p)
    results = {}
    try:
        for r, conn in enumerate(pipes):
            assert conn.poll(120), f"rank {r} produced no result"
            status, payload = conn.recv()
            assert status == "ok", f"rank {r} failed: {payload}"
            results[r] = payload
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():  # pragma: no cover - hung fleet
                p.terminate()
    assert all(p.exitcode == 0 for p in procs)

    for r in range(_NRANKS):
        out = results[r]
        assert out["kind"] == "tcp" and out["rank"] == r
        assert out["transport"] == "TcpPeerTransport"
        assert out["peer_fill"] == (1 - r) + 1   # read the peer's fill
        assert out["from_peer"] == 0xB0 + (1 - r)  # the peer's put landed
        assert out["sum"] == pytest.approx(3.0)  # 1 + 2, both origins
        assert out["bc"] == "root-says"
        assert out["sub_sum"] == pytest.approx(30.0)
        assert out["net"]["bytes_tx"] > 0 and out["net"]["frames_rx"] > 0

    ref = tmp_path / "ref"
    ref.mkdir()
    win = jcore.Window.allocate(jcore.Communicator(_NRANKS), 4096, info={
        "alloc_type": "storage",
        "storage_alloc_filename": str(ref / "w.bin")})
    for r in range(_NRANKS):
        for target, off, data in _fills(r):
            win.put(data, target, off)
    win.sync()
    win.free()
    for r in range(_NRANKS):
        disk = (fleet / f"w.bin.{r}").read_bytes()
        assert disk == (ref / f"w.bin.{r}").read_bytes()
        assert disk[:64] == bytes([r + 1]) * 64 and disk[128] == 0xB0 + 1 - r


def test_tcp_joined_probe_and_respawn_contract(monkeypatch):
    """A joined fleet has no spawner: probe of an unreachable peer fails
    fast (bounded by the probe knob) and respawn_rank tells the operator
    to restart the external process, naming the address."""
    from repro_torch.core.transport import TransportError
    from repro_torch.core.transport.tcp import TcpPeerTransport

    monkeypatch.setenv("REPRO_TCP_PROBE_TIMEOUT", "1")
    monkeypatch.setenv("REPRO_TCP_CONNECT_TIMEOUT", "1")
    me, dead = _pick_ports(2)
    t = TcpPeerTransport(2, 0, [f"127.0.0.1:{me}", f"127.0.0.1:{dead}"])
    try:
        assert t.probe(0) is True          # self: always alive
        assert t.probe(1) is False         # nothing listens there
        with pytest.raises(TransportError, match="launched externally"):
            t.respawn_rank(1)
        with pytest.raises(TransportError, match="cannot respawn itself"):
            t.respawn_rank(0)
    finally:
        t.shutdown()


def test_tcp_roster_length_must_match_size(monkeypatch):
    from repro_torch.core.transport import make_transport
    from repro_torch.core.transport.tcp import TcpPeerTransport
    with pytest.raises(ValueError, match="one host:port per rank"):
        TcpPeerTransport(3, 0, ["127.0.0.1:1", "127.0.0.1:2"])
    with pytest.raises(ValueError, match="expected host:port"):
        TcpPeerTransport(1, 0, ["no-port-here"])
    # the roster reaches the fleet through the environment too
    monkeypatch.setenv("REPRO_HOSTS", "127.0.0.1:1,127.0.0.1:2")
    with pytest.raises(ValueError, match="one host:port per rank"):
        make_transport(3, 1, "tcp")


def test_round_board_matches_positionally_and_caches():
    """The rank-0 board pairs the pos-th round per group and keeps
    completed rounds readable (a restarted rank replays into the cache)."""
    from repro_torch.core.transport import TransportError
    from repro_torch.core.transport.tcp import _RoundBoard

    board = _RoundBoard()
    got = {}

    def rank1():
        got[1] = board.contribute(1, (0, 1), 0, ("allreduce", "sum", 10),
                                  timeout=30.0)

    th = threading.Thread(target=rank1)
    th.start()
    got[0] = board.contribute(0, (0, 1), 0, ("allreduce", "sum", 32),
                              timeout=30.0)
    th.join(timeout=30)
    assert got[0] == got[1] == {0: ("allreduce", "sum", 32),
                                1: ("allreduce", "sum", 10)}
    # replay after completion: served from the cache, no new round opened
    again = board.contribute(1, (0, 1), 0, ("allreduce", "sum", 10),
                             timeout=1.0)
    assert again == got[0]
    # a missing participant times out with a useful message
    with pytest.raises(TransportError, match="missing contributions"):
        board.contribute(0, (0, 1), 1, ("barrier",), timeout=0.2)
