#!/usr/bin/env python3
"""Throughput and round trip of the mp transport's control channel.

A spawned process echoes each message's size back over a duplex
``multiprocessing.Pipe`` (a socketpair), as an mp worker answers a put.
For each ``--mb`` size the message goes out and is read back in two ways:
``Connection.send``/``recv``, and the port's ``multiproc._send``/``_recv``
(the same framing, written and read in 1 MB chunks).  Then ``--pings``
small messages measure the round trip, the cost of one one-sided op.
Host code only; prints one JSON line.

    PYTHONPATH=src python scripts/time_channel.py --mb 16 64 256
"""

import argparse
import json
import multiprocessing
import time

from repro_torch.core.transport import multiproc

WAYS = {
    "connection": (lambda c, m: c.send(m), lambda c: c.recv()),
    "chunked": (multiproc._send, multiproc._recv),
}


def _echo(conn, way: str) -> None:
    send, recv = WAYS[way]
    while True:
        msg = recv(conn)
        if msg is None:
            return
        send(conn, len(msg[1]))


def _time(way: str, sizes_mb: list[int], pings: int) -> dict:
    send, recv = WAYS[way]
    ctx = multiprocessing.get_context("spawn")
    parent, child = ctx.Pipe(duplex=True)
    proc = ctx.Process(target=_echo, args=(child, way))
    proc.start()
    out = {}
    try:
        send(parent, ("ping", b""))  # the child has started and answers
        recv(parent)
        for mb in sizes_mb:
            payload = bytes(mb << 20)
            t0 = time.perf_counter()
            send(parent, ("put", payload))
            assert recv(parent) == len(payload)
            out[f"{mb}MB_s"] = time.perf_counter() - t0
            out[f"{mb}MB_MBps"] = mb / out[f"{mb}MB_s"]
        t0 = time.perf_counter()
        for _ in range(pings):
            send(parent, ("ping", b"x" * 64))
            recv(parent)
        out["round_trip_us"] = (time.perf_counter() - t0) / pings * 1e6
    finally:
        send(parent, None)
        proc.join(timeout=30)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mb", type=int, nargs="+", default=[16, 64, 256])
    ap.add_argument("--pings", type=int, default=2000)
    args = ap.parse_args()
    print(json.dumps({way: _time(way, args.mb, args.pings)
                      for way in WAYS}))


if __name__ == "__main__":
    main()
