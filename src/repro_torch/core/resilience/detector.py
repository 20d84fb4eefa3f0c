"""Probe-driven failure detection: Transport.probe -> HeartbeatMonitor.

The counterpart of ``repro.core.resilience.detector``.  Each ``poll()``
probes every rank through the communicator (``Communicator.probe``: a rank
of the in-process transport is alive until it is marked dead), beats the
monitor for live ranks, and force-marks dead ranks on the monitor, so
``dead()`` reports them at once instead of after its timeout.
"""

from __future__ import annotations

import time

__all__ = ["FailureDetector"]


class FailureDetector:
    """Poll-based liveness feed for a communicator (and optional monitor).

    ``monitor`` is any object with ``beat(rank, step, now=...)`` and
    ``mark_dead(rank)`` -- normally a
    :class:`repro_torch.runtime.fault.HeartbeatMonitor`; ``None`` builds one.
    ``interval`` rate-limits the actual probing: a ``poll()`` arriving
    earlier than ``interval`` seconds after the last one only reports the
    communicator's current dead set (so a training loop can call it every
    step for free).
    """

    def __init__(self, comm, monitor=None, *, interval: float = 0.0):
        self.comm = comm
        if monitor is None:
            from ...runtime.fault import HeartbeatMonitor
            monitor = HeartbeatMonitor(comm.size)
        self.monitor = monitor
        self.interval = interval
        self._last_poll = -float("inf")

    def poll(self, step: int = 0, now: float | None = None) -> list[int]:
        """Probe every rank; returns the (sorted) dead ranks.

        Live ranks beat the monitor with ``step``; dead ranks are marked on
        both the communicator and the monitor.
        """
        t = time.monotonic() if now is None else now
        if t - self._last_poll < self.interval:
            return sorted(self.comm.dead_ranks)
        self._last_poll = t
        for r in range(self.comm.size):
            if self.comm.probe(r):
                self.monitor.beat(r, step, now=now)
            else:
                self.monitor.mark_dead(r)
        return sorted(self.comm.dead_ranks)
