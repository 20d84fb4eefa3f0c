"""Fault tolerance at scale: heartbeats, stragglers, elastic re-meshing.

The counterpart of ``repro.runtime.fault``: numpy only, so it is the
reference's code with its names.

The paper's contribution makes the *state* durable (windows synced to
storage); this module supplies the cluster-side machinery that decides when
and how to restart around it:

* ``HeartbeatMonitor`` -- per-rank step heartbeats; a rank is *suspect*
  after ``timeout`` without one, *dead* after ``dead_timeout``.  Fed two
  ways: SPMD ranks self-report via ``beat``, and
  ``repro_torch.core.resilience.FailureDetector`` probes every rank through
  the communicator's transport (``Transport.probe``) so a worker's death is
  observed (``mark_dead``) instead of discovered on the first hung call.
* ``StragglerDetector`` -- robust (median + MAD) step-time outliers; in
  elastic mode persistent stragglers are evicted into the spare pool.
* ``plan_recovery`` -- given the survivor count, pick the largest valid
  mesh (TP axis is never shrunk -- it is wired to ICI topology; the DP axis
  shrinks, then whole pods drop) and emit a restart plan.  Because window
  checkpoints store *logical* tensors with a deterministic layout
  (WindowedPyTree), any survivor set can re-shard them on restart.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Iterable

import numpy as np

__all__ = ["HeartbeatMonitor", "StragglerDetector", "RecoveryPlan",
           "plan_recovery"]


class HeartbeatMonitor:
    def __init__(self, n_ranks: int, timeout: float = 30.0,
                 dead_timeout: float = 120.0):
        self.n = n_ranks
        self.timeout = timeout
        self.dead_timeout = dead_timeout
        self.last_beat = np.full(n_ranks, -np.inf)
        self.last_step = np.full(n_ranks, -1, dtype=np.int64)

    def beat(self, rank: int, step: int, now: float | None = None) -> None:
        now = time.monotonic() if now is None else now
        self.last_beat[rank] = now
        self.last_step[rank] = step

    def mark_dead(self, rank: int) -> None:
        """Force-expire a rank (probe-confirmed death, e.g. a SIGKILLed mp
        worker): it reports as dead immediately instead of after
        ``dead_timeout`` without a beat.  A later ``beat`` revives it."""
        self.last_beat[rank] = -np.inf

    def suspects(self, now: float | None = None) -> list[int]:
        now = time.monotonic() if now is None else now
        return [r for r in range(self.n)
                if self.timeout <= now - self.last_beat[r] < self.dead_timeout]

    def dead(self, now: float | None = None) -> list[int]:
        now = time.monotonic() if now is None else now
        return [r for r in range(self.n) if now - self.last_beat[r] >= self.dead_timeout]

    def alive(self, now: float | None = None) -> list[int]:
        d = set(self.dead(now))
        return [r for r in range(self.n) if r not in d]


class StragglerDetector:
    """Median + MAD outlier detection over a sliding window of step times."""

    def __init__(self, n_ranks: int, window: int = 20, k: float = 4.0,
                 persist: int = 3):
        self.n = n_ranks
        self.window = window
        self.k = k
        self.persist = persist
        self.times: list[list[float]] = [[] for _ in range(n_ranks)]
        self.flags = np.zeros(n_ranks, dtype=np.int64)

    def record(self, rank: int, step_time: float) -> None:
        t = self.times[rank]
        t.append(step_time)
        if len(t) > self.window:
            t.pop(0)

    def stragglers(self) -> list[int]:
        latest = [t[-1] for t in self.times if t]
        if len(latest) < max(3, self.n // 2):
            return []
        med = float(np.median(latest))
        mad = float(np.median(np.abs(np.asarray(latest) - med))) or 1e-9
        out = []
        for r in range(self.n):
            if not self.times[r]:
                continue
            if self.times[r][-1] > med + self.k * mad and self.times[r][-1] > 1.05 * med:
                self.flags[r] += 1
                if self.flags[r] >= self.persist:
                    out.append(r)
            else:
                self.flags[r] = 0
        return out


@dataclasses.dataclass(frozen=True)
class RecoveryPlan:
    mesh_shape: tuple[int, ...]
    mesh_axes: tuple[str, ...]
    active_ranks: tuple[int, ...]
    spares: tuple[int, ...]
    restart_step: int
    lost_throughput: float  # fraction of original chips idle


def plan_recovery(total: int, alive: Iterable[int], *, model: int = 16,
                  pods: int = 1, restart_step: int = 0) -> RecoveryPlan:
    """Largest usable mesh from the survivor set.

    Never shrinks the TP ("model") axis: TP is pinned to ICI neighbours.
    Shrinks DP first; drops whole pods when a pod cannot field a full TP
    group per DP row.
    """
    alive = sorted(alive)
    n_alive = len(alive)
    per_pod = total // pods
    # survivors per pod
    by_pod = [sum(1 for r in alive if p * per_pod <= r < (p + 1) * per_pod)
              for p in range(pods)]
    pod_rows = [n // model for n in by_pod]      # full TP rows each pod can field
    data = min((r for r in pod_rows if r > 0), default=0)
    live_pods = sum(1 for r in pod_rows if r >= max(1, data))
    if data == 0 or live_pods == 0:
        raise RuntimeError("not enough survivors for a single TP group")
    if live_pods > 1:
        shape = (live_pods, data, model)
        axes = ("pod", "data", "model")
    else:
        shape = (data, model)
        axes = ("data", "model")
    need = live_pods * data * model
    # choose the first `need` survivors pod-by-pod, respecting TP grouping
    active: list[int] = []
    for p in range(pods):
        if pod_rows[p] < data or len(active) >= need:
            continue
        ranks = [r for r in alive if p * per_pod <= r < (p + 1) * per_pod]
        active.extend(ranks[: data * model])
    active = active[:need]
    spares = tuple(r for r in alive if r not in set(active))
    return RecoveryPlan(
        mesh_shape=shape, mesh_axes=axes, active_ranks=tuple(active),
        spares=spares, restart_step=restart_step,
        lost_throughput=1.0 - need / total)
