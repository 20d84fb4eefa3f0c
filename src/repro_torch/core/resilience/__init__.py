"""Failure detection for storage windows.

The counterpart of ``repro.core.resilience``, trimmed to
:class:`FailureDetector`: ``Transport.probe`` turns rank death into an
observed event that feeds a heartbeat monitor and the communicator's dead
set.  Replica placement, failover and ``rebuild_window_rank`` are not
ported yet (ROADMAP.md queue A, A3 'resilience'); a window the reference
would replicate is refused by ``Window.allocate``.
"""

from .detector import FailureDetector

__all__ = ["FailureDetector"]
