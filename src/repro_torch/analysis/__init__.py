"""Correctness tooling for the windows-on-storage RMA model: the runtime
half, the counterpart of ``repro.analysis``.

:class:`~repro_torch.analysis.sanitizer.WindowSanitizer` -- with
``REPRO_SANITIZE=1`` :func:`repro_torch.core.transport.make_transport`
wraps any :class:`~repro_torch.core.transport.Transport` in a shadow-state
checker that tracks per-(segment, byte-range) access sets per
notified-access epoch and raises/records structured violations:
conflicting same-epoch put/put or put/get without an intervening
flush/sync, atomics mixed into non-exclusive posted trains, segment
use-after-free, and free/shutdown before the flush epoch completed.
Findings are JSON records shaped like ``benchmarks/run.py --json``.

The static half, ``rmalint`` (``python -m repro.analysis.rmalint``), is a
linter of source files: its default paths cover ``src/repro_torch`` too,
so this package keeps no copy of it.
"""

from .sanitizer import (Finding, SanitizerError, WindowSanitizer,
                        maybe_sanitize, sanitize_enabled, sanitize_report)

__all__ = ["Finding", "SanitizerError", "WindowSanitizer", "maybe_sanitize",
           "sanitize_enabled", "sanitize_report"]
