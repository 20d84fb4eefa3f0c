"""Transparent checkpointing on storage windows (paper §3.5.2 / §4): the
counterpart of ``repro.ckpt``."""

from .manager import CheckpointManager, RestoreResult

__all__ = ["CheckpointManager", "RestoreResult"]
