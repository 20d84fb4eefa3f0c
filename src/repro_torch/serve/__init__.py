"""Batched serving with window-backed sessions."""

from .engine import Engine, SessionStore, exact_float32

__all__ = ["Engine", "SessionStore", "exact_float32"]
