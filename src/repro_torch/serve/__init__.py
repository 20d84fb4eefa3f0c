"""Batched serving with window-backed sessions."""

from .engine import Engine, SessionStore

__all__ = ["Engine", "SessionStore"]
