"""Utilities: oracle bindings, run-time setup (compile cache, card info)."""

from . import oracle

__all__ = ["oracle"]
