"""Serving: the one-shot batched engine (the scheduler comes in later slices)."""

from .engine import ServeEngine  # noqa: F401
