"""Per-lane sampling (greedy so far)."""

from .sampler import greedy_tokens  # noqa: F401
