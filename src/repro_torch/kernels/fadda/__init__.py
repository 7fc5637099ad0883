"""Strictly ordered f32 accumulation (SVE ``fadda``): a CUDA kernel for
Hopper, the plain sequential loop."""

from .ops import fadda, fadda_rows  # noqa: F401
