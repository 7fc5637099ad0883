"""Predicated flash attention: CUDA kernels for Hopper, plain PyTorch versions."""

from .ops import flash_attention  # noqa: F401
