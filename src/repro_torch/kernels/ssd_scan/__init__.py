"""Mamba2 SSD scan: a CUDA kernel for Hopper, plain PyTorch versions."""

from .ops import ssd_decode_step, ssd_scan  # noqa: F401
