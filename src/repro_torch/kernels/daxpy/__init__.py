"""Predicated daxpy (the paper's Fig. 2): a CUDA kernel for Hopper, the
plain PyTorch version."""

from .ops import daxpy  # noqa: F401
