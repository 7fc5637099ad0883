"""Plain version of the daxpy kernel (paper Fig. 2a), as ``daxpy_ref`` of
the JAX package: what the kernel is held to on the card and what a CPU
tensor runs."""

from __future__ import annotations

import torch


def daxpy_ref(x: torch.Tensor, y: torch.Tensor, a, n) -> torch.Tensor:
    """y[i] = a*x[i] + y[i] for i < n; elements at/after n are untouched.
    ``a`` is a scalar of x's dtype (a 0-dim tensor or a number)."""
    i = torch.arange(x.shape[0], device=x.device)
    return torch.where(i < n, a * x + y, y)
