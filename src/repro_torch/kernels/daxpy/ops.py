"""Public daxpy op: vector-length agnostic, one kernel for every (n, VL).

Routing: a CUDA tensor goes to the CUDA kernel (which launches or raises —
nothing falls back), a CPU tensor to the plain ``daxpy_ref``.  ``block`` is
the strip width (the VL); the kernel masks its own tail by the ``whilelt``
predicate, so nothing is padded and the result does not depend on it.
"""

from __future__ import annotations

import torch

from . import kernel as _kernel
from .ref import daxpy_ref

DEFAULT_BLOCK = 2048


def daxpy(x: torch.Tensor, y: torch.Tensor, a, n=None, *,
          block: int | None = None) -> torch.Tensor:
    """y[i] = a*x[i] + y[i] for i < n (default len(x)); elements at or past
    n keep y.  ``a`` is rounded to x's dtype first, as the JAX op does."""
    n = x.shape[0] if n is None else int(n)
    block = DEFAULT_BLOCK if block is None else block
    _kernel.check_block(block)
    a_x = torch.tensor(a, dtype=x.dtype)
    if not x.is_cuda:
        return daxpy_ref(x, y, a_x, n)
    return _kernel.daxpy_cuda(x, y, float(a_x), n, block=block)
