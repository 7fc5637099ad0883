"""Plain versions of the fadda kernel: the strictly ordered scalar loop.

``fadda_ref`` is the JAX package's numpy oracle, copied.  ``fadda_scan_plain``
is the same loop in PyTorch over a batch of rows: one ``(B,)`` f32 add per
element, in element order, on the rows' device.  It is what the kernel is
held to on the card and what a CPU tensor runs; ``torch.cumsum`` never
stands in for it, as its order of accumulation is unspecified.
"""

from __future__ import annotations

import numpy as np
import torch


def fadda_ref(x, n=None, init=0.0):
    """Bit-exact sequential accumulation of x[:n] into init (float32)."""
    x = np.asarray(x, np.float32)
    n = x.shape[0] if n is None else n
    acc = np.float32(init)
    for v in x[:n]:
        acc = np.float32(acc + v)
    return acc


def fadda_scan_plain(x: torch.Tensor, n, init) -> torch.Tensor:
    """x (B, V); n, init: scalars or (B,).  The inclusive ordered prefix sums
    (B, V) in x's dtype: element i adds x[:, i] where i < n and +0.0 where
    not (masked, not skipped)."""
    b, v = x.shape
    n = torch.as_tensor(n, device=x.device).expand(b)
    acc = torch.as_tensor(init, dtype=x.dtype, device=x.device).expand(b)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    for i in range(v):
        acc = acc + torch.where(i < n, x[:, i], zero)
        out[:, i] = acc
    return out
