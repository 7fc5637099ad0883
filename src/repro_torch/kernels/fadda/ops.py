"""Public fadda ops: the strictly ordered f32 sum of ``x[:n]`` (paper §2.4)
and its row-wise form with every partial, which ``core.reductions`` calls.

Routing: a CUDA tensor goes to the CUDA kernel (which launches or raises —
nothing falls back), a CPU tensor to the plain loop in ``ref``.  ``block``
is the VL: the width of the tiles the kernel stages a row in; the result
does not depend on it.  Nothing is padded: the kernel masks its own tail.
"""

from __future__ import annotations

import torch

from . import kernel as _kernel
from .ref import fadda_scan_plain

DEFAULT_BLOCK = 512


def fadda_rows(x: torch.Tensor, n=None, init=0.0, *, partials: bool,
               block: int = DEFAULT_BLOCK):
    """x (B, V).  Returns (out (B,), partials (B, V) or None): each row's
    strictly ordered sum from ``init`` (scalar or (B,)), elements at or past
    ``n`` (scalar or (B,), default V) adding +0.0.  f32 on the card; a CPU
    tensor runs the plain loop in its own dtype."""
    b, v = x.shape
    n = v if n is None else n
    if not x.is_cuda:
        _kernel.check_block(block)
        if v == 0:
            acc = torch.as_tensor(init, dtype=x.dtype).expand(b).clone()
            return acc, (x.clone() if partials else None)
        scan = fadda_scan_plain(x, n, init)
        return scan[:, -1].clone(), (scan if partials else None)
    return _kernel.fadda_rows_cuda(
        x.contiguous(), _per_row(n, b, torch.int32, x.device),
        _per_row(init, b, torch.float32, x.device), partials=partials,
        block=block)


def _per_row(val, b: int, dtype, device) -> torch.Tensor:
    """A scalar or (B,) argument as a contiguous (B,) tensor on the card; a
    host number becomes a fill, not a blocking host-to-device copy."""
    if isinstance(val, torch.Tensor):
        return val.to(device=device, dtype=dtype).expand(b).contiguous()
    return torch.full((b,), val, dtype=dtype, device=device)


def fadda(x: torch.Tensor, n=None, *, block: int = DEFAULT_BLOCK) -> torch.Tensor:
    """Strictly ordered f32 accumulation of x[:n] (paper §2.4): a 0-dim f32
    tensor, bit-identical to ``fadda_ref`` at every ``block``."""
    out, _ = fadda_rows(x.to(torch.float32).reshape(1, -1), n, partials=False,
                        block=block)
    return out[0]
