"""Horizontal operations (SVE C7): predicated reductions, including the
strictly ordered ``fadda``, with the semantics of ``repro.core.reductions``.

Predicates are bool tensors over the lane axis, broadcast right-aligned
against the data; an inactive lane reads as the reduction's identity (0 for
sums, xor and or, all ones for and, the type's extreme for max and min).

  * order-free predicated reductions (``faddv``, ``eorv``, ``orv``,
    ``andv``, ``smaxv``, ``sminv``);
  * ``fadda`` and ``fadda_scan`` — strictly sequential, bit-identical to the
    scalar loop: on a CUDA f32 tensor the hand-written kernel of
    ``kernels.fadda``, on the CPU the plain loop (``torch.cumsum`` is never
    used: its order of accumulation is unspecified);
  * ``fadda_tiled`` (the strip-mined form, to prove VL invariance) and
    ``pairwise_sum`` (a fixed tree, deterministic and VL-independent).
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels.fadda import fadda_rows

from . import predicate as P


def _masked(p, x: torch.Tensor, ident) -> torch.Tensor:
    if p is None:
        return x
    return torch.where(P._bcast(torch.as_tensor(p, device=x.device), x.dim()),
                       x, torch.as_tensor(ident, dtype=x.dtype, device=x.device))


def _tree(x: torch.Tensor, op, ident, axis: int) -> torch.Tensor:
    """Reduce ``axis`` by halving with a bitwise op (PyTorch has no xor/or/and
    reduction); the identity pads odd lengths."""
    x = torch.movedim(x, axis, -1)
    if x.shape[-1] == 0:
        return torch.full(x.shape[:-1], ident, dtype=x.dtype, device=x.device)
    while x.shape[-1] > 1:
        if x.shape[-1] % 2:
            pad = torch.full(x.shape[:-1] + (1,), ident, dtype=x.dtype,
                             device=x.device)
            x = torch.cat([x, pad], dim=-1)
        x = op(x[..., 0::2], x[..., 1::2])
    return x[..., 0]


def _lowest(dtype):
    return (torch.finfo(dtype).min if dtype.is_floating_point
            else torch.iinfo(dtype).min)


def _highest(dtype):
    return (torch.finfo(dtype).max if dtype.is_floating_point
            else torch.iinfo(dtype).max)


# ---- order-free predicated reductions (SVE faddv/eorv/orv/andv/smaxv/...) ----

def faddv(p, x, axis=-1):
    return torch.sum(_masked(p, x, 0), dim=axis, dtype=x.dtype)


def eorv(p, x, axis=-1):
    return _tree(_masked(p, x, 0), torch.bitwise_xor, 0, axis)


def orv(p, x, axis=-1):
    return _tree(_masked(p, x, 0), torch.bitwise_or, 0, axis)


def andv(p, x, axis=-1):
    return _tree(_masked(p, x, -1), torch.bitwise_and, -1, axis)


def smaxv(p, x, axis=-1):
    return torch.amax(_masked(p, x, _lowest(x.dtype)), dim=axis)


def sminv(p, x, axis=-1):
    return torch.amin(_masked(p, x, _highest(x.dtype)), dim=axis)


# ---- strictly-ordered reduction ----

def _ordered(p, x, init, axis, partials: bool):
    """The one strictly ordered accumulation shared by ``fadda`` and
    ``fadda_scan``: inactive lanes add +0.0 (masked, not skipped), in the
    order of the lane axis.  Returns (final (...), partials (..., V) or
    None), with the lane axis moved last."""
    x = torch.as_tensor(x)
    if axis != -1:
        x = torch.movedim(x, axis, -1)
        if p is not None and torch.as_tensor(p).dim() == x.dim():
            p = torch.movedim(torch.as_tensor(p), axis, -1)
    if x.is_cuda and x.dtype != torch.float32:
        raise TypeError(f"the ordered kernel accumulates float32, got {x.dtype}")
    xm = _masked(p, x, 0)
    lead = xm.shape[:-1]
    rows = xm.reshape(math.prod(lead), xm.shape[-1])
    if isinstance(init, torch.Tensor):
        init = init.to(device=x.device, dtype=x.dtype).expand(lead).reshape(-1)
    out, part = fadda_rows(rows, init=init, partials=partials)
    return out.reshape(lead), (None if part is None else part.reshape(xm.shape))


def fadda(p, x, init=0.0, axis=-1):
    """Strictly ordered FP add reduction (SVE ``fadda``): active elements
    accumulate into ``init`` in ascending element order, bit-identical to
    the sequential scalar loop at every vector length (paper §3.3)."""
    acc, _ = _ordered(p, x, init, axis, partials=False)
    return acc


def fadda_scan(p, x, init=0.0, axis=-1):
    """All partial accumulations of ``fadda``: the inclusive ordered prefix
    sums.  ``fadda_scan(p, x)[..., i]`` is the accumulator after elements
    0..i, so a threshold on it (the nucleus cutoff of top-p) is the same at
    every vector length and on every backend.  Inactive lanes add 0 and
    repeat the running accumulator."""
    _, part = _ordered(p, x, init, axis, partials=True)
    return part if axis == -1 else torch.movedim(part, -1, axis)


def fadda_tiled(p, x, init=0.0, vl: int = 128):
    """fadda over a long vector in VL-wide tiles: tiles in order, lanes in
    order within a tile — the scalar loop's order in strip-mined form.
    Equal to ``fadda`` for any vl; exists to prove VL invariance."""
    x = torch.as_tensor(x)
    n = x.shape[-1]
    pad = (-n) % vl
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
        pp = (P.whilelt(0, n, n + pad, device=x.device) if p is None
              else torch.nn.functional.pad(torch.as_tensor(p), (0, pad)))
    else:
        pp = P.ptrue(n, device=x.device) if p is None else torch.as_tensor(p)
    pt = torch.broadcast_to(P._bcast(pp.to(x.device), x.dim()), x.shape)
    acc = torch.as_tensor(init, dtype=x.dtype, device=x.device).expand(
        x.shape[:-1])
    for t in range(x.shape[-1] // vl):
        tile = slice(t * vl, (t + 1) * vl)
        acc = fadda(pt[..., tile], x[..., tile], init=acc)
    return acc


def pairwise_sum(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Fixed-topology pairwise reduction: deterministic and VL-independent.
    Pads to a power of two with zeros; the tree is a function of the padded
    length only, never of the tiling."""
    x = torch.movedim(torch.as_tensor(x), axis, -1)
    n = x.shape[-1]
    pot = 1 << (max(n - 1, 0)).bit_length() if n > 1 else 1
    if pot != n:
        x = torch.nn.functional.pad(x, (0, pot - n))
    while x.shape[-1] > 1:
        x = x[..., 0::2] + x[..., 1::2]
    return x[..., 0]
