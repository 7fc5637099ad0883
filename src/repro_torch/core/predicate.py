"""Predicate-centric execution (SVE C2/C3) as boolean tensor algebra.

The helpers the serving path needs, with the semantics of
``repro.core.predicate``: predicates are bool tensors over the trailing
(lane) axis and broadcast right-aligned against the data they govern.
"""

from __future__ import annotations

import torch


def ptrue(vl: int, dtype=torch.bool, *, device=None) -> torch.Tensor:
    """All-active predicate (SVE ``ptrue``)."""
    return torch.ones((vl,), dtype=dtype, device=device)


def pfalse(vl: int, dtype=torch.bool, *, device=None) -> torch.Tensor:
    """All-inactive predicate (SVE ``pfalse``)."""
    return torch.zeros((vl,), dtype=dtype, device=device)


def whilelt(start, limit, vl: int, *, device=None) -> torch.Tensor:
    """p[i] = (start + i) < limit — SVE ``whilelt`` (signed compare).

    Saturates instead of wrapping near the top of the index type, like the
    sequential loop it governs: an element whose index overflowed is
    inactive.  The index type is int32 unless an input is int64.
    """
    start = torch.as_tensor(start, device=device)
    limit = torch.as_tensor(limit, device=start.device)
    idx_dtype = (torch.int64 if torch.int64 in (start.dtype, limit.dtype)
                 else torch.int32)
    s = start.to(idx_dtype)
    i = torch.arange(vl, dtype=idx_dtype, device=s.device)
    # add in int64 and detect what the narrower index type would wrap
    wide = s.to(torch.int64) + i.to(torch.int64)
    if idx_dtype == torch.int32:
        wrapped = wide > torch.iinfo(torch.int32).max
        elem = wide
    else:
        elem = s + i
        wrapped = elem < s
    return torch.where(wrapped, torch.zeros((), dtype=torch.bool, device=s.device),
                       elem < limit.to(elem.dtype))


def _bcast(p: torch.Tensor, ndim: int) -> torch.Tensor:
    """Right-align a predicate against an ndim-tensor (lane axis trailing)."""
    while p.dim() < ndim:
        p = p.unsqueeze(0)
    return p


def sel(p, a, b):
    """Predicated select (merging move): p ? a : b."""
    return torch.where(_bcast(p, a.dim()), a, b)


def zeroing(p, a):
    """Zeroing predication: inactive lanes read as 0 (SVE ``/z``)."""
    return torch.where(_bcast(p, a.dim()), a, torch.zeros_like(a))


def merging(p, new, old):
    """Merging predication: inactive lanes keep the old value (SVE ``/m``)."""
    return torch.where(_bcast(p, new.dim()), new, old)
