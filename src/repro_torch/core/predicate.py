"""Predicate-centric execution (SVE C2/C3) as boolean tensor algebra.

The helpers of ``repro.core.predicate``, with its semantics: predicates are
bool tensors over the trailing (lane) axis and broadcast right-aligned
against the data they govern; the NZCV conditions of the paper's Table 1
(``first``, ``none``, ``last``, ...) are reductions over that axis.
Everything runs on the device of its inputs (``device=`` for the
constructors), and nothing reads back to the host.
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


_U32 = 0xFFFFFFFF


def whilelo(start, limit, vl: int, *, device=None) -> torch.Tensor:
    """Unsigned variant of ``whilelt``: start, limit and start + i as
    uint32 (a negative input wraps, as ``astype(uint32)`` does); an element
    whose index passed 2**32 - 1 is inactive."""
    start = torch.as_tensor(start, device=device)
    limit = torch.as_tensor(limit, device=start.device)
    # uint32 words held in int64: an index past 2**32 - 1 is never below a
    # uint32 limit
    s = start.to(torch.int64) & _U32
    lim = limit.to(torch.int64) & _U32
    return s + torch.arange(vl, dtype=torch.int64, device=s.device) < lim


def index_pred(lengths: torch.Tensor, vl: int) -> torch.Tensor:
    """Batched whilelt: row r active for i < lengths[r].  Shape
    (*lengths, vl) — the ragged-batch predicate."""
    lengths = torch.as_tensor(lengths)
    i = torch.arange(vl, dtype=torch.int32, device=lengths.device)
    return i[None, :] < lengths.to(torch.int32)[..., None]


# NZCV condition analogues (paper Table 1)

def first(p: torch.Tensor) -> torch.Tensor:
    """N flag: the first element is active (``b.first`` continues a loop)."""
    return p[..., 0].to(torch.bool)


def none(p: torch.Tensor) -> torch.Tensor:
    """Z flag: no element is active."""
    return ~torch.any(p, dim=-1)


def any_(p: torch.Tensor) -> torch.Tensor:
    return torch.any(p, dim=-1)


def last(p: torch.Tensor) -> torch.Tensor:
    """!C flag: the LAST element is active (``b.last`` continues a loop)."""
    return p[..., -1].to(torch.bool)


def not_last(p: torch.Tensor) -> torch.Tensor:
    """C flag: the last element is NOT active."""
    return ~last(p)


# predicate queries and manipulation

def cntp(p: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Count active elements (SVE ``cntp``), int32."""
    return torch.sum(p.to(torch.int32), dim=axis, dtype=torch.int32)


def _first_index(p: torch.Tensor) -> torch.Tensor:
    """Index of the first active element (0 when none is)."""
    return torch.argmax(p.to(torch.int8), dim=-1)


def pfirst(p: torch.Tensor) -> torch.Tensor:
    """Predicate selecting only the first active element (SVE ``pfirst``)."""
    i = torch.arange(p.shape[-1], device=p.device)
    return (i == _first_index(p)[..., None]) & torch.any(p, dim=-1, keepdim=True)


def plast(p: torch.Tensor) -> torch.Tensor:
    """Predicate selecting only the last active element."""
    return torch.flip(pfirst(torch.flip(p, dims=(-1,))), dims=(-1,))


def pnext(p_gov: torch.Tensor, p_cur: torch.Tensor) -> torch.Tensor:
    """Next active element of ``p_gov`` strictly after the one in ``p_cur``
    (SVE ``pnext``): with an empty ``p_cur`` the first active element; all
    false when exhausted."""
    i = torch.arange(p_gov.shape[-1], device=p_gov.device)
    cur = torch.where(torch.any(p_cur, dim=-1), _first_index(p_cur),
                      torch.full((), -1, device=p_gov.device))
    return pfirst(p_gov & (i > cur[..., None]))


def propagate_last(p: torch.Tensor) -> torch.Tensor:
    """Monotone closure: active up to the LAST active element (inclusive)."""
    flipped = torch.flip(p.to(torch.int32), dims=(-1,))
    return torch.flip(torch.cumsum(flipped, dim=-1) > 0, dims=(-1,))


def lane_iota(vl: int, dtype=torch.int32, *, device=None) -> torch.Tensor:
    """SVE ``index``: the [0, 1, .. VL-1] induction vector."""
    return torch.arange(vl, dtype=dtype, device=device)


def cpy(p_lane: torch.Tensor, scalar, vec: torch.Tensor) -> torch.Tensor:
    """Insert ``scalar`` into ``vec`` at the lanes of ``p_lane`` (SVE
    ``cpy /m``)."""
    fill = torch.as_tensor(scalar, dtype=vec.dtype, device=vec.device)
    return torch.where(_bcast(p_lane, vec.dim()), fill, vec)


def ctermeq(a, b, p_last: torch.Tensor) -> torch.Tensor:
    """SVE ``ctermeq``, the termination test of a scalarized sub-loop
    (paper Fig. 6c): True (continue) while the scalars differ AND the lane
    predicate still has an active element."""
    term = torch.as_tensor(a) == torch.as_tensor(b)
    return (~term.to(p_last.device)) & torch.any(p_last, dim=-1)


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


def set_lanes(v: torch.Tensor, lanes, src, *, axis: int = 0) -> torch.Tensor:
    """JAX's ``v.at[lanes].set(src)`` along ``axis``, as a new tensor: lane
    ``lanes[i]`` takes ``src``'s slice i (``src`` broadcasts against the
    indexed shape; a 0-d ``lanes`` indexes one lane and ``src`` has no lane
    axis).  A negative lane wraps, and a lane outside ``[-n, n)`` drops, as
    JAX's scatters drop it: the scheduler pads admission rows with lane
    ``n``.  Dropped rows land in one spare lane that is sliced off, so the
    result does not depend on the order of writes however many padded rows
    repeat one index, and the splice needs no host sync and has no shape
    that depends on the data (it can run inside a CUDA graph)."""
    n = v.shape[axis]
    idx = torch.as_tensor(lanes, device=v.device).to(torch.int64)
    if isinstance(src, (bool, int, float)):
        # a fill, not a tensor made from a host number: that would be a
        # blocking host-to-device copy
        src = torch.full((), src, dtype=v.dtype, device=v.device)
    src = torch.as_tensor(src, device=v.device).to(v.dtype)
    if idx.dim() == 0:
        idx = idx[None]
        src = src.unsqueeze(axis) if src.dim() == v.dim() - 1 else src
    idx = torch.where(idx < 0, idx + n, idx)
    idx = torch.where((idx < 0) | (idx >= n), torch.full_like(idx, n), idx)
    shape = list(v.shape)
    shape[axis] = idx.shape[0]
    spare = list(v.shape)
    spare[axis] = n + 1
    out = v.new_empty(spare)
    out.narrow(axis, 0, n).copy_(v)
    out.index_copy_(axis, idx, torch.broadcast_to(src, shape).contiguous())
    return out.narrow(axis, 0, n).contiguous()
