"""Vector partitioning and dynamic exits (SVE C5), scalarized sub-loops
(C6) and lane permutation, with the semantics of ``repro.core.partition``.

A break condition cuts a governing predicate into a partition
(``brka``/``brkb``); side effects happen only inside it.  The serving path
uses the same algebra: finished requests are inactive lanes, speculative
acceptance is ``brkb`` over the first mismatch (``accept_prefix``), and
``compact``/``splice``/``lasta``/``lastb`` move lanes.  The loops
(``partitioned_while``, ``serial_subloop``) are Python loops that read one
predicate reduction back to the host per iteration; everything else is
tensor algebra on the device of its inputs.
"""

from __future__ import annotations

from typing import Callable, TypeVar

import torch

from . import predicate as P

T = TypeVar("T")


def brkb(p_gov: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
    """Break-BEFORE partition (SVE ``brkb``): the active lanes of ``p_gov``
    strictly before the first active lane where ``cond`` holds; ``p_gov``
    itself when no active lane does."""
    hit = (p_gov & cond).to(torch.int32)
    return p_gov & ~(torch.cumsum(hit, dim=-1) > 0)


def brka(p_gov: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
    """Break-AFTER partition (SVE ``brka``): the active lanes up to and
    INCLUDING the first active ``cond`` lane."""
    hit = (p_gov & cond).to(torch.int32)
    return p_gov & ((torch.cumsum(hit, dim=-1) - hit) == 0)


def brkpb(p_gov: torch.Tensor, p_prev_partition: torch.Tensor,
          cond: torch.Tensor) -> torch.Tensor:
    """Propagating break (SVE ``brkpb``): empty where the previous
    partition already broke (its last lane is inactive), else ``brkb``."""
    carried = P.last(p_prev_partition)
    return torch.where(carried[..., None], brkb(p_gov, cond),
                       torch.zeros_like(p_gov))


def partitioned_while(cond_fn: Callable[[T, torch.Tensor], torch.Tensor],
                      body_fn: Callable[[T, torch.Tensor], T], init: T,
                      p0: torch.Tensor):
    """Run ``body_fn`` under a monotonically shrinking active partition
    (paper §2.3.4): each iteration intersects the partition with
    ``cond_fn(state, p)`` (True = the lane CONTINUES) and runs
    ``body_fn(state, p)`` while a lane is left; the loop ends when none is.
    ``body_fn`` must not update inactive lanes (``P.merging``).  A lane
    leaves for good, so the loop is bounded by the steps the longest lane
    takes.  Returns (final_state, final_partition)."""
    state, p = init, p0
    while bool(torch.any(p)):
        p = p & cond_fn(state, p)
        if bool(torch.any(p)):
            state = body_fn(state, p)
    return state, p


def serial_subloop(p_gov: torch.Tensor,
                   step_fn: Callable[[T, torch.Tensor, torch.Tensor], tuple],
                   init: T, max_iters: int | None = None):
    """Scalarized sub-loop (paper §2.3.5, Fig. 6): visit the active lanes of
    ``p_gov`` one at a time in element order, as SVE's ``pnext``/``cpy``
    serialize a loop-carried dependency.  ``step_fn(state, p_lane, lane)``
    handles one lane and returns ``(state, continue?)``, the ``ctermeq``
    test.  At most ``max_iters`` (default VL) lanes.  Returns (state,
    p_visited)."""
    max_iters = p_gov.shape[-1] if max_iters is None else max_iters
    state, p_cur = init, P.pfirst(p_gov)
    visited = torch.zeros_like(p_gov)
    cont, it = True, 0
    while cont and it < max_iters and bool(torch.any(p_cur)):
        lane = P._first_index(p_cur)
        state, cont = step_fn(state, p_cur, lane)
        cont = bool(cont)
        visited = visited | p_cur
        p_cur = P.pnext(p_gov, p_cur)
        it += 1
    return state, visited


# ---------------------------------------------------------------------------
# lane permutation (SVE §2.3.4/§2.3.5: compact / splice / lasta / lastb)
# ---------------------------------------------------------------------------

def compact_perm(p: torch.Tensor) -> torch.Tensor:
    """The lane permutation of SVE ``compact``: active lane indices first,
    then the inactive ones, each in ascending order.  (*batch, VL) int32."""
    return torch.argsort((~p).to(torch.int8), dim=-1, stable=True).to(torch.int32)


def _take_along(x: torch.Tensor, idx: torch.Tensor, shape) -> torch.Tensor:
    """``take_along_axis`` on the trailing axis into ``shape``: ``idx``
    broadcast to it, ``x`` to its leading axes."""
    x = x.expand(tuple(shape[:-1]) + x.shape[-1:])
    return torch.gather(x, -1, idx.to(torch.int64).expand(shape))


def compact(p: torch.Tensor, x: torch.Tensor, fill=None) -> torch.Tensor:
    """SVE ``compact``: the active elements of ``x`` in the lowest lanes,
    the rest ``fill`` (0 when None, the architected zeroing)."""
    shape = torch.broadcast_shapes(p.shape, x.shape)
    out = _take_along(x, compact_perm(p), shape)
    n_active = torch.sum(p.to(torch.int32), dim=-1, keepdim=True)
    lane = torch.arange(x.shape[-1], dtype=torch.int32, device=x.device)
    fill_v = torch.zeros((), dtype=x.dtype, device=x.device) if fill is None \
        else torch.as_tensor(fill, dtype=x.dtype, device=x.device)
    return torch.where(lane >= n_active, fill_v, out)


def _last_index(p: torch.Tensor) -> torch.Tensor:
    """Index of the last active element (VL - 1 when none is)."""
    return (p.shape[-1] - 1) - P._first_index(torch.flip(p, dims=(-1,)))


def splice(p: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """SVE ``splice``: the segment of ``a`` from the FIRST to the LAST
    active lane of ``p`` in the low lanes, then the lowest elements of
    ``b``; ``b`` unchanged with an empty predicate."""
    vl = a.shape[-1]
    lane = torch.arange(vl, device=a.device)
    any_p = torch.any(p, dim=-1, keepdim=True)
    first = P._first_index(p)[..., None]
    last = _last_index(p)[..., None]
    seg_len = torch.where(any_p, last - first + 1, 0)
    shape = torch.broadcast_shapes(p.shape, a.shape, b.shape)
    a_part = _take_along(a, (first + lane).clamp(0, vl - 1), shape)
    b_part = _take_along(b, (lane - seg_len).clamp(0, vl - 1), shape)
    return torch.where(lane < seg_len, a_part, b_part)


def _extract(p: torch.Tensor, x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Element ``idx`` of each row of ``x`` (rows broadcast with ``p``'s)."""
    lead = torch.broadcast_shapes(p.shape[:-1], x.shape[:-1])
    return _take_along(x, idx[..., None], lead + (1,))[..., 0]


def lastb(p: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """SVE ``lastb``: the LAST active element of ``x``; with no active lane
    the last element (lane VL-1)."""
    return _extract(p, x, _last_index(p))


def lasta(p: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """SVE ``lasta``: the element AFTER the last active one (lane 0 past
    the end, and with an empty predicate)."""
    vl = x.shape[-1]
    nxt = torch.where(torch.any(p, dim=-1), (_last_index(p) + 1) % vl, 0)
    return _extract(p, x, nxt)


def accept_prefix(match: torch.Tensor, p_gov: torch.Tensor | None = None):
    """Speculative-acceptance partition: the maximal prefix of matching
    lanes, ``brkb`` over the mismatches.  The first rejected lane is where
    the verifier's own token goes (the caller's), as the first faulting
    lane of an FFR load is retried."""
    if p_gov is None:
        p_gov = torch.ones_like(match)
    return brkb(p_gov, ~match)
