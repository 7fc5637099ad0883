"""First-faulting loads and the FFR (SVE C4), with the semantics of
``repro.core.ffr``.

The card has no faulting vector loads either, so what is kept is the
architectural contract of paper §2.3.3: a speculative load may touch
addresses not known to be safe; lanes from the first "faulting" lane on
are not loaded, and a first-fault register (FFR) reports the safe
partition; the first active lane is never suppressed — a fault there reads
the fill value with its FFR bit clear, for the caller to check.  A fault
is a bounds violation of a software-managed address space (page tables,
ragged token buffers, linked structures in arrays), checked explicitly;
the load itself reads clamped addresses, so it has no side effect.
"""

from __future__ import annotations

from typing import Callable

import torch

from . import partition as PT
from . import predicate as P


def fault_oob(indices: torch.Tensor, lower, upper) -> torch.Tensor:
    """Fault predicate of a [lower, upper) address window."""
    return (indices < lower) | (indices >= upper)


def ldff(base: torch.Tensor, indices: torch.Tensor, p: torch.Tensor, *,
         fault: torch.Tensor | None = None, lower: int = 0,
         upper: int | None = None, fill=0):
    """First-faulting gather along axis 0 of ``base``: ``(values, ffr)``.

    ``fault`` defaults to an out-of-bounds check against [lower, upper or
    len(base)).  The FFR is the governed lanes strictly before the first
    faulting active lane (``brkb``); lanes outside it read ``fill``.  Paper
    Fig. 4: A[2] invalid gives FFR = [T, T, F, F]."""
    if upper is None:
        upper = base.shape[0]
    if fault is None:
        fault = fault_oob(indices, lower, upper)
    ffr = PT.brkb(p, fault)
    vals = base[indices.to(torch.int64).clamp(0, base.shape[0] - 1)]
    fill_v = torch.as_tensor(fill, dtype=vals.dtype, device=vals.device)
    return torch.where(P._bcast(ffr, vals.dim()), vals, fill_v), ffr


def ldff_contiguous(base: torch.Tensor, start, p: torch.Tensor, *,
                    valid_len=None, fill=0):
    """First-faulting contiguous load of ``base[start : start + VL]``: the
    ``ldff1b`` of the paper's strlen, lanes past the valid region fault."""
    start = torch.as_tensor(start, device=base.device)
    idx = start + torch.arange(p.shape[-1], dtype=torch.int32, device=base.device)
    upper = base.shape[0] if valid_len is None else valid_len
    return ldff(base, idx, p, lower=0, upper=upper, fill=fill)


def speculative_loop(body: Callable, start_state, p0: torch.Tensor,
                     max_iters: int):
    """The setffr/ldff/rdffr/brk loop of paper Fig. 5c, at most
    ``max_iters`` steps: ``body(state, p) -> (state, p_continue, done)``
    runs one speculative vector step, and the loop re-enters while ``done``
    is false (one host read a step).  Returns (state, p, done)."""
    state, p = start_state, p0
    done = torch.zeros((), dtype=torch.bool, device=p0.device)
    for _ in range(max_iters):
        state, p, done = body(state, p)
        if bool(done):
            break
    return state, p, done


def strlen(buf: torch.Tensor, s=0, *, valid_len=None, vl: int = 128):
    """Paper Fig. 5: strlen by first-faulting loads (ldff1b -> rdffr ->
    cmpeq -> brkbs -> incp, looping on ``b.last``).  ``buf`` holds bytes (0
    terminates); past ``valid_len`` it faults.  Returns the length as an
    int32 tensor (the bounded length when no terminator lies in bounds)."""
    valid_len = buf.shape[0] if valid_len is None else valid_len
    p0 = P.ptrue(vl, device=buf.device)

    def body(e, _p):
        vals, ffr = ldff_contiguous(buf, e, p0, valid_len=valid_len, fill=-1)
        before_nul = PT.brkb(ffr, ffr & (vals == 0))
        # b.last: go on while the partition's last lane is active (no NUL
        # and no fault in this vector)
        return e + P.cntp(before_nul), p0, ~P.last(before_nul)

    s = torch.as_tensor(s, dtype=torch.int32, device=buf.device)
    e, _, _ = speculative_loop(body, s, p0,
                               max_iters=buf.shape[0] // max(vl, 1) + 2)
    return e - s
