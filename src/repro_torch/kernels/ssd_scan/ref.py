"""Plain PyTorch versions of the Mamba2 SSD (state-space duality) scan: the
oracle the CUDA kernel is held to on the card, and the path a CPU tensor
takes.  Same semantics as ``repro.kernels.ssd_scan.ref``, per head:

    h_t = exp(dt_t * A) * h_{t-1} + dt_t * (x_t outer B_t)        # (P, N)
    y_t = h_t @ C_t + D * x_t                                     # (P,)

``ssd_ref`` is the strictly sequential oracle (a loop over time);
``ssd_chunked_ref`` is the chunked algorithm the kernel implements.  All
arithmetic runs in f32.
"""

from __future__ import annotations

import torch


def ssd_ref(x, dt, A, B, C, D=None, h0=None):
    """x: (Bz, S, H, P); dt: (Bz, S, H) positive; A: (H,) negative;
    B, C: (Bz, S, N) (single group, broadcast over heads);
    D: (H,) or None; h0: (Bz, H, P, N) or None.
    Returns y: (Bz, S, H, P) in x's dtype, h_final: (Bz, H, P, N) f32."""
    bz, s, h, p = x.shape
    n = B.shape[-1]
    xf, dtf, Bf, Cf = x.float(), dt.float(), B.float(), C.float()
    Af = A.float()
    hst = (torch.zeros((bz, h, p, n), dtype=torch.float32, device=x.device)
           if h0 is None else h0.float())
    ys = []
    for t in range(s):
        decay = torch.exp(dtf[:, t] * Af[None, :])                 # (Bz,H)
        upd = (dtf[:, t, :, None, None] * xf[:, t, :, :, None]
               * Bf[:, t, None, None, :])
        hst = decay[..., None, None] * hst + upd
        ys.append(torch.einsum("bhpn,bn->bhp", hst, Cf[:, t]))
    y = torch.stack(ys, dim=1) if ys else xf.clone()
    if D is not None:
        y = y + D.float()[None, None, :, None] * xf
    return y.to(x.dtype), hst


def _segsum(a):
    """L[i, j] = sum_{k in (j, i]} a_k for i >= j else -inf.  a: (..., Q)."""
    q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]            # cum_i - cum_j
    i = torch.arange(q, device=a.device)
    mask = i[:, None] >= i[None, :]
    return diff.masked_fill(~mask, float("-inf"))


def ssd_chunked_ref(x, dt, A, B, C, D=None, h0=None, chunk: int = 64):
    """Chunked SSD, the algorithm the CUDA kernel implements: the
    quadratic-in-chunk intra term ``(C·Bᵀ)∘L∘dt @ x`` plus the inter-chunk
    term from the f32 state carried across chunks.  S % chunk == 0."""
    bz, s, h, p = x.shape
    n = B.shape[-1]
    if s % chunk:
        raise ValueError(f"S={s} is not a multiple of chunk={chunk}")
    nc = s // chunk
    xf = x.float().reshape(bz, nc, chunk, h, p)
    dtf = dt.float().reshape(bz, nc, chunk, h)
    Bf = B.float().reshape(bz, nc, chunk, n)
    Cf = C.float().reshape(bz, nc, chunk, n)
    a = dtf * A.float()[None, None, None, :]              # (bz, nc, Q, h)

    hprev = (torch.zeros((bz, h, p, n), dtype=torch.float32, device=x.device)
             if h0 is None else h0.float())
    ys = []
    for c in range(nc):
        xc, dtc, bc, cc, ac = xf[:, c], dtf[:, c], Bf[:, c], Cf[:, c], a[:, c]
        cum = torch.cumsum(ac, dim=1)                     # (bz, Q, h) inclusive
        L = torch.exp(_segsum(ac.transpose(1, 2)))        # (bz, h, Q, Q)
        att = torch.einsum("bqn,bkn->bqk", cc, bc)        # (bz, Q, Q) shared heads
        att = att[:, None] * L * dtc.transpose(1, 2)[:, :, None, :]   # * dt_j
        y_intra = torch.einsum("bhqk,bkhp->bqhp", att, xc)
        y_inter = (torch.einsum("bqn,bhpn->bqhp", cc, hprev)
                   * torch.exp(cum)[:, :, :, None])
        wexp = torch.exp(cum[:, -1:, :] - cum) * dtc      # (bz, Q, h)
        # two operands: a three-operand einsum would build (bz,Q,h,P,N)
        upd = torch.einsum("bqhp,bqn->bhpn", xc * wexp[..., None], bc)
        hprev = torch.exp(cum[:, -1, :])[:, :, None, None] * hprev + upd
        ys.append(y_intra + y_inter)
    y = (torch.stack(ys, dim=1).reshape(bz, s, h, p) if ys
         else x.float().clone())
    if D is not None:
        y = y + D.float()[None, None, :, None] * x.float()
    return y.to(x.dtype), hprev


def _hi_lo(v):
    """f32 ``v`` as the sum of a bf16 hi half and the bf16 lo half of what hi
    rounded off, both returned widened to f32."""
    hi = v.to(torch.bfloat16).float()
    return hi, (v - hi).to(torch.bfloat16).float()


def ssd_chunked_tc_ref(x, dt, A, B, C, D=None, h0=None, chunk: int = 64):
    """``ssd_chunked_ref`` rounded as the CUDA kernel's tensor-core body
    rounds: x, B and C enter the products as they are (bf16, exact), and
    every f32 operand of a product, the decay-weighted ``att``, the carried
    state ``h_prev`` and the state update's ``w * B``, as a hi and a lo bf16
    half, one product each, summed in f32.  A model of the body's precision
    for the tests; no path runs it.  S % chunk == 0."""
    bz, s, h, p = x.shape
    n = B.shape[-1]
    if s % chunk:
        raise ValueError(f"S={s} is not a multiple of chunk={chunk}")
    nc = s // chunk
    xf = x.float().reshape(bz, nc, chunk, h, p)
    dtf = dt.float().reshape(bz, nc, chunk, h)
    Bf = B.float().reshape(bz, nc, chunk, n)
    Cf = C.float().reshape(bz, nc, chunk, n)
    a = dtf * A.float()[None, None, None, :]

    hprev = (torch.zeros((bz, h, p, n), dtype=torch.float32, device=x.device)
             if h0 is None else h0.float())
    ys = []
    for c in range(nc):
        xc, dtc, bc, cc, ac = xf[:, c], dtf[:, c], Bf[:, c], Cf[:, c], a[:, c]
        cum = torch.cumsum(ac, dim=1)                     # (bz, Q, h)
        L = torch.exp(_segsum(ac.transpose(1, 2)))        # (bz, h, Q, Q)
        att = torch.einsum("bqn,bkn->bqk", cc, bc)
        att = att[:, None] * L * dtc.transpose(1, 2)[:, :, None, :]
        y = sum(torch.einsum("bhqk,bkhp->bqhp", part, xc)
                for part in _hi_lo(att))
        y_inter = sum(torch.einsum("bqn,bhpn->bqhp", cc, part)
                      for part in _hi_lo(hprev))
        y = y + y_inter * torch.exp(cum)[:, :, :, None]
        wexp = torch.exp(cum[:, -1:, :] - cum) * dtc      # (bz, Q, h)
        wb = wexp[..., None] * bc[:, :, None, :]          # (bz, Q, h, N)
        upd = sum(torch.einsum("bqhp,bqhn->bhpn", xc, part)
                  for part in _hi_lo(wb))
        hprev = torch.exp(cum[:, -1, :])[:, :, None, None] * hprev + upd
        ys.append(y)
    y = (torch.stack(ys, dim=1).reshape(bz, s, h, p) if ys
         else x.float().clone())
    if D is not None:
        y = y + D.float()[None, None, :, None] * x.float()
    return y.to(x.dtype), hprev
