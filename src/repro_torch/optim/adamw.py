"""AdamW, mirroring ``repro.optim.adamw`` formula for formula (not
``torch.optim.AdamW``: the rounding order is the JAX function's).

Trees are dicts of tensors by name (a state dict's order).  The update and
the clip work IN PLACE on the step's own gradients, moments and masters,
one tensor at a time: a second copy of a 3B model's f32 state would not fit
one card (the JAX launcher donates its state for the same reason)."""

from __future__ import annotations

import torch

from repro_torch.dist import collectives as C
from repro_torch.dist import sharding as SH


def adamw_init(params: dict) -> dict:
    return {"m": {k: torch.zeros_like(p, dtype=torch.float32)
                  for k, p in params.items()},
            "v": {k: torch.zeros_like(p, dtype=torch.float32)
                  for k, p in params.items()},
            "count": torch.zeros((), dtype=torch.int32,
                                 device=next(iter(params.values())).device)}


@torch.no_grad()
def clip_by_global_norm(grads: dict, max_norm: float, *, shardings=None,
                        mesh=None):
    """Scale the gradients (in place) so their global L2 norm is at most
    ``max_norm``; returns (grads, norm before clipping).  The norm sums the
    leaves' squares in the dict's order.

    On a ``mesh`` each gradient is this rank's block under its spec in
    ``shardings`` (a dict by the same names): the blocks' squares are
    summed over the whole mesh, a block replicated over an axis counted
    once (``sharding.counted``)."""
    if mesh is None:
        sq = sum(g.float().square().sum() for g in grads.values())
    else:
        sq = sum(g.float().square().sum() for n, g in grads.items()
                 if SH.counted(shardings[n], mesh))
        sq = C.sum_scalars(torch.as_tensor(
            sq, dtype=torch.float32,
            device=next(iter(grads.values())).device).reshape(()))
    gn = torch.sqrt(sq)
    scale = torch.clamp(max_norm / gn.clamp_min(1e-12), max=1.0)
    for g in grads.values():
        if g.dtype == torch.float32:
            g.mul_(scale)
        else:
            g.copy_(g.float() * scale)
    return grads, gn


@torch.no_grad()
def adamw_update(grads: dict, opt_state: dict, params: dict, *, lr, b1=0.9,
                 b2=0.95, eps=1e-8, weight_decay=0.1):
    """One AdamW step with bias correction and decoupled weight decay on
    every leaf; updates ``opt_state`` and ``params`` in place and returns
    (params, opt_state)."""
    count = opt_state["count"] + 1
    c = count.float()
    bc1 = 1.0 - b1 ** c
    bc2 = 1.0 - b2 ** c
    for k, p in params.items():
        gf = grads[k].float()
        m, v = opt_state["m"][k], opt_state["v"][k]
        m.mul_(b1).add_((1 - b1) * gf)
        v.mul_(b2).add_((1 - b2) * gf.square())
        step = (m / bc1) / ((v / bc2).sqrt() + eps) + weight_decay * p.float()
        p.copy_(p.float() - lr * step)
        del gf, step
    return params, {"m": opt_state["m"], "v": opt_state["v"], "count": count}
