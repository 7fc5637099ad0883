"""Public MoE dispatch ops: the position ranks (kernel or plain version) and
the gather/scatter table builder.

Routing, as in ``flash_attention.ops``: a CUDA tensor goes to the CUDA
kernel (which launches or raises — nothing falls back), a CPU tensor to the
plain ``moe_positions_ref``.  ``impl="naive"`` always takes the plain
version (the on-card comparison).  Overflowed assignments form the cleared
lanes of the dispatch partition (the FFR analogue).
"""

from __future__ import annotations

import torch

from . import kernel as _kernel
from .ref import moe_positions_ref

IMPLS = ("kernel", "naive")


def moe_positions(expert_ids, n_experts: int, *, impl: str = "kernel"):
    """Rank of each (token, slot) assignment within its expert, and the
    per-expert totals: (pos (T, K) int32, counts (E,) int32)."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if impl == "naive" or not expert_ids.is_cuda:
        return moe_positions_ref(expert_ids, n_experts)
    return _kernel.moe_positions_cuda(
        expert_ids.to(torch.int32).contiguous(), n_experts)


def build_dispatch(expert_ids, gates, n_experts: int, capacity: int):
    """Build the dispatch tables of a capacity-C MoE layer.

    Returns a dict with:
      token_table: (E, C) int32 — source token of each expert slot, or T
                   (one past the last: a zero row of the padded activations)
                   for an empty slot;
      slot_of:     (T, K) int32 — e*C + pos for kept assignments, else E*C
                   (a zero row of the flattened expert outputs);
      keep:        (T, K) bool — the dispatch partition (valid and pos < C);
      gates:       (T, K) — combine weights, zeroed on dropped lanes;
      counts:      (E,) int32 — raw demand per expert;
      dropped:     () int32 — the number of dropped valid assignments.
    """
    t, k = expert_ids.shape
    ids = expert_ids.to(torch.int32)
    pos, counts = moe_positions(ids, n_experts)
    valid = (ids >= 0) & (ids < n_experts)
    keep = valid & (pos < capacity)
    overflow = n_experts * capacity
    slot_of = torch.where(keep, ids * capacity + pos,
                          torch.full_like(ids, overflow))
    # scatter token -> expert slot; every dropped lane lands on the overflow
    # slot, which is cut off after the scatter
    token_ids = torch.arange(t, dtype=torch.int32, device=ids.device)
    token_table = torch.full((overflow + 1,), t, dtype=torch.int32,
                             device=ids.device)
    token_table[slot_of.reshape(-1).long()] = (
        token_ids[:, None].expand(t, k).reshape(-1))
    return dict(
        token_table=token_table[:-1].reshape(n_experts, capacity),
        slot_of=slot_of,
        keep=keep,
        gates=torch.where(keep, gates, torch.zeros_like(gates)),
        counts=counts,
        dropped=(valid & ~keep).sum(dtype=torch.int32),
    )
