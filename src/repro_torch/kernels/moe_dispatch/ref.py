"""Plain PyTorch versions of MoE dispatch position assignment (the oracle
the CUDA kernel is held to on the card, and the path a CPU tensor takes)
and a naive-loop reference for the whole dispatch/combine (tests).

Dispatch semantics (Switch-style, capacity-factor dropping), as in
``repro.kernels.moe_dispatch.ref``: assignments are ranked in flattened
(token-major, slot-minor) order; each expert accepts its first ``capacity``
assignments and DROPS the rest.  An id outside ``[0, E)`` ranks nothing: its
position is 0 and it counts for no expert.
"""

from __future__ import annotations

import torch


def moe_positions_ref(expert_ids: torch.Tensor, n_experts: int):
    """expert_ids: (T, K) int32 in [0, E) (or out of range = invalid).
    Returns pos (T, K) int32 — the rank of each assignment within its expert
    in flattened token-major order — and counts (E,) int32."""
    t, k = expert_ids.shape
    flat = expert_ids.reshape(t * k)
    experts = torch.arange(n_experts, dtype=flat.dtype, device=flat.device)
    onehot = (flat[:, None] == experts[None, :]).to(torch.int32)
    excl = torch.cumsum(onehot, dim=0, dtype=torch.int32) - onehot
    pos = (excl * onehot).sum(dim=1, dtype=torch.int32)
    counts = onehot.sum(dim=0, dtype=torch.int32)
    return pos.reshape(t, k), counts


def moe_ffn_loop_ref(x, expert_ids, gates, w_up, w_down, capacity: int):
    """Naive Python-loop MoE FFN with capacity dropping (test oracle).

    x: (T, D); expert_ids / gates: (T, K); w_up: (E, D, F); w_down:
    (E, F, D).  Expert activation: relu.  Returns (T, D) float32."""
    x, gates = x.float(), gates.float()
    w_up, w_down = w_up.float(), w_down.float()
    t, k = expert_ids.shape
    e = w_up.shape[0]
    counts = [0] * e
    y = torch.zeros_like(x)
    for tok in range(t):
        for slot in range(k):
            ex = int(expert_ids[tok, slot])
            if ex < 0 or ex >= e:
                continue
            counts[ex] += 1
            if counts[ex] > capacity:        # overflow: dropped
                continue
            h = torch.relu(x[tok] @ w_up[ex])
            y[tok] += gates[tok, slot] * (h @ w_down[ex])
    return y
