"""The sampler of the port: greedy decoding only so far.  Stochastic
sampling needs a threefry generator that matches ``jax.random`` bit for bit
(ROADMAP Queue 1 item 5)."""

from __future__ import annotations

import torch


def greedy_tokens(logits: torch.Tensor) -> torch.Tensor:
    """Argmax over raw logits (the first maximum on ties, as ``jnp.argmax``)
    as int32 — the greedy sampler."""
    return torch.argmax(logits, dim=-1).to(torch.int32)
