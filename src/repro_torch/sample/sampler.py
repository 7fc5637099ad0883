"""The per-lane predicated sampler: one entry point for greedy AND
stochastic lanes, as in ``repro.sample.sampler``.

``sample(logits, state)`` runs the processor pipeline (penalties ->
temperature -> top-k and top-p and min-p and bans -> masked Gumbel-argmax)
and then per lane SELECTS between the stochastic draw and the bit-exact
raw-logits ``argmax`` under the lane's ``greedy`` predicate — a merging
move, so a greedy lane in a mixed batch decodes exactly as in an all-greedy
one.

Key discipline: every call splits every lane's key exactly once (greedy
lanes too), with ``jax.random``'s threefry (``sample.prng``), so a seeded
lane draws JAX's noise: its uniforms bit for bit, its Gumbel values within
an ulp of the ``log``s.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import processors as PR
from . import prng
from .params import split_keys


def greedy_tokens(logits: torch.Tensor) -> torch.Tensor:
    """Argmax over raw logits (the first maximum on ties, as ``jnp.argmax``)
    as int32 — the greedy sampler."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def process_logits(logits, state: dict, out_tokens=None, n_out=None,
                   ban: Optional[torch.Tensor] = None):
    """The processor pipeline: penalised, temperature-scaled logits with the
    inactive vocab partition at -inf."""
    if out_tokens is not None:
        logits = PR.apply_penalties(logits, out_tokens, n_out,
                                    state["repetition_penalty"],
                                    state["presence_penalty"])
    scaled = PR.temperature_scale(logits, state["temperature"])
    # bans apply BEFORE the filters: banned entries carry no nucleus mass,
    # cannot set the top-k threshold, and the kept set always holds the
    # allowed argmax
    if ban is not None:
        scaled = PR.mask_logits(scaled, ban[None, :])
    keep = PR.keep_pred(scaled, state["top_k"], state["top_p"],
                        state["min_p"])
    return PR.mask_logits(scaled, keep)


def categorical_probs(logits, state: dict, out_tokens=None, n_out=None,
                      ban: Optional[torch.Tensor] = None):
    """Normalized per-lane sampling distribution (B, V)."""
    return torch.softmax(process_logits(logits, state, out_tokens, n_out, ban),
                         dim=-1)


def gumbel_argmax(masked_logits, subkeys):
    """One token per lane from softmax(masked_logits) by per-lane Gumbel
    noise (``gumbel(subkey, (V,))``, one key per row): argmax(logits + g).
    Inactive (-inf) entries never win."""
    g = prng.gumbel(subkeys, masked_logits.shape[-1:])
    return torch.argmax(masked_logits + g, dim=-1).to(torch.int32)


def sample(logits, state: dict, out_tokens=None, n_out=None,
           ban: Optional[torch.Tensor] = None):
    """Per-lane heterogeneous sampling: (tokens (B,) int32, new_state).

    Greedy lanes return the raw-logits argmax (under ``ban`` when set);
    stochastic lanes draw from their processed distribution with their own
    key."""
    state, sub = split_keys(state)
    raw = logits if ban is None else PR.mask_logits(logits, ban[None, :])
    arg = greedy_tokens(raw)
    stoch = gumbel_argmax(process_logits(logits, state, out_tokens, n_out, ban),
                          sub)
    return torch.where(state["greedy"], arg, stoch), state
