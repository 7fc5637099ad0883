"""Per-lane sampling parameters and the batched sampler lane state, as in
``repro.sample.params``.

``SamplingParams`` is the per-request spec; ``lane_state`` stacks specs into
a dict of (B,)-shaped tensors — the same lane layout as the KV cache — so the
sampler state moves with its lane, never with the batch.

The per-lane key is the determinism contract: a request's key chain is a
function of its OWN seed only (``prng_key(seed)``, then ``fold_in(fold)``
when the spec has one, split once per decode step the lane takes part in),
so its tokens depend on (seed, prompt, params) and never on the batch.  The
keys are ``jax.random``'s bit for bit (``sample.prng``), held as (B, 2)
int64 words.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence, Union

import torch

from repro_torch.core.device import resolve_device

from . import prng

#: dict keys of a lane state, with per-lane dtypes (all shape (B,) except key)
_FIELDS = (
    ("temperature", torch.float32),
    ("top_k", torch.int32),
    ("top_p", torch.float32),
    ("min_p", torch.float32),
    ("repetition_penalty", torch.float32),
    ("presence_penalty", torch.float32),
    ("greedy", torch.bool),
)


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Decoding distribution for ONE request.

    ``greedy=True`` (the default) is the bit-exact ``argmax`` over the raw
    logits (keys still advance, so a lane's chain position stays equal to
    its token count).  ``temperature <= 0`` is greedy.  ``top_k <= 0``
    disables top-k; ``top_p >= 1`` disables nucleus; ``min_p <= 0`` disables
    min-p; penalties at their identity (1.0 / 0.0) are no-ops.
    """
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0
    min_p: float = 0.0
    repetition_penalty: float = 1.0
    presence_penalty: float = 0.0
    seed: int = 0
    greedy: bool = True
    # key derivation: prng_key(seed), then fold_in(fold) when fold is set —
    # how broadcast lanes decorrelate without colliding with another
    # request's explicit seed
    fold: Optional[int] = None


#: the all-greedy spec (what a request without SamplingParams decodes with)
GREEDY = SamplingParams()


@functools.lru_cache(maxsize=4096)
def _seed_key(seed: int, fold: Optional[int]) -> tuple:
    # a key is ~200 small tensor ops on the host: memoize per (seed, fold),
    # as plain ints so no caller can mutate the cached value
    k = prng.prng_key(seed)
    if fold is not None:
        k = prng.fold_in(k, fold)
    return tuple(int(w) for w in k)


def _spec_key(spec: SamplingParams) -> tuple:
    return _seed_key(int(spec.seed), None if spec.fold is None else int(spec.fold))


def lane_state(specs: Union[None, SamplingParams,
                            Sequence[Optional[SamplingParams]]],
               b: int, *, device=None) -> dict:
    """Stack per-request specs into a lane state of ``b`` lanes on
    ``device`` (the card unless the caller asks for the CPU).

    ``specs`` may be None (all greedy), one ``SamplingParams`` (broadcast;
    each lane's key folds in the lane index unless the spec pins a
    ``fold``), or a sequence of per-request specs (None means greedy).  Rows
    past the specs are greedy with a zero key.
    """
    device = resolve_device(device)
    if specs is None:
        return greedy_state(b, device=device)
    if isinstance(specs, SamplingParams):
        specs = [specs if specs.fold is not None
                 else dataclasses.replace(specs, fold=i) for i in range(b)]
    if len(specs) > b:
        raise ValueError(f"{len(specs)} sampling specs for {b} lanes")
    if all(s is None for s in specs):
        return greedy_state(b, device=device)
    rows = [s if s is not None else GREEDY for s in specs]
    keys = [_spec_key(s) for s in rows] + [(0, 0)] * (b - len(rows))
    return _stack(rows + [GREEDY] * (b - len(rows)), keys, device)


def _stack(rows: Sequence[SamplingParams], keys, device) -> dict:
    state = {name: torch.tensor([getattr(r, name) for r in rows], dtype=dtype,
                                device=device)
             for name, dtype in _FIELDS}
    # temperature <= 0 is greedy by definition: fold it into the flag so the
    # sampler's per-lane select is a single predicate
    state["greedy"] = state["greedy"] | (state["temperature"] <= 0.0)
    state["key"] = torch.tensor(keys, dtype=torch.int64, device=device).reshape(-1, 2)
    return state


def greedy_state(b: int, *, device=None) -> dict:
    """All-greedy lane state (zero keys: greedy lanes never read them)."""
    return _stack([GREEDY] * b, [(0, 0)] * b, resolve_device(device))


def is_all_greedy(state: dict) -> bool:
    """Every lane greedy?  (One host read of the flags.)"""
    return bool(state["greedy"].all())


# ----------------------------------------------------------------------
# lane permutation — the same contract as the cache lane interface
# ----------------------------------------------------------------------

def gather_lanes(state: dict, lanes) -> dict:
    """Out lane i takes the state of input lane ``lanes[i]``."""
    idx = torch.as_tensor(lanes, device=state["key"].device).long()
    return {k: v.index_select(0, idx) for k, v in state.items()}


def slot_update(state: dict, lanes, sub: dict) -> dict:
    """Splice ``sub`` (lane count == len(lanes)) into a copy of ``state`` at
    ``lanes`` — the admission path."""
    idx = torch.as_tensor(lanes, device=state["key"].device).long()
    out = {}
    for k, v in state.items():
        v = v.clone()
        v[idx] = sub[k].to(v.dtype)
        out[k] = v
    return out


def split_keys(state: dict):
    """Advance every lane's key chain one step: (new_state, subkeys (B, 2)).

    One split per decode step per lane, greedy lanes too — a lane's chain
    position equals the number of steps since its admission.
    """
    ks = prng.split(state["key"])                        # (B, 2, 2)
    return dict(state, key=ks[:, 0]), ks[:, 1]
