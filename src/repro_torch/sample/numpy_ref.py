"""O(V) pure-numpy reference of the sampler's processor semantics.

An independent, loop-written implementation of the same set semantics the
predicate-algebra sampler commits to — the oracle the property tests compare
masks and distributions against.  Deliberately NOT vectorized the same way:
top-k is "everything >= the k-th largest value", top-p is a sequential
accumulation over the descending stable sort (the scalar loop ``fadda``
is bit-identical to), min-p is a threshold against the max prob.
"""

from __future__ import annotations

import numpy as np


def ref_keep_mask(logits: np.ndarray, *, temperature: float = 1.0,
                  top_k: int = 0, top_p: float = 1.0,
                  min_p: float = 0.0) -> np.ndarray:
    """Keep-mask (V,) bool for ONE lane, sequential-reference semantics."""
    x = np.asarray(logits, np.float64)
    if temperature > 0:
        x = x / temperature
    v = x.shape[0]
    keep = np.ones((v,), bool)
    if top_k > 0:
        kth = np.sort(x)[::-1][min(top_k, v) - 1]
        keep &= x >= kth
    e = np.exp(x - x.max())
    probs = e / e.sum()
    if top_p < 1.0:
        # sort key is the (scaled) LOGIT, stable — same tie order as the
        # predicate-algebra implementation (monotone to probability order);
        # the first entry is kept unconditionally (non-empty partition)
        order = np.argsort(-x, kind="stable")
        acc = 0.0
        nucleus = np.zeros((v,), bool)
        for j, idx in enumerate(order):       # the scalar fadda loop
            if j > 0 and acc >= top_p:
                break
            nucleus[idx] = True
            acc += probs[idx]
        keep &= nucleus
    if min_p > 0.0:
        keep &= (probs >= min_p * probs.max()) | (probs >= probs.max())
    return keep


def ref_penalised(logits: np.ndarray, out_tokens, *,
                  repetition_penalty: float = 1.0,
                  presence_penalty: float = 0.0) -> np.ndarray:
    """Penalty-rewritten logits (V,) for ONE lane over its generated tokens."""
    x = np.asarray(logits, np.float64).copy()
    for t in set(int(t) for t in out_tokens):
        x[t] = x[t] / repetition_penalty if x[t] > 0 \
            else x[t] * repetition_penalty
        x[t] -= presence_penalty
    return x


def ref_probs(logits: np.ndarray, *, temperature: float = 1.0,
              top_k: int = 0, top_p: float = 1.0,
              min_p: float = 0.0) -> np.ndarray:
    """Normalized sampling distribution (V,) under the reference masks."""
    keep = ref_keep_mask(logits, temperature=temperature, top_k=top_k,
                         top_p=top_p, min_p=min_p)
    x = np.asarray(logits, np.float64)
    if temperature > 0:
        x = x / temperature
    x = np.where(keep, x, -np.inf)
    e = np.exp(x - x[keep].max())
    return e / e.sum()
