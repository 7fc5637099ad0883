"""Logit processors as SVE predicate algebra over the vocab axis, as in
``repro.sample.processors``.

Each processor either rewrites logits under a predicate (penalties) or
generates a keep-predicate over the vocabulary (top-k / top-p / min-p /
bans).  Predicates compose by AND; masked-out entries read as -inf, so the
final categorical (or argmax) sees only the active partition.  Batched over
lanes on the leading axis.

The top-p cutoff is the paper's serialized reduction (§2.3.5): sort
descending, accumulate with the strictly ordered ``fadda`` prefix sums
(``core.reductions.fadda_scan``, the hand-written kernel on the card), and
keep the ``whilelt``-shaped prefix in sorted order, scattered back through
the sort permutation.

JAX's ``.at[rows, cols].set(v, mode="drop")`` has no PyTorch twin: the port
scatters into a (B, V + 1) buffer whose last column takes every dropped
index, then slices that column off.
"""

from __future__ import annotations

import torch

from repro_torch.core import reductions as R

#: additive identity of the masked vocab partition
NEG_INF = float("-inf")


def _scatter_drop(b: int, v: int, cols: torch.Tensor, value: bool,
                  fill: bool) -> torch.Tensor:
    """(B, V) bool filled with ``fill``, set to ``value`` at (row, cols):
    columns outside [0, V) are dropped."""
    cols = torch.where((cols >= 0) & (cols < v), cols, v).long()
    out = torch.full((b, v + 1), fill, dtype=torch.bool, device=cols.device)
    return out.scatter_(1, cols, value)[:, :v]


def apply_penalties(logits, out_tokens, n_out, repetition_penalty,
                    presence_penalty):
    """Repetition/presence penalties over each lane's OWN output buffer.

    ``out_tokens`` (B, T) is the lane's generated-token buffer and ``n_out``
    (B,) its committed count; the "seen" predicate marks the first ``n_out``
    tokens (stale entries past it never count).  HF semantics: seen and
    logit > 0 -> logit / r, seen and logit <= 0 -> logit * r; presence
    subtracts a constant from seen tokens.
    """
    b, v = logits.shape
    t = out_tokens.shape[1]
    j = torch.arange(t, device=logits.device)[None, :]
    cols = torch.where(j < n_out[:, None], out_tokens, v)
    seen = _scatter_drop(b, v, cols, True, False)
    r = repetition_penalty[:, None]
    pen = torch.where(logits > 0, logits / r, logits * r)
    out = torch.where(seen, pen, logits)
    return out - torch.where(seen, presence_penalty[:, None], 0.0)


def temperature_scale(logits, temperature):
    """Divide by per-lane temperature; non-positive temperatures pass through
    unscaled (those lanes are greedy — the flag is folded in ``lane_state``)."""
    t = torch.where(temperature > 0, temperature, 1.0)
    return logits / t[:, None]


def top_k_pred(logits, k):
    """Keep-predicate of top-k: active where logit >= the k-th largest value
    (ties at the threshold stay).  k <= 0 disables.  A view of
    ``keep_pred``."""
    b, dev = logits.shape[0], logits.device
    return keep_pred(logits, k, torch.ones((b,), device=dev),
                     torch.zeros((b,), device=dev))


def top_p_pred(logits, top_p):
    """Keep-predicate of nucleus (top-p): the smallest prefix of the stable
    descending sort whose mass reaches ``top_p``, by the ordered scan (the
    top-1 token is always kept).  ``top_p >= 1`` disables.  A view of
    ``keep_pred``."""
    b, dev = logits.shape[0], logits.device
    return keep_pred(logits, torch.zeros((b,), dtype=torch.int32, device=dev),
                     top_p, torch.zeros((b,), device=dev))


def min_p_pred(logits, min_p):
    """Keep-predicate of min-p: active where prob >= min_p times the lane's
    max prob.  min_p <= 0 disables.  A view of ``keep_pred``."""
    b, dev = logits.shape[0], logits.device
    return keep_pred(logits, torch.zeros((b,), dtype=torch.int32, device=dev),
                     torch.ones((b,), device=dev), min_p)


def ban_pred(vocab_size: int, banned_ids, *, device=None) -> torch.Tensor:
    """Keep-predicate (V,) banning ``banned_ids`` (constrained decoding: the
    complement of the banned set is the active vocab partition)."""
    keep = torch.ones((vocab_size,), dtype=torch.bool, device=device)
    keep[torch.as_tensor(banned_ids, dtype=torch.long, device=device)] = False
    return keep


def stop_sequence_pred(vocab_size: int, last_token, stop_bigrams):
    """Per-lane keep-predicate suppressing the completion of two-token stop
    sequences: where ``last_token[b]`` equals a bigram's first token, the
    bigram's second token is masked out of lane b's vocab partition."""
    bg = torch.as_tensor(stop_bigrams, dtype=torch.int64,
                         device=last_token.device).reshape(-1, 2)
    hit = last_token[:, None] == bg[None, :, 0]            # (B, N)
    cols = torch.where(hit, bg[None, :, 1], vocab_size)    # miss -> dropped
    return _scatter_drop(last_token.shape[0], vocab_size, cols, False, True)


def keep_pred(scaled, top_k, top_p, min_p):
    """Fused top-k and top-p and min-p keep-predicate — the one definition
    the three views share.

    One softmax and ONE stable descending argsort of the scaled LOGITS serve
    all three filters (the logit, not the prob, is the sort key: f32
    underflow can make distinct logits equal probs).  The nucleus keeps the
    prefix  exclusive_mass < top_p,  the exclusive mass being the shifted
    inclusive ``fadda_scan`` (never a re-rounded subtraction); sorted
    position 0 is always kept, so the partition never goes empty."""
    b, v = scaled.shape
    probs = torch.softmax(scaled, dim=-1)
    order = torch.argsort(-scaled, dim=-1, stable=True)
    sl = torch.gather(scaled, -1, order)
    sp = torch.gather(probs, -1, order)
    kth = torch.gather(sl, -1, (top_k[:, None].long() - 1).clamp(0, v - 1))
    keep = (top_k[:, None] <= 0) | (scaled >= kth)
    csum = R.fadda_scan(None, sp)
    excl = torch.cat([torch.zeros_like(csum[:, :1]), csum[:, :-1]], dim=-1)
    lane = torch.arange(v, device=scaled.device)[None, :]
    keep_sorted = (excl < top_p[:, None]) | (lane == 0)
    nucleus = torch.zeros((b, v), dtype=torch.bool,
                          device=scaled.device).scatter_(1, order, keep_sorted)
    keep &= (top_p[:, None] >= 1.0) | nucleus
    thresh = min_p[:, None] * sp[:, :1]                  # sp[:, 0] is the max prob
    minp_keep = (probs >= thresh) | (probs >= sp[:, :1])   # the max is kept
    return keep & ((min_p[:, None] <= 0) | minp_keep)


def mask_logits(logits, keep):
    """Zeroing predication onto the extended reals: inactive vocab entries
    read as -inf."""
    return torch.where(keep, logits, NEG_INF)
