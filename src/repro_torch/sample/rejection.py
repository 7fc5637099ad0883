"""Distribution-preserving rejection sampling for speculative decoding, as
in ``repro.sample.rejection``.

The draft proposes x_i ~ q_i; the target accepts with probability
min(1, p_i(x_i) / q_i(x_i)); the first rejected position is drawn again
from the residual norm(max(p_i - q_i, 0)), and a fully accepted window
earns a bonus draw from p_K.  The committed stream is then distributed
exactly as target-alone sampling.  The acceptance predicate is the FFR
partition algebra: stochastic accept bits take the place of the equality
predicate and ``accept_prefix`` (``brkb`` over the first rejection) is
unchanged.  Greedy lanes keep the exact-match predicate and the target's
own argmax as the fix.

The draws use JAX's key folds on ``sample.prng``'s threefry: the
acceptance uniforms from ``fold_in(round_key, 0)`` (bit for bit) and the
fix's Gumbel noise from ``fold_in(round_key, 1)`` (within an ulp of the
``log``s).
"""

from __future__ import annotations

import torch

from repro_torch.core import partition as PT
from repro_torch.core import predicate as P

from . import prng

_TINY = 1e-30


def residual_dist(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """norm(max(p - q, 0)), falling back to p where the residual has no
    mass (p == q: a rejection there is a rounding event)."""
    r = torch.clamp_min(p - q, 0.0)
    mass = torch.sum(r, dim=-1, keepdim=True)
    return torch.where(mass > _TINY, r / torch.clamp_min(mass, _TINY), p)


def speculative_accept(draft, q_probs, p_probs, tgt_greedy, greedy, round_key):
    """One round of batched rejection acceptance.

    draft      (B, K)      proposed tokens
    q_probs    (B, K, V)   the distributions the drafts were drawn from
    p_probs    (B, K+1, V) target distributions (processed as the sampler)
    tgt_greedy (B, K+1)    raw-argmax target tokens (the greedy lanes')
    greedy     (B,)        per-lane greedy predicate
    round_key  (B, 2)      per-lane key of this round

    Returns (acc (B, K) the accepted-prefix predicate, fix (B,) the token
    at the first fault: a residual draw, the bonus draw, or the greedy
    target token)."""
    b, k = draft.shape
    idx = draft.to(torch.int64)[..., None]
    pd = torch.gather(p_probs[:, :k], -1, idx)[..., 0]
    qd = torch.gather(q_probs, -1, idx)[..., 0]
    u = prng.uniform(prng.fold_in(round_key, 0), (k,))
    stoch_bits = u < torch.clamp_max(pd / torch.clamp_min(qd, _TINY), 1.0)
    match_bits = draft == tgt_greedy[:, :-1]
    acc = PT.accept_prefix(torch.where(greedy[:, None], match_bits, stoch_bits))
    n_acc = P.cntp(acc).to(torch.int64)

    # the residual at the first fault only (at K it is the bonus
    # distribution p_K, through a zero q row), drawn with a second fold
    rows = torch.arange(b, device=draft.device)
    q_ext = torch.cat([q_probs, torch.zeros_like(p_probs[:, :1])], dim=1)
    res_at = residual_dist(p_probs[rows, n_acc], q_ext[rows, n_acc])
    g = prng.gumbel(prng.fold_in(round_key, 1), res_at.shape[-1:])
    logp = torch.where(res_at > 0, torch.log(torch.clamp_min(res_at, _TINY)),
                       torch.full((), float("-inf"), device=res_at.device))
    stoch_fix = torch.argmax(logp + g, dim=-1).to(torch.int32)
    greedy_fix = tgt_greedy[rows, n_acc].to(torch.int32)
    return acc, torch.where(greedy, greedy_fix, stoch_fix)
