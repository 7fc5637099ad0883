"""Speculative decoding — the first-fault contract at serving scale, as in
``repro.serve.speculative``.

A draft model runs K tokens ahead (the speculative vector load); the target
verifies the whole window before anything commits.  Acceptance is the
maximal matching prefix — ``brkb`` over the mismatch predicate, the FFR
partition of paper §2.3.3: lanes before the first fault commit, the first
faulting lane is executed again (the target's own token takes its place),
everything after it is discarded and retried next round.  Under stochastic
sampling (``sampling=`` with per-lane ``SamplingParams``) the equality
predicate becomes rejection sampling (``sample.rejection``): the committed
stream is distributed exactly as target-alone sampling, and greedy lanes
keep the exact-match predicate.  Inside the window temperature, top-k,
top-p and min-p apply per lane; repetition and presence penalties do not.

Verification issues K+1 single-token target decodes (teacher forcing
through the decode cache), eagerly through each family's ``decode``, as the
JAX package does.  The decoding is batched: every lane carries its own
window, and each round is the partition algebra applied row-wise —
``accept_prefix`` for acceptance, a ``whilelt``-style budget mask and
``brka`` on the stop token for the commit, and ``lastb`` for the next feed
token.  Caches roll back by a per-lane ``pos``: every attention read is
predicated by ``kv_lens = pos + 1``, so stale slots are inert.  A round
runs on the models' device and reads back to the host only whether a lane
is still alive; the stats are read at the end.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import sample as S
from repro_torch.core import partition as PT
from repro_torch.core import predicate as P
from repro_torch.models import get_model
from repro_torch.sample import prng


@torch.inference_mode()
def speculative_decode(target_cfg, target_model, draft_cfg, draft_model,
                       prompt, *, n_tokens: int, k_draft: int = 4,
                       max_len: int | None = None, lens=None,
                       stop_token: int | None = None, sampling=None):
    """Batched speculative decoding (greedy matching or rejection sampling).

    prompt: (B, S) token ids (+ optional per-lane ``lens``), on the models'
    device or the host.  Every lane speculates and commits on its own each
    round; a lane leaves the active partition at ``stop_token`` or its
    ``n_tokens`` budget.  ``sampling``: None (greedy), one
    ``SamplingParams``, a per-lane sequence, or a lane state dict.

    Returns (tokens, stats).  For B == 1 tokens is (n_tokens,) and
    ``stats["accept_counts"]`` a list of ints (the single-lane API); for
    B > 1 tokens is (B, n_tokens) and accept_counts holds per-round (B,)
    arrays (-1 for a lane no longer alive).  stats also carries
    ``mean_accepted``, ``k_draft`` and ``n_generated`` (B,)."""
    tfam, dfam = get_model(target_cfg), get_model(draft_cfg)
    dev = target_model.device
    prompt = torch.as_tensor(prompt, device=dev)
    b, s = prompt.shape
    max_len = max_len or (s + n_tokens + k_draft + 1)
    lens = (torch.full((b,), s, dtype=torch.int32, device=dev) if lens is None
            else torch.as_tensor(lens, device=dev).to(torch.int32))
    state = None
    if sampling is not None:
        state = sampling if isinstance(sampling, dict) \
            else S.lane_state(sampling, b, device=dev)

    tcache = tfam.make_cache(target_cfg, b, max_len, device=dev)
    dcache = dfam.make_cache(draft_cfg, b, max_len, device=dev)
    batch = {"tokens": prompt, "lens": lens}
    tlog, tcache = tfam.prefill(target_model, target_cfg, batch, tcache)
    _, dcache = dfam.prefill(draft_model, draft_cfg, batch, dcache)

    def decode_t(tok, cache):
        return tfam.decode(target_model, target_cfg, {"token": tok[:, None]},
                           cache)

    def decode_d(tok, cache):
        return dfam.decode(draft_model, draft_cfg, {"token": tok[:, None]},
                           cache)

    if state is None:
        cur = S.greedy_tokens(tlog)                     # (B,) first token
    else:
        cur, state = S.sample(tlog, state)
    # one spare column: a window slot that must not commit is routed there
    out = torch.zeros((b, n_tokens + 1), dtype=torch.int32, device=dev)
    out[:, 0] = cur
    n_gen = torch.ones((b,), dtype=torch.int32, device=dev)
    alive = n_gen < n_tokens
    if stop_token is not None:
        alive = alive & (cur != stop_token)

    kp1 = k_draft + 1
    j = torch.arange(kp1, dtype=torch.int32, device=dev)[None, :]
    accepted_hist = []

    while bool(torch.any(alive)):
        pos0 = tcache["pos"]                            # (B,) committed lengths
        if state is not None:
            # one key split a round; draft proposals fold 2 + i, the
            # acceptance and residual draws in speculative_accept fold 0 / 1
            state, round_key = S.split_keys(state)

        # the draft speculates K tokens per lane (the speculative load)
        dtoks, qs = [], []
        dtok = cur
        for i in range(k_draft):
            dlog, dcache = decode_d(dtok, dcache)
            if state is None:
                dtok = S.greedy_tokens(dlog)
            else:
                ml = S.process_logits(dlog, state)
                dtok = torch.where(state["greedy"], S.greedy_tokens(dlog),
                                   S.gumbel_argmax(ml, prng.fold_in(round_key, 2 + i)))
                qs.append(torch.softmax(ml, dim=-1))
            dtoks.append(dtok)
        # one more decode writes the last draft token's K/V, so a fully
        # accepted window needs no special case (rollback truncates)
        _, dcache = decode_d(dtok, dcache)
        draft = torch.stack(dtoks, dim=1)               # (B, K)
        window = torch.cat([cur[:, None], draft], dim=1)   # (B, K+1)

        # the target verifies the whole window (teacher forcing)
        tlogs = []
        for i in range(kp1):
            tl, tcache = decode_t(window[:, i], tcache)
            tlogs.append(tl)
        tlogs = torch.stack(tlogs, dim=1)               # (B, K+1, V)
        tgt_next = S.greedy_tokens(tlogs)

        # FFR acceptance: brkb over each lane's fault predicate
        if state is None:
            acc = PT.accept_prefix(draft == tgt_next[:, :-1])
            n_acc = P.cntp(acc)
            # accepted draft tokens, then the target's own at the first fault
            fix = torch.gather(tgt_next, 1, n_acc[:, None].to(torch.int64))
        else:
            lanes = torch.arange(b, device=dev).repeat_interleave(kp1)
            p_probs = torch.softmax(S.process_logits(
                tlogs.reshape(b * kp1, -1), S.gather_lanes(state, lanes)
            ).reshape(b, kp1, -1), dim=-1)              # (B, K+1, V)
            acc, fix1 = S.speculative_accept(draft, torch.stack(qs, dim=1),
                                             p_probs, tgt_next,
                                             state["greedy"], round_key)
            n_acc = P.cntp(acc)
            fix = fix1[:, None]
        accepted_hist.append(torch.where(alive, n_acc, -1))   # -1: dead lane

        draft_ext = torch.cat([draft, fix], dim=1)              # (B, K+1)
        commit = torch.where(j < n_acc[:, None], draft_ext, fix)

        # the commit window's valid partition: whilelt against each lane's
        # remaining budget, then brka on the stop predicate (the stop token
        # commits, nothing after it does)
        remaining = n_tokens - n_gen
        valid = (j < (n_acc + 1)[:, None]) & (j < remaining[:, None])
        valid = valid & alive[:, None]
        if stop_token is not None:
            valid = PT.brka(valid, commit == stop_token)

        # committed tokens at each lane's write cursor; the rest into the
        # spare column
        cols = torch.where(valid, n_gen[:, None] + j, n_tokens)
        out.scatter_(1, cols.to(torch.int64), commit.to(torch.int32))
        n_commit = P.cntp(valid)
        n_gen = n_gen + n_commit

        # roll both caches back to the committed position: dead lanes keep
        # theirs, live lanes advance by n_acc + 1
        stopped = (torch.any(valid & (commit == stop_token), dim=1)
                   if stop_token is not None else torch.zeros_like(alive))
        new_pos = torch.where(alive, pos0 + n_acc + 1, pos0)
        tcache = _rollback(tcache, new_pos)
        dcache = _rollback(dcache, new_pos)

        # SVE lastb: the next feed token is each lane's last committed one
        cur = torch.where(alive & (n_commit > 0), PT.lastb(valid, commit), cur)
        alive = alive & ~stopped & (n_gen < n_tokens)

    out = out[:, :n_tokens]
    counts = [c.cpu().numpy() for c in accepted_hist]
    n_gen = n_gen.cpu().numpy()
    if b == 1:
        flat = [int(c[0]) for c in counts]
        stats = {"accept_counts": flat,
                 "mean_accepted": sum(flat) / len(flat) if flat else 0.0,
                 "k_draft": k_draft, "n_generated": n_gen}
        return out[0], stats
    live = np.concatenate([c[c >= 0] for c in counts]) if counts else np.array([])
    stats = {"accept_counts": counts,
             "mean_accepted": float(live.mean()) if live.size else 0.0,
             "k_draft": k_draft, "n_generated": n_gen}
    return out, stats


def _rollback(cache: dict, new_pos: torch.Tensor) -> dict:
    """Set each lane's cache position (slots past it are inert: every
    attention read is predicated by kv_lens = pos + 1, so nothing is
    cleared)."""
    cache = dict(cache)
    cache["pos"] = torch.broadcast_to(new_pos, cache["pos"].shape)
    return cache
