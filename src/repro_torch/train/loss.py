"""Losses, mirroring ``repro.train.loss``.  Cross-entropy is computed in
f32 with the padded-vocab slots already masked by ``unembed``; labels < 0
are ignored (padding).

The f32 upcasts run in chunks of 256 sequence positions when the sequence
is a multiple of 256 longer than one chunk, as the JAX loss scans them (its
peak f32 temporary is (B, chunk, V) rather than (B, S, V)); the chunks'
sums are added in order."""

from __future__ import annotations

import torch

_CHUNK = 256


def _ce_terms(lg_chunk, labels_chunk, z_loss):
    valid = labels_chunk >= 0
    lab = labels_chunk.clamp_min(0).long()
    lg = lg_chunk.float()
    lse = torch.logsumexp(lg, dim=-1)
    ll = lg.gather(-1, lab[..., None])[..., 0]
    tot = torch.where(valid, lse - ll, 0.0).sum()
    if z_loss:
        tot = tot + z_loss * torch.where(valid, lse.square(), 0.0).sum()
    return tot, valid.float().sum()


def cross_entropy_loss(logits, labels, *, z_loss: float = 0.0,
                       chunk: int = _CHUNK):
    """logits: (B, S, V); labels: (B, S) int, -1 = ignore.  The mean
    negative log-likelihood over the valid labels (+ ``z_loss`` times the
    sum of their squared log-partitions, over the same count)."""
    b, s, v = logits.shape
    if s % chunk != 0 or s <= chunk:
        tot, cnt = _ce_terms(logits, labels, z_loss)
        return tot / cnt.clamp_min(1.0)
    tot = cnt = None
    for c0 in range(0, s, chunk):
        t, n = _ce_terms(logits[:, c0:c0 + chunk], labels[:, c0:c0 + chunk],
                         z_loss)
        tot, cnt = (t, n) if tot is None else (tot + t, cnt + n)
    return tot / cnt.clamp_min(1.0)
