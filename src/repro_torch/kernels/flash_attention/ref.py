"""Plain PyTorch versions of predicated flash attention: the oracle the CUDA
kernels are held to on the card, and the path a CPU tensor takes.

Same semantics as ``repro.kernels.flash_attention.ref``: GQA, causal masks,
sliding windows, ragged KV lengths (whilelt predicates) and per-row query
offsets.  Rows with no attendable key return 0.
"""

from __future__ import annotations

import torch

NEG_INF = float("-inf")


def attention_mask(sq, skv, *, kv_lens=None, causal=False, window=None,
                   q_offset=0, device=None):
    """Boolean (B?, Sq, Skv) predicate, True = attend.

    ``q_offset`` may be a scalar or a (B,) vector; ``window`` an int, a
    0-d tensor or None (no window)."""
    if device is None:
        device = (kv_lens.device if isinstance(kv_lens, torch.Tensor)
                  else q_offset.device if isinstance(q_offset, torch.Tensor)
                  else None)
    qoff = torch.as_tensor(q_offset, device=device).to(torch.int32)
    batched = (kv_lens is not None) or qoff.dim() == 1
    if qoff.dim() == 0:
        qoff = qoff[None]
    qp = (qoff[:, None] + torch.arange(sq, dtype=torch.int32,
                                       device=qoff.device)[None, :])[:, :, None]
    kp = torch.arange(skv, dtype=torch.int32, device=qoff.device)[None, None, :]
    m = torch.ones((qoff.shape[0], sq, skv), dtype=torch.bool, device=qoff.device)
    if causal:
        m &= qp >= kp
    if window is not None:
        win = torch.as_tensor(window, device=qoff.device).to(torch.int32)
        m &= kp > (qp - win)
    if kv_lens is not None:
        kvl = torch.as_tensor(kv_lens, device=qoff.device).to(torch.int32)
        m = m & (kp < kvl[:, None, None])
    return m if batched else m[0]


def mha_ref(q, k, v, *, kv_lens=None, causal=False, window=None,
            q_offset=None, scale=None):
    """q: (B, Hq, Sq, D); k, v: (B, Hkv, Skv, D).  Returns (B, Hq, Sq, D) in
    ``q.dtype``; the arithmetic runs in f32."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if hq % hkv:
        raise ValueError(f"Hq={hq} is not a multiple of Hkv={hkv}")
    group = hq // hkv
    scale = (d ** -0.5) if scale is None else scale
    if q_offset is None:
        q_offset = (skv - sq) if causal else 0   # suffix alignment, as the kernel

    kr = k.repeat_interleave(group, dim=1).float()
    vr = v.repeat_interleave(group, dim=1).float()
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), kr) * scale
    mask = attention_mask(sq, skv, kv_lens=kv_lens, causal=causal,
                          window=window, q_offset=q_offset, device=q.device)
    mask = mask[:, None] if mask.dim() == 3 else mask[None, None]
    logits = logits.masked_fill(~mask, NEG_INF)
    row_any = mask.any(dim=-1, keepdim=True)
    m = torch.where(mask, logits, torch.full_like(logits, -1e30)).amax(
        dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(logits - m), torch.zeros_like(logits))
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bhkd->bhqd", p, vr)
    out = torch.where(row_any, out / l.clamp_min(1e-30), torch.zeros_like(out))
    return out.to(q.dtype)
