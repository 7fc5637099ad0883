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


# ---------------------------------------------------------------------------
# Training: the blockwise forward with the rows' log-sum-exp and the two-pass
# backward, the plain versions of ``_flash_fwd_impl`` and ``_flash_bwd`` in
# ``repro.kernels.flash_attention.xla_impl`` (same blocks, same order)
# ---------------------------------------------------------------------------

#: the masked score of the blockwise versions (finite, as the JAX ones')
BLOCK_NEG = -1e30
_VMEM_BUDGET = 8 * 2 ** 20      # the JAX op's block budget: half of 16 MiB


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def pick_blocks(sq: int, skv: int, d: int) -> tuple:
    """(bq, bk) as the JAX op picks them (``ops._pick_blocks``): up to 512
    each, halved while the f32 working set exceeds the budget, bq cut to
    Sq rounded up to 8."""
    bq, bk = min(512, _round_up(sq, 128)), min(512, _round_up(skv, 128))

    def need(bq, bk):
        return bq * bk * 4 + (bq + 2 * bk) * d * 4 + bq * (d + 256) * 4
    while need(bq, bk) > _VMEM_BUDGET and bq > 128:
        bq //= 2
    while need(bq, bk) > _VMEM_BUDGET and bk > 128:
        bk //= 2
    return min(bq, _round_up(sq, 8)), bk


def _block_pred(iq, ik, bq, bk, kv_lens, q_offset, window, causal):
    """(B, bq, bk) predicate of block (iq, ik)."""
    dev = kv_lens.device
    qpos = (q_offset.to(torch.int64)[:, None, None] + iq * bq
            + torch.arange(bq, device=dev)[None, :, None])
    kpos = ik * bk + torch.arange(bk, device=dev)[None, None, :]
    pred = kpos < kv_lens.to(torch.int64)[:, None, None]
    if causal:
        pred = pred & (qpos >= kpos)
    return pred & (kpos > qpos - window)


def _blocked(q, k, v, bq, bk):
    """q as (B, Hkv, G, nq, bq, D) and k/v as (B, Hkv, nk, bk, D) f32, the
    sequence axes zero-padded to block multiples (GQA: h-major groups)."""
    b, h, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    nq, nk = -(-sq // bq), -(-skv // bk)
    qf = torch.nn.functional.pad(q.float(), (0, 0, 0, nq * bq - sq))
    kf = torch.nn.functional.pad(k.float(), (0, 0, 0, nk * bk - skv))
    vf = torch.nn.functional.pad(v.float(), (0, 0, 0, nk * bk - skv))
    return (qf.reshape(b, hkv, h // hkv, nq, bq, d),
            kf.reshape(b, hkv, nk, bk, d), vf.reshape(b, hkv, nk, bk, d))


def _window_t(window, device):
    return torch.as_tensor(2 ** 30 if window is None else window,
                           device=device).to(torch.int64).reshape(())


def flash_fwd_lse(q, k, v, *, kv_lens, q_offset, window=None, causal=False,
                  scale=None):
    """Blockwise online-softmax forward that also returns each row's
    log-sum-exp: (out in q's dtype, lse (B, Hq, Sq) f32).  kv_lens and
    q_offset are (B,) int tensors; a row with no live key gives out 0 and
    lse -1e30 + log(1e-30)."""
    b, h, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    g = h // hkv
    scale = d ** -0.5 if scale is None else scale
    win = _window_t(window, q.device)
    bq, bk = pick_blocks(sq, skv, d)
    qs, ks, vs = _blocked(q, k, v, bq, bk)
    nq, nk = qs.shape[3], ks.shape[2]
    outs, lses = [], []
    for iq in range(nq):
        qb = qs[:, :, :, iq]                               # (B,Hkv,G,bq,D)
        m = torch.full((b, hkv, g, bq), BLOCK_NEG, device=q.device)
        l = torch.zeros((b, hkv, g, bq), device=q.device)
        acc = torch.zeros((b, hkv, g, bq, d), device=q.device)
        for ik in range(nk):
            s = torch.einsum("bhgqd,bhkd->bhgqk", qb, ks[:, :, ik]) * scale
            pred = _block_pred(iq, ik, bq, bk, kv_lens, q_offset, win,
                               causal)[:, None, None]
            s = torch.where(pred, s, BLOCK_NEG)
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.where(pred, torch.exp(s - m_new[..., None]), 0.0)
            l = alpha * l + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhgqk,bhkd->bhgqd", p, vs[:, :, ik])
            m = m_new
        outs.append(torch.where(l[..., None] > 0.0,
                                acc / l.clamp_min(1e-30)[..., None], 0.0))
        lses.append(m + torch.log(l.clamp_min(1e-30)))
    out = torch.stack(outs, 3).reshape(b, h, nq * bq, d)[:, :, :sq]
    lse = torch.stack(lses, 3).reshape(b, h, nq * bq)[:, :, :sq]
    return out.to(q.dtype), lse.contiguous()


def flash_bwd(q, k, v, out, dout, lse, *, kv_lens, q_offset, window=None,
              causal=False, scale=None):
    """The two-pass backward of ``flash_fwd_lse``: delta = rowsum(dO * O);
    a dQ pass over the query blocks, each walking every KV block; a dK/dV
    pass over the KV blocks, each walking every query block (and the
    group's heads at once).  Returns (dq, dk, dv) in the inputs' dtypes;
    f32 arithmetic.  A row with no live key gets exactly 0."""
    b, h, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    g = h // hkv
    scale = d ** -0.5 if scale is None else scale
    win = _window_t(window, q.device)
    bq, bk = pick_blocks(sq, skv, d)
    qs, ks, vs = _blocked(q, k, v, bq, bk)
    nq, nk = qs.shape[3], ks.shape[2]
    pad = nq * bq - sq
    dos = torch.nn.functional.pad(dout.float(), (0, 0, 0, pad)).reshape(qs.shape)
    delta = (dout.float() * out.float()).sum(-1)
    ls = torch.nn.functional.pad(lse.float(), (0, pad)).reshape(qs.shape[:-1])
    dl = torch.nn.functional.pad(delta, (0, pad)).reshape(qs.shape[:-1])

    def probs(iq, ik):
        qb, kb = qs[:, :, :, iq], ks[:, :, ik]
        s = torch.einsum("bhgqd,bhkd->bhgqk", qb, kb) * scale
        pred = _block_pred(iq, ik, bq, bk, kv_lens, q_offset, win,
                           causal)[:, None, None]
        p = torch.where(pred, torch.exp(s - ls[:, :, :, iq][..., None]), 0.0)
        dp = torch.einsum("bhgqd,bhkd->bhgqk", dos[:, :, :, iq], vs[:, :, ik])
        return p, p * (dp - dl[:, :, :, iq][..., None]) * scale

    dq = []
    for iq in range(nq):                                   # pass 1: dq
        dqb = torch.zeros_like(qs[:, :, :, iq])
        for ik in range(nk):
            _, ds = probs(iq, ik)
            dqb = dqb + torch.einsum("bhgqk,bhkd->bhgqd", ds, ks[:, :, ik])
        dq.append(dqb)
    dk, dv = [], []
    for ik in range(nk):                                   # pass 2: dk, dv
        dkb = torch.zeros_like(ks[:, :, ik])
        dvb = torch.zeros_like(vs[:, :, ik])
        for iq in range(nq):
            p, ds = probs(iq, ik)
            dvb = dvb + torch.einsum("bhgqk,bhgqd->bhkd", p, dos[:, :, :, iq])
            dkb = dkb + torch.einsum("bhgqk,bhgqd->bhkd", ds, qs[:, :, :, iq])
        dk.append(dkb)
        dv.append(dvb)
    dq = torch.stack(dq, 3).reshape(b, h, nq * bq, d)[:, :, :sq]
    dk = torch.stack(dk, 2).reshape(b, hkv, nk * bk, d)[:, :, :skv]
    dv = torch.stack(dv, 2).reshape(b, hkv, nk * bk, d)[:, :, :skv]
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
