"""Encoder-decoder family (seamless-m4t-large-v2), mirroring
``repro.models.encdec``.

The speech frontend is a stub: the batch carries precomputed frame
embeddings (``src_emb``, (B, S_src, d_model)) straight into the encoder.
Encoder: non-causal self-attention over ragged frame lengths (``src_lens``).
Decoder: causal self-attention, then cross-attention to the encoder memory.
Serving caches the decoder's self K/V token by token and each layer's cross
K/V once, at the first prefill chunk; a resumed chunk and every decode step
read the cached cross K/V.  Caches are dicts of tensors in the JAX layouts,
updated IN PLACE by ``prefill`` and ``decode``.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.core import paging as PG
from repro_torch.core.device import resolve_device
from repro_torch.kernels.flash_attention import flash_attention

from . import layers as L


class DecBlock(nn.Module):
    """A decoder block: self-attention, cross-attention, MLP, each
    pre-normed."""

    def __init__(self, cfg, device):
        super().__init__()
        self.ln1 = L.Norm(cfg, cfg.d_model, device)
        self.self_attn = L.Attention(cfg, device)
        self.lnx = L.Norm(cfg, cfg.d_model, device)
        self.cross_attn = L.Attention(cfg, device)
        self.ln2 = L.Norm(cfg, cfg.d_model, device)
        self.mlp = L.MLP(cfg, device)

    def reset(self, cfg, generator):
        self.self_attn.reset(cfg, generator)
        self.cross_attn.reset(cfg, generator)
        self.mlp.reset(cfg, generator)


class EncDecLM(nn.Module):
    """The encoder-decoder's weights: embedding, ``enc_blocks`` (one
    ``Block`` per encoder layer), ``enc_norm``, ``dec_blocks`` (one
    ``DecBlock`` per decoder layer), final norm.  Built with uninitialised
    weights; ``init`` or ``convert.from_jax_params`` fills them."""

    def __init__(self, cfg, device):
        super().__init__()
        if cfg.family != "encdec":
            raise ValueError(f"EncDecLM is the encdec family, got {cfg.family!r}")
        self.cfg = cfg
        self.embed = L.Embed(cfg, device)
        self.enc_blocks = nn.ModuleList(L.Block(cfg, device)
                                        for _ in range(cfg.n_enc_layers))
        self.enc_norm = L.Norm(cfg, cfg.d_model, device)
        self.dec_blocks = nn.ModuleList(DecBlock(cfg, device)
                                        for _ in range(cfg.n_dec_layers))
        self.final_norm = L.Norm(cfg, cfg.d_model, device)

    @property
    def device(self) -> torch.device:
        return self.embed.tok.device


def axes(cfg):
    """The logical-axis tree of the JAX package's encdec params."""
    dec = {"ln1": L.norm_axes(cfg), "self_attn": L.attn_axes(cfg),
           "lnx": L.norm_axes(cfg), "cross_attn": L.attn_axes(cfg),
           "ln2": L.norm_axes(cfg), "mlp": L.mlp_axes(cfg)}
    return {"embed": L.embed_axes(cfg),
            "enc_blocks": L.stack_axes(L.block_axes(cfg)),
            "enc_norm": L.norm_axes(cfg),
            "dec_blocks": L.stack_axes(dec),
            "final_norm": L.norm_axes(cfg)}


def init(cfg, generator: torch.Generator | None = None, device=None) -> EncDecLM:
    """Random weights with the scales of the JAX init (not its numbers).
    ``generator`` defaults to one on ``device`` seeded with 0."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    model = EncDecLM(cfg, dev)
    model.embed.reset(cfg, generator)
    for blk in list(model.enc_blocks) + list(model.dec_blocks):
        blk.reset(cfg, generator)
    return model


# ---------------------------------------------------------------------------
# the decoder block and the encoder
# ---------------------------------------------------------------------------

def _cross_kv(p: L.Attention, memory, cfg):
    """Cross-attention K/V of one decoder layer from the encoder memory,
    mirroring ``L.attention``'s ``kv_x`` path op for op (the same
    ``linear`` on the same rows, bias, head split, qk-norm), so that
    attending through the cache gives the bits of attending through
    ``kv_x=memory``: a resumed prefill chunk equals the whole prompt."""
    hd = cfg.resolved_head_dim
    src = memory.to(L.cdt(cfg))
    ck, cv = L.linear(src, p.wk), L.linear(src, p.wv)
    if cfg.use_bias:
        ck, cv = ck + p.bk, cv + p.bv
    ck, cv = L.split_heads(ck, hd), L.split_heads(cv, hd)
    if cfg.qk_norm:
        ck = L._rms_headdim(ck)
    return ck, cv


def _cross_from_cache(p: L.Attention, hx, cfg, ck, cv, src_lens, decode):
    """Cross-attention against cached K/V, mirroring ``L.attention``'s
    ``kv_x`` path on the query and output side."""
    cd = L.cdt(cfg)
    q = L.linear(hx.to(cd), p.wq)
    if cfg.use_bias:
        q = q + p.bq
    q = L.split_heads(q, cfg.resolved_head_dim)
    if cfg.qk_norm:
        q = L._rms_headdim(q)
    out = flash_attention(q, ck.to(cd), cv.to(cd), kv_lens=src_lens,
                          causal=False, impl=cfg.attn_impl, decode=decode)
    out = L.out_proj(p, out, cfg)
    if cfg.use_bias:
        out = out + p.bo
    return out.to(hx.dtype)


def _dec_block_apply(p: DecBlock, x, positions, cfg, memory, *, src_lens=None,
                     kv_lens=None, q_offset=None, cache=None, cache_pos=None,
                     cross_cache=None, causal=True, decode=False):
    """One decoder block: causal self-attention (through ``cache`` when
    given), cross-attention to ``memory`` through the ``kv_x`` path or to
    the cached ``cross_cache = (ck, cv)``, then the MLP."""
    h = L.apply_norm(p.ln1, x, cfg)
    attn_out, new_cache = L.attention(
        p.self_attn, h, positions, cfg, causal=causal, kv_lens=kv_lens,
        q_offset=q_offset, cache=cache, cache_pos=cache_pos, decode=decode)
    h2 = x + attn_out
    hx = L.apply_norm(p.lnx, h2, cfg)
    if cross_cache is not None:        # decode / resumed chunk: cached cross K/V
        cross_out = _cross_from_cache(p.cross_attn, hx, cfg, *cross_cache,
                                      src_lens, decode)
    else:
        cross_out, _ = L.attention(p.cross_attn, hx, positions, cfg,
                                   kv_x=memory, causal=False, kv_lens=src_lens,
                                   use_rope=False)
    h3 = h2 + cross_out
    out = h3 + L.mlp(p.mlp, L.apply_norm(p.ln2, h3, cfg), cfg)
    return out, new_cache


def encode(model: EncDecLM, cfg, src_emb, src_lens=None):
    """The encoder over the frame embeddings: non-causal self-attention
    over each row's ``src_lens`` frames, then ``enc_norm``; in training
    each layer under ``layers.remat_wrap``."""
    b, s_src, _ = src_emb.shape
    positions = torch.arange(s_src, dtype=torch.int32,
                             device=src_emb.device)[None].expand(b, s_src)
    h = src_emb.to(L.cdt(cfg))
    body = L.remat_wrap(_enc_body, cfg)
    for blk in model.enc_blocks:
        h = body(blk, h, positions, cfg, src_lens)
    return L.apply_norm(model.enc_norm, h, cfg)


def _enc_body(blk, h, positions, cfg, src_lens):
    return L.block_apply(blk, h, positions, cfg, causal=False,
                         kv_lens=src_lens)[0]


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------

def make_cache(cfg, batch_size: int, max_len: int, src_len: int, dtype=None,
               *, device):
    """Allocate the decode cache dict (zeros): decoder self K/V, each
    layer's cross K/V over ``src_len`` frames, ``src_lens`` and ``pos``."""
    dtype = dtype or L.cdt(cfg)
    hkv, hd, n = cfg.n_kv_heads, cfg.resolved_head_dim, cfg.n_dec_layers
    zeros = lambda s, dt=dtype: torch.zeros(s, dtype=dt, device=device)
    return {"k": zeros((n, batch_size, hkv, max_len, hd)),
            "v": zeros((n, batch_size, hkv, max_len, hd)),
            "cross_k": zeros((n, batch_size, hkv, src_len, hd)),
            "cross_v": zeros((n, batch_size, hkv, src_len, hd)),
            "src_lens": zeros((batch_size,), torch.int32),
            "pos": zeros((batch_size,), torch.int32)}


def cache_batch_axes(cfg):
    """Which axis of each cache tensor is the request-lane (batch) axis."""
    return {"k": 1, "v": 1, "cross_k": 1, "cross_v": 1, "src_lens": 0,
            "pos": 0}


# cross K/V depend on the (per-request) source memory, so a shared text
# prefix does not imply shared decoder state
PAGED_PREFIX_OK = False
# the first chunk runs the encoder and caches each layer's cross K/V;
# resumed chunks (no src_emb in the batch) attend the cached K/V — bit for
# bit the kv_x path, as the cache stores the post-bias/qk-norm heads at the
# compute dtype
CHUNKED_PREFILL_OK = True
# decode has no cross-lane coupling: bursts may narrow to a lane prefix
LANE_INDEPENDENT_DECODE = True


def paged_decode_ok(cfg):
    """decode() reads the decoder's self K/V through the page table; cross
    K/V is a per-request constant and stays per-lane dense."""
    return True


def paged_cache_spec(cfg):
    """Only the decoder's self K/V grows with the target length."""
    return {"k": (cfg.n_dec_layers,), "v": (cfg.n_dec_layers,)}


def make_paged_cache(cfg, batch_size: int, max_len: int, src_len: int = 1, *,
                     page_size: int, pool_pages: int, dtype=None,
                     page_dtype=None, device):
    """Paged decode cache: self K/V page pools (narrow with ``page_dtype``)
    + per-lane page table, with the dense cross K/V, ``src_lens`` and
    ``pos``."""
    dtype = dtype or L.cdt(cfg)
    hkv, hd, n = cfg.n_kv_heads, cfg.resolved_head_dim, cfg.n_dec_layers
    cache = PG.alloc_pools(paged_cache_spec(cfg), pool_pages, page_size,
                           hkv, hd, dtype, device=device, page_dtype=page_dtype)
    zeros = lambda s, dt=dtype: torch.zeros(s, dtype=dt, device=device)
    cache["page_table"] = zeros(
        (batch_size, PG.pages_needed(max_len, page_size)), torch.int32)
    cache["cross_k"] = zeros((n, batch_size, hkv, src_len, hd))
    cache["cross_v"] = zeros((n, batch_size, hkv, src_len, hd))
    cache["src_lens"] = zeros((batch_size,), torch.int32)
    cache["pos"] = zeros((batch_size,), torch.int32)
    return cache


# ---------------------------------------------------------------------------
# serving: prefill + single-token decode
# ---------------------------------------------------------------------------

def prefill(model: EncDecLM, cfg, batch, cache):
    """Encode the source and run the decoder prompt, filling the self and
    cross caches IN PLACE; returns (last-token logits, cache).

    batch: tokens (B, S) [+ lens (B,)] [+ pos0 (B,)] [+ src_emb (B, S_src,
    d) + src_lens (B,)].  With ``src_emb`` (the first chunk) the encoder
    runs and each layer's cross K/V is cached; without it (a resumed chunk)
    cross-attention reads the cached K/V and ``pos0`` offsets the
    self-attention writes."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    dev = tokens.device
    lens = batch.get("lens")
    lens = (torch.full((b,), s, dtype=torch.int32, device=dev) if lens is None
            else torch.as_tensor(lens, device=dev).to(torch.int32))
    pos0 = batch.get("pos0")
    pos0 = (torch.zeros((b,), dtype=torch.int32, device=dev) if pos0 is None
            else torch.as_tensor(pos0, device=dev).to(torch.int32))
    positions = pos0[:, None] + torch.arange(s, dtype=torch.int32, device=dev)[None]
    h = L.embed(model.embed, tokens, cfg)
    cache = dict(cache)
    kw = dict(kv_lens=pos0 + lens, q_offset=pos0, cache_pos=pos0, causal=True)
    if "src_emb" in batch:                     # first chunk: run the encoder
        src_lens = batch.get("src_lens")
        memory = encode(model, cfg, batch["src_emb"], src_lens)
        src_lens = (torch.full((b,), memory.shape[1], dtype=torch.int32,
                               device=dev) if src_lens is None
                    else torch.as_tensor(src_lens, device=dev).to(torch.int32))
        for li, blk in enumerate(model.dec_blocks):
            h, _ = _dec_block_apply(blk, h, positions, cfg, memory,
                                    src_lens=src_lens,
                                    cache=L.layer_cache(cache, "", li), **kw)
            # cross K/V for decode and resumed chunks, once per layer
            ck, cv = _cross_kv(blk.cross_attn, memory, cfg)
            cache["cross_k"][li].copy_(ck)
            cache["cross_v"][li].copy_(cv)
        cache["src_lens"] = src_lens
    else:                                      # resumed chunk: cached cross K/V
        src_lens = cache["src_lens"]
        for li, blk in enumerate(model.dec_blocks):
            h, _ = _dec_block_apply(
                blk, h, positions, cfg, None, src_lens=src_lens,
                cache=L.layer_cache(cache, "", li),
                cross_cache=(cache["cross_k"][li], cache["cross_v"][li]), **kw)
    cache["pos"] = pos0 + lens
    h = L.apply_norm(model.final_norm, h, cfg)
    idx = (lens - 1).clamp(0, s - 1).long()
    h_last = h.gather(1, idx[:, None, None].expand(b, 1, h.shape[-1]))
    return L.unembed(model.embed, h_last, cfg)[:, 0], cache


def decode(model: EncDecLM, cfg, batch, cache):
    """One-token decode: batch = {"token": (B, 1)}.  Returns (logits,
    cache).  Each decoder layer writes its new self K/V IN PLACE into the
    dense cache or (paged) the lane's tail page, attends over it, then
    over the lane's cached cross K/V."""
    token = batch["token"]
    pos = cache["pos"]
    positions = pos[:, None]
    h = L.embed(model.embed, token, cfg)
    for li, blk in enumerate(model.dec_blocks):
        h, _ = _dec_block_apply(
            blk, h, positions, cfg, None, src_lens=cache["src_lens"],
            kv_lens=pos + 1, q_offset=pos, cache=L.layer_cache(cache, "", li),
            cache_pos=pos,
            cross_cache=(cache["cross_k"][li], cache["cross_v"][li]),
            causal=False, decode=True)
    cache = dict(cache)
    cache["pos"] = pos + 1
    h = L.apply_norm(model.final_norm, h, cfg)
    return L.unembed(model.embed, h, cfg)[:, 0], cache


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def _dec_body(blk, h, positions, cfg, memory, src_lens, lens):
    return _dec_block_apply(blk, h, positions, cfg, memory, src_lens=src_lens,
                            kv_lens=lens, causal=True)[0]


def train_logits(model: EncDecLM, cfg, batch):
    """batch: src_emb (B, Ss, d) [+ src_lens (B,)], tokens (B, St) [+ lens
    (B,)].  Returns (logits (B, St, V), {}): ``encode``, then each decoder
    layer under ``layers.remat_wrap``, as in JAX."""
    src_lens = batch.get("src_lens")
    memory = encode(model, cfg, batch["src_emb"], src_lens)
    tokens = batch["tokens"]
    positions = L.train_positions(tokens)
    h = L.embed(model.embed, tokens, cfg)
    body = L.remat_wrap(_dec_body, cfg)
    for blk in model.dec_blocks:
        h = body(blk, h, positions, cfg, memory, src_lens, batch.get("lens"))
    h = L.apply_norm(model.final_norm, h, cfg)
    return L.unembed(model.embed, h, cfg), {}
