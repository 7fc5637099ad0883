"""Dense decoder-LM family (stablelm-3b/12b, command-r-plus, gemma3, and the
llama-3.2-vision backbone with its grouped cross-attention layers),
mirroring ``repro.models.dense``.

Layers run as a Python loop over ``DenseLM.blocks``; the per-layer window is
one predicated attention with a dynamic window (2**30 = global), as in JAX.
llama-vision's layers come in groups of ``cross_attn_group`` (5): each group
holds ``g - 1`` self-attention blocks (``DenseLM.groups["self"]``) and one
cross-attention block (``groups["cross"]``) that sits before self slot
``g - 2`` and reads stub image embeddings (``cross_emb``, (B, N, d)).
Caches are dicts of tensors in the JAX layouts and are updated IN PLACE by
``prefill`` and ``decode``, which return the dict with the new ``pos``.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.core import paging as PG
from repro_torch.core.device import resolve_device
from repro_torch.kernels.flash_attention import flash_attention

from . import layers as L

NO_WINDOW = 2 ** 30


def _groups(cfg):
    """(n_groups, blocks per group) of the vlm variant."""
    g = cfg.cross_attn_group
    return cfg.n_layers // g, g


class DenseLM(nn.Module):
    """The dense LM's weights: embedding, one ``Block`` per layer (the vlm
    variant: ``groups["self"][gi][si]`` and ``groups["cross"][gi]``), final
    norm.  Built with uninitialised weights; ``init`` or
    ``convert.from_jax_params`` fills them."""

    def __init__(self, cfg, device):
        super().__init__()
        if cfg.family != "dense":
            raise ValueError(f"DenseLM is the dense family, got {cfg.family!r}")
        self.cfg = cfg
        self.embed = L.Embed(cfg, device)
        if cfg.cross_attn_group:
            n_groups, g = _groups(cfg)
            self.blocks = nn.ModuleList()
            self.groups = nn.ModuleDict({
                "self": nn.ModuleList(
                    nn.ModuleList(L.Block(cfg, device) for _ in range(g - 1))
                    for _ in range(n_groups)),
                "cross": nn.ModuleList(L.Block(cfg, device)
                                       for _ in range(n_groups))})
        else:
            self.blocks = nn.ModuleList(L.Block(cfg, device)
                                        for _ in range(cfg.n_layers))
            self.groups = None
        self.final_norm = L.Norm(cfg, cfg.d_model, device)

    @property
    def device(self) -> torch.device:
        return self.embed.tok.device

    def all_blocks(self):
        """Every block, self-attention and cross-attention alike."""
        if self.groups is None:
            return list(self.blocks)
        return ([b for grp in self.groups["self"] for b in grp]
                + list(self.groups["cross"]))


def axes(cfg):
    """The logical-axis tree of the JAX package's dense params, stacked
    layers first (``dist.serve.param_axes`` maps it onto the port's
    parameter names)."""
    ax = {"embed": L.embed_axes(cfg), "final_norm": L.norm_axes(cfg)}
    if cfg.cross_attn_group:
        ax["groups"] = {
            "self": L.stack_axes(L.stack_axes(L.block_axes(cfg))),
            "cross": L.stack_axes(L.block_axes(cfg)),
        }
    else:
        ax["blocks"] = L.stack_axes(L.block_axes(cfg))
    return ax


def init(cfg, generator: torch.Generator | None = None, device=None) -> DenseLM:
    """Random weights with the scales of the JAX init (not its numbers):
    N(0, 1/fan_in) matmul weights and embeddings, unit norms, zero biases.
    ``generator`` defaults to one on ``device`` seeded with 0."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    model = DenseLM(cfg, dev)
    model.embed.reset(cfg, generator)
    for blk in model.all_blocks():
        blk.reset(cfg, generator)
    return model


def layer_windows(cfg, device=None) -> torch.Tensor:
    """(L,) int32 per-layer dynamic window (NO_WINDOW = global attention)."""
    idx = torch.arange(cfg.n_layers, dtype=torch.int32, device=device)
    if cfg.local_window is None:
        return torch.full((cfg.n_layers,), NO_WINDOW, dtype=torch.int32,
                          device=device)
    if cfg.local_global_period is None:
        return torch.full((cfg.n_layers,), cfg.local_window, dtype=torch.int32,
                          device=device)
    is_global = (idx % cfg.local_global_period) == (cfg.local_global_period - 1)
    return torch.where(is_global, NO_WINDOW, cfg.local_window).to(torch.int32)


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------

def make_cache(cfg, batch_size: int, max_len: int, dtype=None, *, device):
    """Allocate the decode cache dict (zeros).  The vlm variant's K/V lead
    with (n_groups, n_self) and its cross K/V with (n_groups,)."""
    dtype = dtype or L.cdt(cfg)
    hkv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    shp = (batch_size, hkv, max_len, hd)
    zeros = lambda s, dt=dtype: torch.zeros(s, dtype=dt, device=device)
    if cfg.cross_attn_group:
        n_groups, g = _groups(cfg)
        cross = (n_groups, batch_size, hkv, cfg.n_cross_tokens, hd)
        return {"k": zeros((n_groups, g - 1) + shp),
                "v": zeros((n_groups, g - 1) + shp),
                "cross_k": zeros(cross), "cross_v": zeros(cross),
                "pos": zeros((batch_size,), torch.int32)}
    return {"k": zeros((cfg.n_layers,) + shp),
            "v": zeros((cfg.n_layers,) + shp),
            "pos": zeros((batch_size,), torch.int32)}


def cache_batch_axes(cfg):
    """Which axis of each cache tensor is the request-lane (batch) axis."""
    if cfg.cross_attn_group:
        return {"k": 2, "v": 2, "cross_k": 1, "cross_v": 1, "pos": 0}
    return {"k": 1, "v": 1, "pos": 0}


# full prefix state lives in paged KV + pos, so prefix sharing is sound
PAGED_PREFIX_OK = True
# prefill() takes per-row pos0 start offsets with all state in the KV cache,
# so one prompt's prefill can be split into chunks (scheduler chunked prefill)
CHUNKED_PREFILL_OK = True
# decode has no cross-lane coupling: bursts may narrow to a lane prefix
LANE_INDEPENDENT_DECODE = True


def paged_decode_ok(cfg):
    """decode() reads a paged cache directly through the page table (the
    vlm variant too: self-attention K/V pages, cross K/V per lane)."""
    return True


def paged_cache_spec(cfg):
    """KV cache keys with a token axis -> their leading layer dims.  Cross
    K/V (llama-vision) are per-request constants and stay per-lane dense."""
    if cfg.cross_attn_group:
        n_groups, g = _groups(cfg)
        return {"k": (n_groups, g - 1), "v": (n_groups, g - 1)}
    return {"k": (cfg.n_layers,), "v": (cfg.n_layers,)}


def make_paged_cache(cfg, batch_size: int, max_len: int, *, page_size: int,
                     pool_pages: int, dtype=None, page_dtype=None, device):
    """Paged decode cache: shared page pools + per-lane page table + pos
    (+ the vlm variant's dense cross K/V); with ``page_dtype`` ("int8" /
    "fp8") narrow pools + scale pools."""
    dtype = dtype or L.cdt(cfg)
    hkv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    cache = PG.alloc_pools(paged_cache_spec(cfg), pool_pages, page_size,
                           hkv, hd, dtype, device=device, page_dtype=page_dtype)
    cache["page_table"] = torch.zeros(
        (batch_size, PG.pages_needed(max_len, page_size)), dtype=torch.int32,
        device=device)
    cache["pos"] = torch.zeros((batch_size,), dtype=torch.int32, device=device)
    if cfg.cross_attn_group:
        n_groups, _ = _groups(cfg)
        cross = (n_groups, batch_size, hkv, cfg.n_cross_tokens, hd)
        cache["cross_k"] = torch.zeros(cross, dtype=dtype, device=device)
        cache["cross_v"] = torch.zeros(cross, dtype=dtype, device=device)
    return cache


def _cross_kv(p: L.Attention, cross_emb, cfg):
    """Cross K/V of one group from the (stub) image embeddings, as JAX
    computes them: the K/V projections split into heads."""
    hd = cfg.resolved_head_dim
    src = cross_emb.to(L.cdt(cfg))
    return (L.split_heads(L.linear(src, p.wk), hd),
            L.split_heads(L.linear(src, p.wv), hd))


def _cross_decode(bp: L.Block, h, cfg, ck, cv):
    """The cross-attention block of a decode step against the cached cross
    K/V (no bias, as in JAX; the split-KV body over every image token)."""
    cd = L.cdt(cfg)
    hin = L.apply_norm(bp.ln1, h, cfg)
    q = L.split_heads(L.linear(hin.to(cd), bp.attn.wq), cfg.resolved_head_dim)
    if cfg.qk_norm:
        q = L._rms_headdim(q)
    out = flash_attention(q, ck.to(cd), cv.to(cd), causal=False,
                          impl=cfg.attn_impl, decode=True)
    out = L.out_proj(bp.attn, out, cfg)
    if cfg.parallel_block:
        return h + out + L.mlp(bp.mlp, hin, cfg)
    h2 = h + out
    return h2 + L.mlp(bp.mlp, L.apply_norm(bp.ln2, h2, cfg), cfg)


# ---------------------------------------------------------------------------
# serving: prefill + single-token decode with KV caches
# ---------------------------------------------------------------------------

def prefill(model: DenseLM, cfg, batch, cache):
    """Run the prompt, fill the cache IN PLACE, return (last-token logits,
    cache).

    batch: tokens (B, S), lens (B,) [+ pos0 (B,)] [+ cross_emb (B, N, d):
    the vlm variant's image embeddings, whose cross K/V it caches].
    ``pos0`` is the per-row start of a SUFFIX prefill over a cache that
    already holds positions [0, pos0).  The cache must have max_len >=
    pos0 + S.
    """
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
    kv_lens = pos0 + lens
    h = L.embed(model.embed, tokens, cfg)
    if cfg.cross_attn_group:
        n_groups, g = _groups(cfg)
        cross_emb = batch["cross_emb"]
        for gi in range(n_groups):
            for si in range(g - 1):
                if si == g - 2:                 # cross before self slot g - 2
                    cb = model.groups["cross"][gi]
                    ck, cv = _cross_kv(cb.attn, cross_emb, cfg)
                    cache["cross_k"][gi].copy_(ck)
                    cache["cross_v"][gi].copy_(cv)
                    h, _ = L.block_apply(cb, h, positions, cfg,
                                         kv_x=cross_emb, causal=False)
                h, _ = L.block_apply(
                    model.groups["self"][gi][si], h, positions, cfg,
                    causal=True, kv_lens=kv_lens, q_offset=pos0,
                    cache=L.layer_cache(cache, "", (gi, si)), cache_pos=pos0)
    else:
        wins = layer_windows(cfg, dev)
        for li, blk in enumerate(model.blocks):
            h, _ = L.block_apply(blk, h, positions, cfg, causal=True,
                                 window=wins[li], kv_lens=kv_lens,
                                 q_offset=pos0,
                                 cache=L.layer_cache(cache, "", li),
                                 cache_pos=pos0)
    cache = dict(cache)
    cache["pos"] = pos0 + lens
    h = L.apply_norm(model.final_norm, h, cfg)
    # logits at each row's last valid position (ragged gather)
    idx = (lens - 1).clamp(0, s - 1).long()
    h_last = h.gather(1, idx[:, None, None].expand(b, 1, h.shape[-1]))
    logits = L.unembed(model.embed, h_last, cfg)[:, 0]
    return logits, cache


def decode(model: DenseLM, cfg, batch, cache):
    """One-token decode: batch = {"token": (B, 1)}.  Returns (logits, cache).

    Reads a dense cache (``k``/``v``) or a paged one (``k_pages``/
    ``v_pages`` + ``page_table``, + ``k_pages_scale``/``v_pages_scale`` when
    quantized); either way each layer writes its new K/V IN PLACE at the
    lane's position before attending over the cache.
    """
    token = batch["token"]
    pos = cache["pos"]                              # (B,) current lengths
    positions = pos[:, None]
    h = L.embed(model.embed, token, cfg)
    if cfg.cross_attn_group:
        n_groups, g = _groups(cfg)
        for gi in range(n_groups):
            for si in range(g - 1):
                if si == g - 2:                 # cross before self slot g - 2
                    h = _cross_decode(model.groups["cross"][gi], h, cfg,
                                      cache["cross_k"][gi],
                                      cache["cross_v"][gi])
                h, _ = L.block_apply(
                    model.groups["self"][gi][si], h, positions, cfg,
                    causal=False, kv_lens=pos + 1, q_offset=pos,
                    cache=L.layer_cache(cache, "", (gi, si)), cache_pos=pos,
                    decode=True)
    else:
        wins = layer_windows(cfg, token.device)
        for li, blk in enumerate(model.blocks):
            h, _ = L.block_apply(blk, h, positions, cfg, causal=False,
                                 window=wins[li], kv_lens=pos + 1,
                                 q_offset=pos,
                                 cache=L.layer_cache(cache, "", li),
                                 cache_pos=pos, decode=True)
    cache = dict(cache)
    cache["pos"] = pos + 1
    h = L.apply_norm(model.final_norm, h, cfg)
    logits = L.unembed(model.embed, h, cfg)[:, 0]
    return logits, cache


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def _self_body(blk, h, positions, cfg, window, kv_lens):
    return L.block_apply(blk, h, positions, cfg, causal=True, window=window,
                         kv_lens=kv_lens)[0]


def _vlm_group(self_blocks, cross_blk, h, positions, cfg, kv_lens, cross_emb):
    """One vlm group: ``g - 2`` self layers, the cross layer over the image
    embeddings (non-causal, no rope), the last self layer."""
    pre = cfg.cross_attn_group - 2
    for blk in list(self_blocks)[:pre]:
        h = _self_body(blk, h, positions, cfg, None, kv_lens)
    h, _ = L.block_apply(cross_blk, h, positions, cfg, kv_x=cross_emb,
                         causal=False, use_rope=False)
    return _self_body(self_blocks[pre], h, positions, cfg, None, kv_lens)


def train_logits(model: DenseLM, cfg, batch):
    """batch: tokens (B, S) [+ lens (B,)] [+ cross_emb (B, N, d)].  Returns
    (logits (B, S, V), {}); each layer (each vlm group) under
    ``layers.remat_wrap``, as in JAX."""
    tokens = batch["tokens"]
    positions = L.train_positions(tokens)
    kv_lens = batch.get("lens")
    h = L.embed(model.embed, tokens, cfg)
    if cfg.cross_attn_group:
        group = L.remat_wrap(_vlm_group, cfg)
        for gi, cross in enumerate(model.groups["cross"]):
            h = group(model.groups["self"][gi], cross, h, positions, cfg,
                      kv_lens, batch["cross_emb"])
    else:
        body = L.remat_wrap(_self_body, cfg)
        wins = layer_windows(cfg, tokens.device)
        for li, blk in enumerate(model.blocks):
            h = body(blk, h, positions, cfg, wins[li], kv_lens)
    h = L.apply_norm(model.final_norm, h, cfg)
    return L.unembed(model.embed, h, cfg), {}
