"""Zamba2-style hybrid (zamba2-1.2b): a Mamba2 backbone with a SHARED
transformer block (one weight copy) applied every ``shared_attn_period`` SSM
layers, mirroring ``repro.models.hybrid``.

Each application of the shared block keeps its own K/V slot: the dense cache
holds ``shared_k``/``shared_v`` of shape (n_groups, B, Hkv, S, D), the paged
cache one pool per group, lead axis (n_groups,).  Caches are updated IN
PLACE by ``prefill`` and ``decode``, which return the dict with the new
``pos``.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.core import paging as PG
from repro_torch.core.device import resolve_device

from . import layers as L
from . import ssm as S


def _split_layout(cfg):
    period = cfg.shared_attn_period
    n_groups = cfg.n_layers // period
    rem = cfg.n_layers - n_groups * period
    return period, n_groups, rem


class HybridLM(nn.Module):
    """The hybrid LM's weights: ``main`` (n_groups x period ``MambaBlock``s,
    the shared block after each group), ``tail`` (the remaining blocks), one
    shared ``layers.Block``, embedding and final norm."""

    def __init__(self, cfg, device):
        super().__init__()
        if cfg.family != "hybrid":
            raise ValueError(f"HybridLM serves the hybrid family, got {cfg.family!r}")
        period, n_groups, rem = _split_layout(cfg)
        self.cfg = cfg
        self.embed = L.Embed(cfg, device)
        self.main = nn.ModuleList(
            nn.ModuleList(S.MambaBlock(cfg, device) for _ in range(period))
            for _ in range(n_groups))
        self.tail = nn.ModuleList(S.MambaBlock(cfg, device) for _ in range(rem))
        self.shared = L.Block(cfg, device)
        self.final_norm = L.Norm(cfg, cfg.d_model, device)

    @property
    def device(self) -> torch.device:
        return self.embed.tok.device


def axes(cfg):
    """The logical-axis tree of the JAX package's hybrid params: the Mamba2
    stacks whole, the shared block tensor-parallel as a dense block."""
    _, _, rem = _split_layout(cfg)
    ax = {"embed": L.embed_axes(cfg), "final_norm": L.norm_axes(cfg),
          "shared": L.block_axes(cfg),
          "main": L.stack_axes(L.stack_axes(S.mamba_block_axes(cfg)))}
    if rem:
        ax["tail"] = L.stack_axes(S.mamba_block_axes(cfg))
    return ax


def init(cfg, generator: torch.Generator | None = None, device=None) -> HybridLM:
    """Random weights with the scales of the JAX init (not its numbers).
    ``generator`` defaults to one on ``device`` seeded with 0."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    model = HybridLM(cfg, dev)
    model.embed.reset(cfg, generator)
    model.shared.reset(cfg, generator)
    for group in [*model.main, model.tail]:
        for blk in group:
            blk.reset(cfg, generator)
    return model


def _ssm_cache(cfg, batch_size, dtype, device):
    period, n_groups, rem = _split_layout(cfg)
    conv = (batch_size, cfg.ssm_conv_width - 1, S.conv_dim(cfg))
    state = (batch_size, cfg.n_ssm_heads, cfg.ssm_headdim, cfg.ssm_state)
    f32 = torch.float32
    return {
        "conv": torch.zeros((n_groups, period) + conv, dtype=dtype, device=device),
        "state": torch.zeros((n_groups, period) + state, dtype=f32, device=device),
        "tail_conv": torch.zeros((max(rem, 1),) + conv, dtype=dtype, device=device),
        "tail_state": torch.zeros((max(rem, 1),) + state, dtype=f32, device=device),
        "pos": torch.zeros((batch_size,), dtype=torch.int32, device=device),
    }


def make_cache(cfg, batch_size: int, max_len: int, dtype=None, *, device):
    """Allocate the dense decode cache dict (zeros)."""
    _, n_groups, _ = _split_layout(cfg)
    dtype = dtype or L.cdt(cfg)
    cache = _ssm_cache(cfg, batch_size, dtype, device)
    kv = (n_groups, batch_size, cfg.n_kv_heads, max_len, cfg.resolved_head_dim)
    cache["shared_k"] = torch.zeros(kv, dtype=dtype, device=device)
    cache["shared_v"] = torch.zeros(kv, dtype=dtype, device=device)
    return cache


def cache_batch_axes(cfg):
    """Which axis of each cache tensor is the request-lane (batch) axis."""
    return {"conv": 2, "state": 2, "tail_conv": 1, "tail_state": 1,
            "shared_k": 1, "shared_v": 1, "pos": 0}


# conv/ssm state is NOT paged, so a prompt prefix is not fully captured by
# resident pages — prefix sharing would silently drop the SSM carry
PAGED_PREFIX_OK = False
# prefill() resumes the mamba stacks from the cached conv taps + SSM state
# (zero for a fresh cache — the same as no carry) and the shared attention
# block writes each chunk's K/V at its pos0 offset, so chunked prefill is
# exact at ssm_chunk-aligned boundaries
CHUNKED_PREFILL_OK = True
# decode has no cross-lane coupling: bursts may narrow to a lane prefix
LANE_INDEPENDENT_DECODE = True


def chunked_prefill_granularity(cfg) -> int:
    """Chunk boundaries must align with the SSD scan chunk (see ssm.py)."""
    return int(cfg.ssm_chunk)


def paged_decode_ok(cfg):
    """decode() reads the shared block's K/V through the page table; the
    conv/SSM state stays per-lane dense (it is O(1) in sequence length)."""
    return True


def paged_cache_spec(cfg):
    """Only the shared block's K/V grows with sequence length."""
    _, n_groups, _ = _split_layout(cfg)
    return {"shared_k": (n_groups,), "shared_v": (n_groups,)}


def make_paged_cache(cfg, batch_size: int, max_len: int, *, page_size: int,
                     pool_pages: int, dtype=None, page_dtype=None, device):
    """Paged decode cache: the per-lane SSM state, one page pool per group
    for the shared block's K/V (narrow + scale pools with ``page_dtype``),
    the per-lane page table and pos."""
    dtype = dtype or L.cdt(cfg)
    cache = _ssm_cache(cfg, batch_size, dtype, device)
    cache.update(PG.alloc_pools(paged_cache_spec(cfg), pool_pages, page_size,
                                cfg.n_kv_heads, cfg.resolved_head_dim, dtype,
                                device=device, page_dtype=page_dtype))
    cache["page_table"] = torch.zeros(
        (batch_size, PG.pages_needed(max_len, page_size)), dtype=torch.int32,
        device=device)
    return cache


def _run(model: HybridLM, cfg, x, positions, cache, *, lens, q_offset,
         cache_pos, causal, decode_step, kv_lens, live=None):
    """The backbone over a dense or a paged cache, every cache write IN
    PLACE: each group's blocks, then the shared block on that group's K/V
    slot (``cache["shared_k"][gi]``, or the group's pools ``[gi]``: views,
    so the in-place K/V write reaches the cache), then the tail."""
    h = x
    for gi, group in enumerate(model.main):
        for li, blk in enumerate(group):
            h = S.run_block(blk, h, cfg, cache["conv"][gi, li],
                            cache["state"][gi, li], lens=lens,
                            decode_step=decode_step, live=live)
        h, _ = L.block_apply(model.shared, h, positions, cfg, causal=causal,
                             kv_lens=kv_lens, q_offset=q_offset,
                             cache=L.layer_cache(cache, "shared_", gi),
                             cache_pos=cache_pos, decode=decode_step)
    for li, blk in enumerate(model.tail):
        h = S.run_block(blk, h, cfg, cache["tail_conv"][li],
                        cache["tail_state"][li], lens=lens,
                        decode_step=decode_step, live=live)
    return h


def prefill(model: HybridLM, cfg, batch, cache):
    """Run the prompt from the cached carry, fill the cache IN PLACE, return
    (last-token logits, cache).  batch: tokens (B, S), lens (B,) [+ pos0]."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    dev = tokens.device
    lens, pos0 = S.lens_pos0(batch, b, s, dev)
    positions = pos0[:, None] + torch.arange(s, dtype=torch.int32, device=dev)[None]
    x = L.embed(model.embed, tokens, cfg)
    h = _run(model, cfg, x, positions, cache, lens=lens, q_offset=pos0,
             cache_pos=pos0, causal=True, decode_step=False,
             kv_lens=pos0 + lens)
    cache = dict(cache)
    cache["pos"] = pos0 + lens
    return S.last_logits(model, cfg, h, lens), cache


def decode(model: HybridLM, cfg, batch, cache):
    """One-token decode over a dense or a paged cache: batch = {"token":
    (B, 1)} [+ "live", as ``ssm.decode``].  Returns (logits, cache)."""
    pos = cache["pos"]
    x = L.embed(model.embed, batch["token"], cfg)
    h = _run(model, cfg, x, pos[:, None], cache, lens=None, q_offset=pos,
             cache_pos=pos, causal=False, decode_step=True, kv_lens=pos + 1,
             live=batch.get("live"))
    cache = dict(cache)
    cache["pos"] = pos + 1
    h = L.apply_norm(model.final_norm, h, cfg)
    return L.unembed(model.embed, h, cfg)[:, 0], cache


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def _group_body(blocks, shared, h, positions, cfg, lens):
    for blk in blocks:
        h = S.mamba_block(blk, h, cfg, seq_lens=lens)[0]
    return L.block_apply(shared, h, positions, cfg, causal=True,
                         kv_lens=lens)[0]


def train_logits(model: HybridLM, cfg, batch):
    """batch: tokens (B, S) [+ lens (B,)].  Returns (logits (B, S, V), {});
    each group (its Mamba blocks and the shared block) under
    ``layers.remat_wrap``, the tail not, as in JAX."""
    tokens = batch["tokens"]
    lens = batch.get("lens")
    positions = L.train_positions(tokens)
    h = L.embed(model.embed, tokens, cfg)
    group = L.remat_wrap(_group_body, cfg)
    for blocks in model.main:
        h = group(blocks, model.shared, h, positions, cfg, lens)
    for blk in model.tail:
        h = S.mamba_block(blk, h, cfg, seq_lens=lens)[0]
    h = L.apply_norm(model.final_norm, h, cfg)
    return L.unembed(model.embed, h, cfg), {}
