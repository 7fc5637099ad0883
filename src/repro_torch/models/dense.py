"""Dense decoder-LM family (stablelm-3b/12b, command-r-plus, gemma3), mirroring
``repro.models.dense`` without the llama-vision cross-attention branch.

Layers run as a Python loop over ``DenseLM.blocks``; the per-layer window is
one predicated attention with a dynamic window (2**30 = global), as in JAX.
Caches are dicts of tensors in the JAX layouts and are updated IN PLACE by
``prefill`` and ``decode``, which return the dict with the new ``pos``.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.core import paging as PG
from repro_torch.core.device import resolve_device

from . import layers as L

NO_WINDOW = 2 ** 30


class DenseLM(nn.Module):
    """The dense LM's weights: embedding, one ``Block`` per layer, final norm.
    Built with uninitialised weights; ``init`` or
    ``convert.from_jax_params`` fills them."""

    def __init__(self, cfg, device):
        super().__init__()
        if cfg.family != "dense" or cfg.cross_attn_group:
            raise NotImplementedError(
                f"only the dense family without cross-attention is ported "
                f"(got family={cfg.family!r}, "
                f"cross_attn_group={cfg.cross_attn_group}); "
                "see ROADMAP Queue 1 item 12")
        self.cfg = cfg
        self.embed = L.Embed(cfg, device)
        self.blocks = nn.ModuleList(L.Block(cfg, device)
                                    for _ in range(cfg.n_layers))
        self.final_norm = L.Norm(cfg, cfg.d_model, device)

    @property
    def device(self) -> torch.device:
        return self.embed.tok.device


def init(cfg, generator: torch.Generator | None = None, device=None) -> DenseLM:
    """Random weights with the scales of the JAX init (not its numbers):
    N(0, 1/fan_in) matmul weights and embeddings, unit norms, zero biases.
    ``generator`` defaults to one on ``device`` seeded with 0."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    model = DenseLM(cfg, dev)
    model.embed.reset(cfg, generator)
    for blk in model.blocks:
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
    """Allocate the decode cache dict (zeros)."""
    dtype = dtype or L.cdt(cfg)
    shp = (cfg.n_layers, batch_size, cfg.n_kv_heads, max_len,
           cfg.resolved_head_dim)
    return {"k": torch.zeros(shp, dtype=dtype, device=device),
            "v": torch.zeros(shp, dtype=dtype, device=device),
            "pos": torch.zeros((batch_size,), dtype=torch.int32, device=device)}


def cache_batch_axes(cfg):
    """Which axis of each cache tensor is the request-lane (batch) axis."""
    return {"k": 1, "v": 1, "pos": 0}


# full prefix state lives in paged KV + pos, so prefix sharing is sound
PAGED_PREFIX_OK = True
# prefill() takes per-row pos0 start offsets with all state in the KV cache,
# so one prompt's prefill can be split into chunks (scheduler chunked prefill)
CHUNKED_PREFILL_OK = True
# decode has no cross-lane coupling: bursts may narrow to a lane prefix
LANE_INDEPENDENT_DECODE = True


def paged_decode_ok(cfg):
    """decode() reads a paged cache directly through the page table."""
    return True


def paged_cache_spec(cfg):
    """KV cache keys with a token axis -> their leading layer dims."""
    return {"k": (cfg.n_layers,), "v": (cfg.n_layers,)}


def make_paged_cache(cfg, batch_size: int, max_len: int, *, page_size: int,
                     pool_pages: int, dtype=None, page_dtype=None, device):
    """Paged decode cache: shared page pools + per-lane page table + pos;
    with ``page_dtype`` ("int8" / "fp8") narrow pools + scale pools."""
    dtype = dtype or L.cdt(cfg)
    cache = PG.alloc_pools(paged_cache_spec(cfg), pool_pages, page_size,
                           cfg.n_kv_heads, cfg.resolved_head_dim, dtype,
                           device=device, page_dtype=page_dtype)
    cache["page_table"] = torch.zeros(
        (batch_size, PG.pages_needed(max_len, page_size)), dtype=torch.int32,
        device=device)
    cache["pos"] = torch.zeros((batch_size,), dtype=torch.int32, device=device)
    return cache


# ---------------------------------------------------------------------------
# serving: prefill + single-token decode with KV caches
# ---------------------------------------------------------------------------

def prefill(model: DenseLM, cfg, batch, cache):
    """Run the prompt, fill the cache IN PLACE, return (last-token logits,
    cache).

    batch: tokens (B, S), lens (B,) [+ pos0 (B,)].  ``pos0`` is the per-row
    start of a SUFFIX prefill over a cache that already holds positions
    [0, pos0).  The cache must have max_len >= pos0 + S.
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
    wins = layer_windows(cfg, dev)
    for li, blk in enumerate(model.blocks):
        h, _ = L.block_apply(blk, h, positions, cfg, causal=True,
                             window=wins[li], kv_lens=kv_lens, q_offset=pos0,
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
    wins = layer_windows(cfg, token.device)
    for li, blk in enumerate(model.blocks):
        h, _ = L.block_apply(blk, h, positions, cfg, causal=False,
                             window=wins[li], kv_lens=pos + 1, q_offset=pos,
                             cache=L.layer_cache(cache, "", li), cache_pos=pos,
                             decode=True)
    cache = dict(cache)
    cache["pos"] = pos + 1
    h = L.apply_norm(model.final_norm, h, cfg)
    logits = L.unembed(model.embed, h, cfg)[:, 0]
    return logits, cache
