"""Model zoo of the port (the dense, moe, ssm, hybrid and encdec families)
and the cache lane and paged-layout interface of ``repro.models``.

A decode cache is a dict of tensors, each with ONE request-lane axis
declared by the family's ``cache_batch_axes(cfg)``.  A paged cache replaces
each KV tensor's per-lane token axis with a shared page POOL
(``<key>_pages``: lead + (P, Hkv, page_size, D)) plus one per-lane int32
``page_table`` (B, n_pages).  A QUANTIZED paged cache holds int8/fp8 pools
with f32 scale pools (``<key>_pages_scale``: lead + (P, Hkv, page_size)).
The lane movers below return new tensors; ``paged_writeback`` writes the
pools in place.
"""

from __future__ import annotations

import importlib

import torch

from repro_torch.core import paging as PG
from repro_torch.core import predicate as P

from .config import ModelConfig  # noqa: F401

# each ported family's module is named after it
_PORTED = ("dense", "moe", "ssm", "hybrid", "encdec")


def get_model(cfg: "ModelConfig"):
    """Return the module implementing cfg.family's model API:
    init(cfg, generator, device) -> the family's model (``DenseLM``,
    ``MoELM``, ``SSMLM``, ``HybridLM`` or ``EncDecLM``); prefill(model, cfg,
    batch, cache) -> (logits_last, cache); decode(model, cfg, batch, cache)
    -> (logits, cache); make_cache / make_paged_cache / cache_batch_axes /
    paged_cache_spec (encdec's caches also take ``src_len``)."""
    if cfg.family in _PORTED:
        return importlib.import_module(f"{__name__}.{cfg.family}")
    raise ValueError(f"unknown family {cfg.family!r}")


def _lane_axes(cfg, cache):
    """Lane axis per cache key, paged-layout aware: page pools carry NO lane
    axis, the page table's lane axis is 0."""
    axes = get_model(cfg).cache_batch_axes(cfg)
    if "page_table" not in cache:
        return axes
    out = {k: ax for k, ax in axes.items() if k in cache}
    out["page_table"] = 0
    return out


def gather_lanes(cfg, cache, lanes):
    """Out lane i takes the state of input lane ``lanes[i]``.  On a paged
    cache the pools pass through untouched: moving a lane moves its
    page-table row, never its pages."""
    axes = _lane_axes(cfg, cache)
    lanes = torch.as_tensor(lanes).to(torch.int64)
    return {k: (torch.index_select(v, axes[k], lanes.to(v.device))
                if k in axes else v) for k, v in cache.items()}


def slot_update(cfg, cache, lanes, sub_cache):
    """Write ``sub_cache`` (lane count ``len(lanes)``) into ``cache`` at lane
    indices ``lanes`` along each tensor's lane axis; returns a new dict of new
    tensors.  Keys without a lane axis (pools) and keys missing from
    ``sub_cache`` pass through.  A lane index past the last lane drops, as
    in JAX (``P.set_lanes``): padded admission rows aim there."""
    axes = _lane_axes(cfg, cache)
    out = dict(cache)
    for k, v in cache.items():
        if k not in axes or k not in sub_cache:
            continue
        out[k] = P.set_lanes(v, lanes, sub_cache[k], axis=axes[k])
    return out


def merge_lanes(cfg, cache, lanes, sub_cache):
    """Write a narrowed decode burst's ``sub_cache`` back: lane-axis tensors
    splice at ``lanes`` (slot_update); tensors WITHOUT a lane axis — the
    shared page pools — are taken from ``sub_cache`` wholesale."""
    axes = _lane_axes(cfg, cache)
    out = slot_update(cfg, cache, lanes, sub_cache)
    for k, v in sub_cache.items():
        if k in out and k not in axes:
            out[k] = v
    return out


def is_paged(cache) -> bool:
    return isinstance(cache, dict) and "page_table" in cache


def is_quantized(cache) -> bool:
    """True when the paged cache stores its pools NARROW (int8/fp8) with
    per-slot scale pools under ``<key>_pages_scale``."""
    return isinstance(cache, dict) and any(
        k.endswith("_pages_scale") for k in cache)


def paged_decode_ok(cfg) -> bool:
    """True when cfg's family decode() consumes a paged cache natively."""
    fn = getattr(get_model(cfg), "paged_decode_ok", None)
    return bool(fn and fn(cfg))


def chunked_prefill_ok(cfg) -> bool:
    """True when cfg's family prefill() supports per-row ``pos0`` start
    offsets with all cross-chunk state carried in the cache — the property
    that makes splitting one prompt's prefill into chunks equal to
    prefilling it whole (dense/moe keep everything in the KV cache,
    ssm/hybrid resume the conv taps + SSM state)."""
    return bool(getattr(get_model(cfg), "CHUNKED_PREFILL_OK", False))


def lane_independent_decode(cfg) -> bool:
    """True when cfg's family decode() treats request lanes independently —
    no cross-lane coupling anywhere in the step — so a decode burst over any
    lane PREFIX gives the same per-lane results.  This lets the scheduler
    narrow its burst to the occupied pow2 lane bucket.  MoE does not
    qualify: expert capacity is shared across the batch, so dropping (dead)
    lanes changes which tokens overflow an expert buffer."""
    return bool(getattr(get_model(cfg), "LANE_INDEPENDENT_DECODE", False))


def chunked_prefill_granularity(cfg) -> int:
    """Alignment (in tokens) chunk boundaries must respect for chunked
    prefill to equal whole-prompt prefill: 1 for attention families,
    ``ssm_chunk`` for ssm/hybrid (the resumed SSD scan replays the same
    chunk sequence as the unchunked scan)."""
    fn = getattr(get_model(cfg), "chunked_prefill_granularity", None)
    return int(fn(cfg)) if fn else 1


def to_paged(cfg, cache, *, page_size: int, pool_pages=None, page_dtype=None):
    """Convert a DENSE cache to the paged layout with identity page tables
    (lane b's logical block j lives in physical page ``b * n_pages + j``).
    Token axes are zero-padded up to a page multiple.  Gathering the result
    through ``paged_view`` reproduces the dense cache exactly.

    With ``page_dtype`` the pools store NARROW: each token row truncates to
    int8/fp8 against its absmax scale (``<key>_pages_scale``), and the round
    trip through ``paged_view`` is identity up to quantization error."""
    spec = get_model(cfg).paged_cache_spec(cfg)
    if not spec:
        raise ValueError(f"family '{cfg.family}' has no pageable KV state")
    key0, lead0 = next(iter(spec.items()))
    b = cache[key0].shape[len(lead0)]
    max_len = cache[key0].shape[len(lead0) + 2]
    n_pages = PG.pages_needed(max_len, page_size)
    need = b * n_pages
    pool_pages = need if pool_pages is None else pool_pages
    if pool_pages < need:
        raise ValueError(f"pool_pages={pool_pages} < {need} needed for the "
                         f"identity layout ({b} lanes x {n_pages} pages)")
    qdt = PG.resolve_page_dtype(page_dtype)
    out = {k: v for k, v in cache.items() if k not in spec}
    for key, lead in spec.items():
        nl = len(lead)
        v = cache[key]                               # lead+(B,Hkv,S,D)
        hkv, s, d = v.shape[nl + 1:]
        pool = torch.zeros(lead + (pool_pages, hkv, page_size, d),
                           dtype=v.dtype if qdt is None else qdt,
                           device=v.device)
        # page-by-page copy: never holds a second padded copy of the cache
        blocks = PG.as_bytes(pool).narrow(nl, 0, need).view(
            lead + (b, n_pages, hkv, page_size, d))
        if qdt is not None:
            scale = torch.zeros(lead + (pool_pages, hkv, page_size),
                                dtype=torch.float32, device=v.device)
            scales = scale.narrow(nl, 0, need).view(
                lead + (b, n_pages, hkv, page_size))
            out[key + "_pages_scale"] = scale
        for j in range(n_pages):
            lo, hi = j * page_size, min((j + 1) * page_size, s)
            if lo >= hi:
                continue
            src = v.narrow(nl + 2, lo, hi - lo)
            if qdt is not None:                      # truncating store
                src, sc = PG.quantize_block(src, qdt)
                scales.select(nl + 1, j).narrow(nl + 2, 0, hi - lo).copy_(sc)
            blocks.select(nl + 1, j).narrow(nl + 2, 0, hi - lo).copy_(
                PG.as_bytes(src))
        out[key + "_pages"] = pool
    dev = cache[key0].device
    out["page_table"] = (
        torch.arange(b, dtype=torch.int32, device=dev)[:, None] * n_pages
        + torch.arange(n_pages, dtype=torch.int32, device=dev)[None, :])
    return out


def paged_view(cfg, cache):
    """Materialize the dense logical view of a paged cache through the page
    table.  Non-paged per-lane entries pass through.  On a quantized cache
    the gather widens the pools, so the view is f32."""
    spec = get_model(cfg).paged_cache_spec(cfg)
    table = cache["page_table"]
    out = {k: v for k, v in cache.items()
           if k != "page_table" and not k.endswith("_pages")
           and not k.endswith("_pages_scale")}
    for key, lead in spec.items():
        out[key] = PG.gather_pages(cache[key + "_pages"], table,
                                   n_lead=len(lead),
                                   scale=cache.get(key + "_pages_scale"))
    return out


def paged_writeback(cfg, cache, view, pos):
    """Scatter the ONE token a decode step wrote at per-lane position ``pos``
    from the dense ``view`` back into the page pools (IN PLACE; truncating
    into the narrow pools and their scale pools when quantized), and carry
    the view's other per-lane state (pos, ...) across."""
    spec = get_model(cfg).paged_cache_spec(cfg)
    table = cache["page_table"]
    n_pages = table.shape[1]
    ps = _page_size_of(cfg, cache)
    out = dict(cache)
    pos = torch.as_tensor(pos).to(torch.int32)
    page_col = (pos // ps).clamp(0, n_pages - 1)
    page_ids = table.gather(1, page_col[:, None].long())[:, 0]
    offsets = pos % ps
    for key, lead in spec.items():
        v = view[key]                                 # lead+(B,Hkv,S,D)
        s = v.shape[-2]
        idx = pos.clamp(0, s - 1).long().reshape((1,) * len(lead) + (-1, 1, 1, 1))
        idx = idx.expand(v.shape[:-2] + (1, v.shape[-1]))
        tok = v.gather(-2, idx)[..., 0, :]           # lead+(B,Hkv,D)
        sc = cache.get(key + "_pages_scale")
        if sc is not None:
            PG.scatter_page_q(cache[key + "_pages"], sc, page_ids, offsets,
                              tok, n_lead=len(lead))
        else:
            PG.scatter_page(cache[key + "_pages"], page_ids, offsets, tok,
                            n_lead=len(lead))
    for k, v in view.items():
        if k not in spec:
            out[k] = v
    return out


def _page_size_of(cfg, cache):
    key, lead = next(iter(get_model(cfg).paged_cache_spec(cfg).items()))
    return cache[key + "_pages"].shape[len(lead) + 2]
