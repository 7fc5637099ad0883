"""Page-table indirection (SVE §2.3.3 gather/scatter) for decode caches.

The port of ``repro.core.paging``: a *pool* is ``lead + (P, Hkv, page_size,
D)`` and a *page table* is ``(B, n_pages)`` int32 — lane b's logical block j
lives in physical page ``table[b, j]``.

Quantized pools (SVE §2.3.3 extending/truncating loads) hold int8 or
``torch.float8_e4m3fn`` elements, with an f32 *scale pool* of shape
``lead + (P, Hkv, page_size)`` under ``<key>_pages_scale``: one absmax scale
per token row.  ``gather_pages(..., scale=)`` widens in the gather;
``scatter_page_q`` / ``scatter_block_q`` truncate on store.  Narrow pools
move as raw bytes (a ``uint8`` view): PyTorch implements some indexing ops
(``index_copy`` among them) for no float8 type.

Differences from the JAX module, all on purpose:

* ``scatter_page`` and ``scatter_block`` write the pool IN PLACE (slice
  assignment) and return it, where JAX returns a fresh array.
* JAX gathers clamp out-of-range page ids; ``gather_pages`` and
  ``gather_block`` clamp the same way, so a stale id reads the last page
  instead of raising.  Scatters take ids the caller guarantees in range.
* ``scatter_page_q`` and ``scatter_block_q`` write both pools IN PLACE and
  return ``(pool, scale)``.
"""

from __future__ import annotations

import torch


def pages_needed(length: int, page_size: int) -> int:
    """How many pages cover ``length`` tokens (the strip-mine trip count)."""
    return -(-length // page_size)


def page_whilelt(lens, n_pages: int, page_size: int) -> torch.Tensor:
    """Page-granular ``whilelt``: page j of a lane is live iff its first
    token position ``j * page_size`` is below the lane's valid length.
    Shape ``(*lens, n_pages)`` bool."""
    lens = torch.as_tensor(lens).to(torch.int32)
    first_tok = torch.arange(n_pages, dtype=torch.int32,
                             device=lens.device) * page_size
    return first_tok < lens.unsqueeze(-1)


def _clamp_ids(ids: torch.Tensor, n: int) -> torch.Tensor:
    return ids.to(torch.int64).clamp(0, n - 1)


def as_bytes(t: torch.Tensor) -> torch.Tensor:
    """A narrow pool as its bytes (a view); other tensors as they are."""
    return t.view(torch.uint8) if is_quant_dtype(t.dtype) else t


def gather_pages(pool: torch.Tensor, table: torch.Tensor, *,
                 n_lead: int = 0, scale: torch.Tensor | None = None
                 ) -> torch.Tensor:
    """Gather-load the dense logical view of a paged tensor.

    pool ``lead + (P, Hkv, ps, D)``, table ``(B, n_pages)`` ->
    ``lead + (B, Hkv, n_pages * ps, D)``.  Out-of-range ids clamp.

    With ``scale`` (the ``lead + (P, Hkv, ps)`` scale pool of a quantized
    cache) this is the *extending* gather: the narrow elements widen to f32,
    ``q * scale`` per token row, walked by the same ids."""
    b, n_pages = table.shape
    lead = pool.shape[:n_lead]
    hkv, ps, d = pool.shape[n_lead + 1:]
    ids = _clamp_ids(table.reshape(-1), pool.shape[n_lead])
    flat = torch.index_select(as_bytes(pool), n_lead, ids).view(pool.dtype)
    out = flat.reshape(lead + (b, n_pages, hkv, ps, d))
    out = torch.movedim(out, n_lead + 1, n_lead + 2)     # lead+(B,Hkv,n,ps,D)
    if scale is not None:
        sc = torch.index_select(scale, n_lead, ids).reshape(
            lead + (b, n_pages, hkv, ps))
        sc = torch.movedim(sc, n_lead + 1, n_lead + 2)   # lead+(B,Hkv,n,ps)
        out = out.to(sc.dtype) * sc[..., None]
    return out.reshape(lead + (b, hkv, n_pages * ps, d))


def scatter_page(pool: torch.Tensor, page_ids: torch.Tensor,
                 offsets: torch.Tensor, values: torch.Tensor,
                 *, n_lead: int = 0) -> torch.Tensor:
    """Scatter-store one element per lane into its page, IN PLACE.

    ``values`` is ``lead + (B, Hkv, D)``; lane b's element lands at
    ``pool[..., page_ids[b], :, offsets[b], :]``.  Targets are distinct
    across lanes (every lane writes a page it owns).  Returns ``pool``."""
    hkv, d = pool.shape[n_lead + 1], pool.shape[n_lead + 3]
    b = page_ids.shape[0]
    pool2 = as_bytes(pool).view((-1,) + tuple(pool.shape[n_lead:]))  # (lead*,P,Hkv,ps,D)
    vals = as_bytes(values.to(pool.dtype)).reshape((-1, b, hkv, d))  # (lead*,B,Hkv,D)
    # non-adjacent advanced indices: the lane axis leads the indexed result
    pool2[:, page_ids.long(), :, offsets.long(), :] = torch.movedim(vals, 0, 1)
    return pool


def scatter_block(pool: torch.Tensor, page_ids: torch.Tensor,
                  blocks: torch.Tensor, *, n_lead: int = 0) -> torch.Tensor:
    """Scatter-store whole pages IN PLACE: ``blocks`` is
    ``(K,) + lead + (Hkv, ps, D)`` written to pages ``page_ids (K,)``."""
    pool_m = torch.movedim(as_bytes(pool), n_lead, 0)            # a view
    pool_m[page_ids.long()] = as_bytes(blocks.to(pool.dtype))
    return pool


def gather_block(pool: torch.Tensor, page_ids: torch.Tensor, *,
                 n_lead: int = 0) -> torch.Tensor:
    """Gather whole pages: ``(K,) + lead + (Hkv, ps, D)`` for ``page_ids``."""
    ids = _clamp_ids(page_ids, pool.shape[n_lead])
    return torch.movedim(torch.index_select(as_bytes(pool), n_lead, ids),
                         n_lead, 0).view(pool.dtype)


def alloc_pools(spec: dict, pool_pages: int, page_size: int, kv_heads: int,
                head_dim: int, dtype, *, device, page_dtype=None) -> dict:
    """Allocate the zeroed page pools for a family's paged-cache spec:
    key ``k`` (leading dims ``spec[k]``) -> ``k + "_pages"`` of shape
    ``lead + (pool_pages, kv_heads, page_size, head_dim)``.

    ``page_dtype`` (``"int8"`` / ``"fp8"`` or a torch dtype) stores the pool
    narrow and adds the f32 scale pool ``k + "_pages_scale"`` of shape
    ``lead + (pool_pages, kv_heads, page_size)``."""
    qdt = resolve_page_dtype(page_dtype)
    pools = {}
    for key, lead in spec.items():
        shape = tuple(lead) + (pool_pages, kv_heads, page_size)
        pools[key + "_pages"] = torch.zeros(
            shape + (head_dim,), dtype=dtype if qdt is None else qdt,
            device=device)
        if qdt is not None:
            pools[key + "_pages_scale"] = torch.zeros(
                shape, dtype=torch.float32, device=device)
    return pools


# --- quantization: narrow-in-memory pools, widened in the gather ------------

_QUANT_NAMES = {"int8": torch.int8, "fp8": torch.float8_e4m3fn,
                "float8_e4m3fn": torch.float8_e4m3fn}


def resolve_page_dtype(page_dtype):
    """Normalize a ``--page-dtype`` value to a torch dtype (or None for full
    precision).  Accepts ``"int8"``, ``"fp8"``/``"float8_e4m3fn"``, a
    dtype, or None."""
    if page_dtype is None:
        return None
    if isinstance(page_dtype, str):
        dt = _QUANT_NAMES.get(page_dtype)
        if dt is None:
            raise ValueError(f"unknown page_dtype {page_dtype!r}; "
                             f"expected one of {sorted(_QUANT_NAMES)}")
        return dt
    if not is_quant_dtype(page_dtype):
        raise ValueError(f"page_dtype {page_dtype} is not a supported narrow type")
    return page_dtype


def is_quant_dtype(dtype) -> bool:
    """True for the narrow in-memory element types pools may quantize to."""
    return dtype in (torch.int8, torch.float8_e4m3fn)


def quant_max(dtype) -> float:
    """Largest representable magnitude of a narrow pool dtype: 127 for
    int8, 448 for ``float8_e4m3fn``."""
    if dtype == torch.int8:
        return 127.0
    return float(torch.finfo(dtype).max)


def quantize_block(values: torch.Tensor, dtype):
    """Truncating store: quantize ``values (..., D)`` to ``dtype`` with one
    absmax scale per row.  Returns ``(q (..., D) dtype, scale (...,) f32)``
    with ``q * scale ≈ values``; all-zero rows get scale 0."""
    v = values.float()
    qmax = quant_max(dtype)
    scale = v.abs().amax(dim=-1) / qmax
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = v / safe[..., None]
    if dtype == torch.int8:
        q = torch.round(q)                  # half to even, as jnp.round
    # clip in all cases: float rounding in the division can land a hair past
    # qmax, which would saturate int8 wrongly and overflow fp8 (no inf) to nan
    q = q.clamp(-qmax, qmax)
    return q.to(dtype), scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Extending load: widen ``q (..., D)`` by its per-row ``scale (...,)``."""
    return q.to(scale.dtype) * scale[..., None]


def scatter_page_q(pool, scale, page_ids, offsets, values, *, n_lead: int = 0):
    """Quantizing ``scatter_page``: truncate one element per lane into the
    narrow pool and store its absmax scale at the same (page, offset) of the
    scale pool, both IN PLACE — the decode-step write of a quantized cache.
    Returns ``(pool, scale)``."""
    q, sc = quantize_block(values, pool.dtype)       # lead+(B,Hkv,D) / (B,Hkv)
    scatter_page(pool, page_ids, offsets, q, n_lead=n_lead)
    scatter_page(scale[..., None], page_ids, offsets, sc[..., None],
                 n_lead=n_lead)
    return pool, scale


def scatter_block_q(pool, scale, page_ids, blocks, *, n_lead: int = 0):
    """Quantizing ``scatter_block``: truncate whole pages ``(K,) + lead +
    (Hkv, ps, D)`` into the narrow pool, per-slot scales into the scale
    pool, both IN PLACE — the admission path of a quantized cache.  Returns
    ``(pool, scale)``."""
    q, sb = quantize_block(blocks, pool.dtype)
    scatter_block(pool, page_ids, q, n_lead=n_lead)
    scatter_block(scale, page_ids, sb, n_lead=n_lead)
    return pool, scale
