"""Page-table indirection (SVE §2.3.3 gather/scatter) for decode caches.

The full-precision half of ``repro.core.paging``: a *pool* is
``lead + (P, Hkv, page_size, D)`` and a *page table* is ``(B, n_pages)``
int32 — lane b's logical block j lives in physical page ``table[b, j]``.

Differences from the JAX module, both on purpose:

* ``scatter_page`` and ``scatter_block`` write the pool IN PLACE (slice
  assignment) and return it, where JAX returns a fresh array.
* JAX gathers clamp out-of-range page ids; ``gather_pages`` and
  ``gather_block`` clamp the same way, so a stale id reads the last page
  instead of raising.  Scatters take ids the caller guarantees in range.
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


def gather_pages(pool: torch.Tensor, table: torch.Tensor, *,
                 n_lead: int = 0) -> torch.Tensor:
    """Gather-load the dense logical view of a paged tensor.

    pool ``lead + (P, Hkv, ps, D)``, table ``(B, n_pages)`` ->
    ``lead + (B, Hkv, n_pages * ps, D)``.  Out-of-range ids clamp."""
    b, n_pages = table.shape
    lead = pool.shape[:n_lead]
    hkv, ps, d = pool.shape[n_lead + 1:]
    ids = _clamp_ids(table.reshape(-1), pool.shape[n_lead])
    flat = torch.index_select(pool, n_lead, ids)
    out = flat.reshape(lead + (b, n_pages, hkv, ps, d))
    out = torch.movedim(out, n_lead + 1, n_lead + 2)     # lead+(B,Hkv,n,ps,D)
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
    pool2 = pool.view((-1,) + tuple(pool.shape[n_lead:]))   # (lead*,P,Hkv,ps,D)
    vals = values.reshape((-1, b, hkv, d))                   # (lead*,B,Hkv,D)
    # non-adjacent advanced indices: the lane axis leads the indexed result
    pool2[:, page_ids.long(), :, offsets.long(), :] = (
        torch.movedim(vals, 0, 1).to(pool.dtype))
    return pool


def scatter_block(pool: torch.Tensor, page_ids: torch.Tensor,
                  blocks: torch.Tensor, *, n_lead: int = 0) -> torch.Tensor:
    """Scatter-store whole pages IN PLACE: ``blocks`` is
    ``(K,) + lead + (Hkv, ps, D)`` written to pages ``page_ids (K,)``."""
    pool_m = torch.movedim(pool, n_lead, 0)                  # a view
    pool_m[page_ids.long()] = blocks.to(pool.dtype)
    return pool


def gather_block(pool: torch.Tensor, page_ids: torch.Tensor, *,
                 n_lead: int = 0) -> torch.Tensor:
    """Gather whole pages: ``(K,) + lead + (Hkv, ps, D)`` for ``page_ids``."""
    ids = _clamp_ids(page_ids, pool.shape[n_lead])
    return torch.movedim(torch.index_select(pool, n_lead, ids), n_lead, 0)


def alloc_pools(spec: dict, pool_pages: int, page_size: int, kv_heads: int,
                head_dim: int, dtype, *, device) -> dict:
    """Allocate the zeroed page pools for a family's paged-cache spec:
    key ``k`` (leading dims ``spec[k]``) -> ``k + "_pages"`` of shape
    ``lead + (pool_pages, kv_heads, page_size, head_dim)``."""
    return {key + "_pages": torch.zeros(
        tuple(lead) + (pool_pages, kv_heads, page_size, head_dim),
        dtype=dtype, device=device) for key, lead in spec.items()}
