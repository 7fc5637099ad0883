"""Port parity: the core helpers of ``repro_torch`` (paging, vla, predicates)
against ``repro.core``.  Integer and boolean results must be equal, and
float results are moved, never computed, so they must be equal too."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
import numpy as np

from repro.core import paging as JPG
from repro.core import predicate as JP
from repro.core import vla as JV
from repro_torch.core import paging as PG
from repro_torch.core import predicate as P
from repro_torch.core import vla as V


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("n,m", [(0, 8), (1, 8), (8, 8), (9, 8), (130, 128)])
def test_vla_helpers(n, m):
    assert V.cdiv(n, m) == JV.cdiv(n, m)
    assert V.round_up(n, m) == JV.round_up(n, m)
    assert V.pad_to_vl(n, m) == JV.pad_to_vl(n, m)


@pytest.mark.parametrize("start,limit,vl", [
    (0, 5, 8), (3, 5, 8), (7, 2, 4), (-2, 3, 6),
    (2 ** 31 - 3, 2 ** 31 - 1, 8),               # saturates, never wraps
])
def test_whilelt(start, limit, vl):
    _eq(P.whilelt(start, limit, vl), JP.whilelt(start, limit, vl))


def test_whilelt_batched_start():
    starts = np.array([0, 4, 9], np.int32)
    _eq(P.whilelt(torch.from_numpy(starts)[:, None], 9, 6),
        JP.whilelt(jnp.asarray(starts)[:, None], 9, 6))


def test_predicated_moves():
    rng = np.random.RandomState(0)
    p = rng.rand(5) > 0.5
    a = rng.randn(3, 5).astype(np.float32)
    b = rng.randn(3, 5).astype(np.float32)
    tp, ta, tb = torch.from_numpy(p), torch.from_numpy(a), torch.from_numpy(b)
    jp, ja, jb = jnp.asarray(p), jnp.asarray(a), jnp.asarray(b)
    _eq(P.sel(tp, ta, tb), JP.sel(jp, ja, jb))
    _eq(P.merging(tp, ta, tb), JP.merging(jp, ja, jb))
    _eq(P.zeroing(tp, ta), JP.zeroing(jp, ja))


@pytest.mark.parametrize("length,ps", [(0, 4), (1, 4), (8, 4), (9, 4)])
def test_pages_needed(length, ps):
    assert PG.pages_needed(length, ps) == JPG.pages_needed(length, ps)


def test_page_whilelt():
    lens = np.array([0, 1, 4, 5, 17], np.int32)
    _eq(PG.page_whilelt(torch.from_numpy(lens), 6, 4),
        JPG.page_whilelt(jnp.asarray(lens), 6, 4))


@pytest.mark.parametrize("n_lead", [0, 1])
def test_gather_pages(n_lead):
    rng = np.random.RandomState(1 + n_lead)
    lead = (3,) * n_lead
    pool = rng.randn(*lead, 7, 2, 4, 5).astype(np.float32)
    table = np.array([[6, 0, 2], [1, 3, 3]], np.int32)
    _eq(PG.gather_pages(torch.from_numpy(pool), torch.from_numpy(table),
                        n_lead=n_lead),
        JPG.gather_pages(jnp.asarray(pool), jnp.asarray(table), n_lead=n_lead))


def test_gather_pages_clamps_out_of_range_ids():
    """The port clamps stale ids into the pool, as the JAX docstring says.
    (The installed jax fills NaN for ids past the end instead; the serving
    path never gathers such ids: the op clamps out-of-strip entries to 0.)"""
    pool = torch.arange(7 * 2 * 4 * 5, dtype=torch.float32).reshape(7, 2, 4, 5)
    table = torch.tensor([[9, -1]], dtype=torch.int32)
    view = PG.gather_pages(pool, table)
    _eq(view[0, :, :4], pool[6])
    _eq(view[0, :, 4:], pool[0])
    _eq(PG.gather_block(pool, table[0]), torch.stack([pool[6], pool[0]]))


@pytest.mark.parametrize("n_lead", [0, 1])
def test_scatter_page_in_place(n_lead):
    rng = np.random.RandomState(3 + n_lead)
    lead = (2,) * n_lead
    pool = rng.randn(*lead, 6, 2, 4, 5).astype(np.float32)
    ids = np.array([5, 0, 3], np.int32)
    offs = np.array([3, 1, 0], np.int32)
    vals = rng.randn(*lead, 3, 2, 5).astype(np.float32)
    want = JPG.scatter_page(jnp.asarray(pool), jnp.asarray(ids),
                            jnp.asarray(offs), jnp.asarray(vals), n_lead=n_lead)
    tpool = torch.from_numpy(pool.copy())
    got = PG.scatter_page(tpool, torch.from_numpy(ids), torch.from_numpy(offs),
                          torch.from_numpy(vals), n_lead=n_lead)
    assert got is tpool                                   # updated in place
    _eq(got, want)


@pytest.mark.parametrize("n_lead", [0, 1])
def test_scatter_and_gather_block(n_lead):
    rng = np.random.RandomState(5 + n_lead)
    lead = (2,) * n_lead
    pool = rng.randn(*lead, 6, 2, 4, 5).astype(np.float32)
    ids = np.array([4, 1], np.int32)
    blocks = rng.randn(2, *lead, 2, 4, 5).astype(np.float32)
    want = JPG.scatter_block(jnp.asarray(pool), jnp.asarray(ids),
                             jnp.asarray(blocks), n_lead=n_lead)
    got = PG.scatter_block(torch.from_numpy(pool.copy()), torch.from_numpy(ids),
                           torch.from_numpy(blocks), n_lead=n_lead)
    _eq(got, want)
    _eq(PG.gather_block(got, torch.from_numpy(ids), n_lead=n_lead),
        JPG.gather_block(want, jnp.asarray(ids), n_lead=n_lead))


def test_alloc_pools():
    spec = {"k": (3,), "v": (3,)}
    got = PG.alloc_pools(spec, 5, 4, 2, 8, torch.float32, device="cpu")
    want = JPG.alloc_pools(spec, 5, 4, 2, 8, jnp.float32)
    assert sorted(got) == sorted(want)
    for key in want:
        assert tuple(got[key].shape) == want[key].shape
        _eq(got[key], want[key])
