"""Port parity: the dense family's VLM branch (llama-3.2-vision) of
``repro_torch`` (weights carried across by ``from_jax_params``) against
``repro.models.dense`` with its Pallas kernels in interpret mode — the
cross K/V, one group's cross-attention block in prefill (the ``kv_x``
path) and in decode (``_cross_decode``), prefill and decode logits on the
dense and the paged cache (pools with two lead axes), f32 at atol = rtol =
1e-4, and greedy ``generate`` tokens (the JAX engine on its plain XLA
path).  Inside the port, bit for bit: paged decode == dense decode, a
narrowed burst == a full one, and a lane spilled and resumed by the
engine's movers.

The twin is the reference's tiny vlm config (``test_paged_cache``: 10
layers in groups of 5, 4 image tokens, d 64) with llama's rmsnorm and full
rotary."""

import functools

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np
from torch_parity import TOL, models, np_, plain_models

from repro.models import dense as jdense
from repro.models import layers as JL
from repro.models import paged_view as j_paged_view
from repro.models import to_paged as j_to_paged
from repro.serve import ServeEngine as JaxEngine
from repro_torch.models import dense as tdense
from repro_torch.models import layers as L
from repro_torch.models import paged_view, to_paged
from repro_torch.serve import ServeEngine

VLM = dict(n_layers=10, cross_attn_group=5, n_cross_tokens=4, norm="rmsnorm",
           partial_rotary_factor=1.0)
LENS = np.array([9, 3, 6], np.int32)
MAX_NEW, MAX_LEN = 6, 16


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _twins():
    return models(0, **VLM)


def _batch(cfg, seed=0):
    rng = np.random.RandomState(seed)
    return {"tokens": rng.randint(1, cfg.vocab_size, (3, int(LENS.max()))),
            "lens": LENS,
            "cross_emb": rng.randn(3, cfg.n_cross_tokens, cfg.d_model)
            .astype(np.float32)}


def _close(got, want):
    np.testing.assert_allclose(np_(got), np_(want), **TOL)


def test_model_layout():
    """Two groups of 4 self blocks and one cross block, and caches with the
    JAX shapes and lane axes."""
    cfg_j, _, cfg_t, model = _twins()
    assert [len(g) for g in model.groups["self"]] == [4, 4]
    assert len(model.groups["cross"]) == 2 and len(model.blocks) == 0
    cj = jdense.make_cache(cfg_j, 3, MAX_LEN)
    ct = tdense.make_cache(cfg_t, 3, MAX_LEN, device="cpu")
    assert {k: tuple(v.shape) for k, v in ct.items()} == \
        {k: tuple(v.shape) for k, v in cj.items()}
    assert tdense.cache_batch_axes(cfg_t) == jdense.cache_batch_axes(cfg_j)
    assert tdense.paged_cache_spec(cfg_t) == jdense.paged_cache_spec(cfg_j)


def test_cross_kv_and_group_blocks_match_jax():
    """Group 1's cross K/V, its cross block through the ``kv_x`` path (a
    prefill) and through the cached K/V (``_cross_decode``)."""
    cfg_j, params, cfg_t, model = _twins()
    rng = np.random.RandomState(1)
    emb = rng.randn(3, 4, cfg_j.d_model).astype(np.float32)
    x = rng.randn(3, 5, cfg_j.d_model).astype(np.float32)
    pos = np.arange(5, dtype=np.int32)[None].repeat(3, 0)
    gp = jax.tree.map(lambda a: a[1], params["groups"])
    cb = model.groups["cross"][1]
    ck_j, cv_j = jdense._cross_kv(gp["cross"]["attn"], jnp.asarray(emb), cfg_j)
    ck_t, cv_t = tdense._cross_kv(cb.attn, torch.from_numpy(emb), cfg_t)
    _close(ck_t, ck_j)
    _close(cv_t, cv_j)
    want, _ = JL.block_apply(gp["cross"], jnp.asarray(x), jnp.asarray(pos),
                             cfg_j, kv_x=jnp.asarray(emb), causal=False,
                             use_rope=False)
    got, _ = L.block_apply(cb, torch.from_numpy(x), torch.from_numpy(pos),
                           cfg_t, kv_x=torch.from_numpy(emb), causal=False)
    _close(got, want)
    want = jdense._cross_decode(gp["cross"], jnp.asarray(x[:, :1]),
                                jnp.asarray(pos[:, :1]), cfg_j, ck_j, cv_j)
    got = tdense._cross_decode(cb, torch.from_numpy(x[:, :1]), cfg_t, ck_t, cv_t)
    _close(got, want)


@functools.lru_cache(maxsize=None)
def _prefill_cached():
    cfg_j, params, cfg_t, model = _twins()
    batch = _batch(cfg_j)
    cj = jdense.make_cache(cfg_j, 3, MAX_LEN)
    lj, cj = jdense.prefill(params, cfg_j,
                            {k: jnp.asarray(v) for k, v in batch.items()}, cj)
    ct = tdense.make_cache(cfg_t, 3, MAX_LEN, device="cpu")
    lt, ct = tdense.prefill(model, cfg_t,
                            {k: torch.from_numpy(v) for k, v in batch.items()}, ct)
    return (cfg_j, params, lj, cj), (cfg_t, model, lt, ct)


@pytest.mark.parametrize("paged", [False, True])
def test_prefill_and_decode_match_jax(paged):
    (cfg_j, params, lj, cj), (cfg_t, model, lt, ct) = _prefill_cached()
    _close(lt, lj)
    for key in ("k", "v", "cross_k", "cross_v", "pos"):
        _close(ct[key], cj[key])
    ct = {k: v.clone() for k, v in ct.items()}
    if paged:
        cj = j_to_paged(cfg_j, cj, page_size=4)
        ct = to_paged(cfg_t, ct, page_size=4)
        assert ct["k_pages"].shape[:2] == (2, 4)
    tok = np_(lj).argmax(-1)[:, None].astype(np.int32)
    for _ in range(3):
        lj, cj = jdense.decode(params, cfg_j, {"token": jnp.asarray(tok)}, cj)
        lt, ct = tdense.decode(model, cfg_t, {"token": torch.from_numpy(tok)}, ct)
        _close(lt, lj)
        tok = np_(lj).argmax(-1)[:, None].astype(np.int32)
    if paged:
        # the pools after 3 steps: their dense views agree
        _close(paged_view(cfg_t, ct)["k"], j_paged_view(cfg_j, cj)["k"])


@pytest.mark.parametrize("page_size", [None, 4])
def test_generate_matches_jax(page_size):
    cfg_j, params, cfg_t, model = plain_models(0, **VLM)
    batch = _batch(cfg_j, seed=1)
    kw = dict(max_new_tokens=MAX_NEW, stop_token=-1)
    rj = JaxEngine(cfg_j, params, **kw).generate(
        {k: jnp.asarray(v) for k, v in batch.items()}, page_size=page_size)
    rt = ServeEngine(cfg_t, model, device="cpu", **kw).generate(
        batch, page_size=page_size)
    assert np_(rt["tokens"]).tobytes() == np_(rj["tokens"]).tobytes()
    np.testing.assert_array_equal(np_(rt["n_generated"]), np_(rj["n_generated"]))


def test_paged_equals_dense_narrowed_burst_and_spilled_lane():
    """Inside the port, bit for bit: paged decode logits == dense; a burst
    narrowed to 2 lanes gives those lanes the full burst's tokens and
    cache; a lane spilled and resumed by the engine's movers decodes as
    before."""
    *_, (cfg, model, lt, ct) = _prefill_cached()
    clone = lambda d: {k: v.clone() for k, v in d.items()}
    dense, paged = clone(ct), to_paged(cfg, clone(ct), page_size=4)
    tok = lt.argmax(-1).to(torch.int32)[:, None]
    for _ in range(3):
        ld, dense = tdense.decode(model, cfg, {"token": tok}, dense)
        lp, paged = tdense.decode(model, cfg, {"token": tok}, paged)
        assert torch.equal(ld, lp)
        tok = ld.argmax(-1).to(torch.int32)[:, None]
    eng = ServeEngine(cfg, model, max_new_tokens=MAX_NEW, stop_token=-1,
                      device="cpu")
    cache, out, tok, p, n_gen, budget, sstate, _ = eng._start(_batch(cfg, 2))
    a = eng._burst(clone(cache), out.clone(), tok, p, n_gen, budget, sstate,
                   n_steps=4, stochastic=False)
    b = eng._burst(clone(cache), out.clone(), tok, p, n_gen, budget, sstate,
                   n_steps=4, stochastic=False, width=2)
    assert torch.equal(a[1][:2], b[1][:2])
    for key, ax in tdense.cache_batch_axes(cfg).items():
        assert torch.equal(a[0][key].narrow(ax, 0, 2),
                           b[0][key].narrow(ax, 0, 2)), key
    # lane 1 spilled, zeroed, and resumed
    dense_row, row, srow = eng._spill_lane(cache, out, tok, n_gen, budget,
                                           sstate, 1)
    wiped = {k: v.clone().zero_() if k != "pos" else v.clone()
             for k, v in cache.items()}
    back = eng._resume_lane(wiped, out, tok, p, n_gen, budget, sstate, 1,
                            dense_row, row, srow, None)[0]
    for key, ax in tdense.cache_batch_axes(cfg).items():
        assert torch.equal(back[key].select(ax, 1), cache[key].select(ax, 1)), key
