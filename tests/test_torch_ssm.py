"""Port parity: the ssm (mamba2) and hybrid (zamba2) families of
``repro_torch`` (weights carried across by ``from_jax_params``) against
``repro.models`` with its Pallas kernels in interpret mode — the Mamba block,
prefill logits and caches, decode logits, and greedy ``generate`` tokens on
the dense and the paged cache.  f32, atol = rtol = 1e-4."""

import functools

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np
from torch_parity import TOL, family_models, np_

from repro.models import get_model as j_get_model
from repro.models import ssm as jssm
from repro.models import to_paged as j_to_paged
from repro.serve import ServeEngine as JaxEngine
from repro_torch.models import get_model as t_get_model
from repro_torch.models import ssm as tssm
from repro_torch.models import to_paged
from repro_torch.models.convert import _copy_module
from repro_torch.serve import ServeEngine

LENS = np.array([40, 23, 9], np.int32)
MAX_NEW, MAX_LEN = 6, 48


def _batch(cfg):
    rng = np.random.RandomState(0)
    return {"tokens": rng.randint(1, cfg.vocab_size, (len(LENS), int(LENS.max()))),
            "lens": LENS}


def _block_twins(seed=1):
    """Layer 0 of the ssm twin with random A_log, D and dt_bias (the init
    sets them to constants), as a JAX dict and a port ``MambaBlock``."""
    cfg_j, params, cfg_t, _ = family_models("ssm")
    rng = np.random.RandomState(seed)
    h = cfg_j.n_ssm_heads
    p_np = {k: (np.asarray(v[0]) if not isinstance(v, dict)
                else {kk: np.asarray(vv[0]) for kk, vv in v.items()})
            for k, v in params["blocks"].items()}
    p_np.update(A_log=rng.randn(h).astype(np.float32) * 0.5,
                D=rng.randn(h).astype(np.float32),
                dt_bias=rng.randn(h).astype(np.float32))
    blk = tssm.MambaBlock(cfg_t, "cpu")
    _copy_module(blk, p_np)
    return cfg_j, jax.tree.map(jnp.asarray, p_np), cfg_t, blk


def _carry(cfg, b, seed=2):
    """Non-zero conv taps and SSM state to resume from."""
    rng = np.random.RandomState(seed)
    conv = rng.randn(b, cfg.ssm_conv_width - 1, tssm.conv_dim(cfg)).astype(np.float32)
    state = (rng.randn(b, cfg.n_ssm_heads, cfg.ssm_headdim, cfg.ssm_state)
             * 0.3).astype(np.float32)
    return conv, state


def _close(got, want):
    np.testing.assert_allclose(np_(got), np_(want), **TOL)


@pytest.mark.parametrize("ragged", [False, True])
def test_mamba_block_matches_jax(ragged):
    """Output, conv tail (taken at each row's length) and SSM state, resumed
    from a non-zero carry."""
    cfg_j, p_j, cfg_t, blk = _block_twins()
    b, s = 3, 21
    x = np.random.RandomState(3).randn(b, s, cfg_j.d_model).astype(np.float32)
    conv, state = _carry(cfg_j, b)
    lens = np.array([21, 7, 16], np.int32) if ragged else None
    out_j, (tail_j, st_j) = jssm.mamba_block(
        p_j, jnp.asarray(x), cfg_j, seq_lens=None if lens is None else jnp.asarray(lens),
        conv_init=jnp.asarray(conv), state_init=jnp.asarray(state))
    out_t, (tail_t, st_t) = tssm.mamba_block(
        blk, torch.from_numpy(x), cfg_t,
        seq_lens=None if lens is None else torch.from_numpy(lens),
        conv_init=torch.from_numpy(conv), state_init=torch.from_numpy(state))
    for got, want in ((out_t, out_j), (tail_t, tail_j), (st_t, st_j)):
        _close(got, want)


def test_mamba_block_decode_matches_jax():
    cfg_j, p_j, cfg_t, blk = _block_twins(seed=4)
    b = 3
    x = np.random.RandomState(5).randn(b, 1, cfg_j.d_model).astype(np.float32)
    conv, state = _carry(cfg_j, b, seed=6)
    out_j, (cc_j, st_j) = jssm.mamba_block_decode(
        p_j, jnp.asarray(x), cfg_j, jnp.asarray(conv), jnp.asarray(state))
    out_t, (cc_t, st_t) = tssm.mamba_block_decode(
        blk, torch.from_numpy(x), cfg_t, torch.from_numpy(conv),
        torch.from_numpy(state))
    for got, want in ((out_t, out_j), (cc_t, cc_j), (st_t, st_j)):
        _close(got, want)


@functools.lru_cache(maxsize=None)
def _prefill_cached(family):
    cfg_j, params, cfg_t, model = family_models(family)
    batch = _batch(cfg_j)
    cache_j = j_get_model(cfg_j).make_cache(cfg_j, len(LENS), MAX_LEN)
    logits_j, cache_j = jax.jit(j_get_model(cfg_j).prefill, static_argnums=1)(
        params, cfg_j, {k: jnp.asarray(v) for k, v in batch.items()}, cache_j)
    tm = t_get_model(cfg_t)
    cache_t = tm.make_cache(cfg_t, len(LENS), MAX_LEN, device="cpu")
    logits_t, cache_t = tm.prefill(
        model, cfg_t, {k: torch.from_numpy(v) for k, v in batch.items()}, cache_t)
    return (cfg_j, params, logits_j, cache_j), (cfg_t, model, logits_t, cache_t)


def _prefill_both(family):
    """Prefill on both sides, once per family; the port's cache is copied
    because its decode writes the cache in place."""
    jax_side, (cfg_t, model, logits_t, cache_t) = _prefill_cached(family)
    return jax_side, (cfg_t, model, logits_t,
                      {k: v.clone() for k, v in cache_t.items()})


@pytest.mark.parametrize("family", ["ssm", "hybrid"])
def test_prefill_logits_and_caches_match_jax(family):
    (_, _, logits_j, cache_j), (_, _, logits_t, cache_t) = _prefill_both(family)
    _close(logits_t, logits_j)
    assert sorted(cache_t) == sorted(cache_j)
    for key in cache_j:
        _close(cache_t[key], cache_j[key])


@pytest.mark.parametrize("family,page_size", [("ssm", None), ("hybrid", None),
                                              ("hybrid", 8)])
def test_decode_logits_match_jax(family, page_size):
    """A decode step after prefill, on the dense or the paged cache."""
    (cfg_j, params, logits_j, cache_j), (cfg_t, model, logits_t, cache_t) = \
        _prefill_both(family)
    if page_size is not None:
        cache_j = j_to_paged(cfg_j, cache_j, page_size=page_size)
        cache_t = to_paged(cfg_t, cache_t, page_size=page_size)
    jm, tm = j_get_model(cfg_j), t_get_model(cfg_t)
    tok = np.asarray(jnp.argmax(logits_j, -1)).astype(np.int32)[:, None]
    logits_j, cache_j = jax.jit(jm.decode, static_argnums=1)(
        params, cfg_j, {"token": jnp.asarray(tok)}, cache_j)
    logits_t, cache_t = tm.decode(model, cfg_t, {"token": torch.from_numpy(tok)},
                                  cache_t)
    _close(logits_t, logits_j)
    for key in cache_j:
        _close(cache_t[key], cache_j[key])


def _generate(family, engine_cls, page_size=None, **kw):
    cfg_j, params, cfg_t, model = family_models(family)
    batch = _batch(cfg_j)
    if engine_cls is JaxEngine:
        eng = JaxEngine(cfg_j, params, max_new_tokens=MAX_NEW, stop_token=-1)
        res = eng.generate({k: jnp.asarray(v) for k, v in batch.items()},
                           page_size=page_size)
    else:
        eng = ServeEngine(cfg_t, model, max_new_tokens=MAX_NEW, stop_token=-1,
                          device="cpu", **kw)
        res = eng.generate(batch, page_size=page_size)
    return np_(res["tokens"]), np_(res["n_generated"])


@pytest.mark.parametrize("family,page_size", [("ssm", None), ("hybrid", None),
                                              ("hybrid", 8)])
def test_generate_matches_jax(family, page_size):
    tok_j, n_j = _generate(family, JaxEngine, page_size)
    tok_t, n_t = _generate(family, ServeEngine, page_size)
    np.testing.assert_array_equal(tok_t, tok_j)
    np.testing.assert_array_equal(n_t, n_j)


def test_hybrid_paged_equals_dense_and_gather_oracle():
    dense = _generate("hybrid", ServeEngine)
    native = _generate("hybrid", ServeEngine, page_size=4)
    oracle = _generate("hybrid", ServeEngine, page_size=4, paged_attn="gather")
    for got in (native, oracle):
        np.testing.assert_array_equal(got[0], dense[0])
        np.testing.assert_array_equal(got[1], dense[1])


def test_ssm_has_nothing_to_page():
    """The ssm cache holds no per-token state: paging it raises ValueError,
    as in JAX, from ``to_paged`` and from ``generate(page_size=)``."""
    _, _, cfg_t, model = family_models("ssm")
    cache = tssm.make_cache(cfg_t, 2, device="cpu")
    with pytest.raises(ValueError, match="no pageable KV state"):
        to_paged(cfg_t, cache, page_size=8)
    with pytest.raises(ValueError, match="paging does not apply"):
        tssm.make_paged_cache(cfg_t, 2, 16, page_size=8, pool_pages=4)
    eng = ServeEngine(cfg_t, model, max_new_tokens=2, device="cpu")
    with pytest.raises(ValueError, match="no pageable KV state"):
        eng.generate(_batch(cfg_t), page_size=8)
