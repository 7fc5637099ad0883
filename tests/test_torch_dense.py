"""Port parity: the dense model of ``repro_torch`` (weights carried across by
``from_jax_params``) against ``repro.models`` with its Pallas kernels in
interpret mode — per module, then prefill and decode logits on the dense
and the paged cache.  f32, atol = rtol = 1e-4."""

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np
from torch_parity import TOL, configs, models, np_

from repro.models import dense as jdense
from repro.models import layers as JL
from repro.models import gather_lanes as j_gather_lanes
from repro.models import merge_lanes as j_merge_lanes
from repro.models import slot_update as j_slot_update
from repro.models import to_paged as j_to_paged
from repro_torch.models import dense as tdense
from repro_torch.models import layers as TL
from repro_torch.models import (gather_lanes, merge_lanes, paged_view,
                                slot_update, to_paged)

B, S, MAX_LEN = 3, 7, 16


def _layer0(params):
    return jax.tree.map(lambda a: a[0], params["blocks"])


def _batch(rng, cfg):
    tokens = rng.randint(1, cfg.vocab_size, (B, S))
    lens = np.array([7, 3, 5], np.int32)
    return tokens, lens


@pytest.mark.parametrize("norm", ["layernorm", "rmsnorm"])
def test_apply_norm(norm):
    cfg_j, params, cfg_t, model = models(norm=norm)
    rng = np.random.RandomState(0)
    x = rng.randn(B, S, cfg_j.d_model).astype(np.float32) * 3 + 1
    want = JL.apply_norm(_layer0(params)["ln1"], jnp.asarray(x), cfg_j)
    got = TL.apply_norm(model.blocks[0].ln1, torch.from_numpy(x), cfg_t)
    np.testing.assert_allclose(np_(got), np_(want), **TOL)


@pytest.mark.parametrize("dh,frac", [(16, 0.25), (16, 1.0), (80, 0.25)])
def test_rope(dh, frac):
    rng = np.random.RandomState(dh)
    x = rng.randn(B, 4, S, dh).astype(np.float32)
    pos = rng.randint(0, 3000, (B, S)).astype(np.int32)
    want = JL.rope(jnp.asarray(x), jnp.asarray(pos), 10000.0, frac)
    got = TL.rope(torch.from_numpy(x), torch.from_numpy(pos), 10000.0, frac)
    np.testing.assert_allclose(np_(got), np_(want), **TOL)


@pytest.mark.parametrize("activation", ["swiglu", "geglu", "gelu"])
def test_mlp(activation):
    cfg_j, params, cfg_t, model = models(activation=activation)
    x = np.random.RandomState(1).randn(B, S, cfg_j.d_model).astype(np.float32)
    want = JL.mlp(_layer0(params)["mlp"], jnp.asarray(x), cfg_j)
    got = TL.mlp(model.blocks[0].mlp, torch.from_numpy(x), cfg_t)
    np.testing.assert_allclose(np_(got), np_(want), **TOL)


def test_embed_unembed_masks_padded_vocab():
    cfg_j, params, cfg_t, model = models()
    ids = np.random.RandomState(2).randint(0, cfg_j.vocab_size, (B, S))
    x_j = JL.embed(params["embed"], jnp.asarray(ids), cfg_j)
    x_t = TL.embed(model.embed, torch.from_numpy(ids), cfg_t)
    np.testing.assert_array_equal(np_(x_t), np_(x_j))
    want = JL.unembed(params["embed"], x_j, cfg_j)
    got = TL.unembed(model.embed, x_t, cfg_t)
    assert got.shape[-1] == cfg_t.padded_vocab > cfg_t.vocab_size
    np.testing.assert_allclose(np_(got), np_(want), **TOL)


@pytest.mark.parametrize("paged", [False, True])
def test_attention_decode_step(paged):
    """One decode step of one layer: the new K/V land in the cache (in place
    in the port) and attention reads the cache, dense or through pages."""
    cfg_j, params, cfg_t, model = models()
    rng = np.random.RandomState(3)
    hkv, hd = cfg_j.n_kv_heads, cfg_j.resolved_head_dim
    x = rng.randn(B, 1, cfg_j.d_model).astype(np.float32)
    pos = np.array([5, 0, 11], np.int32)
    kc = rng.randn(B, hkv, MAX_LEN, hd).astype(np.float32)
    vc = rng.randn(B, hkv, MAX_LEN, hd).astype(np.float32)
    kw = dict(causal=False, kv_lens=pos + 1, q_offset=pos, cache_pos=pos)
    if paged:
        ps, n_pages = 4, MAX_LEN // 4
        table = (np.arange(B)[:, None] * n_pages
                 + np.arange(n_pages)[None]).astype(np.int32)
        to_pool = lambda c: c.reshape(B, hkv, n_pages, ps, hd).transpose(
            0, 2, 1, 3, 4).reshape(B * n_pages, hkv, ps, hd)
        kc, vc = to_pool(kc), to_pool(vc)
        cj = (jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(table))
        ct = (torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy()),
              torch.from_numpy(table))
    else:
        cj = (jnp.asarray(kc), jnp.asarray(vc))
        ct = (torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy()))
    out_j, new_j = JL.attention(_layer0(params)["attn"], jnp.asarray(x),
                                jnp.asarray(pos)[:, None], cfg_j, **{
                                    k: (jnp.asarray(v) if isinstance(v, np.ndarray)
                                        else v) for k, v in kw.items()},
                                cache=cj)
    out_t, new_t = TL.attention(model.blocks[0].attn, torch.from_numpy(x),
                                torch.from_numpy(pos)[:, None], cfg_t, **{
                                    k: (torch.from_numpy(v)
                                        if isinstance(v, np.ndarray) else v)
                                    for k, v in kw.items()}, cache=ct)
    np.testing.assert_allclose(np_(out_t), np_(out_j), **TOL)
    assert new_t[0] is ct[0]                       # written in place
    for a, b in zip(new_t, new_j):
        np.testing.assert_allclose(np_(a), np_(b), **TOL)


@pytest.mark.parametrize("over", [{}, {"parallel_block": True},
                                  {"local_window": 3},
                                  {"partial_rotary_factor": 1.0,
                                   "norm": "rmsnorm", "qk_norm": True},
                                  {"embed_scale": True, "tie_embeddings": True,
                                   "activation": "geglu"}],
                         ids=["stablelm", "parallel", "window", "full_rope",
                              "scaled_tied"])
def test_prefill_then_decode_dense_and_paged(over):
    cfg_j, params, cfg_t, model = models(**over)
    rng = np.random.RandomState(4)
    tokens, lens = _batch(rng, cfg_j)
    nxt = rng.randint(1, cfg_j.vocab_size, (B, 1))

    cache_j = jdense.make_cache(cfg_j, B, MAX_LEN)
    lj, cache_j = jdense.prefill(params, cfg_j, {"tokens": jnp.asarray(tokens),
                                                 "lens": jnp.asarray(lens)},
                                 cache_j)
    cache_t = tdense.make_cache(cfg_t, B, MAX_LEN, device="cpu")
    lt, cache_t = tdense.prefill(model, cfg_t, {"tokens": torch.from_numpy(tokens),
                                                "lens": torch.from_numpy(lens)},
                                 cache_t)
    np.testing.assert_allclose(np_(lt), np_(lj), **TOL)
    np.testing.assert_array_equal(np_(cache_t["pos"]), np_(cache_j["pos"]))
    for key in ("k", "v"):
        np.testing.assert_allclose(np_(cache_t[key]), np_(cache_j[key]), **TOL)

    paged_j = j_to_paged(cfg_j, cache_j, page_size=4)
    paged_t = to_paged(cfg_t, cache_t, page_size=4)
    np.testing.assert_array_equal(np_(paged_t["page_table"]),
                                  np_(paged_j["page_table"]))
    for key in ("k", "v"):
        np.testing.assert_array_equal(np_(paged_view(cfg_t, paged_t)[key]),
                                      np_(cache_t[key]))

    for cj, ct in ((cache_j, cache_t), (paged_j, paged_t)):
        lj, cj = jdense.decode(params, cfg_j, {"token": jnp.asarray(nxt)}, cj)
        lt, ct = tdense.decode(model, cfg_t, {"token": torch.from_numpy(nxt)}, ct)
        np.testing.assert_allclose(np_(lt), np_(lj), **TOL)
        np.testing.assert_array_equal(np_(ct["pos"]), np_(cj["pos"]))


def test_suffix_prefill_from_pos0():
    """A prefill of the prompt's suffix over a cache that already holds its
    prefix (per-row ``pos0``) gives the JAX logits and cache."""
    cfg_j, params, cfg_t, model = models()
    rng = np.random.RandomState(5)
    tokens, lens = _batch(rng, cfg_j)
    pos0 = np.array([3, 0, 5], np.int32)
    suffix = rng.randint(1, cfg_j.vocab_size, (B, 4))
    suf_lens = np.array([4, 2, 3], np.int32)
    cache_j = jdense.make_cache(cfg_j, B, MAX_LEN)
    cache_t = tdense.make_cache(cfg_t, B, MAX_LEN, device="cpu")
    _, cache_j = jdense.prefill(params, cfg_j, {"tokens": jnp.asarray(tokens),
                                                "lens": jnp.asarray(pos0)},
                                cache_j)
    _, cache_t = tdense.prefill(model, cfg_t, {"tokens": torch.from_numpy(tokens),
                                               "lens": torch.from_numpy(pos0)},
                                cache_t)
    lj, cache_j = jdense.prefill(params, cfg_j, {
        "tokens": jnp.asarray(suffix), "lens": jnp.asarray(suf_lens),
        "pos0": jnp.asarray(pos0)}, cache_j)
    lt, cache_t = tdense.prefill(model, cfg_t, {
        "tokens": torch.from_numpy(suffix), "lens": torch.from_numpy(suf_lens),
        "pos0": torch.from_numpy(pos0)}, cache_t)
    np.testing.assert_allclose(np_(lt), np_(lj), **TOL)
    np.testing.assert_array_equal(np_(cache_t["pos"]), np_(cache_j["pos"]))
    for key in ("k", "v"):
        np.testing.assert_allclose(np_(cache_t[key]), np_(cache_j[key]), **TOL)


@pytest.mark.parametrize("over", [{}, {"local_window": 3},
                                  {"local_window": 3, "local_global_period": 2}],
                         ids=["global", "local", "local_global"])
def test_layer_windows_and_cache_layouts(over):
    cfg_j, cfg_t = configs(n_layers=4, **over)
    np.testing.assert_array_equal(np_(tdense.layer_windows(cfg_t)),
                                  np_(jdense.layer_windows(cfg_j)))
    assert tdense.cache_batch_axes(cfg_t) == jdense.cache_batch_axes(cfg_j)
    assert tdense.paged_cache_spec(cfg_t) == jdense.paged_cache_spec(cfg_j)
    for make_t, make_j, kw in (
            (tdense.make_cache, jdense.make_cache, {}),
            (tdense.make_paged_cache, jdense.make_paged_cache,
             dict(page_size=4, pool_pages=9))):
        got = make_t(cfg_t, B, MAX_LEN - 1, device="cpu", **kw)
        want = make_j(cfg_j, B, MAX_LEN - 1, **kw)
        assert sorted(got) == sorted(want)
        for key in want:
            assert tuple(got[key].shape) == want[key].shape, key
            assert str(got[key].dtype).split(".")[-1] == str(want[key].dtype), key


@pytest.mark.parametrize("paged", [False, True])
def test_lane_movers_match_jax(paged):
    """gather_lanes / slot_update / merge_lanes move the same lane state as
    JAX on a dense and on a paged cache (pools pass through or are taken
    wholesale, never moved lane by lane)."""
    cfg_j, cfg_t = configs()
    rng = np.random.RandomState(6)
    cache_j = jdense.make_cache(cfg_j, B, MAX_LEN)
    cache = {k: rng.randn(*v.shape).astype(np.float32) if k != "pos"
             else rng.randint(0, MAX_LEN, v.shape).astype(np.int32)
             for k, v in cache_j.items()}
    if paged:
        cache = {k: np_(v) for k, v in j_to_paged(cfg_j, {
            k: jnp.asarray(v) for k, v in cache.items()}, page_size=4).items()}
    lanes = np.array([2, 0], np.int32)
    sub = {k: (v + 1 if v.dtype == np.float32 else v + 2)
           for k, v in cache.items()}
    sub = {k: (v if "_pages" in k else np.take(v, lanes, axis=1 if k in
                                                ("k", "v") else 0))
           for k, v in sub.items()}
    tj = lambda c: {k: jnp.asarray(v) for k, v in c.items()}
    tt = lambda c: {k: torch.from_numpy(v.copy()) for k, v in c.items()}
    for fn_t, fn_j, args in (
            (gather_lanes, j_gather_lanes, (lanes,)),
            (slot_update, j_slot_update, (lanes, sub)),
            (merge_lanes, j_merge_lanes, (lanes, sub))):
        want = fn_j(cfg_j, tj(cache), jnp.asarray(args[0]),
                    *[tj(a) for a in args[1:]])
        got = fn_t(cfg_t, tt(cache), torch.from_numpy(args[0]),
                   *[tt(a) for a in args[1:]])
        assert sorted(got) == sorted(want)
        for key in want:
            np.testing.assert_array_equal(np_(got[key]), np_(want[key]))
