"""Port parity: the encoder-decoder family (seamless-m4t) of ``repro_torch``
(weights carried across by ``from_jax_params``) against ``repro.models.encdec``
with its Pallas kernels in interpret mode — ``encode``, ``_cross_kv``, a
decoder block through the ``kv_x`` path and through the cross cache,
prefill and decode logits on the dense, paged and int8 caches (f32, atol =
rtol = 1e-4), and greedy ``generate`` tokens (the JAX engine on its plain
XLA path).  Inside the port, bit for bit: chunked prefill == the whole
prompt, the cached cross K/V == the ``kv_x`` path, paged decode == dense
decode, and a narrowed burst == a full one.  The scheduler against the JAX
scheduler on an encdec trace (ragged encoder inputs, paged cache, chunked
prefill, compaction): byte-for-byte tokens and equal stats; within the
port fused == unfused and overlap == non-overlap.

The twin is the reference's tiny encdec config (``test_paged_cache``: 2
encoder and 2 decoder layers, d 64) with seamless' layernorm, gelu MLP and
biases."""

import functools

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np
from torch_parity import (TOL, assert_same_results, models, np_,
                          plain_models, sched_trace)

from repro.models import encdec as jenc
from repro.models import to_paged as j_to_paged
from repro.serve import ContinuousBatchingScheduler as JaxScheduler
from repro.serve import ServeEngine as JaxEngine
from repro_torch.models import encdec as tenc
from repro_torch.models import to_paged
from repro_torch.serve import ContinuousBatchingScheduler, ServeEngine

ENC = dict(family="encdec", n_enc_layers=2, n_dec_layers=2, use_bias=True,
           activation="gelu", partial_rotary_factor=1.0)
LENS = np.array([9, 3, 6], np.int32)
SRC_LENS = np.array([7, 2, 5], np.int32)
S_SRC, MAX_NEW, MAX_LEN = 7, 6, 16


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _twins():
    return models(0, **ENC)


def _batch(cfg, seed=0):
    rng = np.random.RandomState(seed)
    return {"tokens": rng.randint(1, cfg.vocab_size, (3, int(LENS.max()))),
            "lens": LENS,
            "src_emb": rng.randn(3, S_SRC, cfg.d_model).astype(np.float32),
            "src_lens": SRC_LENS}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _close(got, want):
    np.testing.assert_allclose(np_(got), np_(want), **TOL)


def _memory(cfg, seed=3):
    return np.random.RandomState(seed).randn(3, S_SRC, cfg.d_model).astype(
        np.float32)


def test_encode_matches_jax():
    cfg_j, params, cfg_t, model = _twins()
    src = _memory(cfg_j)
    want = jenc.encode(params, cfg_j, jnp.asarray(src), jnp.asarray(SRC_LENS))
    got = tenc.encode(model, cfg_t, torch.from_numpy(src),
                      torch.from_numpy(SRC_LENS))
    _close(got, want)


def test_cross_kv_matches_jax():
    cfg_j, params, cfg_t, model = _twins()
    mem = _memory(cfg_j)
    p1 = jax.tree.map(lambda a: a[1], params["dec_blocks"])["cross_attn"]
    for got, want in zip(
            tenc._cross_kv(model.dec_blocks[1].cross_attn, torch.from_numpy(mem),
                           cfg_t),
            jenc._cross_kv(p1, jnp.asarray(mem), cfg_j)):
        _close(got, want)


@pytest.mark.parametrize("cross_cache", [False, True])
def test_decoder_block_matches_jax(cross_cache):
    """One decoder block over a cache, cross-attending the memory through
    the kv_x path or through its cached cross K/V."""
    cfg_j, params, cfg_t, model = _twins()
    rng = np.random.RandomState(4)
    b, s = 3, 5
    x = rng.randn(b, s, cfg_j.d_model).astype(np.float32)
    mem = _memory(cfg_j)
    pos = np.arange(s, dtype=np.int32)[None].repeat(b, 0)
    shp = (b, cfg_j.n_kv_heads, 8, cfg_j.resolved_head_dim)
    p0 = jax.tree.map(lambda a: a[0], params["dec_blocks"])
    blk = model.dec_blocks[0]
    kw_j, kw_t = {}, {}
    if cross_cache:
        kw_j["cross_cache"] = jenc._cross_kv(p0["cross_attn"], jnp.asarray(mem),
                                             cfg_j)
        kw_t["cross_cache"] = tenc._cross_kv(blk.cross_attn,
                                             torch.from_numpy(mem), cfg_t)
    lens = np.array([5, 2, 4], np.int32)
    out_j, (kc_j, _) = jenc._dec_block_apply(
        p0, jnp.asarray(x), jnp.asarray(pos), cfg_j,
        None if cross_cache else jnp.asarray(mem),
        src_lens=jnp.asarray(SRC_LENS), kv_lens=jnp.asarray(lens),
        q_offset=jnp.zeros((b,), jnp.int32),
        cache=(jnp.zeros(shp), jnp.zeros(shp)),
        cache_pos=jnp.zeros((b,), jnp.int32), **kw_j)
    kc, vc = torch.zeros(shp), torch.zeros(shp)
    out_t, _ = tenc._dec_block_apply(
        blk, torch.from_numpy(x), torch.from_numpy(pos), cfg_t,
        None if cross_cache else torch.from_numpy(mem),
        src_lens=torch.from_numpy(SRC_LENS), kv_lens=torch.from_numpy(lens),
        q_offset=torch.zeros(b, dtype=torch.int32), cache=(kc, vc),
        cache_pos=torch.zeros(b, dtype=torch.int32), **kw_t)
    _close(out_t, out_j)
    _close(kc, kc_j)


@functools.lru_cache(maxsize=None)
def _prefill_cached():
    cfg_j, params, cfg_t, model = _twins()
    batch = _batch(cfg_j)
    cj = jenc.make_cache(cfg_j, 3, MAX_LEN, S_SRC)
    lj, cj = jenc.prefill(params, cfg_j, _j(batch), cj)
    ct = tenc.make_cache(cfg_t, 3, MAX_LEN, S_SRC, device="cpu")
    lt, ct = tenc.prefill(model, cfg_t, _t(batch), ct)
    return (cfg_j, params, lj, cj), (cfg_t, model, lt, ct)


@pytest.mark.parametrize("layout", ["dense", "paged", "int8"])
def test_prefill_and_decode_match_jax(layout):
    """Prefill logits and caches, then 3 teacher-forced decode steps on the
    dense cache, the paged one and int8 pages (quantized from JAX's cache
    on both sides: 1e-6 apart, two caches may round a K/V element to
    neighbouring int8 codes)."""
    (cfg_j, params, lj, cj), (cfg_t, model, lt, ct) = _prefill_cached()
    _close(lt, lj)
    for key in ("k", "cross_k", "cross_v", "src_lens", "pos"):
        _close(ct[key], cj[key])
    ct = {k: (torch.from_numpy(np.array(cj[k])) if layout == "int8"
              else v.clone()) for k, v in ct.items()}
    if layout != "dense":
        dt = None if layout == "paged" else layout
        cj = j_to_paged(cfg_j, cj, page_size=4, page_dtype=dt)
        ct = to_paged(cfg_t, ct, page_size=4, page_dtype=dt)
    tok = np_(lj).argmax(-1)[:, None].astype(np.int32)
    for _ in range(3):
        lj, cj = jenc.decode(params, cfg_j, {"token": jnp.asarray(tok)}, cj)
        lt, ct = tenc.decode(model, cfg_t, {"token": torch.from_numpy(tok)}, ct)
        _close(lt, lj)
        tok = np_(lj).argmax(-1)[:, None].astype(np.int32)


@pytest.mark.parametrize("page_size,page_dtype",
                         [(None, None), (4, None), (4, "int8")])
def test_generate_matches_jax(page_size, page_dtype):
    cfg_j, params, cfg_t, model = plain_models(0, **ENC)
    batch = _batch(cfg_j, seed=1)
    kw = dict(max_new_tokens=MAX_NEW, stop_token=-1, page_dtype=page_dtype)
    rj = JaxEngine(cfg_j, params, **kw).generate(_j(batch), page_size=page_size)
    rt = ServeEngine(cfg_t, model, device="cpu", **kw).generate(
        batch, page_size=page_size)
    assert np_(rt["tokens"]).tobytes() == np_(rj["tokens"]).tobytes()
    np.testing.assert_array_equal(np_(rt["n_generated"]), np_(rj["n_generated"]))


# ---------------------------------------------------------------------------
# within the port, bit for bit
# ---------------------------------------------------------------------------

def _prefill(cfg, model, batch, cache):
    return tenc.prefill(model, cfg, _t(batch), cache)


def test_chunked_prefill_equals_whole_prompt():
    """A prompt prefilled in chunks (the first with the encoder input, the
    rest reading the cached cross K/V) gives the whole prompt's logits and
    cache, bit for bit."""
    _, _, cfg, model = _twins()
    b = _batch(cfg, seed=5)
    row = {"tokens": b["tokens"][:1], "src_emb": b["src_emb"][:1],
           "src_lens": b["src_lens"][:1]}
    whole_l, whole = _prefill(cfg, model, row,
                              tenc.make_cache(cfg, 1, MAX_LEN, S_SRC, device="cpu"))
    cache = tenc.make_cache(cfg, 1, MAX_LEN, S_SRC, device="cpu")
    n, start = row["tokens"].shape[1], 0
    for i, m in enumerate((4, 2, 3)):
        toks = np.zeros((1, 4), np.int64)
        toks[0, :m] = row["tokens"][0, start:start + m]
        chunk = {"tokens": toks, "lens": np.array([m]), "pos0": np.array([start])}
        if i == 0:
            chunk.update(src_emb=row["src_emb"], src_lens=row["src_lens"])
        logits, cache = _prefill(cfg, model, chunk, cache)
        start += m
    assert start == n
    assert torch.equal(logits, whole_l)
    for key in ("cross_k", "cross_v", "src_lens", "pos"):
        assert torch.equal(cache[key], whole[key]), key
    assert torch.equal(cache["k"][:, :, :, :n], whole["k"][:, :, :, :n])


def test_cached_cross_kv_equals_kv_x_path():
    """Cross-attention through the cached K/V gives the ``kv_x`` path's
    bits."""
    _, _, cfg, model = _twins()
    rng = np.random.RandomState(6)
    hx = torch.from_numpy(rng.randn(3, 4, cfg.d_model).astype(np.float32))
    mem = torch.from_numpy(_memory(cfg, seed=7))
    src_lens = torch.from_numpy(SRC_LENS)
    p = model.dec_blocks[1].cross_attn
    pos = torch.zeros((3, 4), dtype=torch.int32)
    via_x, _ = tenc.L.attention(p, hx, pos, cfg, kv_x=mem, causal=False,
                                kv_lens=src_lens, use_rope=False)
    via_cache = tenc._cross_from_cache(p, hx, cfg, *tenc._cross_kv(p, mem, cfg),
                                       src_lens, False)
    assert torch.equal(via_x, via_cache)


def test_paged_decode_equals_dense_and_narrowed_burst_equals_full():
    """Paged decode's logits equal the dense cache's bit for bit; a burst
    narrowed to the first two lanes gives those lanes the full burst's
    tokens, cache rows and state."""
    _, _, cfg, model, = _twins()
    *_, (_, _, lt, ct) = _prefill_cached()
    dense = {k: v.clone() for k, v in ct.items()}
    paged = to_paged(cfg, {k: v.clone() for k, v in ct.items()}, page_size=4)
    tok = lt.argmax(-1).to(torch.int32)[:, None]
    for _ in range(3):
        ld, dense = tenc.decode(model, cfg, {"token": tok}, dense)
        lp, paged = tenc.decode(model, cfg, {"token": tok}, paged)
        assert torch.equal(ld, lp)
        tok = ld.argmax(-1).to(torch.int32)[:, None]
    eng = ServeEngine(cfg, model, max_new_tokens=MAX_NEW, stop_token=-1,
                      device="cpu")
    batch = _batch(cfg, seed=8)
    full = eng._start(batch)
    (cache, out, tok, p, n_gen, budget, sstate, _) = full
    clone = lambda d: {k: v.clone() for k, v in d.items()}
    a = eng._burst(clone(cache), out.clone(), tok, p, n_gen, budget, sstate,
                   n_steps=4, stochastic=False)
    b = eng._burst(clone(cache), out.clone(), tok, p, n_gen, budget, sstate,
                   n_steps=4, stochastic=False, width=2)
    assert torch.equal(a[1][:2], b[1][:2]) and torch.equal(a[2][:2], b[2][:2])
    for key, ax in tenc.cache_batch_axes(cfg).items():
        assert torch.equal(a[0][key].narrow(ax, 0, 2),
                           b[0][key].narrow(ax, 0, 2)), key


# ---------------------------------------------------------------------------
# the scheduler
# ---------------------------------------------------------------------------

SRC_LEN, CAP = 10, 4


def _trace():
    """A ragged encdec trace: prompts 3-13 tokens, encoder inputs of 2-10
    frames, budgets 3-7, staggered arrivals, every third request sampled."""
    rng = np.random.RandomState(22)
    out = []
    for arrival, prompt, max_new in sched_trace(rng, 10):
        sl = int(rng.randint(2, SRC_LEN + 1))
        out.append((arrival, prompt, max_new,
                    rng.randn(sl, 64).astype(np.float32)))
    return out


def _serve(sched_cls, samp_cls, eng, trace, **kw):
    sched = sched_cls(eng, capacity=CAP, max_len=24, chunk=4,
                      compact_threshold=0.5, src_len=SRC_LEN, **kw)
    for rid, (arrival, prompt, max_new, src) in enumerate(trace):
        sp = (samp_cls(temperature=0.8, top_p=0.9, seed=rid, greedy=False)
              if rid % 3 == 0 else None)
        sched.submit(prompt, arrival=arrival, max_new_tokens=max_new,
                     sampling=sp, extras={"src_emb": src})
    results = sched.run()
    stats = {k: (list(v) if isinstance(v, list) else v)
             for k, v in sched.stats.items()}
    return results, stats


PAGED = dict(page_size=4, prefill_chunk=4)


@pytest.fixture(scope="module")
def jax_encdec_run():
    from repro.sample import SamplingParams as JS
    cfg_j, params, _, _ = plain_models(0, **ENC)
    eng = JaxEngine(cfg_j, params, max_new_tokens=8, stop_token=0)
    return _serve(JaxScheduler, JS, eng, _trace(), **PAGED)


def _torch_engine():
    _, _, cfg_t, model = plain_models(0, **ENC)
    return ServeEngine(cfg_t, model, max_new_tokens=8, stop_token=0,
                       device="cpu")


def test_scheduler_matches_jax(jax_encdec_run):
    """Paged cache, chunked prefill, compaction: byte-for-byte tokens and
    equal stats."""
    from repro_torch.sample import SamplingParams as TS
    res_j, st_j = jax_encdec_run
    res_t, st_t = _serve(ContinuousBatchingScheduler, TS, _torch_engine(),
                         _trace(), **PAGED)
    assert_same_results(res_t, res_j)
    assert st_t["prefill_chunks"] > 0 and st_t["compactions"] > 0
    for k, v in st_j.items():
        if k in st_t:
            assert st_t[k] == v, k


@pytest.mark.parametrize("kw", [dict(fused=False), dict(overlap=True)])
def test_scheduler_fused_and_overlap_equal_plain(kw):
    """Within the port: unfused and overlapped serving give the fused,
    synchronous run's tokens."""
    from repro_torch.sample import SamplingParams as TS
    eng = _torch_engine()
    trace = _trace()[:6]
    base, _ = _serve(ContinuousBatchingScheduler, TS, eng, trace, **PAGED)
    got, _ = _serve(ContinuousBatchingScheduler, TS, eng, trace, **PAGED, **kw)
    assert_same_results(got, base)

