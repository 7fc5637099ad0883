"""Port parity of ``repro_torch.serve.engine``'s burst, movers and fused
step against the JAX engine's own methods (its Pallas kernels in interpret
mode), on the tiny f32 twins of ``torch_parity`` (dense, moe, ssm, hybrid).

Each case starts from one state made on the JAX side (prefill, then the
paged layout) and copied into the port byte for byte, so a difference can
come only from the method under test.  Held exactly: tokens, ``n_gen``,
``p``, ``tok``, ``pos``, ``steps_run``, page tables and the sampler keys;
K/V below each lane's position within 1e-5 (the widened values of int8 /
fp8 pools too), the SSM conv taps within 1e-5 and state within 1e-4.  The
port's own invariants are held exactly: two bursts equal one, a narrowed
burst equals the full-width one on its lanes, spill/resume equals an
uninterrupted run, and page blocks round-trip bit for bit.
"""

import functools

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np
from torch_parity import FAMILY, models, np_

from repro import sample as SJ
from repro.models import get_model as j_get_model
from repro.models import paged_view as j_paged_view
from repro.models import slot_update as j_slot_update
from repro.models import to_paged as j_to_paged
from repro.serve import ServeEngine as JaxEngine
from repro_torch import sample as ST
from repro_torch.models import get_model, paged_view, slot_update
from repro_torch.serve import ServeEngine

B, PROMPT, MAX_LEN, PS, MAX_OUT = 4, 7, 16, 4, 12
LENS = np.array([7, 3, 5, 2], np.int32)
POOL = B * (MAX_LEN // PS) + 2          # the identity layout, a free page and
TRASH = POOL - 1                        # the trash page
PAGE_DTYPES = {"paged": None, "int8": "int8", "fp8": "fp8"}


def _models(family):
    return models() if family == "dense" else models(**FAMILY[family])


# ---------------------------------------------------------------------------
# moving state between the packages
# ---------------------------------------------------------------------------

def to_t(x):
    """numpy copy of a JAX array as a CPU tensor (fp8 by its bytes, JAX's
    uint32 keys as the port's int64 words)."""
    a = np.asarray(x)
    if a.dtype.name == "float8_e4m3fn":
        return torch.from_numpy(a.view(np.uint8).copy()).view(torch.float8_e4m3fn)
    if a.dtype == np.uint32:
        a = a.astype(np.int64)
    return torch.from_numpy(a.copy())


def to_j(t):
    """A port tensor as a JAX array (the inverse of ``to_t``)."""
    if t.dtype == torch.float8_e4m3fn:
        return jnp.asarray(np_(t.view(torch.uint8)).view(jnp.float8_e4m3fn))
    a = np_(t)
    return jnp.asarray(a.astype(np.uint32) if a.dtype == np.int64 else a)


def tree_j(d):
    return {k: tree_j(v) if isinstance(v, dict) else to_j(v) for k, v in d.items()}


def tree_t(d):
    return {k: tree_t(v) if isinstance(v, dict) else to_t(v) for k, v in d.items()}


def np_bytes(x):
    """numpy copy of a tensor or JAX array, fp8 as its bytes."""
    if torch.is_tensor(x) and x.dtype == torch.float8_e4m3fn:
        x = x.view(torch.uint8)
    a = np_(x)
    return a.view(np.uint8) if a.dtype.name == "float8_e4m3fn" else a


@functools.lru_cache(maxsize=None)
def _prefilled(family):
    """The JAX side's prefilled dense cache and first tokens (greedy) for
    the shared prompts."""
    cfg_j, params, _, _ = _models(family)
    rng = np.random.RandomState(0)
    toks = rng.randint(1, cfg_j.vocab_size, (B, PROMPT)).astype(np.int32)
    eng = _engines(family, -999, None)[0]
    batch = {"tokens": jnp.asarray(toks), "lens": jnp.asarray(LENS)}
    logits, cache = eng._prefill(params, batch, eng.make_cache(B, MAX_LEN, batch))
    first = np.asarray(jnp.argmax(logits, -1)).astype(np.int32)
    return jax.tree.map(np.asarray, cache), first


def _state(family, layout):
    """(JAX cache, port cache, first tokens) for ``layout`` None (dense) or
    a key of ``PAGE_DTYPES``."""
    cfg_j = _models(family)[0]
    cache, first = _prefilled(family)
    cache = {k: jnp.asarray(v) for k, v in cache.items()}
    if layout is not None:
        cache = j_to_paged(cfg_j, cache, page_size=PS, pool_pages=POOL,
                           page_dtype=PAGE_DTYPES[layout])
    return cache, tree_t(cache), first


SPECS = [dict(temperature=0.8, top_k=10, top_p=0.9, seed=5, greedy=False),
         None,
         dict(temperature=1.1, min_p=0.05, repetition_penalty=1.2, seed=7,
              greedy=False),
         None]


def _lane_states(stochastic):
    if not stochastic:
        return SJ.greedy_state(B), ST.greedy_state(B, device="cpu")
    sj = SJ.lane_state([s and SJ.SamplingParams(**s) for s in SPECS], B)
    st = ST.lane_state([s and ST.SamplingParams(**s) for s in SPECS], B,
                       device="cpu")
    np.testing.assert_array_equal(np_(st["key"]), to_t(sj["key"]).numpy())
    return sj, st


@functools.lru_cache(maxsize=None)
def _engines(family, stop, layout):
    """(JAX engine, port engine on the CPU), shared by the cases of one
    family, stop token and layout, so that they share the JAX programs."""
    cfg_j, params, cfg_t, model = _models(family)
    dt = PAGE_DTYPES.get(layout)
    return (JaxEngine(cfg_j, params, stop_token=stop, page_dtype=dt),
            ServeEngine(cfg_t, model, stop_token=stop, page_dtype=dt,
                        device="cpu"))


def _close(got, want, tol):
    np.testing.assert_allclose(np_(got).astype(np.float64),
                               np.asarray(want).astype(np.float64),
                               atol=tol, rtol=tol)


def _kv_views(cfg_j, cfg_t, cache_j, cache_t):
    """{key: (port, JAX)} dense logical K/V views (widened when quantized)."""
    if "page_table" in cache_j:
        vj, vt = j_paged_view(cfg_j, cache_j), paged_view(cfg_t, cache_t)
    else:
        vj, vt = cache_j, cache_t
    return {k: (vt[k], vj[k]) for k in vj
            if k in ("k", "v", "shared_k", "shared_v")}


def _held_caches(cfg_j, cfg_t, cache_j, cache_t):
    """pos and page tables exactly; K/V below each lane's pos within 1e-5;
    SSM conv taps within 1e-5 and state within 1e-4."""
    pos = np.asarray(cache_j["pos"])
    np.testing.assert_array_equal(np_(cache_t["pos"]), pos)
    if "page_table" in cache_j:
        np.testing.assert_array_equal(np_(cache_t["page_table"]),
                                      np.asarray(cache_j["page_table"]))
    for key, (t, j) in _kv_views(cfg_j, cfg_t, cache_j, cache_t).items():
        t, j = np_(t), np.asarray(j)               # lead+(B,Hkv,S,D)
        ax = t.ndim - 4
        for b in range(B):
            sel = (slice(None),) * ax + (b, slice(None), slice(0, pos[b]))
            _close(t[sel], j[sel], 1e-5)
    for key in ("conv", "tail_conv"):
        if key in cache_j:
            _close(cache_t[key], cache_j[key], 1e-5)
    for key in ("state", "tail_state"):
        if key in cache_j:
            _close(cache_t[key], cache_j[key], 1e-4)


def _burst_inputs(first, budgets, p_lanes=None):
    out = np.zeros((B, MAX_OUT), np.int32)
    out[:, 0] = first
    p = np.ones((B,), bool) if p_lanes is None else np.asarray(p_lanes)
    return dict(out_buf=out, tok=first.copy(), p=p & (np.asarray(budgets) > 1),
                n_gen=np.ones((B,), np.int32),
                lane_budget=np.asarray(budgets, np.int32))


def _run_t(eng, cache, x, sstate, **kw):
    return eng._decode_chunk({k: v.clone() for k, v in cache.items()},
                             *(torch.from_numpy(x[k].copy()) for k in
                               ("out_buf", "tok", "p", "n_gen", "lane_budget")),
                             {k: v.clone() for k, v in sstate.items()}, **kw)


def _run_j(eng, cache, x, sstate, **kw):
    return eng._decode_chunk(eng.params, cache,
                             *(jnp.asarray(x[k]) for k in
                               ("out_buf", "tok", "p", "n_gen", "lane_budget")),
                             {k: jnp.asarray(v) for k, v in sstate.items()}, **kw)


# ---------------------------------------------------------------------------
# 0. the lane splices drop lanes past the last, as JAX's scatters do
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family,layout", [
    ("dense", None), ("dense", "paged"), ("moe", None), ("ssm", None),
    ("hybrid", None), ("hybrid", "int8")])
def test_slot_update_drops_padded_rows_like_jax(family, layout):
    """Admission rows padded to lane ``B`` (twice, as the scheduler pads)
    write nothing; the real row lands: the same bytes as JAX's."""
    cfg_j, _, cfg_t, _ = _models(family)
    cache_j, cache_t, _ = _state(family, layout)
    rng = np.random.RandomState(1)
    lanes = np.array([2, B, B], np.int32)
    sub = {}
    axes = dict(j_get_model(cfg_j).cache_batch_axes(cfg_j), page_table=0)
    for k, v in cache_j.items():
        if k not in axes:
            continue                           # page pools: no lane axis
        ax = axes[k]
        shape = list(v.shape)
        shape[ax] = len(lanes)
        sub[k] = rng.randint(1, 50, shape).astype(np.asarray(v).dtype)
    want = j_slot_update(cfg_j, cache_j, jnp.asarray(lanes),
                         {k: jnp.asarray(v) for k, v in sub.items()})
    got = slot_update(cfg_t, cache_t, torch.from_numpy(lanes), tree_t(sub))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(np_bytes(got[k]), np_bytes(to_t(want[k])))
    assert not np.array_equal(np_(got["pos"]), np_(cache_t["pos"]))


def test_sampler_slot_update_drops_padded_rows_like_jax():
    sj, st = _lane_states(True)
    subj = SJ.lane_state([SJ.SamplingParams(temperature=0.3, seed=9,
                                            greedy=False)] * 3, 3)
    subt = ST.lane_state([ST.SamplingParams(temperature=0.3, seed=9,
                                            greedy=False)] * 3, 3, device="cpu")
    lanes = np.array([1, B, B], np.int32)
    want = SJ.slot_update(sj, jnp.asarray(lanes), subj)
    got = ST.slot_update(st, torch.from_numpy(lanes), subt)
    for k in want:
        np.testing.assert_array_equal(np_(got[k]), to_t(want[k]).numpy())


# ---------------------------------------------------------------------------
# 1. the burst against JAX's _decode_chunk
# ---------------------------------------------------------------------------

# (family, layout, stochastic, n_steps, width, dies): with ``dies`` every
# lane is dead by step 4 of an 8-step burst: "token" sets budgets and a stop
# token that lane 1 emits; "oov" budgets only, under the stop token -1,
# which retired lanes then carry and embed (the row JAX's take reads: -1
# wraps; the rows their K/V below pos come from)
BURSTS = [
    ("dense", "paged", True, 3, 2, None),
    ("dense", "int8", False, 8, None, "token"),
    ("dense", None, True, 8, None, "token"),
    ("dense", None, False, 8, None, "oov"),
    ("moe", "paged", True, 8, None, "token"),
    ("ssm", None, True, 3, 2, None),
    ("ssm", None, False, 8, None, "token"),
    ("hybrid", "paged", False, 3, 2, None),
    ("hybrid", "fp8", True, 8, None, "token"),
]


@pytest.mark.parametrize("family,layout,stochastic,n_steps,width,dies", BURSTS)
def test_decode_chunk_matches_jax(family, layout, stochastic, n_steps, width,
                                  dies):
    cfg_j, _, cfg_t, _ = _models(family)
    cache_j, cache_t, first = _state(family, layout)
    sj, st = _lane_states(stochastic)
    kw = dict(n_steps=n_steps, stochastic=stochastic, width=width)
    stop = -999
    budgets = [MAX_OUT] * B
    p_lanes = None if width is None else [True] * width + [False] * (B - width)
    if dies == "token":
        # lane 1 stops on the token it emits at its second step; the others
        # run out of budget after 1, 3 and 4 steps
        probe = _engines(family, stop, layout)[1]
        toks = _run_t(probe, cache_t, _burst_inputs(first, budgets), st,
                      **dict(kw, n_steps=3))[1]
        stop = int(toks[1, 2])
        budgets = [2, MAX_OUT, 4, 5]
    elif dies == "oov":
        stop, budgets = -1, [2, 3, 4, 5]
    x = _burst_inputs(first, budgets, p_lanes)
    eng_j, eng_t = _engines(family, stop, layout)
    (cj, oj, tj, pj, nj, sj2, stj) = _run_j(eng_j, cache_j, x, sj, **kw)
    (ct, ot, tt, pt, nt, st2, stt) = _run_t(eng_t, cache_t, x, st, **kw)
    np.testing.assert_array_equal(np_(ot), np.asarray(oj))
    np.testing.assert_array_equal(np_(tt), np.asarray(tj))
    np.testing.assert_array_equal(np_(pt), np.asarray(pj))
    np.testing.assert_array_equal(np_(nt), np.asarray(nj))
    assert stt.dtype == torch.int32 and stt.dim() == 0
    assert int(stt) == int(stj)
    for k in sj2:
        np.testing.assert_array_equal(np_(st2[k]), to_t(sj2[k]).numpy())
    _held_caches(cfg_j, cfg_t, cj, ct)
    if dies:
        assert int(stt) == 4 and not np_(pt).any()
        # lane 3 ran out of budget in the last live step: the gated steps
        # after it keep its last real token (what generate's active reads)
        assert int(nt[3]) == 5 and int(tt[3]) == int(ot[3, 4]) != stop
    else:
        assert int(stt) == n_steps
    if dies == "oov":
        # lanes 0-2 retired before the last live step, which gave them the
        # stop token; the live steps after lane 0's retirement embedded it
        assert (np_(tt)[:3] == -1).all()


# ---------------------------------------------------------------------------
# 2. the burst's own invariants, exact
# ---------------------------------------------------------------------------

def _equal_carry(cfg_t, a, b, lanes=slice(None)):
    """Two bursts' carries (cache, out_buf, tok, p, n_gen, sstate, ...)
    equal bit for bit on ``lanes``: the paged K/V through the page tables."""
    axes = dict(get_model(cfg_t).cache_batch_axes(cfg_t), page_table=0)
    (ca, *ra), (cb, *rb) = a, b
    for x, y in zip(ra[:4], rb[:4]):          # out_buf, tok, p, n_gen
        np.testing.assert_array_equal(np_(x)[lanes], np_(y)[lanes])
    for k in ra[4]:                           # sampler state
        np.testing.assert_array_equal(np_(ra[4][k])[lanes], np_(rb[4][k])[lanes])
    assert sorted(ca) == sorted(cb)
    views = ((paged_view(cfg_t, ca), paged_view(cfg_t, cb))
             if "page_table" in ca else ({}, {}))
    for k in list(ca) + list(views[0]):
        if k not in axes:
            continue                           # pools: through the views
        x, y = (views[0][k], views[1][k]) if k in views[0] else (ca[k], cb[k])
        sel = (slice(None),) * axes[k] + (lanes,)
        np.testing.assert_array_equal(np_(x)[sel], np_(y)[sel])


@pytest.mark.parametrize("family,layout", [("dense", "paged"), ("ssm", None),
                                           ("hybrid", None), ("moe", "int8")])
def test_two_bursts_equal_one_and_narrowing_is_exact(family, layout):
    cfg_t = _models(family)[2]
    _, cache_t, first = _state(family, layout)
    _, st = _lane_states(True)
    eng = _engines(family, -999, layout)[1]
    x = _burst_inputs(first, [MAX_OUT] * B)
    one = _run_t(eng, cache_t, x, st, n_steps=6, stochastic=True)
    half = _run_t(eng, cache_t, x, st, n_steps=3, stochastic=True)
    c, o, t, p, n, s, _ = half
    two = eng._decode_chunk(c, o, t, p, n, torch.from_numpy(x["lane_budget"]),
                            s, n_steps=3, stochastic=True)
    _equal_carry(cfg_t, one, two)
    if family == "moe":
        return                                 # moe decode couples lanes
    x = _burst_inputs(first, [MAX_OUT] * B, [True, True, False, False])
    full = _run_t(eng, cache_t, x, st, n_steps=3, stochastic=True)
    narrow = _run_t(eng, cache_t, x, st, n_steps=3, stochastic=True, width=2)
    _equal_carry(cfg_t, full, narrow, slice(0, 2))
    for k in ("tok", "n_gen"):                 # lanes past the width untouched
        np.testing.assert_array_equal(np_(narrow[2 if k == "tok" else 4])[2:],
                                      x[k][2:])


# ---------------------------------------------------------------------------
# 3. the page and lane movers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family,layout", [("dense", "paged"), ("dense", "int8"),
                                           ("hybrid", "fp8")])
def test_gather_scatter_blocks_round_trip_and_match_jax(family, layout):
    """Pages gathered, clobbered and scattered back (a padded entry aimed at
    the trash page): the blocks and the pools equal JAX's, bit for bit, and
    every gathered page holds its bytes from before."""
    cfg_j, _, cfg_t, _ = _models(family)
    cache_j, cache_t, _ = _state(family, layout)
    eng_j, eng_t = _engines(family, -999, layout)
    pids = np.array([5, 0, 9, 2], np.int32)
    want = eng_j._gather_blocks(cache_j, jnp.asarray(pids))
    got = eng_t._gather_blocks(cache_t, torch.from_numpy(pids))
    assert sorted(got) == sorted(want) and any(k.endswith("_pages") for k in got)
    assert ("_scale" in " ".join(got)) == (layout != "paged")
    for k in want:
        np.testing.assert_array_equal(np_bytes(got[k]), np_bytes(to_t(want[k])))
    # clobber the pages, scatter the blocks back (a padded entry aims at the
    # trash page): every other page's bytes are as before
    before = {k: v.clone() for k, v in cache_t.items()}
    for k, v in cache_t.items():
        if k.endswith("_pages") or k.endswith("_pages_scale"):
            v.view(torch.uint8 if v.element_size() == 1 else v.dtype)[..., :] = 7
    ids = torch.from_numpy(np.append(pids, TRASH).astype(np.int32))
    blocks = {k: torch.cat([v, v[:1]]) for k, v in got.items()}
    want = eng_j._scatter_blocks(tree_j(cache_t), to_j(ids), tree_j(blocks))
    eng_t._scatter_blocks(cache_t, ids, blocks)
    for k in want:
        np.testing.assert_array_equal(np_bytes(cache_t[k]), np_bytes(to_t(want[k])))
    for k in got:
        lead = cache_t[k].dim() - (4 if k.endswith("_pages") else 3)
        sel = (slice(None),) * lead + (torch.from_numpy(pids).long(),)
        np.testing.assert_array_equal(np_bytes(cache_t[k][sel]),
                                      np_bytes(before[k][sel]))


@pytest.mark.parametrize("family,layout", [("dense", "paged"), ("hybrid", None)])
def test_spill_clobber_resume_equals_uninterrupted(family, layout):
    """Burst, spill lane 1 (carries, rows, sampler row, page blocks), clobber
    its pages, run a burst with the lane out, page it back in and resume:
    after one more burst the lane's carry equals the uninterrupted run's
    after two.  The spill equals JAX's ``_spill_lane`` on the same
    state, and the resume JAX's ``_resume_lane``."""
    cfg_j, _, cfg_t, _ = _models(family)
    _, cache_t, first = _state(family, layout)
    _, st = _lane_states(True)
    eng_j, eng = _engines(family, -999, layout)
    x = _burst_inputs(first, [MAX_OUT] * B)
    budget = torch.from_numpy(x["lane_budget"])
    run = lambda c, o, t, p, n, s: eng._decode_chunk(
        c, o, t, p, n, budget, s, n_steps=3, stochastic=True)[:6]
    ref = run(*_run_t(eng, cache_t, x, st, n_steps=3, stochastic=True)[:6])

    c, o, t, p, n, s = _run_t(eng, cache_t, x, st, n_steps=3,
                              stochastic=True)[:6]
    dense, row, srow = eng._spill_lane(c, o, t, n, budget, s, 1)
    want = eng_j._spill_lane(tree_j(c), to_j(o), to_j(t), to_j(n), to_j(budget),
                             tree_j(s), 1)
    for got_d, want_d in zip((dense, row, srow), want):
        assert sorted(got_d) == sorted(want_d)
        for k in want_d:
            np.testing.assert_array_equal(np_bytes(got_d[k]),
                                          np_bytes(to_t(want_d[k])))
    table = c["page_table"][1].clone() if "page_table" in c else None
    blocks = eng._gather_blocks(c, table) if table is not None else {}
    for k in blocks:                           # clobber the lane's pages
        lead = c[k].dim() - (4 if k.endswith("_pages") else 3)
        c[k][(slice(None),) * lead + (table.long(),)] = 3
    p = p.clone()
    p[1] = False
    c, o, t, p, n, s = run(c, o, t, p, n, s)
    if blocks:
        eng._scatter_blocks(c, table, blocks)
    args = (o, t, p, n, budget, s, 1, dense, row, srow, table)
    got = eng._resume_lane(c, *args)
    want = eng_j._resume_lane(tree_j(c), *(to_j(a) for a in args[:5]),
                              tree_j(s), 1, tree_j(dense), tree_j(row),
                              tree_j(srow),
                              None if table is None else to_j(table))
    _held_live(cfg_j, cfg_t, got, want)
    c, o, t, p, n, _, s = got
    lane1 = run(c, o, t, p, n, s)
    _equal_carry(cfg_t, ref + (None,), lane1 + (None,), slice(1, 2))


# ---------------------------------------------------------------------------
# 4. admission and the fused step
# ---------------------------------------------------------------------------

def _admission(family, seeded):
    """A scheduler-shaped admission of one request into lane 2 (its pages
    recycled) plus one padded row aimed at lane B, with copies padded to
    the trash page; with ``seeded`` the request shares lane 0's first page
    as a prefix."""
    cfg_j = _models(family)[0]
    rng = np.random.RandomState(3)
    n_pages = MAX_LEN // PS
    plen = 6
    sh = 1 if seeded else 0
    pos0 = sh * PS
    toks = np.zeros((2, 8), np.int32)
    toks[0, :plen - pos0] = rng.randint(1, cfg_j.vocab_size, plen - pos0)
    lens = np.array([plen - pos0, 1], np.int32)
    new = [2 * n_pages + j for j in range(sh, 2)]          # lane 2's own pages
    dsts = np.full((4,), TRASH, np.int32)
    dsts[:len(new)] = new
    rows = np.zeros((4,), np.int32)
    cols = np.zeros((4,), np.int32)
    cols[:len(new)] = range(sh, 2)
    tab = np.zeros((2, n_pages), np.int32)
    ids = ([0] if seeded else []) + new
    tab[0, :len(ids)] = ids
    tab[0, len(ids):] = new[-1]
    admit = {"batch": {"tokens": toks, "lens": lens,
                       "pos0": np.array([pos0, 0], np.int32)},
             "lanes": np.array([2, B], np.int32),
             "budgets": np.array([5, 0], np.int32),
             "copy_rows": rows, "copy_cols": cols, "copy_dsts": dsts,
             "tab_rows": tab}
    if seeded:
        seed_tab = np.zeros((2, n_pages), np.int32)
        admit["seed_tab"], admit["seed_len"] = seed_tab, np.array([PS, 0], np.int32)
    return admit


def _live(family, layout, stochastic):
    cache_j, cache_t, first = _state(family, layout)
    sj, st = _lane_states(stochastic)
    x = _burst_inputs(first, [MAX_OUT] * B)
    x["p"][2:] = False                         # lanes 2 and 3 retired
    live_j = (cache_j, *(jnp.asarray(x[k]) for k in
                         ("out_buf", "tok", "p", "n_gen", "lane_budget")),
              {k: jnp.asarray(v) for k, v in sj.items()})
    live_t = (cache_t, *(torch.from_numpy(x[k].copy()) for k in
                         ("out_buf", "tok", "p", "n_gen", "lane_budget")),
              st)
    return live_j, live_t


def _held_live(cfg_j, cfg_t, got, want):
    cj, *rj = want
    ct, *rt = got
    for a, b in zip(rt[:5], rj[:5]):           # out_buf, tok, p, n_gen, budget
        np.testing.assert_array_equal(np_(a), np.asarray(b))
    for k in rj[5]:
        np.testing.assert_array_equal(np_(rt[5][k]), to_t(rj[5][k]).numpy())
    _held_caches(cfg_j, cfg_t, cj, ct)


@pytest.mark.parametrize("family,layout,seeded", [
    ("dense", "paged", True), ("dense", "int8", False), ("hybrid", "paged", True)])
def test_seed_install_and_splice_match_jax(family, layout, seeded):
    cfg_j, params, cfg_t, model = _models(family)
    eng_j, eng_t = _engines(family, -999, layout)
    live_j, live_t = _live(family, layout, True)
    admit = _admission(family, seeded)
    sub_j = eng_j.make_cache(2, MAX_LEN)
    sub_t = eng_t.make_cache(2, MAX_LEN)
    if seeded:
        sub_j = eng_j._seed_pages(live_j[0], sub_j, jnp.asarray(admit["seed_tab"]),
                                  jnp.asarray(admit["seed_len"]), MAX_LEN)
        sub_t = eng_t._seed_pages(live_t[0], sub_t, admit["seed_tab"],
                                  admit["seed_len"], MAX_LEN)
        for k in ("k", "v", "shared_k", "shared_v"):
            if k in sub_j:
                _close(sub_t[k], sub_j[k], 1e-5)
    batch = admit["batch"]
    lj, sub_j = eng_j._prefill(params, {k: jnp.asarray(v) for k, v in batch.items()},
                               sub_j)
    lt, sub_t = eng_t.model.prefill(model, cfg_t, tree_t(batch), sub_t)
    _close(lt, lj, 1e-4)
    first = np.asarray(jnp.argmax(lj, -1)).astype(np.int32)
    subst_j = SJ.lane_state([SJ.SamplingParams(temperature=0.7, seed=11,
                                               greedy=False)], 2)
    subst_t = ST.lane_state([ST.SamplingParams(temperature=0.7, seed=11,
                                               greedy=False)], 2, device="cpu")
    info = {k: v for k, v in admit.items() if k.startswith("copy_") or k == "tab_rows"}
    want = eng_j._splice_admission(
        *live_j[0:5], live_j[5], live_j[6], jnp.asarray(admit["lanes"]),
        jnp.asarray(first), sub_j, subst_j, jnp.asarray(admit["budgets"]),
        {k: jnp.asarray(v) for k, v in info.items()})
    got = eng_t._splice_admission(
        *live_t[0:5], live_t[5], live_t[6], torch.from_numpy(admit["lanes"]),
        torch.from_numpy(first), sub_t, subst_t,
        torch.from_numpy(admit["budgets"]), tree_t(info))
    _held_live(cfg_j, cfg_t, got, want)
    # the pools: every page but the trash page, which the padded copies
    # hit; narrow pools through the lanes' widened views
    if layout == "paged":
        for k in want[0]:
            if k.endswith("_pages"):
                sel = (slice(None),) * (want[0][k].ndim - 4) + (slice(0, TRASH),)
                _close(np_(got[0][k])[sel], np.asarray(want[0][k])[sel], 1e-5)
    else:
        for k, (t, j) in _kv_views(cfg_j, cfg_t, want[0], got[0]).items():
            _close(t, j, 1e-5)


@pytest.mark.parametrize("family,layout,seeded", [
    ("dense", "paged", True), ("hybrid", "paged", False)])
def test_fused_step_matches_jax(family, layout, seeded):
    """One round: a non-final partial chunk, a final one that splices into
    lane 3 (its page copied into lane 3's first page), the admission into
    lane 2 with a padded row, then a 3-step burst."""
    cfg_j, params, cfg_t, model = _models(family)
    eng_j, eng_t = _engines(family, -999, layout)
    live_j, live_t = _live(family, layout, True)
    admit = _admission(family, seeded)
    rng = np.random.RandomState(4)
    ptoks = rng.randint(1, cfg_j.vocab_size, (1, 4)).astype(np.int32)
    part_batch = {"tokens": ptoks, "lens": np.array([4], np.int32),
                  "pos0": np.array([0], np.int32)}
    final_batch = {"tokens": ptoks, "lens": np.array([4], np.int32),
                   "pos0": np.array([0], np.int32)}
    n_pages = MAX_LEN // PS
    part_copy = {"copy_rows": np.zeros((1,), np.int32),
                 "copy_cols": np.zeros((1,), np.int32),
                 "copy_dsts": np.array([3 * n_pages], np.int32),
                 "tab_rows": np.full((1, n_pages), 3 * n_pages, np.int32)}
    sub_state = lambda pkg, dev: (
        pkg.lane_state([pkg.SamplingParams(temperature=0.6, seed=2,
                                           greedy=False)], 1, **dev))
    parts_j = ({"batch": {k: jnp.asarray(v) for k, v in part_batch.items()},
                "cache": eng_j.make_cache(1, MAX_LEN)},
               {"batch": {k: jnp.asarray(v) for k, v in final_batch.items()},
                "cache": eng_j.make_cache(1, MAX_LEN),
                "sub_state": sub_state(SJ, {}), "lane": jnp.asarray([3], jnp.int32),
                "budget": jnp.asarray([3], jnp.int32),
                **{k: jnp.asarray(v) for k, v in part_copy.items()}})
    parts_t = ({"batch": tree_t(part_batch), "cache": eng_t.make_cache(1, MAX_LEN)},
               {"batch": tree_t(final_batch), "cache": eng_t.make_cache(1, MAX_LEN),
                "sub_state": sub_state(ST, {"device": "cpu"}),
                "lane": torch.tensor([3], dtype=torch.int32),
                "budget": torch.tensor([3], dtype=torch.int32),
                **tree_t(part_copy)})
    sj_admit = SJ.lane_state([SJ.SamplingParams(temperature=0.9, seed=8,
                                                greedy=False)], 2)
    st_admit = ST.lane_state([ST.SamplingParams(temperature=0.9, seed=8,
                                                greedy=False)], 2, device="cpu")
    admit_j = {k: ({kk: jnp.asarray(vv) for kk, vv in v.items()} if isinstance(v, dict)
                   else jnp.asarray(v)) for k, v in admit.items()}
    admit_j["sub_state"] = sj_admit
    admit_t = dict(admit, sub_state=st_admit)
    kw = dict(n_steps=3, stochastic=True, admit_stoch=True,
              part_final=(False, True), part_stoch=(False, True),
              max_len=MAX_LEN, width=None)
    cj, oj, tj, pj, nj, bj, sj, stj, newj = eng_j._fused_step(
        params, *live_j, admit_j, parts_j, **kw)
    ct, ot, tt, pt, nt, bt, st, stt, newt = eng_t._fused_step(
        *live_t, admit_t, parts_t, **kw)
    _held_live(cfg_j, cfg_t, (ct, ot, tt, pt, nt, bt, st),
               (cj, oj, tj, pj, nj, bj, sj))
    assert int(stt) == int(stj) == 3
    assert len(newt) == len(newj) == 1
    for k in newj[0]:
        if k in ("k", "v", "shared_k", "shared_v", "conv", "tail_conv"):
            _close(newt[0][k], newj[0][k], 1e-5)
        elif k in ("state", "tail_state"):
            _close(newt[0][k], newj[0][k], 1e-4)
        else:
            np.testing.assert_array_equal(np_(newt[0][k]), np.asarray(newj[0][k]))
