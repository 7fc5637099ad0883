"""Port parity of the SVE partition algebra: the predicate helpers of
``repro_torch.core.predicate``, ``core.partition`` and ``core.ffr`` against
``repro.core`` on the same numpy-seeded inputs, exactly equal (bools and
integers).  Includes paper Fig. 4 (``ldff`` -> FFR [T, T, F, F]), Fig. 5
(``strlen`` by first-faulting loads) and the Fig. 6 linked-list XOR through
``serial_subloop``, and the lane movers on widths 1-64."""

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("hypothesis")

import jax.numpy as jnp
import numpy as np
from hypothesis import given, settings, strategies as st

from repro.core import ffr as JF
from repro.core import partition as JT
from repro.core import predicate as JP
from repro.core import reductions as JR
from repro_torch.core import ffr as TF
from repro_torch.core import partition as TT
from repro_torch.core import predicate as TP
from repro_torch.core import reductions as TR

WIDTHS = (1, 2, 5, 16, 33, 64)
# hypothesis runs the same examples every time: the pass count is fixed
FIXED = dict(derandomize=True, deadline=None, database=None)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same(got, want):
    """Exactly equal, with the same kind of element (bool / int)."""
    got = got.numpy() if hasattr(got, "numpy") else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert got.dtype.kind == want.dtype.kind, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


def _inputs(vl, seed, lead=(3,)):
    """Two predicates (with an all-false and an all-true row) and two int32
    vectors of width ``vl``."""
    rng = np.random.RandomState(1000 * vl + seed)
    p = rng.rand(*lead, vl) < 0.4
    q = rng.rand(*lead, vl) < 0.5
    p[0], q[-1] = False, True
    x = rng.randint(-1000, 1000, lead + (vl,)).astype(np.int32)
    y = rng.randint(-1000, 1000, lead + (vl,)).astype(np.int32)
    return p, q, x, y


@pytest.mark.parametrize("vl", WIDTHS)
def test_predicate_helpers_match_jax(vl):
    p, q, x, _ = _inputs(vl, 0)
    jp, jq, tp, tq = jnp.asarray(p), jnp.asarray(q), torch.from_numpy(p), torch.from_numpy(q)
    for name in ("first", "none", "any_", "last", "not_last", "cntp", "pfirst",
                 "plast", "propagate_last"):
        _same(getattr(TP, name)(tp), getattr(JP, name)(jp))
    _same(TP.pnext(tp, tq), JP.pnext(jp, jq))
    _same(TP.pnext(tp, torch.zeros_like(tq)), JP.pnext(jp, jnp.zeros_like(jq)))
    _same(TP.lane_iota(vl), JP.lane_iota(vl))
    lens = np.array([0, vl // 2, vl, vl + 3], np.int32)
    _same(TP.index_pred(torch.from_numpy(lens), vl), JP.index_pred(jnp.asarray(lens), vl))
    _same(TP.cpy(tp[1], 7, torch.from_numpy(x)), JP.cpy(jp[1], 7, jnp.asarray(x)))
    for a, b in ((1, 2), (3, 3)):
        _same(TP.ctermeq(a, b, tp), JP.ctermeq(a, b, jp))


@pytest.mark.parametrize("start,limit", [
    (0, 5), (3, 2), (-1, 4), (np.uint32(2 ** 32 - 3), np.uint32(2 ** 32 - 1)),
    (np.uint32(2 ** 32 - 2), np.uint32(5)), (np.int32(-3), np.int32(-1)),
])
def test_whilelo_matches_jax(start, limit):
    for vl in (1, 8, 33):
        _same(TP.whilelo(start, limit, vl), JP.whilelo(start, limit, vl))


@pytest.mark.parametrize("vl", WIDTHS)
def test_breaks_match_jax(vl):
    p, q, _, _ = _inputs(vl, 1)
    jp, jq, tp, tq = jnp.asarray(p), jnp.asarray(q), torch.from_numpy(p), torch.from_numpy(q)
    _same(TT.brkb(tp, tq), JT.brkb(jp, jq))
    _same(TT.brka(tp, tq), JT.brka(jp, jq))
    _same(TT.brkpb(tp, tq, ~tp), JT.brkpb(jp, jq, ~jp))
    _same(TT.brkpb(tq, tq, tp), JT.brkpb(jq, jq, jp))
    _same(TT.accept_prefix(tq), JT.accept_prefix(jq))
    _same(TT.accept_prefix(tq, tp), JT.accept_prefix(jq, jp))


@pytest.mark.parametrize("vl", WIDTHS)
def test_lane_movers_match_jax(vl):
    """compact (zero and a fill), its permutation, splice, lastb and lasta
    on rows with none, some and all lanes active; a 1-D predicate over 2-D
    data for compact and splice."""
    p, q, x, y = _inputs(vl, 2)
    jp, tp = jnp.asarray(p), torch.from_numpy(p)
    jx, jy, tx, ty = jnp.asarray(x), jnp.asarray(y), torch.from_numpy(x), torch.from_numpy(y)
    _same(TT.compact_perm(tp), JT.compact_perm(jp))
    _same(TT.compact(tp, tx), JT.compact(jp, jx))
    _same(TT.compact(tp, tx, fill=-7), JT.compact(jp, jx, fill=-7))
    _same(TT.splice(tp, tx, ty), JT.splice(jp, jx, jy))
    _same(TT.lastb(tp, tx), JT.lastb(jp, jx))
    _same(TT.lasta(tp, tx), JT.lasta(jp, jx))
    _same(TT.compact(tp[1], tx), JT.compact(jp[1], jx))
    _same(TT.splice(tp[1], tx, ty), JT.splice(jp[1], jx, jy))
    _same(TT.lastb(tp[1], tx[1]), JT.lastb(jp[1], jx[1]))


def _countdown(P, starts, p0):
    def cond(state, p):
        return state > 0

    def body(state, p):
        return P.merging(p, state - 1, state)
    return cond, body, starts, p0


@pytest.mark.parametrize("starts,p0", [
    ([3, 0, 5, 1], [True] * 4),
    ([2, 7, 4], [True, False, True]),
])
def test_partitioned_while_matches_jax(starts, p0):
    """Lanes count down from their starts and keep their final value; an
    inactive lane is never touched."""
    s, g = np.array(starts, np.int32), np.array(p0)
    got, gp = TT.partitioned_while(*_countdown(TP, torch.from_numpy(s),
                                               torch.from_numpy(g)))
    want, wp = JT.partitioned_while(*_countdown(JP, jnp.asarray(s), jnp.asarray(g)))
    _same(got, want)
    _same(gp, wp)
    assert not bool(gp.any())


def _random_list(rng, n_nodes, length):
    """A linked list of ``length`` nodes inside an ``n_nodes`` arena."""
    order = rng.permutation(n_nodes)[:length]
    nxt = np.full(n_nodes, -1, np.int32)
    for a, b in zip(order[:-1], order[1:]):
        nxt[a] = b
    vals = rng.randint(0, 1 << 30, n_nodes).astype(np.int32)
    return (int(order[0]) if length else -1), nxt, vals


def _fig6_xor(P, PT, R, lib, head, nxt, vals, vl):
    """Paper Fig. 6 with one package: a serial pointer chase (pfirst/pnext,
    cpy, ctermeq) fills a vector of node ids, then a vector gather and a
    horizontal eorv, strip-mined until the list ends."""
    arr = torch.as_tensor if lib == "torch" else jnp.asarray
    nxt_a, vals_a = arr(nxt), arr(vals)

    def lane_step(state, p_lane, lane):
        cur, z = state
        z = P.cpy(p_lane, cur, z)
        return (nxt_a[cur], z), nxt_a[cur] >= 0

    res, ptr = 0, head
    for _ in range(len(nxt) // vl + 2):
        if ptr < 0:
            break
        zeros = (torch.zeros(vl, dtype=torch.int32) if lib == "torch"
                 else jnp.zeros(vl, jnp.int32))
        (ptr_t, z), part = PT.serial_subloop(P.ptrue(vl), lane_step,
                                             (arr(np.int32(ptr)), zeros))
        gathered = vals_a[z.clip(0, None) if lib == "torch" else jnp.clip(z, 0, None)]
        res ^= int(R.eorv(part, gathered))
        ptr = int(ptr_t)
    return res


@pytest.mark.parametrize("length,vl,seed", [
    (0, 4, 0), (1, 1, 1), (7, 3, 2), (20, 16, 3), (13, 5, 4), (32, 32, 5),
])
def test_linked_list_xor_fig6_matches_jax(length, vl, seed):
    head, nxt, vals = _random_list(np.random.RandomState(seed), 32, length)
    want, p = 0, head
    while p != -1:
        want ^= int(vals[p])
        p = nxt[p]
    assert _fig6_xor(TP, TT, TR, "torch", head, nxt, vals, vl) == want
    assert _fig6_xor(JP, JT, JR, "jax", head, nxt, vals, vl) == want


@given(st.integers(0, 20), st.integers(1, 16), st.integers(0, 1000))
@settings(max_examples=15, **FIXED)
def test_linked_list_xor_fig6_property(length, vl, seed):
    head, nxt, vals = _random_list(np.random.RandomState(seed), 32, length)
    want, p = 0, head
    while p != -1:
        want ^= int(vals[p])
        p = nxt[p]
    assert _fig6_xor(TP, TT, TR, "torch", head, nxt, vals, vl) == want


def test_serial_subloop_stops_at_ctermeq_and_max_iters():
    """The sub-loop visits active lanes in order, stops when the step says
    so (ctermeq) and after ``max_iters`` lanes, as JAX's does."""
    g = np.array([False, True, True, False, True, True])
    for stop_after, max_iters in ((2, None), (9, 3), (1, None)):
        def step(P, state, p_lane, lane):
            n = state + 1
            return n, P.ctermeq(n, stop_after, p_lane)
        got = TT.serial_subloop(torch.from_numpy(g), lambda *a: step(TP, *a),
                                torch.tensor(0), max_iters)
        want = JT.serial_subloop(jnp.asarray(g), lambda *a: step(JP, *a),
                                 jnp.int32(0), max_iters)
        assert int(got[0]) == int(want[0])
        _same(got[1], want[1])


def test_fig4_first_fault_gather():
    """Paper Fig. 4: A[2] invalid gives FFR [T, T, F, F] and zeroed lanes;
    retried with the faulting lane first-active, the partition is empty
    (the caller's trap check)."""
    base, idx = np.arange(8.0, dtype=np.float32), np.array([0, 1, 100, 3], np.int32)
    for p in ([True] * 4, [False, False, True, True]):
        p = np.array(p)
        tv, tf = TF.ldff(torch.from_numpy(base), torch.from_numpy(idx), torch.from_numpy(p))
        jv, jf = JF.ldff(jnp.asarray(base), jnp.asarray(idx), jnp.asarray(p))
        _same(tf, jf)
        _same(tv, jv)
    tv, tf = TF.ldff(torch.from_numpy(base), torch.from_numpy(idx), TP.ptrue(4))
    assert tf.tolist() == [True, True, False, False]
    assert tv.tolist() == [0.0, 1.0, 0.0, 0.0]


@given(st.data())
@settings(max_examples=12, **FIXED)
def test_ldff_matches_jax(data):
    n = data.draw(st.integers(1, 64))
    vl = data.draw(st.integers(1, 32))
    idx = np.array(data.draw(st.lists(st.integers(-5, n + 5), min_size=vl,
                                      max_size=vl)), np.int32)
    g = np.array(data.draw(st.lists(st.booleans(), min_size=vl, max_size=vl)), bool)
    fill = data.draw(st.sampled_from([0, -1]))
    base = np.arange(n, dtype=np.int32) * 3 + 1
    tv, tf = TF.ldff(torch.from_numpy(base), torch.from_numpy(idx),
                     torch.from_numpy(g), fill=fill)
    jv, jf = JF.ldff(jnp.asarray(base), jnp.asarray(idx), jnp.asarray(g), fill=fill)
    _same(tf, jf)
    _same(tv, jv)
    tv, tf = TF.ldff_contiguous(torch.from_numpy(base), int(idx[0]),
                                torch.from_numpy(g), valid_len=n // 2 + 1)
    jv, jf = JF.ldff_contiguous(jnp.asarray(base), int(idx[0]), jnp.asarray(g),
                                valid_len=n // 2 + 1)
    _same(tf, jf)
    _same(tv, jv)


@pytest.mark.parametrize("n,vl,start,valid", [
    (0, 8, 0, None), (77, 16, 0, None), (77, 7, 3, None), (128, 128, 0, None),
    (300, 32, 5, None), (50, 8, 0, 30),
])
def test_strlen_fig5_matches_jax(n, vl, start, valid):
    """Paper Fig. 5's strlen: the terminator inside a vector, on its edge,
    past several vectors, and past ``valid_len`` (the bounded length)."""
    buf = np.zeros(n + 64, np.int32)
    buf[:n] = 5
    got = TF.strlen(torch.from_numpy(buf), start, valid_len=valid, vl=vl)
    want = JF.strlen(jnp.asarray(buf), start, valid_len=valid, vl=vl)
    _same(got, want)
    if valid is None:
        assert int(got) == max(n - start, 0)
