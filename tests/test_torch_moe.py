"""Port parity: the MoE family of ``repro_torch`` (olmoe / moonshot twins,
weights carried across by ``from_jax_params``) against ``repro.models.moe``
with its Pallas flash kernels in interpret mode — the dispatch ranks (exact,
against the JAX op's Pallas kernel), the dispatch tables (exact), the MoE
FFN with tokens dropped at capacity, prefill and decode logits on the
dense, paged and int8-paged caches (f32, atol = rtol = 1e-4), and greedy
``generate`` tokens (identical).  Inside the port, int8 native decode
equals the gather oracle."""

import functools

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np
from torch_parity import TOL, configs, family_models, np_

from repro.kernels.moe_dispatch import build_dispatch as j_build_dispatch
from repro.kernels.moe_dispatch import moe_positions as j_moe_positions
from repro.kernels.moe_dispatch.ref import moe_ffn_loop_ref as j_loop_ref
from repro.kernels.moe_dispatch.ref import moe_positions_ref as j_positions_ref
from repro.models import get_model as j_get_model
from repro.models import moe as jmoe
from repro.models import to_paged as j_to_paged
from repro.serve import ServeEngine as JaxEngine
from repro_torch.kernels.moe_dispatch import build_dispatch, moe_positions
from repro_torch.kernels.moe_dispatch import kernel as K
from repro_torch.kernels.moe_dispatch.ref import moe_ffn_loop_ref
from repro_torch.models import get_model as t_get_model
from repro_torch.models import moe as tmoe
from repro_torch.models import to_paged
from repro_torch.models.convert import _copy_module
from repro_torch.serve import ServeEngine

LENS = np.array([11, 4, 9], np.int32)
MAX_NEW, MAX_LEN, PAGE = 5, 24, 8


def _ids(rng, t, k, e, invalid=0.0):
    ids = rng.randint(0, e, (t, k)).astype(np.int32)
    ids[rng.rand(t, k) < invalid] = -1
    return ids


@pytest.mark.parametrize("t,k,e", [(64, 2, 8), (300, 6, 64), (7, 1, 4)])
def test_moe_positions_match_jax_kernel(t, k, e):
    """The plain ranks equal the JAX op on its Pallas kernel (interpret
    mode) exactly, with -1 ids among them."""
    ids = _ids(np.random.RandomState(t), t, k, e, invalid=0.1)
    pos_j, cnt_j = j_moe_positions(jnp.asarray(ids), e, impl="kernel")
    pos_t, cnt_t = moe_positions(torch.from_numpy(ids), e)
    assert pos_t.dtype == cnt_t.dtype == torch.int32
    np.testing.assert_array_equal(np_(pos_t), np_(pos_j))
    np.testing.assert_array_equal(np_(cnt_t), np_(cnt_j))


def test_moe_positions_ids_past_e_follow_the_ref():
    """Ids in [E, round_up(E, 128)) are ranked by the Pallas one-hot, which
    runs over the padded lane count, but not by the JAX ref: the port
    follows the ref (position 0, counted nowhere)."""
    e = 6
    ids = np.array([[0, 7], [7, 2], [9, 0], [7, 200], [-1, 0]], np.int32)
    pos_t, cnt_t = moe_positions(torch.from_numpy(ids), e)
    pos_r, cnt_r = j_positions_ref(jnp.asarray(ids), e)
    np.testing.assert_array_equal(np_(pos_t), np_(pos_r))
    np.testing.assert_array_equal(np_(cnt_t), np_(cnt_r))
    assert (np_(pos_t)[ids >= e] == 0).all()
    np.testing.assert_array_equal(np_(cnt_t), [3, 0, 1, 0, 0, 0])
    pos_p, _ = j_moe_positions(jnp.asarray(ids), e, impl="kernel")
    assert np_(pos_p)[3, 0] == 2          # the third id 7: ranked by Pallas


def test_moe_positions_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA tensor"):
        K.moe_positions_cuda(torch.zeros((4, 2), dtype=torch.int32), 4)
    with pytest.raises(ValueError, match="impl"):
        moe_positions(torch.zeros((4, 2), dtype=torch.int32), 4, impl="pallas")


def test_moe_positions_ref_matches_pallas_at_olmoe_prefill():
    """The plain ranks at the served prefill shape, ids (7704, 8) over 64
    experts with 5% invalid, against the JAX op's Pallas kernel
    (interpret mode), exactly."""
    ids = _ids(np.random.RandomState(7704), 7704, 8, 64, invalid=0.05)
    pos_j, cnt_j = j_moe_positions(jnp.asarray(ids), 64, impl="kernel")
    pos_t, cnt_t = moe_positions(torch.from_numpy(ids), 64)
    np.testing.assert_array_equal(np_(pos_t), np_(pos_j))
    np.testing.assert_array_equal(np_(cnt_t), np_(cnt_j))


@pytest.mark.parametrize("n", [0, 1, 31, 32, 64, 127, 128])
def test_plan_positions_one_warp_at_decode(n):
    """Up to the decode tile (128 assignments): one block of one warp,
    enough rounds of 32 for n."""
    plan = K.plan_positions(n, 64, 132)
    assert plan["grid"] == 1 and plan["warps"] == 1
    assert plan["tile"] >= n and plan["rounds"] <= K.DECODE_ROUNDS


@pytest.mark.parametrize("n", [257, 7704 * 8, 20001 * 8])
def test_plan_positions_one_wave(n):
    """Past decode, the grid is one wave of the card's 132 SMs, a whole
    number of clusters whose last holds the last assignment, and the tiles
    cover n."""
    plan = K.plan_positions(n, 64, 132)
    assert 1 <= plan["grid"] <= 132 and plan["grid"] % K.CLUSTER == 0
    assert plan["tile"] == plan["rounds"] * K.WARP * plan["warps"]
    assert ((plan["grid"] - K.CLUSTER) * plan["tile"] < n
            <= plan["grid"] * plan["tile"])
    assert K.MIN_ROUNDS <= plan["rounds"] <= K.MAX_ROUNDS


def test_plan_positions_shared_memory_at_1024_experts():
    """(warps + 3 + 2 x CLUSTER) x E ints stay under one block's 227 KB at
    E = 1024."""
    for n in (64, 7704 * 8, 20001 * 8):
        plan = K.plan_positions(n, K.MAX_EXPERTS, 132)
        assert plan["smem_bytes"] <= 4 * (plan["warps"] + 3 + 2 * K.CLUSTER) * K.MAX_EXPERTS
        assert plan["smem_bytes"] < K.SMEM_CAP


@pytest.mark.parametrize("cap", [4, 32])
def test_build_dispatch_matches_jax(cap):
    """All six tables, exactly; cap 4 drops assignments, and -1 ids never
    take a slot."""
    rng = np.random.RandomState(cap)
    t, k, e = 40, 2, 6
    ids = _ids(rng, t, k, e, invalid=0.1)
    gates = rng.rand(t, k).astype(np.float32)
    d_j = j_build_dispatch(jnp.asarray(ids), jnp.asarray(gates), e, cap,
                           impl="kernel")
    d_t = build_dispatch(torch.from_numpy(ids), torch.from_numpy(gates), e, cap)
    assert sorted(d_t) == sorted(d_j)
    for key in d_j:
        np.testing.assert_array_equal(np_(d_t[key]), np_(d_j[key]), err_msg=key)
    assert (int(d_t["dropped"]) > 0) == (cap == 4)


def test_dispatch_combine_matches_the_loop_ref():
    """Dispatch, relu experts and combine through the port's tables equal
    the naive loop with capacity dropping (the port's and the JAX one)."""
    rng = np.random.RandomState(2)
    t, k, e, cap, dm, f = 48, 2, 6, 10, 16, 32
    x = rng.randn(t, dm).astype(np.float32)
    ids = rng.randint(0, e, (t, k)).astype(np.int32)
    gates = rng.rand(t, k).astype(np.float32)
    w_up = (rng.randn(e, dm, f) * 0.1).astype(np.float32)
    w_down = (rng.randn(e, f, dm) * 0.1).astype(np.float32)
    xt, wu, wd = map(torch.from_numpy, (x, w_up, w_down))
    d = build_dispatch(torch.from_numpy(ids), torch.from_numpy(gates), e, cap)
    assert int(d["dropped"]) > 0
    xe = torch.cat([xt, xt.new_zeros(1, dm)])[d["token_table"].long()]
    ye = torch.einsum("ecf,efd->ecd", torch.relu(torch.einsum("ecd,edf->ecf", xe, wu)), wd)
    ye_flat = torch.cat([ye.reshape(e * cap, dm), ye.new_zeros(1, dm)])
    y = (ye_flat[d["slot_of"].long()] * d["gates"][..., None]).sum(1)
    want = j_loop_ref(x, ids, gates, w_up, w_down, cap)
    loop = moe_ffn_loop_ref(xt, torch.from_numpy(ids), torch.from_numpy(gates),
                            wu, wd, cap)
    np.testing.assert_allclose(np_(loop), want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np_(y), want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("family", ["moe", "moe_shared"])
def test_moe_ffn_drops_like_jax(family):
    """The MoE FFN at capacity factor 1.25 with a router skewed towards one
    expert, so assignments drop at capacity: output equal to JAX's within
    f32 tolerance, the same assignments dropped."""
    cfg_j, params, cfg_t, _ = family_models(family)
    cfg_j = cfg_j.replace(capacity_factor=1.25)
    cfg_t = cfg_t.replace(capacity_factor=1.25)
    p_np = {k: (np.asarray(v[0]) if not isinstance(v, dict)
                else {kk: np.asarray(vv[0]) for kk, vv in v.items()})
            for k, v in params["blocks"]["moe"].items()}
    p_np["router"] = p_np["router"].copy()
    p_np["router"][:, 0] += 0.1                      # with x > 0 on average,
    blk = tmoe.MoEFFN(cfg_t, "cpu")                  # most tokens pick expert 0
    _copy_module(blk, p_np)
    x = (np.random.RandomState(4).randn(3, 16, cfg_j.d_model) + 1.0).astype(np.float32)
    y_j, metrics = jax.jit(jmoe.moe_ffn, static_argnums=2)(
        jax.tree.map(jnp.asarray, p_np), jnp.asarray(x), cfg_j)
    assert float(metrics["dropped_frac"]) > 0
    y_t = tmoe.moe_ffn(blk, torch.from_numpy(x), cfg_t)
    np.testing.assert_allclose(np_(y_t), np_(y_j), **TOL)
    # the port drops the same number of assignments
    gates, ids = tmoe.route(blk, torch.from_numpy(x).reshape(48, -1), cfg_t)
    d = build_dispatch(ids, gates, cfg_t.n_experts,
                       tmoe.capacity(cfg_t, 48))
    assert float(d["dropped"]) / ids.numel() == pytest.approx(
        float(metrics["dropped_frac"]))


def test_moe_ffn_refuses_token_groups():
    """Token groups that would span data shards are refused, naming the
    ROADMAP item: a training rank holding half the lanes of the one group
    (``moe_groups=1`` over 2 data shards), and serving on lane blocks with
    more than one group.  (Groups on one device, and one group per data
    rank, are held against JAX in ``test_torch_mesh_train.py``.)"""
    from repro_torch.dist import sharding as SH
    from repro_torch.launch.mesh import Mesh
    _, _, cfg_t, _ = family_models("moe")
    blk = tmoe.MoEFFN(cfg_t, "cpu")
    x = torch.zeros((2, 4, cfg_t.d_model))
    mesh = Mesh(("data", "model"), {"data": 2, "model": 1},
                {"data": 0, "model": 0}, {}, "gloo", torch.device("cpu"), 0)
    with SH.use_mesh_rules(mesh), SH.batch_cut():
        with pytest.raises(NotImplementedError, match="Queue 1 item 14"):
            tmoe.moe_ffn(blk, x, cfg_t, aux=True)
    with SH.use_mesh_rules(mesh), SH.lanes_cut():
        with pytest.raises(NotImplementedError, match="moe_groups=2"):
            tmoe.moe_ffn(blk, x, cfg_t.replace(moe_groups=2))


def _batch(cfg):
    rng = np.random.RandomState(0)
    return {"tokens": rng.randint(1, cfg.vocab_size, (len(LENS), int(LENS.max()))),
            "lens": LENS}


@functools.lru_cache(maxsize=None)
def _prefill_cached(family):
    cfg_j, params, cfg_t, model = family_models(family)
    batch = _batch(cfg_j)
    cache_j = j_get_model(cfg_j).make_cache(cfg_j, len(LENS), MAX_LEN)
    logits_j, cache_j = jax.jit(j_get_model(cfg_j).prefill, static_argnums=1)(
        params, cfg_j, {k: jnp.asarray(v) for k, v in batch.items()}, cache_j)
    cache_t = tmoe.make_cache(cfg_t, len(LENS), MAX_LEN, device="cpu")
    logits_t, cache_t = tmoe.prefill(
        model, cfg_t, {k: torch.from_numpy(v) for k, v in batch.items()}, cache_t)
    return (cfg_j, params, logits_j, cache_j), (cfg_t, model, logits_t, cache_t)


@pytest.mark.parametrize("family", ["moe", "moe_shared"])
def test_prefill_logits_and_caches_match_jax(family):
    (_, _, logits_j, cache_j), (_, _, logits_t, cache_t) = _prefill_cached(family)
    np.testing.assert_allclose(np_(logits_t), np_(logits_j), **TOL)
    assert sorted(cache_t) == sorted(cache_j)           # dense_k kept, as JAX
    for key in cache_j:
        np.testing.assert_allclose(np_(cache_t[key]), np_(cache_j[key]), **TOL,
                                   err_msg=key)


@pytest.mark.parametrize("page_size,page_dtype", [(None, None), (PAGE, None),
                                                  (PAGE, "int8")])
def test_decode_logits_match_jax(page_size, page_dtype):
    """A decode step after prefill on the dense, paged and int8-paged cache:
    logits within f32 tolerance, and every cache tensor (pool bytes and
    scales too) equal to JAX's."""
    (cfg_j, params, logits_j, cache_j), (cfg_t, model, _, cache_t) = \
        _prefill_cached("moe")
    cache_t = {k: v.clone() for k, v in cache_t.items()}   # decode writes in place
    if page_size is not None:
        cache_j = j_to_paged(cfg_j, cache_j, page_size=page_size,
                             page_dtype=page_dtype)
        cache_t = to_paged(cfg_t, cache_t, page_size=page_size,
                           page_dtype=page_dtype)
    tok = np.asarray(jnp.argmax(logits_j, -1)).astype(np.int32)[:, None]
    logits_j, cache_j = jax.jit(jmoe.decode, static_argnums=1)(
        params, cfg_j, {"token": jnp.asarray(tok)}, cache_j)
    logits_t, cache_t = tmoe.decode(model, cfg_t, {"token": torch.from_numpy(tok)},
                                    cache_t)
    np.testing.assert_allclose(np_(logits_t), np_(logits_j), **TOL)
    assert sorted(cache_t) == sorted(cache_j)
    for key in cache_j:
        want = np_(cache_j[key])
        if want.dtype == np.int8:                       # narrow pool bytes
            diff = np.abs(np_(cache_t[key]).astype(int) - want.astype(int))
            assert diff.max() <= 1, key                 # a rounding edge at most
            assert (diff > 0).mean() < 1e-3, key
        else:
            np.testing.assert_allclose(np_(cache_t[key]), want, **TOL, err_msg=key)


def _generate(engine_cls, family="moe", page_size=None, page_dtype=None,
              paged_attn="native"):
    cfg_j, params, cfg_t, model = family_models(family)
    batch = _batch(cfg_j)
    if engine_cls is JaxEngine:
        eng = JaxEngine(cfg_j, params, max_new_tokens=MAX_NEW, stop_token=-1,
                        page_dtype=page_dtype)
        res = eng.generate({k: jnp.asarray(v) for k, v in batch.items()},
                           max_len=MAX_LEN, page_size=page_size)
    else:
        eng = ServeEngine(cfg_t, model, max_new_tokens=MAX_NEW, stop_token=-1,
                          page_dtype=page_dtype, paged_attn=paged_attn,
                          device="cpu")
        res = eng.generate(batch, max_len=MAX_LEN, page_size=page_size)
    return np_(res["tokens"]), np_(res["n_generated"])


@pytest.mark.parametrize("page_size,page_dtype", [(None, None), (PAGE, None),
                                                  (PAGE, "int8")])
def test_generate_matches_jax(page_size, page_dtype):
    tok_j, n_j = _generate(JaxEngine, page_size=page_size, page_dtype=page_dtype)
    tok_t, n_t = _generate(ServeEngine, page_size=page_size, page_dtype=page_dtype)
    np.testing.assert_array_equal(tok_t, tok_j)
    np.testing.assert_array_equal(n_t, n_j)


def test_paged_and_int8_native_equal_dense_and_gather_oracle():
    """Inside the port: the paged cache gives the dense cache's tokens, and
    int8 native decode gives the tokens of the gather oracle, which
    dequantizes the same pool bytes (JAX's
    ``test_quantized_native_decode_matches_gather_oracle``)."""
    dense = _generate(ServeEngine, family="moe_shared")
    paged = _generate(ServeEngine, family="moe_shared", page_size=4)
    native = _generate(ServeEngine, family="moe_shared", page_size=4,
                       page_dtype="int8")
    oracle = _generate(ServeEngine, family="moe_shared", page_size=4,
                       page_dtype="int8", paged_attn="gather")
    for a, b in ((paged, dense), (native, oracle)):
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])


def test_capacity_and_flags_match_jax():
    cfg_j, cfg_t = configs(**{"family": "moe", "n_experts": 64, "top_k": 8,
                              "capacity_factor": 1.25})
    for t in (8, 7704, 100, 1):
        assert tmoe.capacity(cfg_t, t) == jmoe.capacity(cfg_j, t)
    assert tmoe.capacity(cfg_t, 8 * 963) == 1208
    for name in ("PAGED_PREFIX_OK", "CHUNKED_PREFILL_OK", "LANE_INDEPENDENT_DECODE"):
        assert getattr(tmoe, name) == getattr(jmoe, name)
    assert tmoe.paged_cache_spec(cfg_t) == jmoe.paged_cache_spec(cfg_j)
    assert tmoe.cache_batch_axes(cfg_t) == jmoe.cache_batch_axes(cfg_j)
    assert t_get_model(cfg_t) is tmoe
