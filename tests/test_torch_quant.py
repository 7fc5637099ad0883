"""Port parity: int8/fp8-quantized KV pages in ``repro_torch`` against the
JAX package — ``quantize_block`` byte for byte, the extending gather and
the truncating scatters (pool bytes and scales equal), quantized paged
flash attention (the plain path of the CUDA kernel) against the JAX Pallas
kernel in interpret mode (f32, atol = rtol = 1e-4), ``to_paged`` /
``paged_view`` of a quantized cache, and greedy ``generate`` tokens with
int8 pages for the dense and hybrid families (identical).  Inside the
port, int8 native decode equals the gather oracle."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
import numpy as np
from torch_parity import family_models, models, np_

from repro.core import paging as JPG
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.models import paged_view as j_paged_view
from repro.models import to_paged as j_to_paged
from repro.serve import ServeEngine as JaxEngine
from repro_torch.core import paging as PG
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention import kernel as K
from repro_torch.models import is_quantized, paged_view, to_paged
from repro_torch.serve import ServeEngine

DTYPES = ["int8", "fp8"]
TOL = dict(atol=1e-4, rtol=1e-4)
MAX_NEW = 5


def _bytes(x):
    """The raw bytes of a JAX array or torch tensor, as numpy uint8."""
    if hasattr(x, "detach"):
        return PG.as_bytes(x).numpy() if PG.is_quant_dtype(x.dtype) else x.numpy()
    x = np.asarray(x)
    return x.view(np.uint8) if x.dtype.itemsize == 1 else x


def _values(rng, shape):
    """Random rows with the edges of the truncating store: an all-zero row,
    exact .5 ties after scaling, and values at the narrow type's max."""
    v = (rng.randn(*shape) * 3.0).astype(np.float32)
    v.reshape(-1, shape[-1])[1] = 0.0
    tie = v.reshape(-1, shape[-1])[2]
    tie[:] = (np.arange(shape[-1]) - shape[-1] / 2 + 0.5) * 2.0
    return v


@pytest.mark.parametrize("page_dtype", DTYPES)
def test_quantize_block_byte_exact(page_dtype):
    v = _values(np.random.RandomState(0), (40, 3, 16))
    q_j, s_j = JPG.quantize_block(jnp.asarray(v), JPG.resolve_page_dtype(page_dtype))
    q_t, s_t = PG.quantize_block(torch.from_numpy(v),
                                 PG.resolve_page_dtype(page_dtype))
    assert q_t.dtype == {"int8": torch.int8, "fp8": torch.float8_e4m3fn}[page_dtype]
    np.testing.assert_array_equal(_bytes(q_t), _bytes(q_j))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    np.testing.assert_array_equal(PG.dequantize(q_t, s_t).numpy(),
                                  np.asarray(JPG.dequantize(q_j, s_j)))
    assert PG.quant_max(q_t.dtype) == JPG.quant_max(q_j.dtype)


def test_resolve_page_dtype():
    assert PG.resolve_page_dtype(None) is None
    assert PG.resolve_page_dtype("fp8") is PG.resolve_page_dtype("float8_e4m3fn")
    assert PG.resolve_page_dtype(torch.int8) is torch.int8
    for bad in ("int4", torch.float16):
        with pytest.raises(ValueError):
            PG.resolve_page_dtype(bad)
    with pytest.raises(ValueError, match="page_dtype"):
        ServeEngine(None, None, page_dtype="int4", device="cpu")


@pytest.mark.parametrize("n_lead", [0, 1])
@pytest.mark.parametrize("page_dtype", DTYPES)
def test_scatters_and_extending_gather_match_jax(page_dtype, n_lead):
    """scatter_block_q (admission), scatter_page_q (decode) and
    gather_pages(scale=) on pools with and without a lead axis: pool bytes,
    scales and the widened view equal JAX's."""
    rng = np.random.RandomState(1 + n_lead)
    lead = (2,) * n_lead
    P, hkv, ps, d = 7, 2, 4, 16
    spec = {"k": lead}
    pj = JPG.alloc_pools(spec, P, ps, hkv, d, jnp.float32, page_dtype=page_dtype)
    pt = PG.alloc_pools(spec, P, ps, hkv, d, torch.float32, device="cpu",
                        page_dtype=page_dtype)
    assert sorted(pt) == sorted(pj) == ["k_pages", "k_pages_scale"]
    pool_j, sc_j = pj["k_pages"], pj["k_pages_scale"]
    pool_t, sc_t = pt["k_pages"], pt["k_pages_scale"]
    ids = np.array([5, 0, 2], np.int32)
    blocks = _values(rng, (3,) + lead + (hkv, ps, d))
    pool_j, sc_j = JPG.scatter_block_q(pool_j, sc_j, jnp.asarray(ids),
                                       jnp.asarray(blocks), n_lead=n_lead)
    PG.scatter_block_q(pool_t, sc_t, torch.from_numpy(ids),
                       torch.from_numpy(blocks), n_lead=n_lead)
    vals = _values(rng, lead + (2, hkv, d))
    page_ids, offs = np.array([3, 5], np.int32), np.array([1, 3], np.int32)
    pool_j, sc_j = JPG.scatter_page_q(pool_j, sc_j, jnp.asarray(page_ids),
                                      jnp.asarray(offs), jnp.asarray(vals),
                                      n_lead=n_lead)
    PG.scatter_page_q(pool_t, sc_t, torch.from_numpy(page_ids),
                      torch.from_numpy(offs), torch.from_numpy(vals),
                      n_lead=n_lead)
    np.testing.assert_array_equal(_bytes(pool_t), _bytes(pool_j))
    np.testing.assert_array_equal(sc_t.numpy(), np.asarray(sc_j))
    table = np.array([[5, 0], [2, 3]], np.int32)
    view_j = JPG.gather_pages(pool_j, jnp.asarray(table), n_lead=n_lead, scale=sc_j)
    view_t = PG.gather_pages(pool_t, torch.from_numpy(table), n_lead=n_lead,
                             scale=sc_t)
    assert view_t.dtype == torch.float32
    np.testing.assert_array_equal(view_t.numpy(), np.asarray(view_j))
    np.testing.assert_array_equal(
        PG.gather_block(pool_t, torch.from_numpy(ids), n_lead=n_lead).view(
            torch.uint8).numpy(),
        _bytes(JPG.gather_block(pool_j, jnp.asarray(ids), n_lead=n_lead)))


@pytest.mark.parametrize("page_dtype", DTYPES)
@pytest.mark.parametrize("d,group,window", [(16, 2, None), (80, 1, 5)])
def test_quantized_flash_matches_jax_kernel(page_dtype, d, group, window):
    """The plain path widens through gather_pages(scale=) and attends: equal
    to the JAX Pallas quantized body (interpret mode) within 1e-4, with
    ragged kv_lens, stale out-of-strip table entries and an empty lane."""
    rng = np.random.RandomState(d + group)
    b, hkv, ps, n_pages, P = 3, 2, 8, 3, 11
    hq, skv = hkv * group, n_pages * ps
    dt_j = JPG.resolve_page_dtype(page_dtype)
    dt_t = PG.resolve_page_dtype(page_dtype)
    q = rng.randn(b, hq, 1, d).astype(np.float32)
    pools = {}
    for name in ("k", "v"):
        q8, sc = JPG.quantize_block(jnp.asarray(rng.randn(P, hkv, ps, d)
                                                .astype(np.float32)), dt_j)
        pools[name] = (q8, sc)
    table = rng.permutation(P)[:b * n_pages].reshape(b, n_pages).astype(np.int32)
    kv_lens = np.array([skv, 10, 0], np.int32)
    table[1, 2] = 10 ** 6                              # stale, out of the strip
    q_off = np.maximum(kv_lens - 1, 0)
    kw = dict(kv_lens=kv_lens, causal=True, window=window, q_offset=q_off,
              page_table=table)
    ref = np.asarray(jax_flash(jnp.asarray(q), pools["k"][0], pools["v"][0],
                               impl="kernel", k_scale=pools["k"][1],
                               v_scale=pools["v"][1],
                               **{k: jnp.asarray(v) if isinstance(v, np.ndarray)
                                  else v for k, v in kw.items()}))
    tt = {n: (torch.from_numpy(_bytes(pools[n][0]).copy()).view(dt_t),
              torch.from_numpy(np.asarray(pools[n][1]).copy())) for n in pools}
    out = flash_attention(torch.from_numpy(q), tt["k"][0], tt["v"][0],
                          k_scale=tt["k"][1], v_scale=tt["v"][1],
                          **{k: torch.from_numpy(v) if isinstance(v, np.ndarray)
                             else v for k, v in kw.items()})
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    assert not out[2].any()                          # kv_len 0 -> rows read 0


def test_quantized_flash_refuses_what_it_cannot_take():
    q = torch.zeros(1, 2, 1, 16)
    pool = torch.zeros(4, 2, 8, 16, dtype=torch.int8)
    sc = torch.zeros(4, 2, 8)
    table = torch.zeros(1, 2, dtype=torch.int32)
    with pytest.raises(ValueError, match="page_table"):
        flash_attention(q, q, q, k_scale=sc, v_scale=sc)
    with pytest.raises(ValueError, match="both"):
        flash_attention(q, pool, pool, page_table=table, k_scale=sc)
    with pytest.raises(ValueError, match="CUDA tensor"):
        K.flash_paged_quant_cuda(q, pool, pool, sc, sc, table,
                                 torch.ones(1, dtype=torch.int32),
                                 torch.zeros(1, dtype=torch.int32),
                                 torch.zeros(1, dtype=torch.int32),
                                 causal=False, scale=1.0)


@pytest.mark.parametrize("page_dtype", DTYPES)
@pytest.mark.parametrize("sq,group,body", [
    (1, 1, K.SPLIT_KV), (1, 16, K.SPLIT_KV), (4, 4, K.SPLIT_KV),
    (17, 1, K.CUDA_CORE),
])
def test_plan_paged_routes_narrow_pools(page_dtype, sq, group, body):
    """A bf16 decode call over int8/fp8 pools with at most 16 rows per KV
    head takes the split-KV body, on the grid of a bf16 pool of the same
    pages; more rows, a prefill at any row count, and f32 q the CUDA-core
    body."""
    pool = PG.resolve_page_dtype(page_dtype)
    args = (8, 2 * group, 2, sq, 65, 16, 80)
    plan = K.plan_paged(torch.bfloat16, pool, *args, decode=True)
    assert plan.body == body
    assert K.plan_paged(torch.bfloat16, pool, *args,
                        decode=False).body == K.CUDA_CORE
    if body == K.SPLIT_KV:
        assert plan == K.plan_paged(torch.bfloat16, torch.bfloat16, *args,
                                    decode=True)
        assert plan.scratch == (8, 2, K.split_grid(65 * 16), group * sq, 82)
    f32 = K.plan_paged(torch.float32, pool, *args, decode=True)
    assert f32.body == K.CUDA_CORE and f32.scratch is None


@pytest.mark.parametrize("page_dtype", DTYPES)
@pytest.mark.parametrize("d", [8, 40, 72, 100])
def test_plan_paged_refuses_narrow_head_dims_off_16(page_dtype, d):
    """Narrow K/V are read 16 elements (16 bytes) at a time: a head dim
    that is not a multiple of 16 is refused over int8/fp8 pools, on either
    body, and taken over a bf16 pool."""
    pool = PG.resolve_page_dtype(page_dtype)
    for dtype in (torch.bfloat16, torch.float32):
        with pytest.raises(ValueError, match="multiple of 16"):
            K.plan_paged(dtype, pool, 2, 4, 2, 1, 3, 16, d, decode=True)
    assert K.plan_paged(torch.bfloat16, torch.bfloat16, 2, 4, 2, 1, 3, 16,
                        d, decode=True).body == K.SPLIT_KV


@pytest.mark.parametrize("family", ["dense", "hybrid"])
def test_to_paged_and_view_match_jax(family):
    """to_paged(page_dtype="int8") of the same dense cache: pool bytes and
    scale pools equal JAX's, page by page; paged_view widens them and drops
    the scale keys, as JAX."""
    cfg_j, _, cfg_t, _ = (models() if family == "dense" else family_models(family))
    rng = np.random.RandomState(5)
    keys, lead = (("k", "v"), 2) if family == "dense" else (("shared_k", "shared_v"), 1)
    shp = (lead, 3, cfg_j.n_kv_heads, 13, cfg_j.resolved_head_dim)
    cache = {k: rng.randn(*shp).astype(np.float32) for k in keys}
    cache["pos"] = np.array([13, 4, 7], np.int32)
    if family == "hybrid":
        from repro_torch.models import hybrid as th
        extra = th._ssm_cache(cfg_t, 3, torch.float32, "cpu")
        cache.update({k: v.numpy() for k, v in extra.items() if k != "pos"})
    pj = j_to_paged(cfg_j, {k: jnp.asarray(v) for k, v in cache.items()},
                    page_size=4, pool_pages=14, page_dtype="int8")
    pt = to_paged(cfg_t, {k: torch.from_numpy(v) for k, v in cache.items()},
                  page_size=4, pool_pages=14, page_dtype="int8")
    assert sorted(pt) == sorted(pj) and is_quantized(pt)
    for k in pj:
        np.testing.assert_array_equal(_bytes(pt[k]), _bytes(pj[k]), err_msg=k)
    vj, vt = j_paged_view(cfg_j, pj), paged_view(cfg_t, pt)
    assert sorted(vt) == sorted(vj) and not any(k.endswith("_scale") for k in vt)
    for k in vj:
        np.testing.assert_array_equal(np_(vt[k]), np_(vj[k]), err_msg=k)


def _generate(family, engine_cls, page_dtype, paged_attn="native", page_size=8):
    cfg_j, params, cfg_t, model = (models() if family == "dense"
                                   else family_models(family))
    rng = np.random.RandomState(7)
    batch = {"tokens": rng.randint(1, cfg_j.vocab_size, (3, 12)),
             "lens": np.array([12, 5, 9], np.int32)}
    if engine_cls is JaxEngine:
        eng = JaxEngine(cfg_j, params, max_new_tokens=MAX_NEW, stop_token=-1,
                        page_dtype=page_dtype)
        res = eng.generate({k: jnp.asarray(v) for k, v in batch.items()},
                           page_size=page_size)
    else:
        eng = ServeEngine(cfg_t, model, max_new_tokens=MAX_NEW, stop_token=-1,
                          page_dtype=page_dtype, paged_attn=paged_attn,
                          device="cpu")
        res = eng.generate(batch, page_size=page_size)
    return np_(res["tokens"]), np_(res["n_generated"])


@pytest.mark.parametrize("family,page_dtype", [("dense", "int8"), ("dense", "fp8"),
                                               ("hybrid", "int8")])
def test_generate_matches_jax(family, page_dtype):
    tok_j, n_j = _generate(family, JaxEngine, page_dtype)
    tok_t, n_t = _generate(family, ServeEngine, page_dtype)
    np.testing.assert_array_equal(tok_t, tok_j)
    np.testing.assert_array_equal(n_t, n_j)


@pytest.mark.parametrize("family", ["dense", "hybrid"])
def test_int8_native_decode_matches_gather_oracle(family):
    """The reference's own invariant inside the port: native decode over
    int8 pools gives the tokens of the gather oracle, which dequantizes the
    same pool bytes into a dense view."""
    native = _generate(family, ServeEngine, "int8", page_size=4)
    oracle = _generate(family, ServeEngine, "int8", paged_attn="gather",
                       page_size=4)
    np.testing.assert_array_equal(native[0], oracle[0])
    np.testing.assert_array_equal(native[1], oracle[1])
