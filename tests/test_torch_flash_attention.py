"""Port parity: flash attention (dense and paged) of ``repro_torch`` on the
CPU — the plain PyTorch version of the CUDA kernels — against the JAX
package's Pallas kernel (interpret mode) and its naive oracle.  f32,
atol = rtol = 1e-5: the same f32 arithmetic summed in another order."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
import numpy as np

from repro.kernels.flash_attention import flash_attention as jax_flash
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention import kernel as K

TOL = dict(atol=1e-5, rtol=1e-5)


def _inputs(rng, b, hq, hkv, sq, skv, d):
    q = rng.randn(b, hq, sq, d).astype(np.float32)
    k = rng.randn(b, hkv, skv, d).astype(np.float32)
    v = rng.randn(b, hkv, skv, d).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("d", [16, 80])
@pytest.mark.parametrize("group", [1, 2])
@pytest.mark.parametrize("window", [None, 4])
@pytest.mark.parametrize("causal", [False, True])
def test_dense_matches_jax(causal, window, group, d):
    rng = np.random.RandomState(d + 7 * group + 3 * causal)
    b, hkv, sq, skv = 3, 2, 5, 13
    q, k, v = _inputs(rng, b, hkv * group, hkv, sq, skv, d)
    kv_lens = np.array([13, 6, 0], np.int32)      # ragged, one empty lane
    q_offset = np.array([8, 1, 0], np.int32)      # per-row decode positions
    kw = dict(kv_lens=kv_lens, causal=causal, window=window, q_offset=q_offset)
    ref_k = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 impl="kernel", **kw))
    ref_n = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 impl="naive", **kw))
    out = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), impl="kernel",
                          kv_lens=torch.from_numpy(kv_lens), causal=causal,
                          window=window, q_offset=torch.from_numpy(q_offset))
    assert out.dtype == torch.float32 and out.shape == q.shape
    np.testing.assert_allclose(out.numpy(), ref_k, **TOL)
    np.testing.assert_allclose(out.numpy(), ref_n, **TOL)
    assert not out[2].any()                       # kv_len 0 -> rows read 0


@pytest.mark.parametrize("causal", [False, True])
def test_dense_defaults_suffix_alignment(causal):
    """kv_lens / q_offset defaults: full length, and Skv - Sq under causal."""
    rng = np.random.RandomState(11)
    q, k, v = _inputs(rng, 2, 4, 2, 3, 9, 16)
    ref = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               causal=causal, impl="kernel"))
    out = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), causal=causal)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


@pytest.mark.parametrize("sq,causal,window", [(1, False, None), (1, False, 5),
                                              (3, True, None)])
@pytest.mark.parametrize("group", [1, 2])
def test_paged_matches_jax(sq, causal, window, group):
    """Shuffled page table with stale out-of-strip entries (ids past the
    pool): the op clamps them to page 0 before the table is followed."""
    rng = np.random.RandomState(5 + sq + group)
    b, hkv, d, ps, n_pages, n_pool = 3, 2, 16, 4, 4, 14
    q = rng.randn(b, hkv * group, sq, d).astype(np.float32)
    k_pool = rng.randn(n_pool, hkv, ps, d).astype(np.float32)
    v_pool = rng.randn(n_pool, hkv, ps, d).astype(np.float32)
    table = rng.permutation(n_pool)[:b * n_pages].reshape(b, n_pages)
    table = table.astype(np.int32)
    kv_lens = np.array([16, 6, 0], np.int32)
    table[1, 2:] = 99                              # stale, past the strip
    table[2, :] = 57
    q_offset = kv_lens - sq if causal else kv_lens - 1
    q_offset = np.maximum(q_offset, 0).astype(np.int32)
    kw = dict(kv_lens=kv_lens, causal=causal, window=window, q_offset=q_offset)
    ref_k = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k_pool),
                                 jnp.asarray(v_pool), impl="kernel",
                                 page_table=jnp.asarray(table), **kw))
    ref_n = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k_pool),
                                 jnp.asarray(v_pool), impl="naive",
                                 page_table=jnp.asarray(table), **kw))
    out = flash_attention(torch.from_numpy(q), torch.from_numpy(k_pool),
                          torch.from_numpy(v_pool),
                          page_table=torch.from_numpy(table),
                          kv_lens=torch.from_numpy(kv_lens), causal=causal,
                          window=window, q_offset=torch.from_numpy(q_offset))
    np.testing.assert_allclose(out.numpy(), ref_k, **TOL)
    np.testing.assert_allclose(out.numpy(), ref_n, **TOL)
    assert not out[2].any()


def test_kernel_wrappers_refuse_cpu_tensors():
    """The CUDA wrappers take CUDA tensors only; the CPU route is the op's."""
    q = torch.zeros(1, 2, 1, 16)
    kv = torch.zeros(1, 2, 4, 16)
    i32 = dict(kv_lens=torch.ones(1, dtype=torch.int32),
               q_offset=torch.zeros(1, dtype=torch.int32),
               window=torch.full((1,), 2 ** 30, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        K.flash_dense_cuda(q, kv, kv, **i32, causal=False, scale=0.25)
    with pytest.raises(ValueError, match="CUDA"):
        K.flash_paged_cuda(q, kv, kv, torch.zeros(1, 1, dtype=torch.int32),
                           **i32, causal=False, scale=0.25)
    assert K.flash_dense_cuda.launches == 0 and K.flash_paged_cuda.launches == 0


def test_unknown_impl_raises():
    q = torch.zeros(1, 1, 1, 8)
    with pytest.raises(ValueError, match="impl"):
        flash_attention(q, q, q, impl="pallas")


@pytest.mark.parametrize("d", [64, 80, 128])
@pytest.mark.parametrize("b,hq,hkv,sq,skv,body", [
    (8, 32, 32, 963, 1027, K.TENSOR_CORE),    # prefill at the smoke shapes
    (3, 4, 2, 9, 90, K.TENSOR_CORE),          # 18 rows per KV head
    (8, 32, 32, 1, 1027, K.SPLIT_KV),         # decode
    (3, 8, 2, 4, 77, K.SPLIT_KV),             # GQA group 4, 16 rows
    (2, 2, 1, 1, 40, K.SPLIT_KV),             # Skv below one tile
])
def test_plan_routes_bf16_by_rows(b, hq, hkv, sq, skv, body, d):
    """bf16 with more than 16 rows per KV head (group * Sq) takes the
    tensor-core body on 64-row CTAs; with at most 16 the split-KV body on
    a grid of ``split_grid(skv)`` splits per (KV head, lane), with
    (B, Hkv, splits, rows, D + 2) f32 scratch."""
    plan = K.plan_dense(torch.bfloat16, b, hq, hkv, sq, skv, d)
    assert plan.body == body
    if body == K.TENSOR_CORE:
        assert plan.splits == 1 and plan.scratch is None
    else:
        rows = (hq // hkv) * sq
        assert plan.scratch == (b, hkv, plan.splits, rows, d + 2)
        assert plan.splits == K.split_grid(skv)
        assert 1 <= plan.splits <= K.MAX_SPLITS


@pytest.mark.parametrize("sq,skv", [(1, 1027), (963, 1027), (3, 10)])
def test_plan_f32_takes_cuda_core_body(sq, skv):
    """f32 stays on the CUDA-core body: the tensor cores would round it to
    TF32."""
    plan = K.plan_dense(torch.float32, 2, 4, 2, sq, skv, 80)
    assert plan.body == K.CUDA_CORE and plan.scratch is None


def _lanes(skv):
    """(kv_len, q_offset, sq, causal, window) of decode lanes that fit in a
    cache of ``skv`` keys: full, ragged, one key, empty, windowed."""
    lens = sorted({skv, max(skv // 2, 1), min(5, skv), 1, 0})
    lanes = [(n, max(n - 1, 0), 1, True, None) for n in lens]
    lanes += [(n, max(n - 1, 0), 1, False, 100) for n in lens]
    return lanes


@pytest.mark.parametrize("skv", [1, 40, 127, 128, 1027, 4097, 10 ** 5])
@pytest.mark.parametrize("b,hkv", [(1, 1), (8, 1), (8, 32)])
def test_lane_splits_do_not_depend_on_the_call(b, hkv, skv):
    """A lane's split boundaries follow from its own kv_len, q_offset and
    window (``lane_splits`` takes nothing else), whatever the batch, the KV
    heads and the cache's allocated length: every lane that fits in a
    cache of ``skv`` keys has the same splits in any larger cache, and all
    of them inside the plan's grid, which the scratch covers."""
    plan = K.plan_dense(torch.bfloat16, b, hkv, hkv, 1, skv, 64)
    assert plan.body == K.SPLIT_KV
    assert plan.scratch == (b, hkv, plan.splits, 1, 66)
    for kv_len, q_offset, sq, causal, window in _lanes(skv):
        splits = K.lane_splits(kv_len, q_offset, sq, causal=causal,
                               window=window)
        span = K.split_span(kv_len)
        assert all(hi <= (lo // span + 1) * span for lo, hi in splits)
        assert all(lo // span < plan.splits for lo, _ in splits)
        for bigger in (skv + 1, 2 * skv + 63, 10 ** 6):
            grid = K.plan_dense(torch.bfloat16, b, hkv, hkv, 1, bigger,
                                64).splits
            assert grid >= plan.splits
            assert all(lo // span < grid for lo, _ in splits)


@pytest.mark.parametrize("kv_len,q_offset,sq,causal,window", [
    (1027, 1026, 1, True, None),      # stablelm decode, longest lane
    (320, 319, 1, False, None),       # shortest lane of the smoke batch
    (1027, 1026, 1, True, 300),       # a window: splits below it skipped
    (100, 90, 10, True, None),        # a short chunk of 10 rows
    (0, 0, 1, True, None),            # an empty lane: no split
    (5, 4, 1, False, 2),              # fewer live keys than one tile
    (10 ** 5, 10 ** 5 - 1, 1, True, None),   # the span doubles
    (64 * 256, 64 * 256 - 1, 1, True, None),  # exactly MAX_SPLITS spans
])
def test_lane_splits_partition_the_live_keys(kv_len, q_offset, sq, causal,
                                             window):
    """The splits of a lane are disjoint, in key order, and cover exactly
    the keys some row may attend; each lies inside one span of
    ``split_span(kv_len)`` keys at a fixed absolute position (a multiple of
    the 64-key tile, ``SPLIT_KEYS`` doubled until at most ``MAX_SPLITS``
    splits cover the lane); every split but the first starts on a span
    boundary."""
    splits = K.lane_splits(kv_len, q_offset, sq, causal=causal, window=window)
    k_begin = 0 if window is None else max(q_offset - window + 1, 0)
    k_end = min(kv_len, q_offset + sq) if causal else kv_len
    covered = [k for lo, hi in splits for k in range(lo, hi)]
    assert covered == list(range(k_begin, max(k_end, k_begin)))
    span = K.split_span(kv_len)
    assert span % K.TILE_KEYS == 0 and span % K.SPLIT_KEYS == 0
    assert (span // K.SPLIT_KEYS) & (span // K.SPLIT_KEYS - 1) == 0
    assert -(-kv_len // span) <= K.MAX_SPLITS
    assert span == K.SPLIT_KEYS or -(-kv_len // (span // 2)) > K.MAX_SPLITS
    for i, (lo, hi) in enumerate(splits):
        assert lo < hi and lo // span == (hi - 1) // span
        assert i == 0 or lo % span == 0
    assert len(splits) <= K.split_grid(kv_len)


@pytest.mark.parametrize("dtype,pool,sq,group,body", [
    (torch.bfloat16, torch.bfloat16, 1, 1, K.SPLIT_KV),     # decode
    (torch.bfloat16, torch.bfloat16, 4, 4, K.SPLIT_KV),     # 16 rows
    (torch.bfloat16, torch.bfloat16, 17, 1, K.CUDA_CORE),   # a longer chunk
    (torch.bfloat16, torch.bfloat16, 3, 8, K.CUDA_CORE),    # 24 rows
    (torch.float32, torch.float32, 1, 1, K.CUDA_CORE),      # f32 decode
    (torch.float32, torch.float32, 40, 2, K.CUDA_CORE),
])
def test_plan_paged_routes_by_dtype_and_rows(dtype, pool, sq, group, body):
    """bf16 q with at most 16 rows per KV head takes the split-KV body on
    the grid a dense cache of n_pages * ps keys would take; f32 q (the
    template of f32 dense decode) and more rows the CUDA-core body."""
    b, hkv, n_pages, ps, d = 8, 4, 65, 16, 80
    plan = K.plan_paged(dtype, pool, b, hkv * group, hkv, sq, n_pages, ps, d)
    assert plan.body == body
    if body == K.SPLIT_KV:
        dense = K.plan_dense(dtype, b, hkv * group, hkv, sq, n_pages * ps, d)
        assert plan == dense
        assert plan.scratch == (b, hkv, plan.splits, group * sq, d + 2)
    else:
        assert plan.splits == 1 and plan.scratch is None


def test_plan_paged_refuses_what_no_body_takes():
    with pytest.raises(ValueError):
        K.plan_paged(torch.bfloat16, torch.bfloat16, 1, 2, 2, 1, 4, 16, 160)
    with pytest.raises(ValueError):
        K.plan_paged(torch.bfloat16, torch.float32, 1, 2, 2, 1, 4, 16, 64)
    with pytest.raises(ValueError):
        K.plan_paged(torch.float16, torch.float16, 1, 2, 2, 1, 4, 16, 64)


def test_plan_refuses_what_no_body_takes():
    with pytest.raises(ValueError):
        K.plan_dense(torch.bfloat16, 1, 2, 2, 1, 8, 160)
    with pytest.raises(ValueError):
        K.plan_dense(torch.bfloat16, 1, 3, 2, 1, 8, 64)
    with pytest.raises(ValueError):
        K.plan_dense(torch.float16, 1, 2, 2, 1, 8, 64)
