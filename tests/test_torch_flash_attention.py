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
