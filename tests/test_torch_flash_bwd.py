"""Port parity: the flash-attention backward of ``repro_torch`` on the CPU
(the plain PyTorch versions of the CUDA forward-with-lse and backward)
against the JAX package's custom VJP (``xla_impl._flash``: its forward's
row log-sum-exp and ``jax.vjp`` of ``flash_attention(impl="xla")``), over
causal and non-causal masks, sliding windows, ragged and empty lanes, an
explicit ``q_offset``, Sq != Skv and GQA.  f32, atol = rtol = 1e-5.  Then
the autograd route against autograd through the plain attention
(``mha_ref``) and the route's contract: fully masked rows get 0, serving
(no grad) keeps today's route, the CUDA wrappers refuse CPU tensors."""

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.core import vla
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.flash_attention import ops as jax_ops
from repro.kernels.flash_attention import xla_impl
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention import kernel as K
from repro_torch.kernels.flash_attention import ref as R

TOL = dict(atol=1e-5, rtol=1e-5)
NO_WINDOW = 2 ** 30

torch.set_num_threads(1)


def _inputs(seed, b, hkv, group, sq, skv, d):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, hkv * group, sq, d).astype(np.float32)
    k = rng.randn(b, hkv, skv, d).astype(np.float32)
    v = rng.randn(b, hkv, skv, d).astype(np.float32)
    dout = rng.randn(b, hkv * group, sq, d).astype(np.float32)
    return q, k, v, dout


def _jax_lse(q, k, v, kv_lens, q_offset, window, causal):
    """The row lse of the JAX forward, padded as its op pads."""
    b, h, sq, d = q.shape
    skv = k.shape[2]
    bq, bk = jax_ops._pick_blocks(sq, skv, d, q.dtype)
    bq = min(bq, vla.pad_to_vl(sq, 8))
    sq_p, skv_p = vla.pad_to_vl(sq, bq), vla.pad_to_vl(skv, bk)
    pad = lambda x, n: jnp.pad(x, ((0, 0), (0, 0), (0, n - x.shape[2]), (0, 0)))
    _, lse = xla_impl._flash_fwd_impl(
        pad(jnp.asarray(q), sq_p), pad(jnp.asarray(k), skv_p),
        pad(jnp.asarray(v), skv_p), jnp.asarray(kv_lens), jnp.asarray(q_offset),
        jnp.int32(NO_WINDOW if window is None else window), causal,
        float(d ** -0.5), bq, bk)
    return np.asarray(lse)[:, :, :sq]


# (hkv, group, sq, skv): square, Sq < Skv (suffix aligned under causal; a
# decoder over encoder frames without), Sq > Skv (an encoder over fewer
# keys), every shape with GQA groups 1 and 4 over the test's masks
SHAPES = [(2, 1, 12, 12), (1, 4, 7, 20), (2, 1, 20, 9), (1, 4, 140, 140)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("causal", [False, True])
def test_plain_backward_matches_jax_vjp(causal, window, shape):
    hkv, group, sq, skv = shape
    b, d = 3, 16
    q, k, v, dout = _inputs(sq + 3 * skv + group, b, hkv, group, sq, skv, d)
    kv_lens = np.array([skv, skv // 2, 0], np.int32)   # ragged, one empty lane
    q_offset = np.full((b,), skv - sq if causal else 0, np.int32)

    def f(q, k, v):
        return jax_flash(q, k, v, kv_lens=kv_lens, causal=causal, window=window,
                         impl="xla")
    out_j, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    grads_j = vjp(jnp.asarray(dout))
    lse_j = _jax_lse(q, k, v, kv_lens, q_offset, window, causal)

    t = lambda x: torch.from_numpy(x)
    kw = dict(kv_lens=t(kv_lens), q_offset=t(q_offset), window=window,
              causal=causal)
    out, lse = R.flash_fwd_lse(t(q), t(k), t(v), **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), **TOL)
    np.testing.assert_allclose(lse.numpy(), lse_j, **TOL)
    grads = R.flash_bwd(t(q), t(k), t(v), out, t(dout), lse, **kw)
    for g, gj in zip(grads, grads_j):
        np.testing.assert_allclose(g.numpy(), np.asarray(gj), **TOL)
        assert torch.isfinite(g).all()
    assert not grads[0][2].any() and not grads[1][2].any() \
        and not grads[2][2].any()                    # the empty lane: exactly 0


def test_explicit_q_offset_matches_jax_vjp():
    """Per-lane query offsets other than Skv - Sq: lane 1 starts before key
    0, so its first rows attend no key (lse -1e30, gradient exactly 0)."""
    b, hkv, group, sq, skv, d = 3, 1, 2, 9, 16, 16
    q, k, v, dout = _inputs(5, b, hkv, group, sq, skv, d)
    kv_lens = np.array([16, 12, 3], np.int32)
    q_offset = np.array([4, -3, 0], np.int32)

    def f(q, k, v):
        return jax_flash(q, k, v, kv_lens=kv_lens, causal=True,
                         q_offset=q_offset, impl="xla")
    _, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    grads_j = vjp(jnp.asarray(dout))
    t = lambda x: torch.from_numpy(x)
    kw = dict(kv_lens=t(kv_lens), q_offset=t(q_offset), causal=True)
    out, lse = R.flash_fwd_lse(t(q), t(k), t(v), **kw)
    np.testing.assert_allclose(
        lse.numpy(), _jax_lse(q, k, v, kv_lens, q_offset, None, True), **TOL)
    assert (lse[1, :, :3] < -1e29).all()
    grads = R.flash_bwd(t(q), t(k), t(v), out, t(dout), lse, **kw)
    for g, gj in zip(grads, grads_j):
        np.testing.assert_allclose(g.numpy(), np.asarray(gj), **TOL)
    assert not grads[0][1, :, :3].any()


@pytest.mark.parametrize("window", [None, 6])
@pytest.mark.parametrize("group", [1, 2])
def test_autograd_route_matches_autograd_through_plain(group, window):
    """``flash_attention`` on tensors that require grad (the autograd
    route) == autograd through ``mha_ref`` (``impl="naive"``)."""
    b, hkv, sq, skv, d = 2, 2, 11, 11, 8
    q, k, v, dout = _inputs(group, b, hkv, group, sq, skv, d)
    kv_lens = torch.tensor([11, 5], dtype=torch.int32)
    grads = []
    for impl in ("xla", "naive"):
        leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
        out = flash_attention(*leaves, kv_lens=kv_lens, causal=True,
                              window=window, impl=impl)
        grads.append(torch.autograd.grad(out, leaves, torch.from_numpy(dout)))
    for g, w in zip(*grads):
        torch.testing.assert_close(g, w, **TOL)


def test_route_contract():
    """No grad -> today's route and bits; a CPU tensor never reaches the
    CUDA wrappers, which refuse it."""
    q, k, v, dout = _inputs(0, 1, 1, 2, 6, 6, 8)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    with torch.inference_mode():
        served = flash_attention(tq, tk, tv, causal=True)
    assert torch.equal(served, R.mha_ref(tq, tk, tv, causal=True))
    lens = torch.tensor([6], dtype=torch.int32)
    zero = torch.zeros(1, dtype=torch.int32)
    win = torch.tensor([NO_WINDOW], dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        K.flash_bwd_cuda(tq, tk, tv, tq, tq, torch.zeros(1, 2, 6), lens, zero,
                         win, causal=True, scale=1.0)
    with pytest.raises(ValueError, match="CUDA"):
        K.flash_dense_lse_cuda(tq, tk, tv, lens, zero, win, causal=True,
                               scale=1.0)


@pytest.mark.parametrize("d", [64, 80, 128, 160])
def test_bwd_launch_plan(d):
    """The wgmma backward's plan at the configs' head dims: no padding,
    each pass's shared memory within one block's 227 KB, three launches a
    call (delta, dQ, dK/dV) at every head dim, D 160 included, and query
    tiles of 48 rows at D 128 and 32 at D 160 (dK and dV of 64 keys x D
    beside S^T and dP^T in the consumers' registers)."""
    plan = K.plan_bwd_launch(d)
    assert plan.d_pad == d and plan.boxes == -(-d // 64)
    assert max(plan.smem_dq, plan.smem_kv) <= 232448   # one H100 block's shared memory
    assert plan.launches == 3
    assert plan.q_tile == {64: 64, 80: 64, 128: 48, 160: 32}[d]
    assert min(plan.stages_dq, plan.stages_kv) >= 2
    assert K.plan_bwd(torch.bfloat16, d) == K.WGMMA
    assert K.plan_bwd(torch.float32, d) == K.CUDA_CORE


@pytest.mark.parametrize("d", [1, 16, 37, 72, 100, 150])
def test_bwd_launch_plan_pads_other_head_dims(d):
    """Any other head dim pads (zero columns) to the next instance."""
    plan = K.plan_bwd_launch(d)
    assert plan.d_pad == min(w for w in K.BWD_HEAD_DIMS if w >= d)
    assert plan == K.plan_bwd_launch(plan.d_pad)


def _bwd_rounded(p, ds, k, q, dout, mode):
    """dq, dk, dv of the wgmma body's products with P and dS entering them
    as ONE bf16 value ("one") or as hi + lo bf16 halves ("hilo"), f64
    otherwise (the body's sums are f32)."""
    r = lambda x: x.to(torch.bfloat16).double()
    if mode == "hilo":
        p, ds = r(p) + r(p - r(p)), r(ds) + r(ds - r(ds))
    else:
        p, ds = r(p), r(ds)
    return ds @ k, ds.T @ q, p.T @ dout


def test_one_bf16_operand_fails_the_bwd_limit():
    """Why the wgmma body keeps P and dS as hi + lo bf16 halves: a model of
    its rounding (bf16 inputs, f64 sums, each gradient rounded once to
    bf16) against the exact backward rounded to bf16, at ``chip_smoke.py``'s
    ``TOL["bwd"]`` (atol 1e-3, rtol 2^-7), one causal head of 64 x 64 keys
    at D 64 and 80.  hi + lo stays within the limit; one bf16 operand
    exceeds it in every gradient."""
    atol, rtol = 1e-3, 2 ** -7
    bf = lambda x: x.to(torch.bfloat16).double()
    for d in (64, 80):
        g = torch.Generator().manual_seed(d)
        q, k, v, dout = (bf(torch.randn(64, d, generator=g)) for _ in range(4))
        scale = d ** -0.5
        pred = torch.ones(64, 64, dtype=torch.bool).tril()
        s = (q @ k.T * scale).masked_fill(~pred, float("-inf"))
        p = torch.softmax(s, -1)
        out = bf(p @ v)
        delta = (dout * out).sum(-1, keepdim=True)
        ds = p * (dout @ v.T - delta) * scale
        exact = (ds @ k, ds.T @ q, p.T @ dout)
        ratio = {}
        for mode in ("hilo", "one"):
            got = _bwd_rounded(p, ds, k, q, dout, mode)
            ratio[mode] = [float(((bf(x) - bf(w)).abs() / (atol + rtol * bf(w).abs())).max())
                           for x, w in zip(got, exact)]
        print(f"d {d}: tol_ratio (dq, dk, dv) hi + lo {ratio['hilo']}, one bf16 {ratio['one']}")
        assert max(ratio["hilo"]) <= 1.0
        assert min(ratio["one"]) > 1.0
