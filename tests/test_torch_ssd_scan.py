"""Port parity: the SSD-scan ops of ``repro_torch`` (on the CPU, the plain
PyTorch versions) against ``repro.kernels.ssd_scan`` with its Pallas kernel
in interpret mode; and the port's own invariants, mirroring
``tests/test_kernel_ssd_scan.py``.  f32, atol = rtol = 1e-4 unless stated."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
import numpy as np
from torch_parity import TOL, np_

from repro.kernels import ssd_scan as jssd
from repro.kernels.ssd_scan import ref as jref
from repro_torch.kernels import ssd_scan as tssd
from repro_torch.kernels.ssd_scan import kernel as tkernel
from repro_torch.kernels.ssd_scan import ref as tref


def _mk(bz, s, h, p, n, seed=0):
    """numpy inputs of the JAX package's SSD tests, plus an initial state."""
    rng = np.random.RandomState(seed)
    f32 = np.float32
    return dict(
        x=rng.randn(bz, s, h, p).astype(f32),
        dt=(np.abs(rng.randn(bz, s, h)) * 0.1 + 0.01).astype(f32),
        A=(-np.abs(rng.randn(h)) - 0.1).astype(f32),
        B=(rng.randn(bz, s, n) * 0.3).astype(f32),
        C=(rng.randn(bz, s, n) * 0.3).astype(f32),
        D=rng.randn(h).astype(f32),
        h0=(rng.randn(bz, h, p, n) * 0.5).astype(f32))


def _j(a):
    return {k: jnp.asarray(v) for k, v in a.items()}


def _t(a):
    return {k: torch.from_numpy(v) for k, v in a.items()}


def _close(got, want, **tol):
    for g, w in zip(got, want):
        np.testing.assert_allclose(np_(g), np_(w), **(tol or TOL))


@pytest.mark.parametrize("chunk", [32, 64, 128])
def test_ssd_scan_matches_jax(chunk):
    """Ragged seq_lens, a non-zero h0, the D skip and S = 200 (not a
    multiple of any chunk here)."""
    a = _mk(2, 200, 3, 16, 32, seed=chunk)
    lens = np.array([200, 77], np.int32)
    j, t = _j(a), _t(a)
    want = jssd.ssd_scan(j["x"], j["dt"], j["A"], j["B"], j["C"], j["D"],
                         seq_lens=jnp.asarray(lens), h0=j["h0"], chunk=chunk,
                         impl="kernel")
    got = tssd.ssd_scan(t["x"], t["dt"], t["A"], t["B"], t["C"], t["D"],
                        seq_lens=torch.from_numpy(lens), h0=t["h0"],
                        chunk=chunk, impl="kernel")
    _close(got, want)


@pytest.mark.parametrize("chunk", [32, 64, 128])
def test_ssd_refs_match_jax(chunk):
    """The sequential oracle and the chunked algorithm, each against its JAX
    twin, with D and h0."""
    a = _mk(2, 256, 3, 16, 32, seed=10 + chunk)
    j, t = _j(a), _t(a)
    args_j = (j["x"], j["dt"], j["A"], j["B"], j["C"], j["D"])
    args_t = (t["x"], t["dt"], t["A"], t["B"], t["C"], t["D"])
    _close(tref.ssd_ref(*args_t, h0=t["h0"]), jref.ssd_ref(*args_j, h0=j["h0"]))
    _close(tref.ssd_chunked_ref(*args_t, h0=t["h0"], chunk=chunk),
           jref.ssd_chunked_ref(*args_j, h0=j["h0"], chunk=chunk))


def test_segsum_matches_jax():
    a = np.random.RandomState(3).randn(2, 3, 16).astype(np.float32)
    want = np_(jref._segsum(jnp.asarray(a)))
    got = np_(tref._segsum(torch.from_numpy(a)))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], **TOL)


@pytest.mark.parametrize("chunk", [32, 64, 96])
def test_chunk_invariance(chunk):
    """The chunk is this scan's vector length: every chunk gives the result of
    the sequential oracle."""
    t = _t(_mk(1, 192, 2, 8, 16, seed=2))
    args = (t["x"], t["dt"], t["A"], t["B"], t["C"], t["D"])
    _close(tssd.ssd_scan(*args, chunk=chunk), tref.ssd_ref(*args))


def test_ragged_tail_predication():
    """Past a row's length dt is predicated to 0: the state carries
    unchanged and the valid prefix equals the unpadded run."""
    t = _t(_mk(2, 100, 2, 8, 16, seed=3))
    args = (t["x"], t["dt"], t["A"], t["B"], t["C"], t["D"])
    y_full, _ = tref.ssd_ref(*args)
    y, hT = tssd.ssd_scan(*args, seq_lens=torch.tensor([100, 60]), chunk=64)
    np.testing.assert_allclose(np_(y[0]), np_(y_full[0]), **TOL)
    y60, h60 = tref.ssd_ref(t["x"][1:2, :60], t["dt"][1:2, :60], t["A"],
                            t["B"][1:2, :60], t["C"][1:2, :60], t["D"])
    np.testing.assert_allclose(np_(y[1, :60]), np_(y60[0]), **TOL)
    np.testing.assert_allclose(np_(hT[1]), np_(h60[0]), **TOL)


@pytest.mark.parametrize("with_d", [True, False])
def test_decode_step_matches_jax(with_d):
    a = _mk(3, 1, 4, 8, 16, seed=4)
    j, t = _j(a), _t(a)
    D_j, D_t = (j["D"], t["D"]) if with_d else (None, None)
    want = jssd.ssd_decode_step(j["x"][:, 0], j["dt"][:, 0], j["A"],
                                j["B"][:, 0], j["C"][:, 0], j["h0"], D_j)
    got = tssd.ssd_decode_step(t["x"][:, 0], t["dt"][:, 0], t["A"],
                               t["B"][:, 0], t["C"][:, 0], t["h0"], D_t)
    _close(got, want)


def test_decode_steps_continue_the_scan():
    """Prefill state + N decode steps == the full scan's suffix."""
    t = _t(_mk(1, 64, 2, 8, 16, seed=5))
    y_all, _ = tref.ssd_ref(t["x"], t["dt"], t["A"], t["B"], t["C"], t["D"])
    _, h = tssd.ssd_scan(t["x"][:, :48], t["dt"][:, :48], t["A"],
                         t["B"][:, :48], t["C"][:, :48], t["D"], chunk=16)
    ys = []
    for s in range(48, 64):
        y_t, h = tssd.ssd_decode_step(t["x"][:, s], t["dt"][:, s], t["A"],
                                      t["B"][:, s], t["C"][:, s], h, t["D"])
        ys.append(y_t)
    np.testing.assert_allclose(np_(torch.stack(ys, 1)), np_(y_all[:, 48:]), **TOL)


def test_bf16_inputs():
    """bf16 x, B, C: y comes back in bf16, near the f32 oracle on the same
    rounded inputs (5e-2: y is rounded to bf16)."""
    t = _t(_mk(1, 128, 2, 8, 16, seed=6))
    bf = torch.bfloat16
    xb, Bb, Cb = t["x"].to(bf), t["B"].to(bf), t["C"].to(bf)
    y, _ = tssd.ssd_scan(xb, t["dt"], t["A"], Bb, Cb, t["D"], chunk=64)
    y_ref, _ = tref.ssd_ref(xb, t["dt"], t["A"], Bb, Cb, t["D"])
    assert y.dtype == bf
    np.testing.assert_allclose(np_(y.float()), np_(y_ref.float()),
                               rtol=5e-2, atol=5e-2)


def test_unknown_impl_raises():
    t = _t(_mk(1, 8, 1, 4, 4))
    with pytest.raises(ValueError, match="impl"):
        tssd.ssd_scan(t["x"], t["dt"], t["A"], t["B"], t["C"], impl="pallas")


def test_cuda_wrapper_refuses_cpu_tensors():
    """The kernel's wrapper takes CUDA tensors only: nothing falls back."""
    t = _t(_mk(1, 8, 1, 4, 4))
    before = tkernel.ssd_scan_cuda.launches
    bodies = dict(tkernel.ssd_scan_cuda.body_launches)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tkernel.ssd_scan_cuda(t["x"], t["dt"], t["A"], t["B"], t["C"],
                              t["h0"], chunk=8)
    tssd.ssd_scan(t["x"], t["dt"], t["A"], t["B"], t["C"], chunk=8)
    assert tkernel.ssd_scan_cuda.launches == before
    assert tkernel.ssd_scan_cuda.body_launches == bodies
    assert set(bodies) == set(tkernel.BODIES)


@pytest.mark.parametrize("p,n", [(64, 64), (64, 128)])
def test_serving_shapes_fit_shared_memory(p, n):
    """zamba2-1.2b (P 64, N 64) and mamba2-130m (P 64, N 128) at chunk 128
    fit one block's 227 KB of shared memory."""
    assert tkernel.smem_bytes(128, p, n) <= tkernel.MAX_SMEM_BYTES


@pytest.mark.parametrize("dtype,chunk,p,n,body", [
    (torch.bfloat16, 128, 64, 64, tkernel.TENSOR_CORE),    # zamba2-1.2b
    (torch.bfloat16, 128, 64, 128, tkernel.TENSOR_CORE),   # mamba2-130m
    (torch.bfloat16, 16, 16, 16, tkernel.TENSOR_CORE),
    (torch.bfloat16, 64, 48, 32, tkernel.TENSOR_CORE),
    (torch.float32, 128, 64, 64, tkernel.CUDA_CORE),
    (torch.float32, 128, 64, 128, tkernel.CUDA_CORE),
    (torch.bfloat16, 40, 64, 128, tkernel.CUDA_CORE),      # chunk off the 16-grid
    (torch.bfloat16, 64, 8, 16, tkernel.CUDA_CORE),        # P off the grid
    (torch.bfloat16, 40, 16, 16, tkernel.CUDA_CORE),
    (torch.bfloat16, 64, 64, 24, tkernel.CUDA_CORE),       # N off the grid
])
def test_plan_routes_by_shape(dtype, chunk, p, n, body):
    """bf16 on the 16-grid takes the tensor-core body; f32 and shapes off
    the grid the CUDA-core body, whose grid is one block per (head, lane)."""
    plan = tkernel.plan_ssd(dtype, 8, 963, 24, p, n, chunk)
    assert plan.body == body
    if body == tkernel.CUDA_CORE:
        assert plan.grid == (24, 8, 1) and plan.slice == p
        assert plan.smem == tkernel.smem_bytes(chunk, p, n)


def test_plan_refuses_what_no_body_takes():
    with pytest.raises(ValueError, match="chunk"):
        tkernel.plan_ssd(torch.float32, 1, 8, 1, 16, 16, 6)
    with pytest.raises(ValueError, match="dtype"):
        tkernel.plan_ssd(torch.float16, 1, 8, 1, 16, 16, 16)


@pytest.mark.parametrize("slice_", tkernel.SLICES)
@pytest.mark.parametrize("n", [64, 128])
def test_tensor_core_serving_shapes_fit_shared_memory(slice_, n):
    """zamba2-1.2b (N 64) and mamba2-130m (N 128) at chunk 128 fit one
    block's 227 KB on the tensor-core body at every slice width."""
    assert (tkernel.smem_bytes(128, slice_, n, tkernel.TENSOR_CORE)
            <= tkernel.MAX_SMEM_BYTES)


def test_tensor_core_smem_formula_matches_the_source_header():
    """The figures the source's header gives for slices of 64 head dims."""
    tc = tkernel.TENSOR_CORE
    assert tkernel.smem_bytes(128, 64, 64, tc) == 115_712
    assert tkernel.smem_bytes(128, 64, 128, tc) == 181_248


@pytest.mark.parametrize("p,slice_", [(16, 16), (32, 32), (48, 16), (64, 64),
                                      (96, 32), (128, 64)])
def test_tensor_core_grid_covers_p(p, slice_):
    """Slices of one width, the widest up to ``SLICE`` that divides P, tile
    P exactly: grid (P / slice, H, Bz)."""
    plan = tkernel.plan_ssd(torch.bfloat16, 8, 963, 64, p, 64, 128)
    assert plan.body == tkernel.TENSOR_CORE
    assert plan.slice == slice_ and tkernel.SLICE == 64
    assert plan.grid == (p // plan.slice, 64, 8)
    assert plan.grid[0] * plan.slice == p
    assert plan.smem == tkernel.smem_bytes(128, plan.slice, 64,
                                           tkernel.TENSOR_CORE)


# one bf16 rounding step of y, and h_final as the card holds them
Y_TOL = dict(atol=1e-5, rtol=2 ** -7)
H_TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("bz,s,h,p,n,chunk", [
    (2, 256, 3, 32, 64, 64),
    (1, 256, 2, 64, 128, 128),     # mamba2-130m's head at chunk 128
    (2, 128, 2, 64, 64, 128),      # zamba2-1.2b's head
])
def test_tensor_core_precision_model_matches_jax(bz, s, h, p, n, chunk):
    """The tensor-core body's rounding (``ssd_chunked_tc_ref``: hi + lo bf16
    halves of att, h_prev and w * B) on bf16 x, B, C against the JAX kernel
    (Pallas, interpret mode) on the same inputs, at the card's limits: y to
    one bf16 rounding step, h_final 1e-4.  The second lane is predicated
    past 3/5 of S, as a ragged prompt is."""
    a = _mk(bz, s, h, p, n, seed=20 + p + n)
    bf = torch.bfloat16
    t = _t(a)
    xb, Bb, Cb = t["x"].to(bf), t["B"].to(bf), t["C"].to(bf)
    dt = t["dt"].clone()
    if bz > 1:
        dt[1, 3 * s // 5:] = 0.0
    want = jssd.ssd_scan(
        jnp.asarray(xb.float().numpy(), jnp.bfloat16), jnp.asarray(dt.numpy()),
        jnp.asarray(a["A"]), jnp.asarray(Bb.float().numpy(), jnp.bfloat16),
        jnp.asarray(Cb.float().numpy(), jnp.bfloat16), h0=jnp.asarray(a["h0"]),
        chunk=chunk, impl="kernel")
    y, hT = tref.ssd_chunked_tc_ref(xb, dt, t["A"], Bb, Cb, h0=t["h0"],
                                    chunk=chunk)
    assert y.dtype == bf
    np.testing.assert_allclose(np_(y.float()), np.asarray(want[0], np.float32),
                               **Y_TOL)
    np.testing.assert_allclose(np_(hT), np.asarray(want[1]), **H_TOL)


def test_tensor_core_precision_model_is_not_single_bf16():
    """The model has teeth: with each f32 operand as ONE bf16 half (no lo
    half), h_final moves past its 1e-4 limit."""
    a = _t(_mk(1, 256, 2, 64, 64, seed=7))
    bf = torch.bfloat16
    xb, Bb, Cb = a["x"].to(bf), a["B"].to(bf), a["C"].to(bf)
    args = (xb, a["dt"], a["A"], Bb, Cb)
    _, want = tref.ssd_chunked_ref(*args, h0=a["h0"], chunk=64)
    _, got = tref.ssd_chunked_tc_ref(*args, h0=a["h0"], chunk=64)
    np.testing.assert_allclose(np_(got), np_(want), **H_TOL)
    hi_only = lambda v: (v.to(bf).float(), torch.zeros_like(v))
    orig = tref._hi_lo
    try:
        tref._hi_lo = hi_only
        _, bad = tref.ssd_chunked_tc_ref(*args, h0=a["h0"], chunk=64)
    finally:
        tref._hi_lo = orig
    err = np.abs(np_(bad) - np_(want)) - (1e-4 + 1e-4 * np.abs(np_(want)))
    assert err.max() > 0
