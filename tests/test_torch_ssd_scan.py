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
    with pytest.raises(ValueError, match="CUDA tensor"):
        tkernel.ssd_scan_cuda(t["x"], t["dt"], t["A"], t["B"], t["C"],
                              t["h0"], chunk=8)
    tssd.ssd_scan(t["x"], t["dt"], t["A"], t["B"], t["C"], chunk=8)
    assert tkernel.ssd_scan_cuda.launches == before


@pytest.mark.parametrize("p,n", [(64, 64), (64, 128)])
def test_serving_shapes_fit_shared_memory(p, n):
    """zamba2-1.2b (P 64, N 64) and mamba2-130m (P 64, N 128) at chunk 128
    fit one block's 227 KB of shared memory."""
    assert tkernel.smem_bytes(128, p, n) <= tkernel.MAX_SMEM_BYTES
