"""Port parity of the horizontal operations: ``repro_torch.core.reductions``
against ``repro.core.reductions`` and the scalar loop ``fadda_ref``.

The strictly ordered ``fadda``/``fadda_scan``/``fadda_tiled`` are held bit
for bit (the whole point of ``fadda``), including ``init = -0.0`` where
masked lanes add +0.0; integer reductions exactly; float ``faddv``,
``smaxv``, ``sminv`` and ``pairwise_sum`` at 1e-6."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
import numpy as np
from torch_parity import np_

from repro.core import reductions as RJ
from repro.kernels.fadda.ref import fadda_ref
from repro_torch.core import predicate as PT
from repro_torch.core import reductions as RT


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


def _pair(x, p=None):
    return ((jnp.asarray(x), None if p is None else jnp.asarray(p)),
            (torch.from_numpy(np.asarray(x)),
             None if p is None else torch.from_numpy(np.asarray(p))))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("predicated", [False, True])
def test_fadda_and_scan_bitwise_equal_jax_and_the_loop(seed, predicated):
    rng = np.random.RandomState(seed)
    x = (rng.randn(5, 37) * 10 ** rng.uniform(-3, 3, (5, 37))).astype(np.float32)
    p = (rng.rand(5, 37) < 0.6) if predicated else None
    init = np.float32(rng.randn())
    (xj, pj), (xt, pt) = _pair(x, p)
    for fn in ("fadda", "fadda_scan"):
        want = np_(getattr(RJ, fn)(pj, xj, init=init))
        got = np_(getattr(RT, fn)(pt, xt, init=float(init)))
        np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=fn)
    xm = np.where(p, x, 0) if predicated else x
    loop = [fadda_ref(row, init=init) for row in xm]
    np.testing.assert_array_equal(_bits(np_(RT.fadda(pt, xt, init=float(init)))),
                                  _bits(loop))


def test_fadda_scan_other_axis_and_row_init():
    rng = np.random.RandomState(3)
    x = rng.randn(7, 4).astype(np.float32)
    init = rng.randn(4).astype(np.float32)
    (xj, _), (xt, _) = _pair(x)
    for fn in ("fadda", "fadda_scan"):
        want = np_(getattr(RJ, fn)(None, xj, init=jnp.asarray(init), axis=0))
        got = np_(getattr(RT, fn)(None, xt, init=torch.from_numpy(init), axis=0))
        np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=fn)


def test_masked_lanes_add_plus_zero():
    """init = -0.0 with every lane inactive: each masked lane adds +0.0, so
    the result is +0.0, as in JAX; an empty vector keeps -0.0."""
    x = np.array([-0.0, 3.0, -1.5], np.float32)
    p = np.zeros(3, bool)
    (xj, pj), (xt, pt) = _pair(x, p)
    want = np_(RJ.fadda(pj, xj, init=-0.0))
    got = np_(RT.fadda(pt, xt, init=-0.0))
    assert _bits(got) == _bits(want) == _bits(np.float32(0.0))
    scan = np_(RT.fadda_scan(pt, xt, init=-0.0))
    np.testing.assert_array_equal(_bits(scan), _bits(np_(RJ.fadda_scan(pj, xj, init=-0.0))))
    empty = np_(RT.fadda(None, torch.zeros(0), init=-0.0))
    assert _bits(empty) == _bits(np_(RJ.fadda(None, jnp.zeros(0), init=-0.0)))
    assert np.signbit(empty)
    # all-(-0.0) active lanes from -0.0 stay -0.0
    neg = np_(RT.fadda(None, torch.tensor([-0.0, -0.0]), init=-0.0))
    assert _bits(neg) == _bits(np_(RJ.fadda(None, jnp.asarray([-0.0, -0.0]), init=-0.0)))


@pytest.mark.parametrize("vl", [4, 8, 16, 64, 128])
def test_fadda_tiled_is_vl_invariant_and_equals_jax(vl):
    rng = np.random.RandomState(vl)
    x = (rng.randn(3, 150) * 100).astype(np.float32)
    p = rng.rand(150) < 0.7
    for pp in (None, p):
        (xj, pj), (xt, pt) = _pair(x, pp)
        want = np_(RJ.fadda_tiled(pj, xj, vl=vl))
        got = np_(RT.fadda_tiled(pt, xt, vl=vl))
        np.testing.assert_array_equal(_bits(got), _bits(want))
        np.testing.assert_array_equal(_bits(got), _bits(np_(RT.fadda(pt, xt))))


def test_fadda_differs_from_the_tree_on_the_adversarial_sequence():
    x = np.array([1e8, 1.0, -1e8, 1.0] * 64, np.float32)
    got = np_(RT.fadda(None, torch.from_numpy(x)))
    assert _bits(got) == _bits(fadda_ref(x)) == _bits(np_(RJ.fadda(None, jnp.asarray(x))))
    assert got != np_(RT.pairwise_sum(torch.from_numpy(x)))


@pytest.mark.parametrize("seed", [0, 1])
def test_integer_reductions_exact(seed):
    rng = np.random.RandomState(seed)
    for vl in (1, 7, 64):
        x = rng.randint(0, 1 << 20, (3, vl)).astype(np.int32)
        p = rng.rand(3, vl) < 0.5
        (xj, pj), (xt, pt) = _pair(x, p)
        for fn in ("eorv", "orv", "andv", "smaxv", "sminv", "faddv"):
            want = np_(getattr(RJ, fn)(pj, xj))
            got = np_(getattr(RT, fn)(pt, xt))
            assert got.dtype == want.dtype, fn
            np.testing.assert_array_equal(got, want, err_msg=fn)


def test_float_reductions_close():
    rng = np.random.RandomState(4)
    x = rng.randn(4, 33).astype(np.float32)
    p = rng.rand(4, 33) < 0.5
    (xj, pj), (xt, pt) = _pair(x, p)
    for fn in ("faddv", "smaxv", "sminv"):
        np.testing.assert_allclose(np_(getattr(RT, fn)(pt, xt)),
                                   np_(getattr(RJ, fn)(pj, xj)), rtol=1e-6,
                                   atol=1e-6, err_msg=fn)
    for axis in (0, -1):
        np.testing.assert_allclose(np_(RT.pairwise_sum(xt, axis=axis)),
                                   np_(RJ.pairwise_sum(xj, axis=axis)),
                                   rtol=1e-6, atol=1e-6)


def test_ptrue_pfalse():
    assert PT.ptrue(5).tolist() == [True] * 5
    assert PT.pfalse(3).tolist() == [False] * 3
    assert PT.ptrue(2, torch.int32).dtype == torch.int32
