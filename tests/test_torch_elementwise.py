"""Port parity of the paper's two elementwise kernels: ``kernels.fadda``
against ``repro.kernels.fadda`` (Pallas, interpret mode) bit for bit, and
``kernels.daxpy`` against ``repro.kernels.daxpy`` (f32 within 1e-6: XLA
contracts a*x+y into one FMA, the port rounds twice as PyTorch's two ops
do; bf16 within one bf16 ulp; the tail past n bitwise equal to y).  On the
CPU the ops run their plain versions; the CUDA wrappers refuse CPU tensors.
Also the port's quickstart on the CPU."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
import numpy as np
from torch_parity import np_

from repro.kernels.daxpy import daxpy as daxpy_j
from repro.kernels.fadda import fadda as fadda_j
from repro.kernels.fadda.ref import fadda_ref
from repro_torch.kernels.daxpy import daxpy
from repro_torch.kernels.daxpy import kernel as DK
from repro_torch.kernels.fadda import fadda, fadda_rows
from repro_torch.kernels.fadda import kernel as FK
from repro_torch.kernels.fadda.ref import fadda_scan_plain


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


@pytest.mark.parametrize("length,n,block", [
    (600, 600, 128), (600, 421, 128), (1024, 1024, 512), (3, 3, 512),
])
def test_fadda_op_bitwise_equals_pallas(length, n, block):
    x = np.random.RandomState(1).randn(length).astype(np.float32)
    want = np_(fadda_j(jnp.asarray(x), n, block=block))
    got = np_(fadda(torch.from_numpy(x), n, block=block))
    assert _bits(got) == _bits(want) == _bits(fadda_ref(x, n))


def test_fadda_vl_invariant_but_ordered():
    x = np.array([1e8, 1.0, -1e8, 1.0] * 64, np.float32)
    xt = torch.from_numpy(x)
    got = {vl: np_(fadda(xt, block=vl)) for vl in (8, 128, 512)}
    assert len({int(_bits(g)) for g in got.values()}) == 1
    assert _bits(got[128]) == _bits(np_(fadda_j(jnp.asarray(x), block=128)))
    assert got[128] != np.float32(x.sum())


def test_fadda_rows_plain_loop():
    """Per-row n and init, partials: element i adds where i < n, +0.0 past."""
    rng = np.random.RandomState(2)
    x = torch.from_numpy(rng.randn(3, 11).astype(np.float32))
    n = torch.tensor([11, 4, 0])
    init = torch.tensor([0.5, -0.0, -0.0])
    out, part = fadda_rows(x, n, init, partials=True)
    for r in range(3):
        acc = np.float32(init[r])
        for i in range(11):
            acc = np.float32(acc + (x[r, i].item() if i < n[r] else np.float32(0)))
            assert _bits(part[r, i]) == _bits(acc)
        assert _bits(out[r]) == _bits(acc)
    assert not np.signbit(np_(out[2]))                 # -0.0 + 0.0 = +0.0
    assert torch.equal(part, fadda_scan_plain(x, n, init))
    empty, _ = fadda_rows(torch.zeros(2, 0), init=-0.0, partials=False)
    assert np.signbit(np_(empty)).all()


@pytest.mark.parametrize("length,n,block", [
    (1000, 777, 128), (128, 128, 128), (4096, 4095, 1024), (50, 10, 128),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_daxpy_matches_pallas(length, n, block, dtype):
    rng = np.random.RandomState(0)
    x = rng.randn(length).astype(np.float32)
    y = rng.randn(length).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = np_(daxpy_j(jnp.asarray(x, jd), jnp.asarray(y, jd), 2.5, n,
                       block=block)).astype(np.float32)
    xt, yt = torch.from_numpy(x).to(td), torch.from_numpy(y).to(td)
    got_t = daxpy(xt, yt, 2.5, n, block=block)
    assert got_t.dtype == td
    got = np_(got_t.float())
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    else:       # one bf16 ulp: 2**-7 relative
        np.testing.assert_allclose(got, want, rtol=2.0 ** -7, atol=0)
    np.testing.assert_array_equal(_bits(got[n:]), _bits(np_(yt.float())[n:]))


def test_daxpy_vl_agnostic():
    """One source, any (n, VL): the Fig. 2 contract."""
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(600).astype(np.float32))
    y = torch.from_numpy(rng.randn(600).astype(np.float32))
    outs = [daxpy(x, y, -1.25, 421, block=b) for b in (8, 128, 256, 2048)]
    for o in outs[1:]:
        assert torch.equal(o, outs[0])
    assert torch.equal(outs[0][421:], y[421:])


def test_cuda_wrappers_refuse_cpu_tensors_and_bad_blocks():
    x = torch.zeros(4, 16)
    with pytest.raises(ValueError, match="CUDA tensor"):
        FK.fadda_rows_cuda(x, torch.zeros(4, dtype=torch.int32), torch.zeros(4),
                           partials=False, block=512)
    with pytest.raises(ValueError, match="CUDA tensor"):
        DK.daxpy_cuda(x[0], x[0], 1.0, 16, block=512)
    with pytest.raises(ValueError, match="multiple of 8"):
        fadda(x[0], block=100)
    with pytest.raises(ValueError, match="multiple of 8"):
        daxpy(x[0], x[0], 1.0, block=12)


def test_quickstart_on_the_cpu(capsys):
    from repro_torch.launch import quickstart
    quickstart.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "quickstart OK" in out and out.count("identical result") == 3
