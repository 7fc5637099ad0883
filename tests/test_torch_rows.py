"""A row's bits do not depend on how many rows share its call: the port's
``layers.per_row`` (every projection runs on at least ``ROW_FLOOR`` rows,
every norm on at least ``NORM_ROW_FLOOR``) gives a row the same output
alone and inside calls of every row count up to the floor and past it, in
f32 and bf16, wherever the row sits in the call; ``linear`` and the norms
keep the plain functions' values and shapes.  At model level on the CPU,
one decode step gives lane 0 the same logits at widths 1, 2, 4 and 8, and
a prompt's first-token logits are the same alone and inside a batch.  (On
the card, ``chip_smoke.py`` holds the same and ``--gemm-probe`` shows why
the floors are where they are.)
"""

import pytest

torch = pytest.importorskip("torch")

import numpy as np
from torch_parity import FAMILY, models

from repro_torch.models import gather_lanes, get_model
from repro_torch.models import layers as L

OVER = {"dense": {}, "ssm": FAMILY["ssm"], "hybrid": FAMILY["hybrid"]}



@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny tensors: one intra-op thread runs them faster than many, and
    leaves the cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _rows(dtype, m, k, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(m, k, generator=g).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_linear_row_is_the_same_in_calls_of_every_row_count(dtype):
    """16 probe rows inside calls of every M from 1 to past the floor, at
    the call's start, middle and end: each row's bits equal its bits
    alone."""
    k, n = 96, 80
    w = _rows(dtype, k, n, 1)
    probe = _rows(dtype, 16, k, 2)
    alone = torch.cat([L.linear(probe[i:i + 1], w) for i in range(16)])
    for m in list(range(1, L.ROW_FLOOR + 1)) + [L.ROW_FLOOR + 37]:
        rows = min(16, m)
        for at in sorted({0, (m - rows) // 2, m - rows}):
            x = _rows(dtype, m, k, 3 + m)
            x[at:at + rows] = probe[:rows]
            out = L.linear(x, w)
            assert out.shape == (m, n) and out.dtype == dtype
            if m <= L.ROW_FLOOR:
                assert torch.equal(out[at:at + rows], alone[:rows]), (m, at)


def test_per_row_keeps_values_and_shapes():
    """``linear`` is ``x @ w`` over any leading dims; the norms keep the
    plain f32 formulas (values to f32 rounding)."""
    w = _rows(torch.float32, 64, 48, 4)
    x = _rows(torch.float32, 30, 64, 5).reshape(2, 3, 5, 64)
    got = L.linear(x, w)
    assert got.shape == (2, 3, 5, 48)
    torch.testing.assert_close(got, x @ w, atol=1e-5, rtol=1e-5)
    _, _, cfg, model = models(0)
    h = _rows(torch.float32, 7, cfg.d_model, 6).reshape(1, 7, -1)
    norm = model.blocks[0].ln1
    xf = h.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, unbiased=False)
    want = (xf - mu) * torch.rsqrt(var + cfg.norm_eps) * norm.scale + norm.bias
    torch.testing.assert_close(L.apply_norm(norm, h, cfg), want,
                               atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_norm_row_is_the_same_in_calls_of_every_row_count(dtype):
    _, _, cfg, model = models(0)
    norm = model.blocks[0].ln1
    probe = _rows(dtype, 4, cfg.d_model, 7)
    alone = torch.cat([L.apply_norm(norm, probe[i:i + 1], cfg)
                       for i in range(4)])
    for m in list(range(1, L.NORM_ROW_FLOOR + 1)) + [64, 255, L.ROW_FLOOR]:
        rows = min(4, m)
        x = _rows(dtype, m, cfg.d_model, 8 + m)
        x[m - rows:] = probe[:rows]
        assert torch.equal(L.apply_norm(norm, x, cfg)[m - rows:],
                           alone[:rows]), m


@pytest.mark.parametrize("family", ["dense", "ssm", "hybrid"])
def test_lane_decode_is_the_same_at_every_burst_width(family):
    """One decode step of the same lanes narrowed to widths 1, 2, 4 and 8
    (the first w lanes, as a narrowed burst takes them): lane 0's logits
    equal bit for bit."""
    _, _, cfg, model = models(0, **OVER[family])
    fam = get_model(cfg)
    rng = np.random.RandomState(9)
    prompts = torch.from_numpy(rng.randint(1, 64, (8, 12)).astype(np.int32))
    cache = fam.make_cache(cfg, 8, 24, device="cpu")
    logits, cache = fam.prefill(model, cfg, {"tokens": prompts}, cache)
    tok = logits.argmax(-1).to(torch.int32)
    lane0 = []
    for w in (1, 2, 4, 8):
        sub = {k: v.clone() for k, v in gather_lanes(
            cfg, cache, torch.arange(w)).items()}
        lg, _ = fam.decode(model, cfg, {"token": tok[:w, None]}, sub)
        lane0.append(lg[0])
    assert all(torch.equal(lane0[0], x) for x in lane0)


@pytest.mark.parametrize("family", ["dense", "hybrid"])
def test_prompt_prefills_alone_as_in_a_batch(family):
    _, _, cfg, model = models(0, **OVER[family])
    fam = get_model(cfg)
    rng = np.random.RandomState(10)
    toks = torch.from_numpy(rng.randint(1, 64, (5, 16)).astype(np.int32))
    lens = torch.tensor([16, 9, 12, 16, 5], dtype=torch.int32)
    batch, _ = fam.prefill(model, cfg, {"tokens": toks, "lens": lens},
                           fam.make_cache(cfg, 5, 24, device="cpu"))
    for i in range(5):
        alone, _ = fam.prefill(
            model, cfg, {"tokens": toks[i:i + 1, :int(lens[i])]},
            fam.make_cache(cfg, 1, 24, device="cpu"))
        assert torch.equal(alone[0], batch[i]), i
