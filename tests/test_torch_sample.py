"""Port parity of stochastic sampling: ``repro_torch.sample`` (threefry,
lane state, processors, sampler) and ``ServeEngine.generate`` on mixed
batches, against ``jax.random`` and ``repro.sample`` on the same inputs.

Bits are held exactly where the arithmetic is the same (keys, random bits,
uniforms, the ordered scan, tokens); ``gumbel`` within 1e-6 (XLA's and
PyTorch's ``log`` differ in the last bit); keep masks except where the
exclusive mass or the prob lies within 1e-6 of its threshold (``softmax``
sums in another order in the two frameworks, ROADMAP's top-p caveat)."""

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np
from torch_parity import models, np_

from repro import sample as SJ
from repro.sample import processors as PJ
from repro.serve import ServeEngine as JaxEngine
from repro_torch import sample as ST
from repro_torch.sample import numpy_ref as NR
from repro_torch.sample import processors as PT
from repro_torch.sample import prng
from repro_torch.serve import ServeEngine

SEEDS = (0, 1, 12345, 2 ** 31 - 1, -7)
SHAPES = ((64,), (50304,))
MAX_NEW = 6


def _u32(x):
    return np_(x).astype(np.int64)


# ---------------------------------------------------------------------------
# threefry against jax.random
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", SEEDS)
def test_keys_fold_in_and_split_match_jax(seed):
    kj, kt = jax.random.PRNGKey(seed), prng.prng_key(seed)
    np.testing.assert_array_equal(kt.numpy(), _u32(kj))
    for data in (0, 5, 2 ** 32 - 1):
        np.testing.assert_array_equal(prng.fold_in(kt, data).numpy(),
                                      _u32(jax.random.fold_in(kj, data)))
    lanes_j = jnp.stack([jax.random.fold_in(kj, i) for i in range(4)])
    lanes_t = torch.stack([prng.fold_in(kt, i) for i in range(4)])
    np.testing.assert_array_equal(prng.split(lanes_t).numpy(),
                                  _u32(jax.vmap(jax.random.split)(lanes_j)))
    np.testing.assert_array_equal(prng.split(kt, 3).numpy(),
                                  _u32(jax.random.split(kj, 3)))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", SEEDS)
def test_bits_and_uniform_match_jax_bitwise(seed, shape):
    kj, kt = jax.random.PRNGKey(seed), prng.prng_key(seed)
    np.testing.assert_array_equal(prng.random_bits(kt, shape).numpy(),
                                  _u32(jax.random.bits(kj, shape)))
    # [0, 1) and the Gumbel draw's [tiny, 1): the scale is 1.0, so the
    # product is exact and both roundings agree
    for lo, hi in ((0.0, 1.0), (float(np.finfo(np.float32).tiny), 1.0)):
        got = prng.uniform(kt, shape, lo, hi).numpy()
        want = np_(jax.random.uniform(kj, shape, minval=lo, maxval=hi))
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    # another range: XLA's CPU backend contracts floats * (hi - lo) + lo into
    # one FMA, the port rounds the product and the sum as the source reads:
    # they differ by at most one rounding of the product (< 5 * 2**-24)
    got = prng.uniform(kt, shape, -2.0, 3.0).numpy()
    want = np_(jax.random.uniform(kj, shape, minval=-2.0, maxval=3.0))
    np.testing.assert_allclose(got, want, rtol=0, atol=5 * 2.0 ** -24)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", SEEDS)
def test_gumbel_matches_jax_within_an_ulp_of_log(seed, shape):
    keys_j = jax.random.split(jax.random.PRNGKey(seed), 3)
    keys_t = torch.from_numpy(_u32(keys_j))
    want = np_(jax.vmap(lambda k: jax.random.gumbel(k, shape))(keys_j))
    got = prng.gumbel(keys_t, shape).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_lane_state_keys_match_jax():
    """Broadcast specs fold in the lane index, per-lane specs use their own
    seed, ``fold=`` pins the fold, padded rows are greedy with zero keys."""
    spec = dict(temperature=0.9, top_k=7, top_p=0.8, min_p=0.05,
                repetition_penalty=1.2, presence_penalty=0.3, greedy=False)
    cases = [
        (lambda M: M.SamplingParams(seed=11, **spec), 5),
        (lambda M: [M.SamplingParams(seed=3, **spec), None,
                    M.SamplingParams(seed=4, fold=9, **spec),
                    M.SamplingParams(temperature=0.0, seed=5, greedy=False)], 6),
        (lambda M: M.SamplingParams(seed=2, fold=1, **spec), 3),
        (lambda M: None, 2),
    ]
    for make, b in cases:
        sj = SJ.lane_state(make(SJ), b)
        st = ST.lane_state(make(ST), b, device="cpu")
        assert set(st) == set(sj)
        for k in sj:
            want = np.asarray(sj[k])
            got = np_(st[k])
            np.testing.assert_array_equal(got, want.astype(got.dtype), err_msg=k)
        np.testing.assert_array_equal(np_(st["key"]), want_keys := _u32(sj["key"]))
        assert ST.is_all_greedy(st) == SJ.is_all_greedy(sj)
        sub_j = SJ.split_keys(sj)
        sub_t = ST.split_keys(st)
        np.testing.assert_array_equal(np_(sub_t[1]), _u32(sub_j[1]))
        np.testing.assert_array_equal(np_(sub_t[0]["key"]), _u32(sub_j[0]["key"]))
        assert want_keys.shape == (b, 2)


def test_lane_permutation_matches_jax():
    specs = [SJ.SamplingParams(temperature=0.5 + i, seed=i, greedy=False)
             for i in range(4)]
    sj = SJ.lane_state(specs, 4)
    st = ST.lane_state([ST.SamplingParams(temperature=0.5 + i, seed=i,
                                          greedy=False) for i in range(4)],
                       4, device="cpu")
    lanes = [2, 0, 3]
    gj, gt = SJ.gather_lanes(sj, lanes), ST.gather_lanes(st, lanes)
    uj = SJ.slot_update(sj, [1, 3], SJ.gather_lanes(sj, [0, 2]))
    ut = ST.slot_update(st, [1, 3], ST.gather_lanes(st, [0, 2]))
    for k in sj:
        np.testing.assert_array_equal(np_(gt[k]), np.asarray(gj[k]).astype(np_(gt[k]).dtype))
        np.testing.assert_array_equal(np_(ut[k]), np.asarray(uj[k]).astype(np_(ut[k]).dtype))
    assert st["temperature"][1] == 1.5          # slot_update copies


# ---------------------------------------------------------------------------
# processors against repro.sample.processors
# ---------------------------------------------------------------------------

def test_penalties_temperature_and_mask_match_jax():
    rng = np.random.RandomState(1)
    b, v, t = 4, 32, 10
    logits = (rng.randn(b, v) * 2).astype(np.float32)
    out = rng.randint(0, v, (b, t)).astype(np.int32)
    n_out = np.array([0, 3, 6, 10], np.int32)
    rep = np.array([1.0, 1.4, 0.7, 1.2], np.float32)
    pres = np.array([0.0, 0.3, 0.5, -0.2], np.float32)
    temp = np.array([0.7, 1.0, -1.0, 2.5], np.float32)
    got = PT.apply_penalties(torch.from_numpy(logits), torch.from_numpy(out),
                             torch.from_numpy(n_out), torch.from_numpy(rep),
                             torch.from_numpy(pres))
    want = PJ.apply_penalties(jnp.asarray(logits), jnp.asarray(out),
                              jnp.asarray(n_out), jnp.asarray(rep),
                              jnp.asarray(pres))
    np.testing.assert_allclose(np_(got), np_(want), rtol=1e-6, atol=1e-6)
    got = PT.temperature_scale(torch.from_numpy(logits), torch.from_numpy(temp))
    want = PJ.temperature_scale(jnp.asarray(logits), jnp.asarray(temp))
    np.testing.assert_allclose(np_(got), np_(want), rtol=1e-6, atol=1e-6)
    keep = rng.rand(b, v) < 0.5
    got = PT.mask_logits(torch.from_numpy(logits), torch.from_numpy(keep))
    want = PJ.mask_logits(jnp.asarray(logits), jnp.asarray(keep))
    np.testing.assert_array_equal(np_(got), np_(want))
    # stale buffer contents beyond n_out are never penalised
    stale = out.copy()
    stale[:, 6:] = 5
    again = PT.apply_penalties(torch.from_numpy(logits), torch.from_numpy(stale),
                               torch.from_numpy(np.minimum(n_out, 6)),
                               torch.from_numpy(rep), torch.from_numpy(pres))
    ref = PT.apply_penalties(torch.from_numpy(logits), torch.from_numpy(out),
                             torch.from_numpy(np.minimum(n_out, 6)),
                             torch.from_numpy(rep), torch.from_numpy(pres))
    np.testing.assert_array_equal(np_(again), np_(ref))


def _near_threshold(scaled, idx, top_p, min_p, eps=1e-6):
    """Entry ``idx`` of one lane sits within eps of the top-p or min-p cut."""
    x = scaled.astype(np.float64)
    e = np.exp(x - x.max())
    probs = e / e.sum()
    order = np.argsort(-x, kind="stable")
    pos = int(np.flatnonzero(order == idx)[0])
    excl = probs[order[:pos]].sum()
    return (abs(excl - top_p) < eps
            or abs(probs[idx] - min_p * probs.max()) < eps)


def test_keep_pred_matches_jax_except_at_thresholds():
    rng = np.random.RandomState(8)
    for v in (40, 50304):
        b = 6
        scaled = (rng.randn(b, v) * 2.5).astype(np.float32)
        k = rng.randint(0, min(v, 60) + 2, b).astype(np.int32)
        p = rng.uniform(0.05, 1.1, b).astype(np.float32)
        mp = rng.uniform(0.0, 0.4, b).astype(np.float32)
        got = np_(PT.keep_pred(torch.from_numpy(scaled), torch.from_numpy(k),
                               torch.from_numpy(p), torch.from_numpy(mp)))
        want = np_(PJ.keep_pred(jnp.asarray(scaled), jnp.asarray(k),
                                jnp.asarray(p), jnp.asarray(mp)))
        for r, idx in zip(*np.nonzero(got != want)):
            assert _near_threshold(scaled[r], idx, p[r], mp[r]), (v, r, idx)
        assert (got.sum(-1) >= 1).all()


def test_masks_match_numpy_reference_seeded():
    rng = np.random.RandomState(0)
    v = 48
    for _ in range(60):
        logits = (rng.randn(v) * 2.5).astype(np.float32)
        k = int(rng.randint(0, v + 2))
        p = float(rng.uniform(0.05, 0.999))
        mp = float(rng.uniform(0.0, 0.4))
        t = float(rng.uniform(0.3, 2.0))
        scaled = PT.temperature_scale(torch.from_numpy(logits)[None],
                                      torch.tensor([t]))
        got = np_(PT.keep_pred(scaled, torch.tensor([k], dtype=torch.int32),
                               torch.tensor([p]), torch.tensor([mp]))[0])
        ref = NR.ref_keep_mask(logits, temperature=t, top_k=k, top_p=p, min_p=mp)
        for idx in np.flatnonzero(got != ref):
            assert _near_threshold(np_(scaled[0]), idx, p, mp, eps=1e-5), (k, p, mp, t)
        assert got[np.argmax(logits)]


def test_fused_keep_pred_equals_individual_predicates():
    rng = np.random.RandomState(8)
    b, v = 6, 40
    scaled = torch.from_numpy((rng.randn(b, v) * 2).astype(np.float32))
    k = torch.from_numpy(rng.randint(0, v + 2, b).astype(np.int32))
    p = torch.from_numpy(rng.uniform(0.05, 1.1, b).astype(np.float32))
    mp = torch.from_numpy(rng.uniform(0.0, 0.4, b).astype(np.float32))
    fused = PT.keep_pred(scaled, k, p, mp)
    sep = (PT.top_k_pred(scaled, k) & PT.top_p_pred(scaled, p)
           & PT.min_p_pred(scaled, mp))
    assert torch.equal(fused, sep)


def test_top_p_cutoff_bit_identical_to_scalar_accumulator():
    """The nucleus keeps  exclusive mass < top_p  with the exclusive mass
    taken from the shifted ordered scan: the f32 scalar loop's cut."""
    rng = np.random.RandomState(5)
    for _ in range(25):
        v = int(rng.randint(4, 64))
        logits = torch.from_numpy((rng.randn(v) * 2).astype(np.float32))
        top_p = float(rng.uniform(0.1, 0.99))
        got = np_(PT.top_p_pred(logits[None], torch.tensor([top_p]))[0])
        probs = np_(torch.softmax(logits, -1))
        keep = np.zeros((v,), bool)
        acc = np.float32(0.0)
        for idx in np.argsort(-np_(logits), kind="stable"):
            keep[idx] = acc < np.float32(top_p)
            acc = np.float32(acc + probs[idx])
        np.testing.assert_array_equal(got, keep)


def test_degenerate_knobs_never_empty_the_partition():
    rng = np.random.RandomState(12)
    v = 12
    logits = torch.from_numpy((rng.randn(1, v) * 2).astype(np.float32))
    top = int(torch.argmax(logits[0]))
    assert top != 0
    for spec in (ST.SamplingParams(temperature=0.8, top_p=0.0, seed=0, greedy=False),
                 ST.SamplingParams(temperature=0.8, min_p=1.5, seed=0, greedy=False)):
        tok, _ = ST.sample(logits, ST.lane_state([spec], 1, device="cpu"))
        assert int(tok[0]) == top, spec


def test_ban_applies_before_vocab_filters_and_stop_bigrams():
    rng = np.random.RandomState(9)
    v = 16
    logits = torch.from_numpy((rng.randn(1, v) * 3).astype(np.float32))
    order = torch.argsort(-logits[0])
    top, runner_up = int(order[0]), int(order[1])
    state = ST.lane_state([ST.SamplingParams(temperature=0.8, top_k=1, seed=0,
                                             greedy=False)], 1, device="cpu")
    ban = PT.ban_pred(v, [top])
    for _ in range(4):
        tok, state = ST.sample(logits, state, ban=ban)
        assert int(tok[0]) == runner_up
    pred = PT.stop_sequence_pred(8, torch.tensor([3, 5]), [(3, 6), (5, 1)])
    want = np.ones((2, 8), bool)
    want[0, 6] = want[1, 1] = False
    np.testing.assert_array_equal(np_(pred), want)
    np.testing.assert_array_equal(
        np_(pred), np_(PJ.stop_sequence_pred(8, jnp.asarray([3, 5]),
                                             [(3, 6), (5, 1)])))


def test_top_k_threshold_survives_softmax_underflow():
    scaled = torch.tensor([[0.0, -300.0, -200.0]])
    got = PT.top_k_pred(scaled, torch.tensor([2], dtype=torch.int32))[0]
    assert got.tolist() == [True, False, True]


# ---------------------------------------------------------------------------
# the sampler against repro.sample.sample
# ---------------------------------------------------------------------------

def test_sample_tokens_match_jax():
    """Seeded logits, every processor, a ban, penalties over a buffer, five
    chained steps: the same tokens and keys as JAX."""
    rng = np.random.RandomState(2)
    b, v, t = 8, 64, 12
    make = lambda M: [None] + [
        M.SamplingParams(temperature=0.6 + 0.1 * i, top_k=(0, 5, 20)[i % 3],
                         top_p=(1.0, 0.8, 0.95)[i % 3], min_p=0.02 * (i % 2),
                         repetition_penalty=1.0 + 0.1 * i,
                         presence_penalty=0.1 * (i % 3), seed=40 + i,
                         greedy=False) for i in range(b - 1)]
    sj = SJ.lane_state(make(SJ), b)
    st = ST.lane_state(make(ST), b, device="cpu")
    ban_j, ban_t = PJ.ban_pred(v, [3, 17]), PT.ban_pred(v, [3, 17])
    out = rng.randint(0, v, (b, t)).astype(np.int32)
    n_out = rng.randint(0, t + 1, b).astype(np.int32)
    for _ in range(5):
        logits = (rng.randn(b, v) * 2).astype(np.float32)
        tj, sj = SJ.sample(jnp.asarray(logits), sj, jnp.asarray(out),
                           jnp.asarray(n_out), ban=ban_j)
        tt, st = ST.sample(torch.from_numpy(logits), st, torch.from_numpy(out),
                           torch.from_numpy(n_out), ban=ban_t)
        np.testing.assert_array_equal(np_(tt), np_(tj))
        np.testing.assert_array_equal(np_(st["key"]), _u32(sj["key"]))
        assert not np.isin(np_(tt), [3, 17]).any()


def test_sampled_tokens_respect_masks():
    rng = np.random.RandomState(2)
    v, b = 24, 16
    logits = torch.from_numpy((rng.randn(b, v) * 2).astype(np.float32))
    state = ST.lane_state([ST.SamplingParams(temperature=0.7, top_k=5, top_p=0.8,
                                             seed=i, greedy=False)
                           for i in range(b)], b, device="cpu")
    for _ in range(5):
        tok, state = ST.sample(logits, state)
        for i in range(b):
            ref = NR.ref_keep_mask(np_(logits[i]), temperature=0.7, top_k=5,
                                   top_p=0.8)
            assert ref[int(tok[i])]


# ---------------------------------------------------------------------------
# ServeEngine.generate on mixed batches
# ---------------------------------------------------------------------------

def _specs(M):
    """Greedy, temperature only, top-k, top-p, min-p, penalties, all of
    them, and an explicit greedy spec with a seed."""
    return [None,
            M.SamplingParams(temperature=0.7, seed=1, greedy=False),
            M.SamplingParams(temperature=1.0, top_k=5, seed=2, greedy=False),
            M.SamplingParams(temperature=0.9, top_p=0.8, seed=3, greedy=False),
            M.SamplingParams(temperature=1.2, min_p=0.1, seed=4, greedy=False),
            M.SamplingParams(temperature=1.0, repetition_penalty=1.5,
                             presence_penalty=0.5, seed=5, greedy=False),
            M.SamplingParams(temperature=0.8, top_k=20, top_p=0.9, min_p=0.05,
                             repetition_penalty=1.1, seed=6, greedy=False),
            M.SamplingParams(greedy=True, seed=7)]


@pytest.fixture(scope="module")
def engines():
    cfg_j, params, cfg_t, model = models()
    rng = np.random.RandomState(0)
    batch = {"tokens": rng.randint(1, cfg_j.vocab_size, (8, 9)),
             "lens": np.array([9, 3, 6, 1, 9, 7, 4, 8], np.int32)}
    kw = dict(max_new_tokens=MAX_NEW, stop_token=-999, banned_tokens=[3, 17])
    return (JaxEngine(cfg_j, params, **kw),
            ServeEngine(cfg_t, model, device="cpu", **kw), batch)


@pytest.mark.parametrize("page_size", [None, 8])
def test_mixed_batch_generate_matches_jax(engines, page_size):
    eng_j, eng_t, batch = engines
    res_j = eng_j.generate({k: jnp.asarray(v) for k, v in batch.items()},
                           sampling=_specs(SJ), page_size=page_size)
    res_t = eng_t.generate(batch, sampling=_specs(ST), page_size=page_size)
    np.testing.assert_array_equal(np_(res_t["tokens"]), np_(res_j["tokens"]))
    np.testing.assert_array_equal(np_(res_t["n_generated"]),
                                  np_(res_j["n_generated"]))
    assert not np.isin(np_(res_t["tokens"]), [3, 17]).any()


def test_seeds_reproduce_and_greedy_lanes_stay_unperturbed(engines):
    _, eng, batch = engines
    a = np_(eng.generate(batch, sampling=_specs(ST))["tokens"])
    b = np_(eng.generate(batch, sampling=_specs(ST))["tokens"])
    np.testing.assert_array_equal(a, b)
    greedy = np_(eng.generate(batch)["tokens"])
    np.testing.assert_array_equal(a[[0, 7]], greedy[[0, 7]])
    other = _specs(ST)
    other[3] = ST.SamplingParams(temperature=0.9, top_p=0.8, seed=99, greedy=False)
    c = np_(eng.generate(batch, sampling=other)["tokens"])
    assert c[3].tolist() != a[3].tolist()
    np.testing.assert_array_equal(np.delete(c, 3, 0), np.delete(a, 3, 0))


def test_default_sampling_decorrelates_lanes_and_matches_jax(engines):
    eng_j, eng_t, batch = engines
    prompt = np.repeat(batch["tokens"][:1], 2, axis=0)
    spec = dict(temperature=1.0, seed=0, greedy=False)
    kw = dict(max_new_tokens=MAX_NEW, stop_token=-999)
    ej = JaxEngine(eng_j.cfg, eng_j.params, default_sampling=SJ.SamplingParams(**spec),
                   **kw)
    et = ServeEngine(eng_t.cfg, eng_t.params, device="cpu",
                     default_sampling=ST.SamplingParams(**spec), **kw)
    got = np_(et.generate({"tokens": prompt})["tokens"])
    assert got[0].tolist() != got[1].tolist()
    np.testing.assert_array_equal(
        got, np_(ej.generate({"tokens": jnp.asarray(prompt)})["tokens"]))
