"""Port parity of speculative decoding: ``repro_torch.sample.rejection``
(``residual_dist``, ``speculative_accept``) against ``repro.sample.rejection``
on the same inputs and keys (probabilities within 1e-6, accept bits and fix
tokens equal), the rejection algebra's own properties in the port (the
first committed token distributed as the target's: the chi-squared test of
``tests/test_spec_rejection.py``), and ``repro_torch.serve.speculative_decode``
against ``repro.serve.speculative_decode`` on that file's ``BASE`` (f32, 2
layers, vocab 64) with converted weights: greedy tokens, ``n_generated`` and
``accept_counts`` byte-identical for k 2 and 4 with ragged ``lens`` and a
stop token, the single-lane form, a perfect draft accepting every window,
and mixed greedy and sampled lanes.  Each JAX reference runs once, in a
module fixture.  Also the port's serving demo, ``launch/serve_lm.py``."""

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np
from torch_parity import np_

from repro import sample as JS
from repro.models import ModelConfig as JaxConfig
from repro.models import get_model as jax_get_model
from repro.serve import speculative_decode as jax_spec
from repro_torch import sample as TS
from repro_torch.core import predicate as TP
from repro_torch.models import ModelConfig as TorchConfig
from repro_torch.models.convert import from_jax_params
from repro_torch.sample import prng
from repro_torch.serve import ServeEngine, speculative_decode

# tests/test_spec_rejection.py's BASE and its draft's overrides
BASE = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
            vocab_size=64, param_dtype="float32", compute_dtype="float32")
DRAFT = dict(n_layers=1, d_model=32, d_ff=64, n_heads=2, n_kv_heads=1)
STOP, N_TOKENS = 5, 8
LENS = np.array([8, 5, 7, 8], np.int32)
MIXED = [dict(greedy=True),
         dict(temperature=1.0, top_p=0.9, seed=9, greedy=False),
         dict(temperature=0.8, top_k=8, min_p=0.05, seed=4, greedy=False),
         dict(greedy=True, seed=2)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _twins(seed, **over):
    """(JAX config, JAX params, port config, port model on the CPU)."""
    kw = dict(name="t", family="dense", **{**BASE, **over})
    cfg_j, cfg_t = JaxConfig(**kw), TorchConfig(**kw)
    params, _ = jax_get_model(cfg_j).init(jax.random.PRNGKey(seed), cfg_j)
    model = from_jax_params(cfg_t, jax.tree.map(np.asarray, params), device="cpu")
    return cfg_j, params, cfg_t, model


@pytest.fixture(scope="module")
def spec():
    """The target and draft twins, the prompts, and each JAX reference run
    once: greedy with k 2 and 4 (ragged lens, stop token), and the mixed
    batch with k 2."""
    tj, tp, tt, tm = _twins(2)
    dj, dp, dt, dm = _twins(3, **DRAFT)
    prompts = np.random.RandomState(2).randint(1, 64, (4, 8)).astype(np.int32)
    runs = {}
    for k in (2, 4):
        runs[k] = jax_spec(tj, tp, dj, dp, jnp.asarray(prompts), n_tokens=N_TOKENS,
                           k_draft=k, lens=jnp.asarray(LENS), stop_token=STOP)
    runs["mixed"] = jax_spec(tj, tp, dj, dp, jnp.asarray(prompts),
                             n_tokens=N_TOKENS, k_draft=2,
                             sampling=[JS.SamplingParams(**m) for m in MIXED])
    return dict(target=(tt, tm), draft=(dt, dm), prompts=prompts, jax=runs)


def _same_stats(got, want):
    assert np_(got[0]).tobytes() == np_(want[0]).tobytes()
    assert np_(got[1]["n_generated"]).tobytes() == np_(want[1]["n_generated"]).tobytes()
    gc, wc = got[1]["accept_counts"], want[1]["accept_counts"]
    assert len(gc) == len(wc)
    for g, w in zip(gc, wc):
        assert np_(g).astype(np.int32).tobytes() == np_(w).astype(np.int32).tobytes()
    assert got[1]["mean_accepted"] == pytest.approx(want[1]["mean_accepted"])
    assert got[1]["k_draft"] == want[1]["k_draft"]


@pytest.mark.parametrize("k", [2, 4])
def test_greedy_speculative_decode_matches_jax(spec, k):
    """Tokens, n_generated and every round's accept counts byte for byte,
    with ragged prompts and a stop token that ends some lanes early."""
    (tt, tm), (dt, dm) = spec["target"], spec["draft"]
    got = speculative_decode(tt, tm, dt, dm, torch.from_numpy(spec["prompts"]),
                             n_tokens=N_TOKENS, k_draft=k, lens=LENS,
                             stop_token=STOP)
    _same_stats(got, spec["jax"][k])
    assert got[0].shape == (4, N_TOKENS) and got[0].dtype == torch.int32


def test_single_lane_form_matches_jax(spec):
    """B == 1: tokens (n_tokens,) and accept_counts as a list of ints, lane
    0's rounds of the batched JAX run (lane 0 holds a full prompt)."""
    (tt, tm), (dt, dm) = spec["target"], spec["draft"]
    toks, stats = speculative_decode(tt, tm, dt, dm,
                                     torch.from_numpy(spec["prompts"][:1]),
                                     n_tokens=N_TOKENS, k_draft=2, stop_token=STOP)
    jtoks, jstats = spec["jax"][2]
    assert toks.shape == (N_TOKENS,)
    assert np_(toks).tobytes() == np_(jtoks)[0].tobytes()
    want = [int(c[0]) for c in jstats["accept_counts"] if int(c[0]) >= 0]
    assert stats["accept_counts"] == want
    assert all(type(c) is int for c in stats["accept_counts"])
    assert int(stats["n_generated"][0]) == int(np_(jstats["n_generated"])[0])


def test_perfect_draft_accepts_every_window(spec):
    """The target as its own draft: every window accepted (mean_accepted
    == k), and the greedy stream unchanged (the k 4 run's tokens)."""
    (tt, tm) = spec["target"]
    toks, stats = speculative_decode(tt, tm, tt, tm, torch.from_numpy(spec["prompts"]),
                                     n_tokens=N_TOKENS, k_draft=4, lens=LENS,
                                     stop_token=STOP)
    assert stats["mean_accepted"] == 4.0
    assert np_(toks).tobytes() == np_(spec["jax"][4][0]).tobytes()


def test_mixed_greedy_and_sampled_lanes_match_jax(spec):
    """Greedy lanes on the exact-match algebra and sampled lanes on
    rejection sampling in one batch: JAX's tokens on these seeds (the keys
    are JAX's threefry bit for bit; the Gumbel draws within an ulp)."""
    (tt, tm), (dt, dm) = spec["target"], spec["draft"]
    specs = [TS.SamplingParams(**m) for m in MIXED]
    got = speculative_decode(tt, tm, dt, dm, torch.from_numpy(spec["prompts"]),
                             n_tokens=N_TOKENS, k_draft=2, sampling=specs)
    _same_stats(got, spec["jax"]["mixed"])
    again = speculative_decode(tt, tm, dt, dm, torch.from_numpy(spec["prompts"]),
                               n_tokens=N_TOKENS, k_draft=2, sampling=specs)
    assert torch.equal(got[0], again[0])


def test_greedy_tokens_equal_target_alone(spec):
    """The FFR contract: greedy speculative tokens are the target's own
    greedy tokens (the port's ``generate``), whatever the draft."""
    (tt, tm), (dt, dm) = spec["target"], spec["draft"]
    prompts = torch.from_numpy(spec["prompts"])
    eng = ServeEngine(tt, tm, max_new_tokens=N_TOKENS, stop_token=-1, device="cpu")
    want = eng.generate({"tokens": prompts, "lens": LENS})["tokens"]
    for k in (1, 3):
        got, _ = speculative_decode(tt, tm, dt, dm, prompts, n_tokens=N_TOKENS,
                                    k_draft=k, lens=LENS)
        assert torch.equal(got, want.to(got.dtype))


# ---------------------------------------------------------------------------
# the rejection algebra
# ---------------------------------------------------------------------------

def _jax_keys(seeds):
    return jax.vmap(jax.random.PRNGKey)(jnp.asarray(seeds))


def _port_keys(jkeys):
    return torch.from_numpy(np.asarray(jkeys).astype(np.int64))


@pytest.mark.parametrize("seed", [0, 1])
def test_residual_dist_matches_jax(seed):
    rng = np.random.RandomState(seed)
    p = rng.dirichlet(np.ones(16), size=(5, 3)).astype(np.float32)
    q = rng.dirichlet(np.ones(16), size=(5, 3)).astype(np.float32)
    q[0] = p[0]                                   # no residual mass: p itself
    got = TS.residual_dist(torch.from_numpy(p), torch.from_numpy(q))
    want = JS.residual_dist(jnp.asarray(p), jnp.asarray(q))
    np.testing.assert_allclose(np_(got), np_(want), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(np_(got)[0], p[0])


@pytest.mark.parametrize("b,k,v,seed", [(64, 2, 6, 0), (16, 3, 512, 2)])
def test_speculative_accept_matches_jax(b, k, v, seed):
    """The same draft, distributions, greedy tokens, greedy predicate and
    round keys through both: accept bits and fix tokens equal.  Half the
    q rows equal p (always accepted), lanes 0 and 3 greedy."""
    rng = np.random.RandomState(seed)
    q = rng.dirichlet(np.ones(v) * 0.5, size=(b, k)).astype(np.float32)
    p = rng.dirichlet(np.ones(v) * 0.5, size=(b, k + 1)).astype(np.float32)
    q[::2] = p[::2, :k]
    draft = np.stack([[rng.choice(v, p=q[i, j] / q[i, j].sum()) for j in range(k)]
                      for i in range(b)]).astype(np.int32)
    tgt = p.argmax(-1).astype(np.int32)
    tgt[1::4, 0] = draft[1::4, 0]                # some greedy windows match
    greedy = np.zeros(b, bool)
    greedy[[0, 3]] = True
    jkeys = _jax_keys(np.arange(b) + 1000 * seed)
    jacc, jfix = JS.speculative_accept(jnp.asarray(draft), jnp.asarray(q),
                                       jnp.asarray(p), jnp.asarray(tgt),
                                       jnp.asarray(greedy), jkeys)
    acc, fix = TS.speculative_accept(torch.from_numpy(draft), torch.from_numpy(q),
                                     torch.from_numpy(p), torch.from_numpy(tgt),
                                     torch.from_numpy(greedy), _port_keys(jkeys))
    np.testing.assert_array_equal(np_(acc), np_(jacc))
    np.testing.assert_array_equal(np_(fix), np_(jfix))
    assert fix.dtype == torch.int32


def test_rejection_first_token_marginal_matches_target():
    """Many lanes, fixed q != p: the first committed token is distributed as
    p (chi-squared on a toy vocab), and not as q — with the port's keys."""
    v, k, b = 6, 2, 20000
    rng = np.random.RandomState(0)
    q_row = rng.dirichlet(np.ones(v)).astype(np.float32)
    p_row = rng.dirichlet(np.ones(v)).astype(np.float32)
    q = torch.from_numpy(q_row).expand(b, k, v)
    p = torch.from_numpy(p_row).expand(b, k + 1, v)
    seeds = torch.arange(b, dtype=torch.int64)
    keys = torch.stack([torch.zeros_like(seeds), seeds], dim=-1)  # prng_key(i)
    draft = torch.argmax(torch.log(q) + prng.gumbel(keys, (k, v)), dim=-1).to(torch.int32)
    round_key = torch.stack([torch.zeros_like(seeds), seeds + 10_000_000], dim=-1)
    acc, fix = TS.speculative_accept(draft, q, p, torch.zeros((b, k + 1), dtype=torch.int32),
                                     torch.zeros(b, dtype=torch.bool), round_key)
    tok = torch.where(acc[:, 0], draft[:, 0], fix).numpy()
    counts = np.bincount(tok, minlength=v).astype(np.float64)
    expected = p_row.astype(np.float64) * b
    chi2 = ((counts - expected) ** 2 / np.maximum(expected, 1e-9)).sum()
    assert chi2 < 30.0, (chi2, counts / b, p_row)
    chi2_q = ((counts - q_row * b) ** 2 / np.maximum(q_row * b, 1e-9)).sum()
    assert chi2_q > 100.0


def test_identical_distributions_always_accept_and_prefix_is_monotone():
    """q == p: every window accepted, the bonus drawn in the vocab; and for
    q != p the accepted partition is a prefix (brkb)."""
    rng = np.random.RandomState(1)
    v, k, b = 8, 3, 256
    dist = torch.from_numpy(rng.dirichlet(np.ones(v)).astype(np.float32))
    draft = torch.from_numpy(rng.randint(0, v, (b, k)).astype(np.int32))
    keys = _port_keys(_jax_keys(np.arange(b)))
    none = torch.zeros(b, dtype=torch.bool)
    tgt = torch.zeros((b, k + 1), dtype=torch.int32)
    acc, fix = TS.speculative_accept(draft, dist.expand(b, k, v),
                                     dist.expand(b, k + 1, v), tgt, none, keys)
    assert bool(acc.all()) and int(fix.min()) >= 0 and int(fix.max()) < v
    q = torch.softmax(torch.from_numpy(rng.randn(b, k, v).astype(np.float32)), -1)
    p = torch.softmax(torch.from_numpy(rng.randn(b, k + 1, v).astype(np.float32)), -1)
    acc, _ = TS.speculative_accept(draft, q, p, tgt, none, keys)
    n = TP.cntp(acc)
    j = torch.arange(k)[None, :]
    assert torch.equal(acc, j < n[:, None])


def test_serve_lm_demo_runs_on_the_cpu(capsys):
    """The port's serving demo on the CPU: generate, the scheduler, per-lane
    sampling and speculative decoding, its speculative tokens equal to its
    target-alone greedy tokens (the demo asserts it and prints it)."""
    from repro_torch.launch import serve_lm
    serve_lm.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "speculative tokens equal target-alone greedy generate: True" in out
    assert "batched speculative tokens equal target-alone greedy generate: True" in out
