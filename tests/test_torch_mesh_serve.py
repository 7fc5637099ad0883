"""Mesh serving of every family (``ServeEngine(mesh=...)``, ``dist.serve``):
request lanes over the data axis, heads, MLP columns, experts and vocab
over the model axis, on gloo CPU ranks started by ``launch.mesh.run_ranks``
(one start per mesh shape, shared by all its cases).

JAX's acceptance (``test_sharded_serve.py``'s ``_PRELUDE`` and numbers,
weights from JAX's ``model.init(PRNGKey(0))`` through ``models.convert``),
in the port, on a data 4 x model 2 mesh: for each of the five families the
``RandomState(11)`` trace (capacity 4, max_len 24, chunk 3, compaction
0.5, every third request sampled at T 0.8, top-p 0.9) gives every request
the one-device scheduler's tokens, ``n_generated`` and finish reason bit
for bit, with equal dispatches and host syncs; the paged leg (dense,
``PRNGKey(1)``, the ``RandomState(12)`` trace with its shared prefix, page
size 4, 14 pool pages, prefill chunk 4) the same, with chunks and prefix
hits on both sides, and every data rank's pools equal after it.  Greedy
requests equal JAX's one-device scheduler (JAX's own mesh run fails under
the installed jax, so its one-device run is the reference).  A capacity the
data axis does not divide is held whole by every rank and still equals one
device.  On a data 2 x model 2 mesh ``generate`` (dense, paged and
int8-paged caches, greedy and mixed sampling, and the dense family's
paged-gather oracle) for every family and the VLM, the first step's
prefill and decode logits, an MoE whose capacity drops tokens, and a
batch the data axis does not divide, bit for bit against one device; and
a pod 2 x data 2 mesh, whose folded "batch" line cuts the lanes.

The rank functions live here, importable by name, and import no JAX; the
JAX weights cross to the ranks as numpy arrays.
"""

import contextlib
import hashlib

import pytest

torch = pytest.importorskip("torch")

import numpy as np

from repro_torch.dist import sharding as SH
from repro_torch.launch.mesh import run_ranks
from repro_torch.models import ModelConfig, get_model, moe
from repro_torch.models.convert import from_jax_params
from repro_torch.sample import SamplingParams, greedy_tokens
from repro_torch.serve import ContinuousBatchingScheduler, ServeEngine

# test_sharded_serve.py's _PRELUDE
BASE = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
            vocab_size=64, param_dtype="float32", compute_dtype="float32")
FAMILY_OVER = {
    "dense": {},
    "moe": dict(first_k_dense=1, n_experts=4, top_k=2, capacity_factor=4.0),
    "ssm": dict(ssm_state=16, ssm_headdim=16, ssm_chunk=4),
    "hybrid": dict(ssm_state=16, ssm_headdim=16, ssm_chunk=4,
                   shared_attn_period=2),
    "encdec": dict(n_enc_layers=2, n_dec_layers=2),
}
SRC_LEN = 12
FAMILIES = tuple(FAMILY_OVER)
MAX_NEW, STOP = 6, 7
SCHED = dict(capacity=4, max_len=24, chunk=3, compact_threshold=0.5)
PAGED = dict(page_size=4, pool_pages=14, prefill_chunk=4)
# models beyond the acceptance's: (family, overrides, init seed)
MODELS = dict({f: (f, FAMILY_OVER[f], 0) for f in FAMILIES},
              paged=("dense", {}, 1),
              vlm=("dense", dict(n_layers=6, cross_attn_group=3,
                                 n_cross_tokens=4), 0),
              # capacity 16 for a 4 x 9 prefill's 72 assignments over 4
              # experts: one device drops tokens
              moe_drop=("moe", dict(FAMILY_OVER["moe"], capacity_factor=0.5),
                        0))
MIXED = [None, SamplingParams(temperature=0.8, top_p=0.9, seed=1, greedy=False),
         None, SamplingParams(temperature=1.0, top_k=8, seed=3, greedy=False)]


def _cfg(name):
    fam, over, _ = MODELS[name]
    return dict(BASE, name=f"t-{name}", family=fam, **over)


def _trace(rng, n, *, family="dense", shared_prefix=None):
    """``test_sharded_serve``'s ``mk_trace``: ``(arrival, prompt, budget,
    extras)``."""
    out, t = [], 0.0
    for _ in range(n):
        t += rng.exponential(1.5)
        prompt = rng.randint(1, 64, rng.randint(3, 14))
        if shared_prefix is not None and rng.rand() < 0.5:
            prompt = np.concatenate([shared_prefix, prompt])[:16]
        extras = None
        if family == "encdec":
            sl = int(rng.randint(2, SRC_LEN - 1))
            extras = {"src_emb": rng.randn(sl, BASE["d_model"]).astype(
                np.float32)}
        out.append((t, prompt, int(rng.randint(3, 8)), extras))
    return out


def family_trace(family):
    return _trace(np.random.RandomState(11), 6, family=family)


def paged_trace():
    rng = np.random.RandomState(12)
    return _trace(rng, 8, shared_prefix=rng.randint(1, 64, 8))


def _serve(sched_cls, sampling_cls, eng, trace, **kw):
    """``test_sharded_serve``'s ``serve``, for either package."""
    sched = sched_cls(eng, **dict(SCHED, **kw))
    for rid, (arrival, prompt, budget, extras) in enumerate(trace):
        sp = (sampling_cls(temperature=0.8, top_p=0.9, seed=rid, greedy=False)
              if rid % 3 == 0 else None)
        sched.submit(prompt, arrival=arrival, max_new_tokens=budget,
                     sampling=sp, extras=extras)
    return sched.run(), sched


def _results(res, sched):
    return ({rid: (np.asarray(r["tokens"]), int(r["n_generated"]),
                   r["finish_reason"].value) for rid, r in res.items()},
            {k: sched.stats[k] for k in (
                "steps", "dispatches", "host_syncs", "prefill_chunks",
                "prefix_hits", "compactions", "decode_steps")})


def _lanes_held(eng, cache):
    """How many lanes this rank's cache holds (a per-lane key other than
    ``pos`` / ``page_table``)."""
    axes = eng.model.cache_batch_axes(eng.cfg)
    k = next(k for k in axes if k in cache and k not in ("pos", "page_table"))
    return cache[k].shape[axes[k]]


def _pool_digest(eng, cache, keep=None):
    """sha256 of every page pool (and scale pool) of ``cache``, its first
    ``keep`` pages (a scheduler's trash page, which free lanes write in any
    order, left out)."""
    spec = eng.model.paged_cache_spec(eng.cfg)
    h = hashlib.sha256()
    for k in sorted(cache):
        if "_pages" in k:
            t = cache[k]
            if keep is not None:
                t = t.narrow(len(spec[k.split("_pages")[0]]), 0, keep)
            h.update(t.contiguous().numpy().tobytes())
    return h.hexdigest()


def _engine(name, weights, mesh, **kw):
    cfg = ModelConfig(**_cfg(name))
    model = from_jax_params(cfg, weights[name], device="cpu")
    return ServeEngine(cfg, model, max_new_tokens=MAX_NEW, stop_token=STOP,
                       device="cpu", mesh=mesh, **kw)


def serve_4x2(mesh, weights):
    """The acceptance's scheduler traces on one engine per model (a rank's,
    or one device's with ``mesh`` None)."""
    out = {}
    for fam in FAMILIES:
        eng = _engine(fam, weights, mesh)
        kw = {"src_len": SRC_LEN} if fam == "encdec" else {}
        res, sched = _serve(ContinuousBatchingScheduler, SamplingParams, eng,
                            family_trace(fam), **kw)
        out[fam] = _results(res, sched) + (_lanes_held(eng, sched.cache),)
    eng = _engine("paged", weights, mesh)
    res, sched = _serve(ContinuousBatchingScheduler, SamplingParams, eng,
                        paged_trace(), **PAGED)
    out["paged"] = _results(res, sched) + (
        _pool_digest(eng, sched.cache, sched.trash_page),)
    # a capacity of 6: the data axis of 4 does not divide it
    res, sched = _serve(ContinuousBatchingScheduler, SamplingParams,
                        _engine("dense", weights, mesh), family_trace("dense"),
                        capacity=6)
    out["capacity6"] = _results(res, sched) + (
        _lanes_held(sched.engine, sched.cache),)
    return out


def _batch(name, b=4):
    rng = np.random.RandomState(0)
    batch = {"tokens": torch.from_numpy(rng.randint(1, 64, (b, 9))),
             "lens": torch.tensor([9, 3, 6, 1][:b], dtype=torch.int32)}
    fam, over, _ = MODELS[name]
    if fam == "encdec":
        batch["src_emb"] = torch.from_numpy(
            rng.randn(b, 7, BASE["d_model"]).astype(np.float32))
        batch["src_lens"] = torch.tensor([7, 2, 5, 3][:b], dtype=torch.int32)
    if over.get("cross_attn_group"):
        batch["cross_emb"] = torch.from_numpy(rng.randn(
            b, over["n_cross_tokens"], BASE["d_model"]).astype(np.float32))
    return batch


def generate_2x2(mesh, weights):
    """``generate`` and the first step's logits of every model on one
    engine (a rank's, or one device's)."""
    out = {}
    for name in (*FAMILIES, "vlm", "moe_drop"):
        batch = _batch(name)
        eng = _engine(name, weights, mesh)
        runs = [("dense", eng, {}), ("mixed", eng, dict(sampling=MIXED))]
        if name != "ssm":
            eng8 = _engine(name, weights, mesh, page_dtype="int8")
            runs += [("paged", eng, dict(page_size=4)),
                     ("int8", eng8, dict(page_size=4))]
        if name == "dense":
            # the gather oracle: every rank writes back every lane's token
            runs.append(("gather", _engine(name, weights, mesh,
                                           paged_attn="gather"),
                         dict(page_size=4)))
        for run, e, kw in runs:
            r = e.generate(batch, **kw)
            out[name, run] = (r["tokens"].numpy(), r["n_generated"].numpy())
            if "page_size" in kw:
                out[name, "pools", run] = _pool_digest(e, r["cache"])
        with torch.inference_mode():
            lp, cache = eng._prefill(eng.params, batch,
                                     eng.make_cache(4, 16, batch))
            with (SH.use_mesh_rules(mesh, SH.SERVE_RULES) if mesh
                  else contextlib.nullcontext()):
                ld, cache = eng._cached_decode(
                    {"token": greedy_tokens(lp)[:, None]}, cache)
        out[name, "logits"] = (lp.numpy(), ld.numpy())
        out[name, "lanes"] = _lanes_held(eng, cache)
    # three lanes: the data axis of 2 does not divide them
    r = _engine("dense", weights, mesh).generate(_batch("dense", 3))
    out["dense", "b3"] = (r["tokens"].numpy(), r["n_generated"].numpy())
    return out


def generate_pod(mesh, weights):
    """The dense model's ``generate`` (dense and paged caches) over a mesh
    whose "batch" folds pod x data: (tokens, n_generated) per run and the
    lanes this rank holds."""
    eng = _engine("dense", weights, mesh)
    out = {}
    for run, kw in (("dense", {}), ("paged", dict(page_size=4))):
        r = eng.generate(_batch("dense"), **kw)
        out[run] = (r["tokens"].numpy(), r["n_generated"].numpy())
        if run == "dense":
            out["lanes"] = _lanes_held(eng, r["cache"])
    return out


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    """Every model's JAX weights (``PRNGKey(seed)``) as numpy arrays."""
    import jax

    from repro.models import ModelConfig as JaxConfig
    from repro.models import get_model as jax_get_model

    out = {}
    for name, (_, _, seed) in MODELS.items():
        cfg = JaxConfig(**_cfg(name))
        params, _ = jax_get_model(cfg).init(jax.random.PRNGKey(seed), cfg)
        out[name] = jax.tree.map(np.asarray, params)
    return out


@pytest.fixture(scope="module")
def runs(weights):
    """(the ranks' results on 4 x 2, the one-device port's; the ranks' on
    2 x 2, the one-device port's)."""
    mesh42 = run_ranks(serve_4x2, (4, 2), ("data", "model"), weights,
                       device="cpu", timeout=400)
    mesh22 = run_ranks(generate_2x2, (2, 2), ("data", "model"), weights,
                       device="cpu", timeout=400)
    return (mesh42, serve_4x2(None, weights), mesh22,
            generate_2x2(None, weights))


@pytest.fixture(scope="module")
def jax_runs(weights):
    """JAX's one-device scheduler on the same traces."""
    import jax.numpy as jnp  # noqa: F401

    from repro.models import ModelConfig as JaxConfig
    from repro.serve import ContinuousBatchingScheduler as JaxScheduler
    from repro.serve import SamplingParams as JaxSampling
    from repro.serve import ServeEngine as JaxEngine

    out = {}
    for name in (*FAMILIES, "paged"):
        eng = JaxEngine(JaxConfig(**_cfg(name)), weights[name],
                        max_new_tokens=MAX_NEW, stop_token=STOP)
        fam = MODELS[name][0]
        kw = (PAGED if name == "paged"
              else {"src_len": SRC_LEN} if fam == "encdec" else {})
        trace = paged_trace() if name == "paged" else family_trace(fam)
        res, _ = _serve(JaxScheduler, JaxSampling, eng, trace, **kw)
        out[name] = {rid: np.asarray(r["tokens"]) for rid, r in res.items()}
    return out


def _same_bits(a, b):
    return (a.dtype == b.dtype and a.shape == b.shape
            and a.tobytes() == b.tobytes())


def _assert_same_requests(got, want, tag):
    assert sorted(got) == sorted(want), tag
    for rid, (toks, n, why) in want.items():
        assert _same_bits(got[rid][0], toks), (tag, rid, got[rid][0], toks)
        assert got[rid][1:] == (n, why), (tag, rid)


@pytest.mark.parametrize("family", FAMILIES)
def test_family_trace_on_4x2_equals_one_device(runs, family):
    mesh42, one = runs[0], runs[1]
    want, st_one, lanes_one = one[family]
    assert lanes_one == 4
    for rank in mesh42:
        got, st, lanes = rank[family]
        _assert_same_requests(got, want, family)
        # the same rounds, dispatches and host syncs as one device
        assert st == st_one, (st, st_one)
        # capacity 4 over a data axis of 4: one lane a rank
        assert lanes == 1


def test_paged_prefix_chunked_leg_on_4x2_equals_one_device(runs):
    mesh42, one = runs[0], runs[1]
    want, st_one, _ = one["paged"]
    assert st_one["prefill_chunks"] > 0 and st_one["prefix_hits"] > 0
    assert st_one["compactions"] > 0
    for rank in mesh42:
        got, st, _ = rank["paged"]
        _assert_same_requests(got, want, "paged")
        assert st == st_one, (st, st_one)
    # every data rank's copy of the pools is the same (at its model
    # coordinate: rank r is data r // 2, model r % 2)
    for m in range(2):
        digests = {rank["paged"][2] for rank in mesh42[m::2]}
        assert len(digests) == 1, digests


def test_capacity_the_data_axis_does_not_divide_is_replicated(runs):
    mesh42, one = runs[0], runs[1]
    want, st_one, _ = one["capacity6"]
    for rank in mesh42:
        got, st, lanes = rank["capacity6"]
        _assert_same_requests(got, want, "capacity6")
        assert st == st_one
        assert lanes == 6


@pytest.mark.parametrize("name", [*FAMILIES, "paged"])
def test_greedy_requests_equal_jax_one_device(runs, jax_runs, name):
    one = runs[1][name][0]
    greedy = [rid for rid in one if rid % 3]
    assert greedy
    for rid in greedy:
        np.testing.assert_array_equal(one[rid][0], jax_runs[name][rid])
        np.testing.assert_array_equal(runs[0][0][name][0][rid][0],
                                      jax_runs[name][rid])


@pytest.mark.parametrize("name", [*FAMILIES, "vlm"])
def test_generate_on_2x2_equals_one_device(runs, name):
    mesh22, one = runs[2], runs[3]
    keys = [k for k in one if k[0] == name
            and k[1] in ("dense", "mixed", "paged", "int8", "gather")]
    assert len(keys) == {"ssm": 2, "dense": 5}.get(name, 4)
    for rank in mesh22:
        for k in keys:
            for got, want in zip(rank[k], one[k]):
                assert _same_bits(got, want), (k, got, want)
        for got, want in zip(rank[name, "logits"], one[name, "logits"]):
            assert got.dtype == np.float32 and _same_bits(got, want), name
        assert rank[name, "lanes"] == 2
    # the data ranks' pools are equal at each model coordinate (rank r is
    # data r // 2, model r % 2)
    for k in [k for k in one if k[:2] == (name, "pools")]:
        for m in range(2):
            assert len({rank[k] for rank in mesh22[m::2]}) == 1, k


def test_moe_that_drops_tokens_on_2x2_equals_one_device(runs, weights,
                                                        monkeypatch):
    mesh22, one = runs[2], runs[3]
    # one device drops tokens in this model's prefill
    dropped = []
    build = moe.build_dispatch

    def counting(*args):
        d = build(*args)
        dropped.append(int(d["dropped"]))
        return d
    monkeypatch.setattr(moe, "build_dispatch", counting)
    eng = _engine("moe_drop", weights, None)
    eng.generate(_batch("moe_drop"))
    assert max(dropped) > 0
    for rank in mesh22:
        for k in [k for k in one if k[0] == "moe_drop"
                  and k[1] in ("dense", "mixed", "paged", "int8", "logits")]:
            for got, want in zip(rank[k], one[k]):
                assert _same_bits(got, want), k


def test_batch_the_data_axis_does_not_divide_equals_one_device(runs):
    mesh22, one = runs[2], runs[3]
    for rank in mesh22:
        for got, want in zip(rank["dense", "b3"], one["dense", "b3"]):
            assert _same_bits(got, want)


def test_pod_and_data_axes_fold_into_one_lane_cut(weights):
    """A pod 2 x data 2 x model 1 mesh cuts 4 lanes one a rank over the
    folded "batch" line, and ``generate`` equals one device's."""
    ranks = run_ranks(generate_pod, (2, 2, 1), ("pod", "data", "model"),
                      weights, device="cpu", timeout=300)
    one = generate_pod(None, weights)
    for rank in ranks:
        assert rank["lanes"] == 1
        for run in ("dense", "paged"):
            for got, want in zip(rank[run], one[run]):
                assert _same_bits(got, want), run
