"""Port parity of ``repro_torch.serve.ContinuousBatchingScheduler`` against
the JAX scheduler (its plain XLA path), on the tiny f32 twins of
``torch_parity``: the same ragged traces — staggered arrivals, mixed greedy
and stochastic requests, per-request budgets, capacity 4, chunk 4,
compaction at 0.5 — give each rid the same tokens byte for byte, the same
``n_generated`` and finish reason, and equal stats (rounds, dispatches,
host syncs, decode/lane steps, compactions, prefill chunks, the occupancy
traces).  Each JAX trace runs once per module.

The dense trace also runs with ``overlap=True`` on both sides.

Within the port (cheap, no JAX run): fused == unfused and tracing on == off
for every family it serves, requests through recycled and compacted lanes
equal ``generate`` of each alone, arrivals, rejection, an immediate stop,
the capability flags against JAX's, ``src_len`` ignored outside encdec
and an encdec request's extras checked as the JAX scheduler checks them.
"""

import pytest

torch = pytest.importorskip("torch")

import json

import numpy as np
from torch_parity import (FAMILY, assert_same_results, plain_models,
                          sched_trace, serve_trace)

from repro import models as MJ
from repro.serve import ContinuousBatchingScheduler as JaxScheduler
from repro.serve import SamplingParams as JaxSampling
from repro.serve import ServeEngine as JaxEngine
from repro_torch import models as MT
from repro_torch.obs import Obs, Tracer, validate_trace
from repro_torch.serve import (ContinuousBatchingScheduler, RequestRejected,
                               SamplingParams, ServeEngine)

MAX_NEW, STOP, MAX_LEN = 6, 7, 24
# the SSD scan chunk of the serving twins: chunked prefill of 4 sits on it
OVER = {"dense": {}, "moe": FAMILY["moe"],
        "ssm": dict(FAMILY["ssm"], ssm_chunk=4),
        "hybrid": dict(FAMILY["hybrid"], ssm_chunk=4),
        "encdec": dict(family="encdec", n_enc_layers=1, n_dec_layers=1),
        "vlm": dict(n_layers=10, cross_attn_group=5, n_cross_tokens=4)}


def _engines(family, seed=0, **kw):
    cfg_j, params, cfg_t, model = plain_models(seed, **OVER[family])
    kw = dict(dict(max_new_tokens=MAX_NEW, stop_token=STOP), **kw)
    return (JaxEngine(cfg_j, params, **kw),
            ServeEngine(cfg_t, model, device="cpu", **kw))


def _port(eng, trace, **kw):
    return serve_trace(ContinuousBatchingScheduler, SamplingParams, eng,
                       trace, max_len=MAX_LEN, **kw)


TRACES = {
    # (family, engine seed, trace seed, requests, scheduler options)
    "dense": ("dense", 1, 16, 10, {}),
    "hybrid_chunked": ("hybrid", 0, 11, 8, dict(prefill_chunk=4)),
}


@pytest.fixture(scope="module")
def jax_runs():
    """Each trace through the JAX scheduler (fused), once; the dense trace
    also with ``overlap=True`` on the same JAX engine (its compiled
    programs shared)."""
    out = {}
    for name, (family, seed, tseed, n, kw) in TRACES.items():
        eng_j, eng_t = _engines(family, seed)
        trace = sched_trace(np.random.RandomState(tseed), n)
        res, stats, _ = serve_trace(JaxScheduler, JaxSampling, eng_j, trace,
                                    max_len=MAX_LEN, **kw)
        out[name] = (eng_t, trace, kw, res, stats)
        if name == "dense":
            res, stats, _ = serve_trace(JaxScheduler, JaxSampling, eng_j,
                                        trace, max_len=MAX_LEN, overlap=True)
            out["dense_overlap"] = (eng_t, trace, dict(overlap=True), res,
                                    stats)
    return out


@pytest.mark.parametrize("name", sorted(TRACES))
def test_trace_matches_jax_scheduler(jax_runs, name):
    eng_t, trace, kw, want, want_stats = jax_runs[name]
    got, stats, sched = _port(eng_t, trace, **kw)
    assert_same_results(got, want, name)
    assert stats == want_stats
    assert stats["dispatches"] <= stats["steps"]
    if name == "dense":
        assert stats["compactions"] > 0
    else:
        assert stats["prefill_chunks"] > 0
    assert (sched.lane_rid < 0).all() and not sched.queue


def test_overlap_trace_matches_jax_scheduler(jax_runs):
    """The async overlap loop on the dense trace: the JAX scheduler's
    ``overlap=True`` bytes and stats, one blocking sync a round plus the
    final flush."""
    eng_t, trace, kw, want, want_stats = jax_runs["dense_overlap"]
    got, stats, sched = _port(eng_t, trace, **kw)
    assert_same_results(got, want, "dense overlap")
    assert stats == want_stats
    assert stats["host_syncs"] <= stats["steps"] + 1
    assert sched._stash is None and (sched.lane_rid < 0).all()


@pytest.mark.parametrize("family", ["dense", "moe", "ssm", "hybrid"])
def test_fused_equals_unfused(family):
    """The fused step serves the same bytes as the unfused loop (separate
    prefill and burst calls), with fewer dispatches."""
    _, eng = _engines(family)
    trace = sched_trace(np.random.RandomState(21), 8)
    fused, st_f, _ = _port(eng, trace, prefill_chunk=4)
    unfused, st_u, _ = _port(eng, trace, prefill_chunk=4, fused=False)
    assert_same_results(fused, unfused, family)
    assert st_f["prefill_chunks"] > 0
    assert st_f["dispatches"] < st_u["dispatches"]
    assert st_f["host_syncs"] < st_u["host_syncs"]


@pytest.mark.parametrize("family", ["dense", "moe", "ssm", "hybrid"])
def test_tracing_on_equals_off(family, tmp_path):
    """A tracer at every host seam moves no token, no dispatch and no host
    sync; the exported trace validates, and every request's track opens at
    submit, sees admitted/first_token and closes at harvest."""
    _, eng = _engines(family)
    trace = sched_trace(np.random.RandomState(22), 7)
    off, st_off, _ = _port(eng, trace, prefill_chunk=4)
    obs = Obs(tracer=Tracer(), annotations=True)
    on, st_on, _ = _port(eng, trace, prefill_chunk=4, obs=obs)
    assert_same_results(on, off, family)
    assert st_on == st_off
    path = tmp_path / "trace.json"
    assert obs.export(str(path)) > 0
    events = json.loads(path.read_text())["traceEvents"]
    assert validate_trace(events) == []
    names = {e.get("name") for e in events}
    assert {"round", "plan", "dispatch", "harvest", "sync"} <= names
    for rid in range(len(trace)):
        track = [e["name"] for e in events
                 if e.get("pid") == 2 and e.get("tid") == rid
                 and e["ph"] != "M"]
        assert track[0] == f"req{rid}" and track[-1] == f"req{rid}"
        assert "admitted" in track and "first_token" in track


def test_generate_records_its_seams():
    """``ServeEngine.generate`` traces a ``prefill`` and a ``decode`` span
    into the engine's ``obs`` and serves the bytes it serves untraced."""
    _, eng = _engines("dense")
    obs = Obs(tracer=Tracer())
    traced = ServeEngine(eng.cfg, eng.params, max_new_tokens=MAX_NEW,
                         stop_token=STOP, device="cpu", obs=obs)
    batch = {"tokens": np.random.RandomState(4).randint(1, 64, (2, 7)),
             "lens": np.array([7, 4], np.int32)}
    a, b = eng.generate(batch), traced.generate(batch)
    assert torch.equal(a["tokens"], b["tokens"])
    spans = [e["name"] for e in obs.tracer.events if e["ph"] == "B"]
    assert spans == ["prefill", "decode"]
    assert validate_trace(obs.tracer.trace_events()) == []


def _alone(eng, prompt, budget):
    res = eng.generate({"tokens": np.asarray(prompt)[None, :]},
                       max_len=MAX_LEN)
    n = min(int(res["n_generated"][0]), budget)
    return res["tokens"][0, :n].numpy(), n


def test_recycled_and_compacted_lanes_equal_generate_alone():
    """Three requests with a 1-token budget free 75% of the lanes after the
    first round; the survivor compacts, queued requests splice into the
    recycled lanes, and every request's tokens equal ``generate`` of it
    alone."""
    _, eng = _engines("dense", 1, max_new_tokens=12)
    rng = np.random.RandomState(1)
    wave1 = [rng.randint(1, 64, rng.randint(4, 10)) for _ in range(4)]
    wave2 = [rng.randint(1, 64, rng.randint(4, 10)) for _ in range(5)]
    sched = ContinuousBatchingScheduler(eng, capacity=4, max_len=MAX_LEN,
                                        chunk=2, compact_threshold=0.75)
    budgets = [12 if i == 2 else 1 for i in range(4)] + [12] * 5
    rids = [sched.submit(p, max_new_tokens=b)
            for p, b in zip(wave1, budgets)]
    rids += [sched.submit(p, arrival=2.0) for p in wave2]
    results = sched.run()
    assert sched.stats["compactions"] >= 1
    for rid, prompt, budget in zip(rids, wave1 + wave2, budgets):
        want, n = _alone(eng, prompt, budget)
        assert results[rid]["n_generated"] == n
        np.testing.assert_array_equal(results[rid]["tokens"], want)


def test_arrivals_respected_and_future_head_does_not_block():
    _, eng = _engines("dense", 2, max_new_tokens=4, stop_token=-1)
    rng = np.random.RandomState(2)
    sched = ContinuousBatchingScheduler(eng, capacity=2, max_len=MAX_LEN,
                                        chunk=2)
    future = sched.submit(rng.randint(1, 64, 5), arrival=1000.0)
    early = sched.submit(rng.randint(1, 64, 5), arrival=0.0)
    late = sched.submit(rng.randint(1, 64, 5), arrival=100.0)
    results = sched.run()
    assert results[early]["finished_at"] < results[late]["finished_at"]
    assert 100.0 < results[late]["finished_at"] < 1000.0
    assert results[future]["finished_at"] > 1000.0
    assert all(r["n_generated"] == 4 for r in results.values())


def test_submit_rejects_what_can_never_be_admitted():
    _, eng = _engines("dense", max_new_tokens=4)
    sched = ContinuousBatchingScheduler(eng, capacity=2, max_len=MAX_LEN)
    with pytest.raises(RequestRejected, match="exceeds lane capacity"):
        sched.submit(np.arange(MAX_LEN + 1))
    paged = ContinuousBatchingScheduler(eng, capacity=2, max_len=MAX_LEN,
                                        page_size=4, pool_pages=3,
                                        prefix_sharing=False)
    with pytest.raises(RequestRejected, match="fresh pages"):
        paged.submit(np.arange(1, 17))
    with pytest.raises(ValueError, match="1-D"):
        sched.submit(np.ones((2, 3), np.int32))


def test_immediate_stop_lane_recycles():
    """A request whose FIRST token is the stop token completes with
    n_generated == 1 and frees its lane."""
    _, eng0 = _engines("dense", 3, max_new_tokens=4, stop_token=-1)
    rng = np.random.RandomState(3)
    prompt = rng.randint(1, 64, 6)
    stop = int(eng0.generate({"tokens": prompt[None, :]},
                             max_len=MAX_LEN)["tokens"][0, 0])
    _, eng = _engines("dense", 3, max_new_tokens=4, stop_token=stop)
    sched = ContinuousBatchingScheduler(eng, capacity=1, max_len=MAX_LEN)
    rid = sched.submit(prompt)
    other = sched.submit(rng.randint(1, 64, 6))
    results = sched.run()
    assert results[rid]["n_generated"] == 1
    assert results[rid]["tokens"].tolist() == [stop]
    assert other in results and (sched.lane_rid < 0).all()


@pytest.mark.parametrize("family", ["dense", "moe", "ssm", "hybrid", "encdec",
                                    "vlm"])
def test_capability_flags_equal_jax(family):
    cfg_j, _, cfg_t, _ = plain_models(0, **OVER[family])
    for flag in ("PAGED_PREFIX_OK", "CHUNKED_PREFILL_OK",
                 "LANE_INDEPENDENT_DECODE"):
        assert (getattr(MT.get_model(cfg_t), flag, False)
                == getattr(MJ.get_model(cfg_j), flag, False)), flag
    for fn in ("chunked_prefill_ok", "lane_independent_decode",
               "chunked_prefill_granularity", "paged_decode_ok"):
        assert getattr(MT, fn)(cfg_t) == getattr(MJ, fn)(cfg_j), fn


def test_src_len_is_ignored_outside_encdec():
    """As in the JAX scheduler: ``src_len`` sizes encdec's cross memory and
    is ignored by the other families (the same tokens as without it)."""
    _, eng = _engines("dense")
    trace = sched_trace(np.random.RandomState(24), 4)
    base, _, _ = _port(eng, trace)
    got, _, sched = _port(eng, trace, src_len=8)
    assert_same_results(got, base)
    assert "cross_k" not in sched.cache


@pytest.mark.parametrize("extras,match", [
    (None, "src_emb"),
    ({"src_emb": np.zeros((9, 64), np.float32)}, "exceeds src_len=8"),
])
def test_encdec_request_extras_are_checked(extras, match):
    """As in the JAX scheduler: an encdec request without ``src_emb``, or
    with one longer than ``src_len``, raises ``ValueError`` and queues
    nothing; an encdec scheduler without ``src_len`` raises too."""
    cfg_j, params, cfg_t, model = plain_models(0, **OVER["encdec"])
    eng = ServeEngine(cfg_t, model, max_new_tokens=MAX_NEW, stop_token=STOP,
                      device="cpu")
    with pytest.raises(ValueError, match="src_len"):
        ContinuousBatchingScheduler(eng, capacity=2, max_len=MAX_LEN)
    sched = ContinuousBatchingScheduler(eng, capacity=2, max_len=MAX_LEN,
                                        src_len=8)
    with pytest.raises(ValueError, match=match):
        sched.submit(np.arange(1, 5), extras=extras)
    assert sched.cancel(0) is False         # never submitted
    assert not sched.queue


def test_interrupted_run_drains_leak_free():
    """A run torn down mid-flight records every live request as cancelled
    with its partial output and frees every lane and page."""
    _, eng = _engines("dense")
    trace = sched_trace(np.random.RandomState(23), 6)
    sched = ContinuousBatchingScheduler(eng, capacity=2, max_len=MAX_LEN,
                                        page_size=4, prefill_chunk=4)
    for arrival, prompt, max_new in trace:
        sched.submit(prompt, arrival=arrival, max_new_tokens=max_new)
    sched.step()
    sched.step()
    step = sched.step
    sched.step = lambda: (_ for _ in ()).throw(KeyboardInterrupt)
    results = sched.run()
    sched.step = step
    assert sorted(results) == list(range(len(trace)))
    reasons = {r["finish_reason"].value for r in results.values()}
    assert "cancelled" in reasons
    assert sched.allocator.live_pages == 0 and (sched.lane_rid < 0).all()
