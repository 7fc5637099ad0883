"""The port's request control plane and chaos harness
(``repro_torch.serve.chaos``), held to the invariants of the JAX package's
``test_robustness.py`` within the port, on the tiny f32 twins of
``torch_parity``: priority preemption resumes bit for bit (the spilled and
resumed request serves the bytes of a run that never preempts) for every
family the port serves, under paged + chunked prefill + compaction +
overlap; equal priorities never preempt; cancel at every stage, deadlines
and shedding return typed partial results; the drain on abort leaks no
page under overlap; a corrupted host-swap entry degrades to a cold prefill;
a chaos schedule replays exactly from its seed and, under any drawn
schedule, drains leak-free with every done request's bytes intact; the
lifecycle instants land in a valid trace.  One seeded chaos schedule, with
preemptions among its events, serves the JAX scheduler's results, finish
reasons and stats.  The launcher's
control-plane flags each run and print their summary line.
"""

import pytest

torch = pytest.importorskip("torch")

import numpy as np
from torch_parity import FAMILY, assert_same_results, plain_models

from repro.serve import ContinuousBatchingScheduler as JaxScheduler
from repro.serve import ServeEngine as JaxEngine
from repro.serve import chaos as CJ
from repro_torch.obs import Obs, Tracer, validate_trace
from repro_torch.serve import (ContinuousBatchingScheduler, FinishReason,
                               HostSwapStore, SamplingParams, ServeEngine)
from repro_torch.serve import chaos as CT
from repro_torch.serve.chaos import ChaosConfig, ChaosMonkey, burst_trace

OVER = {"dense": {}, "moe": FAMILY["moe"],
        "ssm": dict(FAMILY["ssm"], ssm_chunk=4),
        "hybrid": dict(FAMILY["hybrid"], ssm_chunk=4)}
CHAOS = dict(capacity=3, max_len=24, chunk=1, page_size=8, pool_pages=6,
             host_swap_pages=4, fused=True, overlap=True)



@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny tensors: one intra-op thread runs them faster than many, and
    leaves the cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _engine(family="dense", seed=0, **kw):
    _, _, cfg_t, model = plain_models(seed, **OVER[family])
    kw = dict(dict(max_new_tokens=6, stop_token=7), **kw)
    return ServeEngine(cfg_t, model, device="cpu", **kw)


def _overload_reqs(seed=0):
    """Two low-priority prompts at t=0 saturate a 4-page pool; a priority-5
    prompt due at t=1 then starves and must preempt a victim."""
    rng = np.random.RandomState(seed)
    return [dict(tokens=rng.randint(1, 64, size=(9,)).astype(np.int32),
                 arrival=arrival, priority=priority)
            for arrival, priority in [(0.0, 0), (0.0, 0), (1.0, 5)]]


def _submit_all(sched, reqs):
    """Every 3rd rid samples stochastically, so a preempted lane's PRNG
    stream is exercised."""
    return [sched.submit(
        r["tokens"], arrival=r["arrival"], priority=r.get("priority", 0),
        deadline=r.get("deadline"), ttft_deadline=r.get("ttft_deadline"),
        sampling=(SamplingParams(temperature=0.8, top_p=0.9, seed=i,
                                 greedy=False) if i % 3 == 0 else None))
        for i, r in enumerate(reqs)]


def _same_bytes(a, b, tag):
    assert set(a) == set(b), tag
    for rid in a:
        assert a[rid]["tokens"].tobytes() == b[rid]["tokens"].tobytes(), \
            (tag, rid, a[rid]["tokens"], b[rid]["tokens"])
        assert a[rid]["n_generated"] == b[rid]["n_generated"], (tag, rid)


# ---------------------------------------------------------------------------
# preempt/resume == uninterrupted
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", ["dense", "moe", "ssm", "hybrid"])
def test_preempt_resume_byte_identity(family):
    """A starved pool (lanes for ssm, which pages nothing) under a
    priority-5 arrival forces preemption; every request serves the bytes
    of the same submissions on an ample pool that never preempts."""
    eng = _engine(family, stop_token=-1)
    reqs = _overload_reqs()
    combo = dict(max_len=24, chunk=1, compact_threshold=0.5,
                 prefill_chunk=4, fused=True, overlap=True)
    if family == "ssm":
        tight_kw, ample_kw = dict(capacity=2, **combo), dict(capacity=4, **combo)
    else:
        tight_kw = dict(capacity=4, page_size=8, pool_pages=4, **combo)
        ample_kw = dict(capacity=4, page_size=8, pool_pages=12, **combo)
    tight = ContinuousBatchingScheduler(eng, **tight_kw)
    _submit_all(tight, reqs)
    got = tight.run()
    assert tight.stats["preemptions"] > 0, family
    if family != "ssm":
        assert tight.stats["resume_page_ins"] > 0
        assert tight.allocator.live_pages == 0
    ample = ContinuousBatchingScheduler(eng, **ample_kw)
    _submit_all(ample, reqs)
    ref = ample.run()
    assert ample.stats["preemptions"] == 0
    _same_bytes(got, ref, family)
    assert FinishReason.PREEMPTED_RESUMED in {
        r["finish_reason"] for r in got.values()}
    assert all(r["finish_reason"] == FinishReason.DONE for r in ref.values())


def test_equal_priority_never_preempts():
    eng = _engine(stop_token=-1)
    reqs = _overload_reqs()
    for r in reqs:
        r["priority"] = 0
    sched = ContinuousBatchingScheduler(
        eng, capacity=4, max_len=24, chunk=1, page_size=8, pool_pages=4,
        prefill_chunk=4, overlap=True)
    _submit_all(sched, reqs)
    res = sched.run()
    assert sched.stats["preemptions"] == 0 and sched.stats["page_waits"] > 0
    assert all(r["finish_reason"] == FinishReason.DONE for r in res.values())
    assert sched.allocator.live_pages == 0


# ---------------------------------------------------------------------------
# cancel, deadlines, shedding
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("overlap", [False, True])
def test_cancel_lifecycle_stages(overlap):
    """Cancel at every stage: queued (empty result), chunk-prefilling (its
    lane and pages released), preempted (its spilled partial output),
    resident mid-flight (a prefix of the uninterrupted stream), finished
    and unknown rids (False, results untouched)."""
    eng = _engine(stop_token=-1)
    rng = np.random.RandomState(3)
    prompts = [rng.randint(1, 64, size=(n,)).astype(np.int32)
               for n in (5, 5, 5, 14)]
    ref = ContinuousBatchingScheduler(eng, capacity=2, max_len=24, chunk=1)
    ref.submit(prompts[0])
    full = ref.run()[0]["tokens"]

    sched = ContinuousBatchingScheduler(eng, capacity=2, max_len=24, chunk=1,
                                        page_size=4, prefill_chunk=4,
                                        overlap=overlap)
    r0 = sched.submit(prompts[0])
    r1 = sched.submit(prompts[1], priority=0)
    r2 = sched.submit(prompts[2], arrival=100.0)     # stays queued
    for _ in range(3):
        sched.step()
    assert sched.cancel(r0) is True                  # resident, mid-flight
    part = sched.results[r0]
    assert part["finish_reason"] == FinishReason.CANCELLED
    assert 0 < part["n_generated"] < len(full)
    assert part["tokens"].tobytes() == full[:part["n_generated"]].tobytes()
    r3 = sched.submit(prompts[3])                    # 14 tokens: chunked
    sched.step()
    assert sched._partials and sched._partials[0].req.rid == r3
    assert sched.cancel(r3) is True                  # chunk-prefilling
    assert not sched._partials and sched.results[r3]["n_generated"] == 0
    assert sched.cancel(r2) is True                  # still queued
    assert sched.results[r2]["n_generated"] == 0
    # a preempted request: spill r1 by hand, then cancel it
    sched._flush_stash()
    lane = int(np.flatnonzero(sched.lane_rid == r1)[0])
    sched._preempt_lane(lane)
    n1 = int(sched._preempted[0].row["ngen"])
    assert sched.cancel(r1) is True
    assert sched.results[r1]["n_generated"] == n1 > 0
    res = sched.run()
    assert {res[r]["finish_reason"] for r in (r0, r1, r2, r3)} == {
        FinishReason.CANCELLED}
    assert sched.cancel(r1) is False                 # already finished
    assert sched.cancel(999) is False                # never existed
    assert sched.stats["cancelled"] == 4
    assert sched.allocator.live_pages == 0 and not sched._preempted


def test_deadline_returns_partial():
    eng = _engine(stop_token=-1)
    prompt = np.random.RandomState(4).randint(1, 64, size=(5,)).astype(
        np.int32)
    ref = ContinuousBatchingScheduler(eng, capacity=2, max_len=16, chunk=1)
    ref.submit(prompt)
    full = ref.run()[0]["tokens"]
    sched = ContinuousBatchingScheduler(eng, capacity=2, max_len=16, chunk=1)
    rid = sched.submit(prompt, deadline=3.0)
    res = sched.run()
    assert res[rid]["finish_reason"] == FinishReason.DEADLINE
    assert sched.stats["deadline_misses"] == 1
    n = res[rid]["n_generated"]
    assert 0 < n < len(full)
    assert res[rid]["tokens"].tobytes() == full[:n].tobytes()


def test_infeasible_ttft_is_shed():
    """A request whose first token cannot land by its ``ttft_deadline``
    (from the observed queue-wait histogram) is shed at admission."""
    eng = _engine(stop_token=-1)
    rng = np.random.RandomState(5)
    sched = ContinuousBatchingScheduler(eng, capacity=2, max_len=16, chunk=1)
    sched.submit(rng.randint(1, 64, size=(5,)).astype(np.int32))
    late = sched.submit(rng.randint(1, 64, size=(5,)).astype(np.int32),
                        arrival=10.0, ttft_deadline=5.0)
    res = sched.run()
    assert res[late]["finish_reason"] == FinishReason.SHED
    assert res[late]["n_generated"] == 0 and sched.stats["shed"] == 1


def test_bounded_queue_sheds_overflow():
    eng = _engine()
    rng = np.random.RandomState(6)
    sched = ContinuousBatchingScheduler(eng, capacity=1, max_len=16, chunk=1,
                                        max_queue=2)
    rids = [sched.submit(rng.randint(1, 64, size=(4,)).astype(np.int32))
            for _ in range(4)]
    shed = [rid for rid in rids if rid in sched.results]
    assert len(shed) == 2 and sched.stats["shed"] == 2
    assert all(sched.results[r]["finish_reason"] == FinishReason.SHED
               for r in shed)
    res = sched.run()
    assert all(res[r]["finish_reason"] == FinishReason.DONE
               for r in rids if r not in shed)
    with pytest.raises(ValueError, match="max_queue"):
        ContinuousBatchingScheduler(eng, capacity=1, max_len=16, max_queue=0)


# ---------------------------------------------------------------------------
# drain on abort, CRC'd swap
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("exc", [KeyboardInterrupt, RuntimeError])
def test_run_drains_on_abort_under_overlap(exc):
    """An interrupt or a crash mid-run still yields a typed result for
    every request and releases every page; a real exception re-raises
    after draining; the stash is flushed."""
    eng = _engine()
    rng = np.random.RandomState(7)
    sched = ContinuousBatchingScheduler(eng, capacity=2, max_len=24, chunk=1,
                                        page_size=8, pool_pages=6,
                                        overlap=True)
    rids = [sched.submit(rng.randint(1, 64, size=(6,)).astype(np.int32))
            for _ in range(4)]
    inner, calls = sched._step_fused, {"n": 0}

    def bomb():
        calls["n"] += 1
        if calls["n"] == 3:
            raise exc("mid-run abort")
        inner()

    sched._step_fused = bomb
    if exc is KeyboardInterrupt:
        res = sched.run()
    else:
        with pytest.raises(RuntimeError):
            sched.run()
        res = sched.results
    assert set(res) == set(rids)
    assert {r["finish_reason"] for r in res.values()} <= {
        FinishReason.CANCELLED, FinishReason.DONE}
    assert sched.allocator.live_pages == 0 and sched._stash is None


def test_host_swap_crc_detects_corruption():
    store = HostSwapStore(4)
    store.put(b"key", {"k": np.arange(32, dtype=np.float32),
                       "v": np.arange(32, dtype=np.float32) * 2})
    assert store.get(b"key") is not None
    store._store[b"key"]["k"][3] += 1.0
    assert store.get(b"key") is None and store.checksum_failures == 1
    assert b"key" not in store


def test_swap_corruption_degrades_to_cold_prefill():
    """With every swap insert corrupted, a session's swap hits all fail
    their CRC and prefill cold: the bytes of a clean run."""
    eng = _engine()
    rng = np.random.RandomState(9)
    prefix = rng.randint(1, 64, size=(8,)).astype(np.int32)
    prompts = [np.concatenate([prefix, rng.randint(1, 64, size=(4,)).astype(
        np.int32)]) for _ in range(3)]
    kw = dict(capacity=2, max_len=24, chunk=1, page_size=4, pool_pages=12,
              host_swap_pages=8, overlap=True)
    clean = ContinuousBatchingScheduler(eng, **kw)
    for i, p in enumerate(prompts):
        clean.submit(p, arrival=float(i * 12))
    ref = clean.run()
    assert clean.stats["session_hits"] > 0
    sched = ContinuousBatchingScheduler(eng, **kw)
    monkey = ChaosMonkey(ChaosConfig(seed=1, swap_corrupt_rate=1.0))
    monkey.install(sched)
    for i, p in enumerate(prompts):
        sched.submit(p, arrival=float(i * 12))
    got = monkey.run(sched)
    assert monkey.corruptions > 0 and sched.stats["swap_checksum_failures"] > 0
    assert sched.stats["session_hits"] == 0
    _same_bytes(got, ref, "swap-corrupt")
    assert sched.allocator.live_pages == 0


# ---------------------------------------------------------------------------
# chaos
# ---------------------------------------------------------------------------

def _chaos_trace(mod):
    return mod.burst_trace(8, prompt_len=6, vocab=64, burst=3, gap=3.0,
                           seed=11, priority_of=lambda i: i % 2)


def _run_chaos(cfg: ChaosConfig, eng=None):
    sched = ContinuousBatchingScheduler(eng or _engine(), **CHAOS)
    monkey = ChaosMonkey(cfg).install(sched)
    for r in _chaos_trace(CT):
        sched.submit(r["tokens"], arrival=r["arrival"],
                     priority=r["priority"])
    return sched, monkey, monkey.run(sched)


def _check_chaos_run(sched, res, ref):
    assert sched.allocator.live_pages == 0, "page leak after drain"
    assert sched.allocator.free_pages == sched.allocator.pool_pages
    assert set(res) == set(ref), "a request vanished without a result"
    for rid, r in res.items():
        assert r["finish_reason"] in set(FinishReason)
        if r["finish_reason"] in (FinishReason.DONE,
                                  FinishReason.PREEMPTED_RESUMED):
            assert r["tokens"].tobytes() == ref[rid].tobytes(), rid


def test_burst_trace_equals_jax():
    for a, b in zip(_chaos_trace(CJ), burst_trace(
            8, prompt_len=6, vocab=64, burst=3, gap=3.0, seed=11,
            priority_of=lambda i: i % 2)):
        assert a["tokens"].tobytes() == b["tokens"].tobytes()
        assert (a["arrival"], a["priority"]) == (b["arrival"], b["priority"])


def test_chaos_replay_is_deterministic():
    cfg = ChaosConfig(seed=5, alloc_fail_rate=0.3, cancel_rate=0.1,
                      swap_corrupt_rate=0.5)
    s1, m1, r1 = _run_chaos(cfg)
    s2, m2, r2 = _run_chaos(cfg)
    assert (m1.alloc_failures, m1.cancels, m1.corruptions) == (
        m2.alloc_failures, m2.cancels, m2.corruptions)
    assert m1.alloc_failures > 0
    _same_bytes(r1, r2, "chaos-replay")
    assert {k: r1[k]["finish_reason"] for k in r1} == {
        k: r2[k]["finish_reason"] for k in r2}
    assert dict(s1.stats) == dict(s2.stats)


def test_chaos_soak_hypothesis():
    """Under any drawn fault schedule the scheduler drains leak-free,
    every request gets a typed result, and every done or resumed request
    serves exactly the calm run's bytes."""
    hyp = pytest.importorskip("hypothesis")
    st = pytest.importorskip("hypothesis.strategies")
    eng = _engine()
    _, _, calm = _run_chaos(ChaosConfig(seed=0), eng)
    ref = {rid: r["tokens"] for rid, r in calm.items()}

    @hyp.settings(max_examples=8, deadline=None, database=None,
                  suppress_health_check=list(hyp.HealthCheck))
    @hyp.given(seed=st.integers(0, 2 ** 16),
               alloc=st.sampled_from([0.0, 0.2, 0.5]),
               cancel=st.sampled_from([0.0, 0.1, 0.3]))
    def soak(seed, alloc, cancel):
        sched, _, res = _run_chaos(ChaosConfig(
            seed=seed, alloc_fail_rate=alloc, cancel_rate=cancel), eng)
        _check_chaos_run(sched, res, ref)

    soak()


def test_chaos_schedule_matches_jax_scheduler():
    """One seeded chaos schedule (alloc failures, cancels, swap
    corruption) on the chaos trace, with its priority-1 arrivals preempting
    and resuming lanes: the JAX scheduler's results, finish reasons, stats
    and injection counts."""
    cfg_j, params, _, _ = plain_models(0)
    eng_j = JaxEngine(cfg_j, params, max_new_tokens=6, stop_token=7)
    sched_j = JaxScheduler(eng_j, **CHAOS)
    conf = dict(seed=5, alloc_fail_rate=0.3, cancel_rate=0.1,
                swap_corrupt_rate=0.5)
    monkey_j = CJ.ChaosMonkey(CJ.ChaosConfig(**conf)).install(sched_j)
    for r in _chaos_trace(CJ):
        sched_j.submit(r["tokens"], arrival=r["arrival"],
                       priority=r["priority"])
    want = monkey_j.run(sched_j)
    sched, monkey, got = _run_chaos(ChaosConfig(**conf))
    assert_same_results(got, want, "chaos")
    assert dict(sched.stats) == dict(sched_j.stats)
    assert (monkey.alloc_failures, monkey.cancels, monkey.corruptions) == (
        monkey_j.alloc_failures, monkey_j.cancels, monkey_j.corruptions)
    assert monkey.alloc_failures > 0 and monkey.cancels > 0
    assert sched.stats["preemptions"] > 0
    assert FinishReason.PREEMPTED_RESUMED in {
        r["finish_reason"] for r in got.values()}


# ---------------------------------------------------------------------------
# observability
# ---------------------------------------------------------------------------

def test_lifecycle_instants_trace_and_validate():
    """cancelled / preempted / resumed / deadline instants land inside
    their request's open span, and the exported trace validates."""
    eng = _engine(stop_token=-1)
    obs = Obs(tracer=Tracer())
    reqs = _overload_reqs()
    reqs[0]["deadline"] = reqs[1]["deadline"] = 6.0
    sched = ContinuousBatchingScheduler(
        eng, capacity=4, max_len=24, chunk=1, page_size=8, pool_pages=4,
        prefill_chunk=4, overlap=True, obs=obs)
    rids = _submit_all(sched, reqs)
    extra = sched.submit(np.arange(1, 10, dtype=np.int32))
    assert sched.cancel(extra) is True
    res = sched.run()
    obs.tracer.close()
    names = {e.get("name") for e in obs.tracer.events if e.get("ph") == "i"}
    assert {"preempted", "resumed", "cancelled", "deadline"} <= names, names
    assert validate_trace(obs.tracer.trace_events()) == []
    snap = obs.metrics.snapshot()
    for key in ("preemptions", "cancelled", "deadline_misses",
                "resume_page_ins", "shed", "swap_checksum_failures"):
        assert key in snap, key
    assert FinishReason.DEADLINE in {res[rids[0]]["finish_reason"],
                                     res[rids[1]]["finish_reason"]}
    assert res[extra]["finish_reason"] == FinishReason.CANCELLED


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("argv,line", [
    (["--overlap"], "[scheduler]"),
    (["--max-queue", "2"], "shed=8"),
    (["--deadline-steps", "3"], "deadline misses="),
    (["--priority-every", "2", "--pool-pages", "7", "--requests", "12"],
     "preemptions=1"),
    (["--chaos-seed", "1", "--chaos-alloc-fail-rate", "0.3"],
     "alloc fails="),
    (["--chaos-seed", "2", "--chaos-cancel-rate", "0.2"], "cancels="),
    (["--chaos-seed", "3", "--chaos-swap-corrupt-rate", "1.0",
      "--host-swap-pages", "8"], "checksum failures="),
])
def test_launcher_control_plane_flags(argv, line, capsys):
    from repro_torch.launch import serve
    serve.main(["--device", "cpu", "--page-size", "4", "--overlap"] + argv)
    out = capsys.readouterr().out
    assert line in out, out[-800:]
    assert out.count("req") >= 10
