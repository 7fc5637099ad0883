"""The port's async overlap loop (``ContinuousBatchingScheduler(overlap=
True)``) within the port, on the tiny f32 twins of ``torch_parity`` (its
parity with the JAX scheduler's ``overlap=True`` on the dense trace and on
the paged + prefix + swap + chunked + compacting trace is held in
``test_torch_scheduler.py`` and ``test_torch_scheduler_paged.py``, whose
module fixtures trace the JAX scheduler): overlap == non-overlap for every
family it serves, with
one blocking host sync a round (plus the final flush); the carry hazard —
an engine that returns the SAME tensors every burst and overwrites them in
place, as the card's graphs do, must not change a token or a stat, and a
stash that keeps those tensors instead of its own copy fails that check;
and a lane that finished but is not harvested yet writes, in the burst
that runs meanwhile, only into pages it holds alone (or the trash page).
"""

import pytest

torch = pytest.importorskip("torch")

import dataclasses

import numpy as np
from torch_parity import (FAMILY, assert_same_results, plain_models,
                          sched_trace, serve_trace)

from repro_torch.serve import (ContinuousBatchingScheduler, SamplingParams,
                               ServeEngine)

MAX_NEW, STOP, MAX_LEN = 6, 7, 24
OVER = {"dense": {}, "moe": FAMILY["moe"],
        "ssm": dict(FAMILY["ssm"], ssm_chunk=4),
        "hybrid": dict(FAMILY["hybrid"], ssm_chunk=4)}



@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny tensors: one intra-op thread runs them faster than many, and
    leaves the cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _engine(family="dense", seed=0, engine_cls=ServeEngine):
    _, _, cfg_t, model = plain_models(seed, **OVER[family])
    return engine_cls(cfg_t, model, device="cpu", max_new_tokens=MAX_NEW,
                      stop_token=STOP)


def _port(eng, trace, **kw):
    return serve_trace(ContinuousBatchingScheduler, SamplingParams, eng,
                       trace, max_len=MAX_LEN, **kw)


@pytest.mark.parametrize("family", ["dense", "moe", "ssm", "hybrid"])
def test_overlap_equals_non_overlap(family):
    """The same bytes as the synchronous fused loop, with one blocking
    sync a round (plus the final flush) where that loop makes three."""
    eng = _engine(family)
    trace = sched_trace(np.random.RandomState(21), 8)
    sync, st_s, _ = _port(eng, trace, prefill_chunk=4)
    over, st_o, _ = _port(eng, trace, prefill_chunk=4, overlap=True)
    assert_same_results(over, sync, family)
    assert st_o["host_syncs"] <= st_o["steps"] + 1
    assert st_o["dispatches"] <= st_o["steps"]
    assert st_s["host_syncs"] > st_s["steps"]
    assert st_o["prefill_chunks"] > 0


def test_overlap_single_blocking_sync_per_round():
    """The unfused loop syncs several times a round; the overlap loop at
    most once (plus the final stash flush), with the same bytes."""
    eng = _engine("dense", 2)
    trace = sched_trace(np.random.RandomState(13), 8)
    legacy, st_l, _ = _port(eng, trace, fused=False)
    over, st_o, _ = _port(eng, trace, overlap=True)
    assert_same_results(over, legacy, "sync-count")
    assert st_o["host_syncs"] <= st_o["steps"] + 1
    assert st_l["host_syncs"] > st_l["steps"]
    with pytest.raises(ValueError, match="fused"):
        ContinuousBatchingScheduler(eng, capacity=2, max_len=MAX_LEN,
                                    overlap=True, fused=False)


@dataclasses.dataclass
class StaticCarryEngine(ServeEngine):
    """On the CPU, the card's static carry: every burst copies its results
    into persistent tensors (one per name and shape) and returns THOSE, so
    the next burst overwrites in place what the last one returned."""

    def __post_init__(self):
        super().__post_init__()
        self._bufs = {}

    def _keep(self, name, t):
        key = (name, tuple(t.shape), t.dtype)
        if key not in self._bufs:
            self._bufs[key] = torch.empty_like(t)
        return self._bufs[key].copy_(t)

    def _decode_chunk(self, *args, **kw):
        cache, out, tok, p, n_gen, sstate, steps = super()._decode_chunk(
            *args, **kw)
        keep = lambda pre, d: {k: self._keep(pre + k, v) for k, v in d.items()}
        return (keep("cache.", cache), self._keep("out", out),
                self._keep("tok", tok), self._keep("p", p),
                self._keep("n_gen", n_gen), keep("sstate.", sstate),
                self._keep("steps", steps))


class AliasedStash(ContinuousBatchingScheduler):
    """A faulty overlap stash: it keeps the round's device tensors instead
    of copies it owns."""

    def _push_stash(self, steps_h, width=None):
        prev = self._stash
        self._stash = {"p": self.p, "out": self.out_buf, "ngen": self.n_gen,
                       "steps": steps_h, "event": None, "width": width,
                       "admitted": list(self._round_admitted)}
        if prev is not None:
            self._harvest_stash(prev)
        self._stash["lane_rid"] = self.lane_rid.copy()
        self._stash["pending"] = self._lane_pending.copy()


def _run(sched_cls, eng, trace, overlap=True, **kw):
    sched = sched_cls(eng, capacity=4, max_len=MAX_LEN, chunk=2,
                      compact_threshold=0.5, overlap=overlap, **kw)
    for arrival, prompt, max_new in trace:
        sched.submit(prompt, arrival=arrival, max_new_tokens=max_new)
    res = sched.run()
    return res, dict(sched.stats)


@pytest.mark.parametrize("stash", ["owned", "aliased"])
def test_static_carry_hazard(stash):
    """Overlap over the static-carry engine serves what it serves over the
    plain engine: the same tokens, finish times and stats.  The stash owns
    its bytes; a stash that keeps the burst's tensors reads the NEXT
    round's values there and fails the comparison (the check's own
    check)."""
    plain = _engine("dense", 1)
    static = _engine("dense", 1, engine_cls=StaticCarryEngine)
    trace = sched_trace(np.random.RandomState(31), 10)
    kw = dict(page_size=4, prefill_chunk=4)
    cls = ContinuousBatchingScheduler if stash == "owned" else AliasedStash
    want, want_st = _run(cls, plain, trace, **kw)
    got, got_st = _run(cls, static, trace, **kw)
    same = (got_st == want_st and sorted(got) == sorted(want) and all(
        got[r]["tokens"].tobytes() == want[r]["tokens"].tobytes()
        and got[r]["finished_at"] == want[r]["finished_at"] for r in want))
    assert same == (stash == "owned")
    if stash == "owned":
        sync, _ = _run(cls, plain, trace, overlap=False, **kw)
        assert_same_results(got, sync, "static carry")


class WriteWatch(ServeEngine):
    """Checks, before every burst, where each lane of the scheduler
    ``self.sched`` can write: the page of every position the burst may
    store a token at (the clamped column of ``pos + s``)."""

    def _decode_chunk(self, cache, out_buf, tok, p, n_gen, lane_budget,
                      sstate, *, n_steps, **kw):
        s = self.sched
        ps, table = s.page_size, cache["page_table"]
        pos = cache["pos"]
        for lane in range(table.shape[0]):
            cols = ((pos[lane] + torch.arange(n_steps)) // ps).clamp(
                0, table.shape[1] - 1)
            for page in set(table[lane, cols].tolist()):
                if page == s.trash_page:
                    continue
                self.writes += 1
                assert s.lane_rid[lane] >= 0, (lane, page)
                assert page in s.lane_pages[lane], (lane, page)
                assert s.allocator.refcount[page] == 1, (lane, page)
                assert s.prefix_index.prefix_of(page) is None, (lane, page)
        return super()._decode_chunk(cache, out_buf, tok, p, n_gen,
                                     lane_budget, sstate, n_steps=n_steps,
                                     **kw)


def test_unharvested_lane_writes_only_its_own_pages():
    """In the burst after a lane finished and before its delayed harvest
    repoints it at the trash page, it writes into no page another request
    holds and into no shared (prefix-indexed) page: its table row reaches
    only its private tail pages.  Shared prefixes, a small pool that
    recycles pages and chunk 1 make such bursts frequent."""
    cfg_j, params, cfg_t, model = plain_models(1)
    eng = WriteWatch(cfg_t, model, device="cpu", max_new_tokens=MAX_NEW,
                     stop_token=STOP)
    eng.writes = 0
    rng = np.random.RandomState(12)
    trace = sched_trace(rng, 12, shared_prefix=rng.randint(1, 64, 8))
    sched = ContinuousBatchingScheduler(eng, capacity=4, max_len=MAX_LEN,
                                        chunk=1, page_size=4, pool_pages=14,
                                        prefill_chunk=4, overlap=True)
    eng.sched = sched
    for rid, (arrival, prompt, max_new) in enumerate(trace):
        sched.submit(prompt, arrival=arrival, max_new_tokens=max_new)
    res = sched.run()
    assert len(res) == len(trace) and eng.writes > 0
    assert sched.stats["prefix_hits"] > 0 and sched.stats["page_waits"] > 0
    assert sched.allocator.live_pages == 0
