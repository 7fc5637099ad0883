"""Port parity of ``repro_torch.obs`` against ``repro.obs``: on the same
records, the metrics registry, its histograms and ``StatsView`` give the
same snapshots, and the tracer the same events (timestamps aside);
``validate_trace`` finds the same faults, and span healing (``close``)
closes the same tracks.  The ``Obs`` facade is a no-op without a tracer,
and its profiler ranges leave the trace as it is."""

import pytest

torch = pytest.importorskip("torch")

import json

import numpy as np

from repro import obs as OJ
from repro_torch import obs as OT


def _strip(events):
    """Events without their timestamps (the only field that may differ)."""
    return [{k: v for k, v in ev.items() if k != "ts"} for ev in events]


def _record(o, values, dist_q):
    """The same records into one package's registry."""
    reg = o.MetricsRegistry()
    reg.counter("dispatches").inc(3)
    reg.counter("steps", key="rounds").inc()
    reg.inc("host_syncs", 5)
    reg.gauge("pool").set(0.25)
    s = reg.series("occupancy_trace", key="mean_occupancy")
    for v in values[:7]:
        s.append(float(v))
    h = reg.histogram("ttft", unit="ms", percentiles=dist_q)
    for v in values:
        h.record(float(v))
    reg.observe("tpot", 0.0, unit="ms")
    reg.observe("tpot", 3.5, unit="ms")
    return reg


@pytest.mark.parametrize("dist", ["lognormal", "uniform", "with_zeros"])
def test_registry_snapshots_equal(dist):
    rng = np.random.RandomState(0)
    values = {"lognormal": rng.lognormal(1.0, 1.5, 500),
              "uniform": rng.uniform(0.01, 100.0, 500),
              "with_zeros": np.concatenate([np.zeros(40),
                                            rng.exponential(2.0, 200)])}[dist]
    q = (1, 50, 90, 99, 100)
    reg_j, reg_t = _record(OJ, values, q), _record(OT, values, q)
    assert reg_t.snapshot() == reg_j.snapshot()
    for p in (0, 0.5, 25, 50, 75, 99.9):
        assert (reg_t.get("ttft").percentile(p)
                == reg_j.get("ttft").percentile(p))
    assert reg_t.get("ttft").mean == reg_j.get("ttft").mean


def test_stats_view_equal():
    views = []
    for o in (OJ, OT):
        reg = o.MetricsRegistry()
        reg.counter("steps", key="rounds")
        reg.series("occupancy_trace", key="mean_occupancy")
        st = reg.stats_view()
        st["steps"] += 2
        st["occupancy_trace"].append(0.5)
        st["occupancy_trace"].append(1.0)
        st["new_counter"] = 7
        with pytest.raises(TypeError):
            del st["steps"]
        assert isinstance(st, o.StatsView)
        views.append((dict(st), len(st), reg.snapshot()))
    assert views[0] == views[1]
    reg = OT.MetricsRegistry()
    reg.gauge("x")
    with pytest.raises(TypeError, match="already registered"):
        reg.counter("x")


def _drive(o, heal: bool):
    """One scripted serve-loop timeline through a package's ``Obs``."""
    tr = o.Tracer()
    ob = o.Obs(tracer=tr)
    ob.request_begin(0, prompt_len=5, arrival=0.0)
    ob.request_begin(1, prompt_len=9, arrival=2.0)
    with ob.span("round", round=0):
        with ob.span("plan"):
            ob.request_event(0, "admitted", lane=0)
            ob.request_event(0, "first_token")
        ob.counter("occupancy", 0.25)
        with ob.span("dispatch", kind="fused", width=1):
            ob.event("burst", chunk=4, width=1)
        with ob.span("harvest"):
            with ob.span("sync", what="harvest"):
                pass
            ob.request_end(0, n_generated=4, finished_at=4.0, reason="done")
    ob.event("idle", now=8.0)
    ob.request_event(7, "ignored")           # never begun: dropped
    if heal:
        tr.span("round", round=1).__enter__()     # left open
        tr.close()
    else:
        ob.request_end(1, n_generated=0, finished_at=8.0, reason="cancelled")
    return tr


@pytest.mark.parametrize("heal", [False, True])
def test_tracer_events_equal_and_validate(heal):
    tr_j, tr_t = _drive(OJ, heal), _drive(OT, heal)
    assert _strip(tr_t.trace_events()) == _strip(tr_j.trace_events())
    assert OT.validate_trace(tr_t.trace_events()) == []
    ts = [ev["ts"] for ev in tr_t.events]
    assert ts == sorted(ts)


BAD = [
    [{"ph": "E", "ts": 1.0, "pid": 1, "tid": 0}],
    [{"ph": "B", "ts": 2.0, "pid": 1, "tid": 0, "name": "a"},
     {"ph": "E", "ts": 1.0, "pid": 1, "tid": 0, "name": "b"}],
    [{"ph": "i", "ts": 1.0, "pid": 2, "tid": 3, "name": "admitted"}],
    [{"ph": "B", "ts": 1.0, "pid": 1, "tid": 0, "name": "open"}],
    [{"ph": "Q", "ts": 1.0, "pid": 1, "tid": 0}],
    [{"ph": "B", "pid": 1, "tid": 0}],
]


@pytest.mark.parametrize("case", range(len(BAD)))
def test_validate_trace_same_faults(case):
    got = OT.validate_trace(BAD[case])
    assert got and got == OJ.validate_trace(BAD[case])


def test_export_and_null_paths(tmp_path):
    ob = OT.Obs()
    assert not ob.tracing and ob.span("x", dispatch=True) is OT.NULL_SPAN
    ob.event("x")
    ob.counter("x", 1.0)
    ob.request_begin(0)
    ob.request_event(0, "x")
    ob.request_end(0)
    assert ob.export(str(tmp_path / "none.json")) == 0
    # profiler ranges around dispatch seams leave the recorded trace as it
    # is (on the CPU: record_function only)
    traced = [OT.Obs(tracer=OT.Tracer(), annotations=a) for a in (False, True)]
    for ob in traced:
        with ob.span("round"):
            with ob.span("dispatch", dispatch=True, kind="decode"):
                pass
    a, b = (_strip(ob.tracer.trace_events()) for ob in traced)
    assert a == b
    n = traced[1].export(str(tmp_path / "t.json"))
    with open(tmp_path / "t.json") as f:
        data = json.load(f)
    assert n == 4 and OT.validate_trace(data["traceEvents"]) == []
