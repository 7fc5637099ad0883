"""Span/event recorder exporting Chrome/Perfetto ``trace_event`` JSON, as in
``repro.obs.trace`` (pure Python; the same events and checks).

One :class:`Tracer` records a serve run's timeline as two processes:

* pid 1, "serve loop" — the scheduler's round anatomy.  Every scheduling
  round is a ``round`` span on tid 0 nesting its phase spans (``plan`` /
  ``admit`` / ``dispatch`` / ``burst`` / ``harvest`` / ``compact`` /
  ``swap_out`` / ``swap_in`` / ``sync``), mirroring the round walk in
  docs/ARCHITECTURE.md §1.  Counter tracks (``occupancy``,
  ``pool_occupancy``) ride alongside as ``ph: "C"`` events.
* pid 2, "requests" — one lifecycle track per request (tid = rid): a
  ``req<rid>`` span opened at submit and closed at harvest (or at any other
  typed finish — cancel, deadline, shed), with instant events for
  ``admitted`` / ``first_token`` and the robustness arcs ``cancelled`` /
  ``preempted`` / ``resumed`` / ``deadline`` / ``shed``, plus
  page/prefix/session annotations in ``args``.  Lifecycle instants always
  land INSIDE the request's open span — ``validate_trace`` pins that.

Timestamps are host ``perf_counter_ns`` microseconds relative to the
tracer's birth; everything recorded is a value the serve loop already
holds on the host, so recording NEVER adds a device sync (the byte-identity
contract tests/test_torch_obs.py pins).  Open ``chrome://tracing`` or
https://ui.perfetto.dev and load the exported file to inspect a round.
"""

from __future__ import annotations

import json
import time
from typing import Optional

__all__ = ["Tracer", "validate_trace", "PID_SERVE", "PID_REQUESTS"]

PID_SERVE = 1
PID_REQUESTS = 2


class _Span:
    """Context manager recording a B/E pair on the tracer (re-entrant per
    instance is NOT supported — each ``span()`` call makes a fresh one)."""

    __slots__ = ("_tr", "_name", "_tid", "_args", "_ann")

    def __init__(self, tr: "Tracer", name: str, tid: int, args: dict,
                 ann=None):
        self._tr = tr
        self._name = name
        self._tid = tid
        self._args = args
        self._ann = ann                 # optional device-profiler range

    def __enter__(self):
        if self._ann is not None:
            self._ann.__enter__()
        self._tr._emit("B", self._name, self._tid, self._args)
        return self

    def __exit__(self, *exc):
        self._tr._emit("E", self._name, self._tid, None)
        if self._ann is not None:
            self._ann.__exit__(*exc)
        return False


class Tracer:
    """In-memory ``trace_event`` recorder (see module docstring)."""

    def __init__(self):
        self._t0 = time.perf_counter_ns()
        self.events: list = []
        self._open: dict = {}           # (pid, tid) -> open-span depth
        self._req_names: dict = {}      # rid -> track name (open tracks)

    # ------------------------------------------------------------------
    # recording
    # ------------------------------------------------------------------

    def _ts(self) -> float:
        return (time.perf_counter_ns() - self._t0) / 1e3   # µs

    def _emit(self, ph: str, name: Optional[str], tid: int, args,
              pid: int = PID_SERVE, **extra):
        ev = {"ph": ph, "ts": self._ts(), "pid": pid, "tid": tid}
        if name is not None:
            ev["name"] = name
        if args:
            ev["args"] = args
        ev.update(extra)
        if ph == "B":
            self._open[(pid, tid)] = self._open.get((pid, tid), 0) + 1
        elif ph == "E":
            self._open[(pid, tid)] = self._open.get((pid, tid), 0) - 1
        self.events.append(ev)

    def span(self, name: str, tid: int = 0, ann=None, **args) -> _Span:
        """B/E span on the serve-loop track (context manager)."""
        return _Span(self, name, tid, args or None, ann)

    def instant(self, name: str, tid: int = 0, **args):
        """Instant event on the serve-loop track."""
        self._emit("i", name, tid, args or None, s="t")

    def counter(self, name: str, value: float, tid: int = 0):
        """Counter-track sample (Perfetto renders these as a value track)."""
        self._emit("C", name, tid, {"value": value})

    # ------------------------------------------------------------------
    # per-request lifecycle tracks (pid 2, tid = rid)
    # ------------------------------------------------------------------

    def request_begin(self, rid: int, **args):
        name = f"req{rid}"
        self._req_names[rid] = name
        self._emit("B", name, rid, args or None, pid=PID_REQUESTS)

    def request_event(self, rid: int, name: str, **args):
        if rid in self._req_names:
            self._emit("i", name, rid, args or None, pid=PID_REQUESTS, s="t")

    def request_end(self, rid: int, **args):
        name = self._req_names.pop(rid, None)
        if name is not None:
            self._emit("E", name, rid, args or None, pid=PID_REQUESTS)

    # ------------------------------------------------------------------
    # export
    # ------------------------------------------------------------------

    def close(self):
        """Close any still-open spans/tracks (a trace exported mid-run must
        still validate: every B needs its E)."""
        for rid in list(self._req_names):
            self.request_end(rid, truncated=True)
        for (pid, tid), depth in list(self._open.items()):
            for _ in range(max(depth, 0)):
                self._emit("E", None, tid, None, pid=pid)

    def trace_events(self) -> list:
        """Metadata + recorded events (the ``traceEvents`` payload)."""
        meta = [
            {"ph": "M", "pid": PID_SERVE, "tid": 0, "name": "process_name",
             "args": {"name": "serve loop"}},
            {"ph": "M", "pid": PID_SERVE, "tid": 0, "name": "thread_name",
             "args": {"name": "scheduler"}},
            {"ph": "M", "pid": PID_REQUESTS, "tid": 0, "name": "process_name",
             "args": {"name": "requests"}},
        ]
        return meta + self.events

    def export(self, path: str) -> int:
        """Write Chrome/Perfetto ``trace_event`` JSON; returns the number of
        recorded (non-metadata) events."""
        self.close()
        with open(path, "w") as f:
            json.dump({"traceEvents": self.trace_events(),
                       "displayTimeUnit": "ms"}, f)
        return len(self.events)


def validate_trace(events: list) -> list:
    """Structural check of a ``trace_event`` list; returns error strings.

    Pinned properties (the schema subset Perfetto relies on): every B has a
    matching same-track E (proper nesting, all spans closed), per-track
    timestamps are monotonically non-decreasing, E names — when present —
    match their B, and request-lifecycle instants (pid 2) fall inside their
    request's open span — an ``admitted``/``cancelled``/``preempted`` landing
    on a closed track means the scheduler finished a request twice.
    Metadata (``ph: "M"``) events are exempt.
    """
    errors: list = []
    stacks: dict = {}
    last_ts: dict = {}
    for i, ev in enumerate(events):
        ph = ev.get("ph")
        if ph == "M":
            continue
        key = (ev.get("pid"), ev.get("tid"))
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)):
            errors.append(f"event {i}: missing/bad ts {ts!r}")
            continue
        if ts < last_ts.get(key, float("-inf")):
            errors.append(f"event {i}: ts {ts} not monotonic on track {key}")
        last_ts[key] = ts
        if ph == "i" and ev.get("pid") == PID_REQUESTS \
                and not stacks.get(key):
            errors.append(f"event {i}: lifecycle instant "
                          f"{ev.get('name')!r} outside any open request "
                          f"span on track {key}")
        if ph == "B":
            stacks.setdefault(key, []).append((i, ev.get("name")))
        elif ph == "E":
            stack = stacks.setdefault(key, [])
            if not stack:
                errors.append(f"event {i}: E with no open B on track {key}")
                continue
            j, bname = stack.pop()
            ename = ev.get("name")
            if ename is not None and bname is not None and ename != bname:
                errors.append(f"event {i}: E name {ename!r} closes B "
                              f"{bname!r} (event {j}) on track {key}")
        elif ph not in ("i", "C", "X"):
            errors.append(f"event {i}: unknown phase {ph!r}")
    for key, stack in stacks.items():
        for j, name in stack:
            errors.append(f"track {key}: span {name!r} (event {j}) "
                          "never closed")
    return errors
