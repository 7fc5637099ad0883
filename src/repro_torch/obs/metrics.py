"""Typed metrics registry: counters, gauges, series, log2 histograms, as in
``repro.obs.metrics`` (pure Python; the same names and snapshots).

The registry replaces the scheduler's free-form ``stats`` dict and the
serving benchmark's per-leg percentile math with one definition of each
aggregate.  Metric types:

* :class:`Counter` — monotonic int (``dispatches``, ``host_syncs``, ...).
* :class:`Gauge` — last-value float (pool occupancy right now).
* :class:`Series` — an appended per-round trace whose *snapshot* is its
  mean (``occupancy_trace`` → ``mean_occupancy``).
* :class:`LogHistogram` — streaming percentiles from FIXED log2 buckets;
  no sample list is ever stored, so recording is O(1) and memory is a few
  hundred int64s regardless of traffic.  Quantile error is bounded by the
  bucket width (``2 ** (1 / SUBDIV)`` relative), which tests pin against
  ``numpy.percentile``.

``MetricsRegistry.snapshot()`` flattens everything to the flat
``{key: number}`` dict shape a serving benchmark records per leg
(histograms emit ``{name}_p{q}_{unit}`` keys); ``stats_view()`` returns a
dict-like façade over the counters/series so existing ``stats["x"] += 1``
call sites and tests keep working unchanged.
"""

from __future__ import annotations

import math
from collections.abc import MutableMapping
from typing import Optional, Sequence

__all__ = ["Counter", "Gauge", "Series", "LogHistogram", "MetricsRegistry",
           "StatsView"]


class Counter:
    """Monotonic-ish integer counter (decrements are allowed for plan
    rollbacks — ``_unplan_pages`` un-counts a hit it optimistically took)."""

    __slots__ = ("name", "key", "value")

    def __init__(self, name: str, key: Optional[str] = None):
        self.name = name
        self.key = key or name
        self.value = 0

    def inc(self, n: int = 1):
        self.value += n

    def snapshot(self) -> dict:
        return {self.key: int(self.value)}


class Gauge:
    """Last-observed value."""

    __slots__ = ("name", "key", "value")

    def __init__(self, name: str, key: Optional[str] = None):
        self.name = name
        self.key = key or name
        self.value = 0.0

    def set(self, v: float):
        self.value = float(v)

    def snapshot(self) -> dict:
        return {self.key: self.value}


class Series:
    """Appended per-round trace; snapshots as its MEAN under ``key``.

    The underlying list stays reachable (``sched.stats["occupancy_trace"]``)
    because round-resolution traces are themselves an observability product
    — one float per scheduling round, bounded by the run length.
    """

    __slots__ = ("name", "key", "values")

    def __init__(self, name: str, key: Optional[str] = None):
        self.name = name
        self.key = key or name
        self.values: list = []

    def append(self, v: float):
        self.values.append(v)

    @property
    def mean(self) -> float:
        return float(sum(self.values) / len(self.values)) if self.values else 0.0

    def snapshot(self) -> dict:
        return {self.key: self.mean}


class LogHistogram:
    """Streaming percentile estimator over fixed log2 buckets.

    Positive samples land in bucket ``floor(log2(v) * SUBDIV)``: SUBDIV
    sub-buckets per octave give a relative resolution of ``2**(1/SUBDIV)``
    (~9% at the default 8).  Non-positive samples land in a dedicated
    zero bucket reported as 0.0.  ``percentile(q)`` is nearest-rank over
    the bucket counts, returning the hit bucket's geometric midpoint — so
    p50/p90/p99 cost an O(buckets) scan and NO stored samples, the
    property that lets the serve loop record per-round latencies without
    growing state.
    """

    SUBDIV = 8                       # sub-buckets per octave
    LO = -30                         # 2**-30 ≈ 1e-9 in the recording unit
    HI = 30                          # 2**30 ≈ 1e9

    __slots__ = ("name", "unit", "percentiles", "counts", "zero", "count",
                 "total")

    def __init__(self, name: str, *, unit: str = "ms",
                 percentiles: Sequence[int] = (50, 99)):
        self.name = name
        self.unit = unit
        self.percentiles = tuple(percentiles)
        n = (self.HI - self.LO) * self.SUBDIV
        self.counts = [0] * n
        self.zero = 0                # v <= 0 samples
        self.count = 0
        self.total = 0.0             # exact running sum (mean stays exact)

    def record(self, v: float):
        self.count += 1
        self.total += v
        if v <= 0.0:
            self.zero += 1
            return
        idx = math.floor(math.log2(v) * self.SUBDIV) - self.LO * self.SUBDIV
        self.counts[min(max(idx, 0), len(self.counts) - 1)] += 1

    def _bucket_mid(self, idx: int) -> float:
        return 2.0 ** ((idx + 0.5) / self.SUBDIV + self.LO)

    def percentile(self, q: float) -> float:
        """Nearest-rank percentile (geometric bucket midpoint); 0.0 when
        empty."""
        if self.count == 0:
            return 0.0
        rank = max(int(math.ceil(q / 100.0 * self.count)), 1)
        if rank <= self.zero:
            return 0.0
        seen = self.zero
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= rank:
                return self._bucket_mid(i)
        return self._bucket_mid(len(self.counts) - 1)

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def snapshot(self) -> dict:
        return {f"{self.name}_p{q}_{self.unit}": self.percentile(q)
                for q in self.percentiles}


class StatsView(MutableMapping):
    """Dict façade over a registry's counters and series.

    ``view["dispatches"] += 1`` hits the underlying :class:`Counter`;
    ``view["occupancy_trace"].append(x)`` hits the :class:`Series` list.
    This is what keeps every existing ``sched.stats[...]`` call site and
    test working while the registry owns the storage.
    """

    def __init__(self, registry: "MetricsRegistry"):
        self._registry = registry

    def _stats(self) -> dict:
        return {name: m for name, m in self._registry._metrics.items()
                if isinstance(m, (Counter, Series))}

    def __getitem__(self, name):
        m = self._stats()[name]
        return m.values if isinstance(m, Series) else m.value

    def __setitem__(self, name, value):
        m = self._registry._metrics.get(name)
        if isinstance(m, Counter):
            m.value = value
        elif isinstance(m, Series):
            m.values = list(value)
        else:
            self._registry.counter(name).value = value

    def __delitem__(self, name):
        raise TypeError("stats metrics cannot be deleted")

    def __iter__(self):
        return iter(self._stats())

    def __len__(self):
        return len(self._stats())

    def __repr__(self):
        return repr(dict(self))


class MetricsRegistry:
    """Name-keyed collection of metrics with one flat snapshot.

    ``counter``/``gauge``/``series``/``histogram`` are idempotent
    fetch-or-create (re-registering under the same name returns the live
    metric), so the scheduler and the bench can both name the metrics they
    touch without ordering constraints.
    """

    def __init__(self):
        self._metrics: dict = {}

    def _get_or_make(self, cls, name, **kw):
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = cls(name, **kw)
        elif not isinstance(m, cls):
            raise TypeError(f"metric {name!r} already registered as "
                            f"{type(m).__name__}, not {cls.__name__}")
        return m

    def counter(self, name: str, key: Optional[str] = None) -> Counter:
        return self._get_or_make(Counter, name, key=key)

    def gauge(self, name: str, key: Optional[str] = None) -> Gauge:
        return self._get_or_make(Gauge, name, key=key)

    def series(self, name: str, key: Optional[str] = None) -> Series:
        return self._get_or_make(Series, name, key=key)

    def histogram(self, name: str, *, unit: str = "ms",
                  percentiles: Sequence[int] = (50, 99)) -> LogHistogram:
        return self._get_or_make(LogHistogram, name, unit=unit,
                                 percentiles=percentiles)

    def inc(self, name: str, n: int = 1):
        self.counter(name).inc(n)

    def observe(self, name: str, v: float, **kw):
        self.histogram(name, **kw).record(v)

    def get(self, name: str):
        return self._metrics.get(name)

    def stats_view(self) -> StatsView:
        return StatsView(self)

    def snapshot(self) -> dict:
        """Flat ``{key: number}`` dict over every registered metric — the
        per-leg summary shape a serving benchmark records."""
        out: dict = {}
        for m in self._metrics.values():
            out.update(m.snapshot())
        return out
