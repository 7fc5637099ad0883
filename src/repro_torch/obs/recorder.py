"""The ``Obs`` facade the serving stack threads through (``obs=...``), as in
``repro.obs.recorder``.

One object bundles the two sinks — a :class:`~repro_torch.obs.metrics.
MetricsRegistry` (always present; it backs ``scheduler.stats``) and an
optional :class:`~repro_torch.obs.trace.Tracer` — behind no-op-cheap entry
points.  Every hook degrades to a single attribute test when tracing is
off: ``span`` returns the shared :data:`NULL_SPAN`, ``event``/``counter``/
``request_*`` return immediately.  That is the "tracing OFF costs nothing
measurable" half of the contract; the other half (tracing ON moves no
tokens and no ``dispatches``/``host_syncs``) holds because every hook
records only host-resident values.

``annotations=True`` additionally wraps ``span(..., dispatch=True)`` seams
in ``torch.profiler.record_function`` (and an NVTX range once CUDA is in
use), so a concurrently captured ``torch.profiler`` trace interleaves the
device timeline with these spans.
"""

from __future__ import annotations

import contextlib
from typing import Optional

from .metrics import MetricsRegistry
from .trace import Tracer

__all__ = ["Obs", "NULL_SPAN"]


class _NullSpan:
    """Shared do-nothing context manager (the tracing-off fast path)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_SPAN = _NullSpan()


@contextlib.contextmanager
def _profiler_range(name: str):
    """A ``torch.profiler.record_function`` range, inside an NVTX range when
    CUDA is in use (torch is imported here, never by ``obs`` itself)."""
    import torch

    nvtx = torch.cuda.is_available() and torch.cuda.is_initialized()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


class Obs:
    """Observability handle: a metrics registry plus an optional tracer.

    Parameters
    ----------
    metrics: registry to record into (default: a fresh one — callers that
        want engine + scheduler + bench in one registry pass it explicitly).
    tracer: a :class:`Tracer` to record the span timeline into, or None
        (the default) for metrics-only operation.
    annotations: wrap dispatch-seam spans in profiler ranges so device
        profiles interleave.
    """

    def __init__(self, metrics: Optional[MetricsRegistry] = None,
                 tracer: Optional[Tracer] = None,
                 annotations: bool = False):
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.tracer = tracer
        self.annotations = annotations

    @property
    def tracing(self) -> bool:
        return self.tracer is not None

    # ------------------------------------------------------------------
    # span/event hooks (no-ops without a tracer)
    # ------------------------------------------------------------------

    def span(self, name: str, dispatch: bool = False, **args):
        """Span on the serve-loop track; ``dispatch=True`` marks a device
        dispatch seam eligible for the profiler-range wrapper."""
        if self.tracer is None:
            return NULL_SPAN
        ann = (_profiler_range(name)
               if dispatch and self.annotations else None)
        return self.tracer.span(name, ann=ann, **args)

    def event(self, name: str, **args):
        if self.tracer is not None:
            self.tracer.instant(name, **args)

    def counter(self, name: str, value: float):
        if self.tracer is not None:
            self.tracer.counter(name, value)

    def request_begin(self, rid: int, **args):
        if self.tracer is not None:
            self.tracer.request_begin(rid, **args)

    def request_event(self, rid: int, name: str, **args):
        if self.tracer is not None:
            self.tracer.request_event(rid, name, **args)

    def request_end(self, rid: int, **args):
        if self.tracer is not None:
            self.tracer.request_end(rid, **args)

    def export(self, path: str) -> int:
        """Export the trace (0 events when tracing is off)."""
        return self.tracer.export(path) if self.tracer is not None else 0
