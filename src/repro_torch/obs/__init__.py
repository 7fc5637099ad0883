"""`repro_torch.obs` — zero-sync serve observability, as in ``repro.obs``.

Three pieces, threaded through the serving stack at host-side seams only:

* :mod:`repro_torch.obs.metrics` — a typed metrics registry (counters,
  gauges, series, fixed-bucket log2 histograms) that backs the scheduler's
  ``stats`` and produces the flat summary dict a serving benchmark records.
* :mod:`repro_torch.obs.trace` — a span/event recorder exporting
  Chrome/Perfetto ``trace_event`` JSON: round anatomy spans on the
  scheduler track plus one lifecycle track per request.
* :mod:`repro_torch.obs.recorder` — the ``Obs`` facade the engine and the
  scheduler accept (``obs=...``), with a free no-op path when tracing is
  off.

The hard contract (tests/test_torch_obs.py, tests/test_torch_scheduler.py):
with tracing ON, served tokens stay byte-identical and
``dispatches``/``host_syncs`` do not move — observability reads host-side
values the serve loop already holds and never adds a device sync; with
tracing OFF the recorder costs one predictable branch per seam.  The
package is pure Python: only the optional profiler ranges import torch.
"""

from .metrics import (  # noqa: F401
    Counter,
    Gauge,
    LogHistogram,
    MetricsRegistry,
    Series,
    StatsView,
)
from .recorder import NULL_SPAN, Obs  # noqa: F401
from .trace import Tracer, validate_trace  # noqa: F401
