"""Observability core of the one-shot scan: tracing and metrics.

* `trace`   — hierarchical thread/async-safe spans
  (``scan → discover → fetch → compute`` plus per-Prometheus-query
  children), a bounded in-memory ring of completed scan traces, Chrome
  trace-event JSON export (``--trace``), and ``current_ids()``.
  ``NULL_TRACER`` is the no-op default on every hot path.
* `metrics` — the Prometheus text-format registry the loaders and the
  runner record into (``--metrics-dump``), with process self-metrics
  refreshed at dump time.
"""

from krr_tpu_torch.obs.metrics import MetricsRegistry
from krr_tpu_torch.obs.trace import NULL_TRACER, NullTracer, Span, Tracer, current_ids

__all__ = ["MetricsRegistry", "NULL_TRACER", "NullTracer", "Span", "Tracer", "current_ids"]
