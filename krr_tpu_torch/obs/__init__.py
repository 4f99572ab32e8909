"""Observability core of the one-shot scan: tracing, metrics, device stages,
the SLO engine, critical-path attribution and debug dumps.

* `trace`   — hierarchical thread/async-safe spans
  (``scan → discover → fetch → compute`` plus per-Prometheus-query
  children), a bounded in-memory ring of completed scan traces, Chrome
  trace-event JSON export (``--trace``) and import, cross-process
  stitching, and ``current_ids()`` (the structured log channel's hook).
  ``NULL_TRACER`` is the no-op default on every hot path.
* `metrics` — the Prometheus text-format registry the loaders and the
  runner record into (``--metrics-dump``), with process self-metrics
  refreshed at dump time.
* `device`  — staged ``compute`` sub-spans fenced on the CUDA stream, the
  nvcc build's compile accounting, padding-efficiency gauges, CUDA memory
  watermarks.
* `health`  — the SLO engine: objectives, burn-rate alerts (``--statusz``).
* `profile` — critical-path attribution over a scan trace (``--profile``,
  ``analyze``).
* `dump`    — the SIGUSR2 debug dump (trace ring, metrics snapshot and
  attribution report to timestamped files).
"""

from krr_tpu_torch.obs.device import NULL_DEVICE_OBS, DeviceObs, install_compile_hooks
from krr_tpu_torch.obs.health import Objective, SloEngine, default_objectives, engine_from_config
from krr_tpu_torch.obs.metrics import MetricsRegistry, record_build_info, refresh_process_metrics
from krr_tpu_torch.obs.trace import (
    NULL_TRACER,
    NullTracer,
    Span,
    Tracer,
    current_ids,
    stitch_chrome,
    traces_from_chrome,
    write_chrome_trace,
)

__all__ = [
    "DeviceObs",
    "MetricsRegistry",
    "NULL_DEVICE_OBS",
    "NULL_TRACER",
    "NullTracer",
    "Objective",
    "SloEngine",
    "Span",
    "Tracer",
    "current_ids",
    "default_objectives",
    "engine_from_config",
    "install_compile_hooks",
    "record_build_info",
    "refresh_process_metrics",
    "stitch_chrome",
    "traces_from_chrome",
    "write_chrome_trace",
]
