"""`serve`: the long-running recommendation service.

A port of `krr_tpu/server`. Everything here is host code: a tick's digests
come from the native parse, fold with numpy and query on the host
(``DigestStore.percentile_host``), so the serve path launches no kernel.

The one-shot CLI re-discovers the fleet and re-fetches the full history
window on every invocation. This package keeps the scan state RESIDENT — per-object digests in
a `krr_tpu_torch.core.streaming.DigestStore`, the last published
`krr_tpu_torch.models.result.Result` — and amortizes the expensive scan across
requests:

* `scheduler`  — background delta scans (fetch only the window since the
  last tick; the digest's integer-count mergeability makes the fold exact)
  plus slower-cadence re-discovery for workload churn;
* `state`      — the published-snapshot cache with read/write locking, so
  queries keep serving the previous result while a scan is in flight;
* `app`        — the asyncio HTTP surface: ``GET /recommendations``,
  ``GET /healthz``, ``GET /metrics`` (Prometheus text format),
  ``GET /statusz``, ``GET /history``, ``GET /drift``, ``GET /fleet`` (on
  a federation aggregator) and the ``/debug/trace``, ``/debug/profile`` and
  ``/debug/timeline`` routes;
* `metrics`    — re-export of the shared registry, which lives in
  `krr_tpu_torch.obs.metrics` (CLI scans record into the same
  declarations).
"""

from krr_tpu_torch.server.app import KrrServer, run_server
from krr_tpu_torch.server.metrics import MetricsRegistry
from krr_tpu_torch.server.scheduler import ScanScheduler
from krr_tpu_torch.server.state import ServerState, Snapshot

__all__ = [
    "KrrServer",
    "MetricsRegistry",
    "ScanScheduler",
    "ServerState",
    "Snapshot",
    "run_server",
]
