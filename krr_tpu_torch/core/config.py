"""Global configuration: the fields the one-shot CLI and its loaders read.

A trimmed copy of `krr_tpu/core/config.py`. Level 1 (this model) holds the
cluster/namespace selectors, value floors, the Prometheus and fetch settings,
the Kubernetes discovery settings, logging and observability flags, the
pinned scan end, fleet-axis row chunking and the compute device. Level 2 —
the per-strategy ``StrategySettings`` — rides in ``other_args`` and is
reflected into CLI flags by `krr_tpu_torch.main`. The serve, SLO, store and
federation fields arrive with the slices that read them.

Cluster detection is lazy and lives in the integrations layer: nothing
authenticates at import time.
"""

from __future__ import annotations

import os
from typing import Any, Literal, Optional, Union

import pydantic as pd
from pydantic import field_validator

from krr_tpu_torch.utils.logging import KrrLogger


def detect_inside_cluster() -> bool:
    """True when running inside a pod with a service-account token mounted."""
    return bool(os.environ.get("KUBERNETES_SERVICE_HOST")) and os.path.exists(
        "/var/run/secrets/kubernetes.io/serviceaccount/token"
    )


#: Default per-window sample budget for streamed range queries — THE single
#: source of truth (the Config field default and the CLI flag default both
#: reference it). Sits under Prometheus's default --query.max-samples=50e6.
DEFAULT_MAX_STREAMED_SAMPLES = 40_000_000


class Config(pd.BaseModel):
    quiet: bool = False
    verbose: bool = False

    clusters: Union[list[str], Literal["*"], None] = None
    namespaces: Union[list[str], Literal["*"]] = "*"

    # Value settings
    cpu_min_value: int = pd.Field(5, ge=0)  # millicores
    memory_min_value: int = pd.Field(10, ge=0)  # megabytes

    # Prometheus settings
    prometheus_url: Optional[str] = None
    prometheus_auth_header: Optional[str] = None
    prometheus_ssl_enabled: bool = False
    prometheus_max_connections: int = pd.Field(32, ge=1)  # bulk-fetch fan-out width
    #: Per-window total-sample budget for STREAMED range queries (the stats
    #: native ingest — bodies never materialize, so this bounds the retry
    #: unit and the server-side load, not client memory).
    prometheus_max_streamed_samples: int = pd.Field(DEFAULT_MAX_STREAMED_SAMPLES, ge=1)
    #: Cap on one jittered exponential backoff sleep between range-query
    #: retry attempts.
    prometheus_backoff_cap_seconds: float = pd.Field(5.0, gt=0)
    #: Per-SCAN retry deadline budget: total seconds of retry-backoff sleep
    #: all of a scan's range queries may burn combined. 0 disables it.
    prometheus_retry_deadline_seconds: float = pd.Field(60.0, ge=0)
    #: Circuit breaker around each Prometheus target: this many CONSECUTIVE
    #: retry-ladder exhaustions open it. 0 disables the breaker.
    prometheus_breaker_threshold: int = pd.Field(10, ge=0)
    #: Seconds an OPEN breaker fails fast before letting ONE probe through.
    prometheus_breaker_cooldown_seconds: float = pd.Field(30.0, gt=0)
    #: Log a warning for any Prometheus range query slower than this many
    #: seconds (retries included); 0 disables the slow-query log.
    prometheus_slow_query_seconds: float = pd.Field(10.0, ge=0)

    # Adaptive fetch engine (`krr_tpu_torch.core.fetchplan`)
    #: "adaptive" coalesces small namespaces and shards giant ones from the
    #: previous scan's telemetry; "fixed" pins one query per (namespace,
    #: resource) — results are bit-exact either way.
    fetch_plan: Literal["adaptive", "fixed"] = "adaptive"
    #: Series-count target for one planned query. 0 = auto.
    fetch_plan_target_series: int = pd.Field(0, ge=0)
    #: Most shards one giant namespace may split into.
    fetch_plan_max_shards: int = pd.Field(16, ge=1)
    #: AIMD-autotune the in-flight range-query limit; false pins the
    #: fixed-width semaphore at --prometheus-max-connections.
    fetch_autotune: bool = True
    #: Compressed transport for range-query responses (auto|gzip|off).
    fetch_compression: Literal["auto", "gzip", "off"] = "auto"
    #: Server-side pre-aggregation for stats-route queries: "auto" rewrites
    #: eligible queries as count/max_over_time subqueries into grid-aligned
    #: coarse buckets (bit-exact by construction); "off" disables it.
    fetch_downsample: Literal["auto", "off"] = "off"
    #: Grid points per coarse downsample bucket. 0 = auto.
    fetch_downsample_factor: int = pd.Field(0, ge=0)

    # Kubernetes settings
    kubeconfig: Optional[str] = None  # path override; default resolution in integrations
    #: One pods request per namespace with client-side selector matching
    #: (O(namespaces) apiserver calls); False = the reference's per-workload
    #: server-side selector queries.
    bulk_pod_discovery: bool = True
    #: One Prometheus range query per (namespace, resource) with client-side
    #: (pod, container) routing; False = one query per (workload, resource).
    #: A failed batched query falls back to per-workload automatically.
    batched_fleet_queries: bool = True

    # Logging settings
    format: str = "table"
    strategy: str = "simple"
    log_to_stderr: bool = False

    # Observability (`krr_tpu_torch.obs`)
    #: Write a Chrome trace-event JSON of the scan's spans to this file at
    #: exit. None = the no-op tracer.
    trace_path: Optional[str] = None
    #: Write a Prometheus text-exposition snapshot of the scan's metrics
    #: registry to this file at exit.
    metrics_dump_path: Optional[str] = None
    #: Exit nonzero when any object's fetch failed terminally (rows rendered
    #: UNKNOWN).
    strict: bool = False

    #: Pin the scan window's right edge to an absolute unix timestamp —
    #: reproducible scans (two runs see identical samples). Default: now.
    scan_end_timestamp: Optional[float] = None

    #: Scan-pipeline depth (`krr_tpu_torch.core.pipeline`): digest-ingest
    #: scans fetch the fleet as per-namespace batches and fold each batch
    #: while the rest still fetch, with at most this many batches in flight
    #: at each of the fetch and the fold-queue stages (bounded backpressure:
    #: ≤ 2 × depth + 1 fetched-but-unfolded batches ever exist). 0 disables
    #: streaming — the staged gather-then-fold path.
    pipeline_depth: int = pd.Field(4, ge=0)

    #: Fleet-axis host chunking: the raw path's packed [rows × T] copy is
    #: built (and run) at most this many rows at a time
    #: (`krr_tpu_torch.strategies.base.run_batch_row_chunks`).
    max_fleet_rows_per_device: int = pd.Field(200_000, ge=1)

    #: Compute device handed to strategies that take one: "cuda" (the
    #: hand-written kernels; raises without a card) or "cpu" (the plain
    #: PyTorch versions). A ``device`` in ``other_args`` wins.
    device: str = "cuda"

    other_args: dict[str, Any] = pd.Field(default_factory=dict)

    @field_validator("namespaces")
    @classmethod
    def _empty_namespaces_mean_all(cls, v: Union[list[str], Literal["*"]]) -> Union[list[str], Literal["*"]]:
        return "*" if v == [] else v

    @field_validator("strategy")
    @classmethod
    def _strategy_exists(cls, v: str) -> str:
        from krr_tpu_torch.strategies.base import BaseStrategy

        BaseStrategy.find(v)  # raises with the available list if unknown
        return v

    @field_validator("format")
    @classmethod
    def _format_exists(cls, v: str) -> str:
        from krr_tpu_torch.formatters.base import BaseFormatter

        BaseFormatter.find(v)
        return v

    @property
    def inside_cluster(self) -> bool:
        return detect_inside_cluster()

    def create_strategy(self):
        from krr_tpu_torch.strategies.base import BaseStrategy

        strategy_type = BaseStrategy.find(self.strategy)
        settings_type = strategy_type.get_settings_type()
        args = dict(self.other_args)
        if "device" in settings_type.model_fields:
            args.setdefault("device", self.device)
        return strategy_type(settings_type(**args))

    def create_logger(self) -> KrrLogger:
        return KrrLogger(
            quiet=self.quiet,
            verbose=self.verbose,
            log_to_stderr=self.log_to_stderr,
        )

    def create_tracer(self):
        """A recording tracer when ``--trace`` asked for one, else the no-op
        tracer — the disabled path must stay free (`krr_tpu_torch.obs.trace`)."""
        from krr_tpu_torch.obs.trace import NULL_TRACER, Tracer

        if self.trace_path:
            return Tracer()
        return NULL_TRACER
