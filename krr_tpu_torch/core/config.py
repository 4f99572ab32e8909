"""Global configuration: the fields the one-shot CLI and its loaders read.

A trimmed copy of `krr_tpu/core/config.py`. Level 1 (this model) holds the
cluster/namespace selectors, value floors, the Prometheus and fetch settings,
the Kubernetes discovery settings, logging and observability flags, the
pinned scan end, the serve plane (scheduler, read path, durable store,
history journal and hysteresis gate, flight recorder and sentinel, SLO
engine), fleet-axis row chunking and the compute device. Level 2 — the
per-strategy ``StrategySettings`` — rides in ``other_args`` and is reflected
into CLI flags by `krr_tpu_torch.main`. The federation fields (the shard,
aggregator, ring, replica and lineage knobs) and the push-ingest fields
(the remote-write listener, the plane's buffers and the audit cadence) are
the JAX package's.

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

    #: Inventory maintenance strategy: "relist" re-fetches every workload
    #: kind and pod index per discovery round (the classic shape — request
    #: shapes byte-identical to previous releases); "watch" keeps a resident
    #: inventory fed by Kubernetes watch streams (one list+watch per
    #: workload kind plus metadata-only pod watches per active namespace,
    #: with resourceVersion bookmarks) so each discovery tick is an
    #: in-memory O(churn) reconcile — the relist remains the cold-start
    #: seed and the 410/desync resync path. Watch mode always resolves
    #: pods client-side (the bulk-discovery selection path).
    discovery_mode: Literal["relist", "watch"] = "relist"
    #: Watch-mode ground-truth audit cadence: every this many seconds a
    #: FULL relist diffs the watched inventory against the apiserver —
    #: divergence is logged, counted
    #: (``krr_tpu_discovery_verify_divergences_total``), and repaired by
    #: adopting the relist. 0 = auto: four discovery intervals.
    discovery_verify_interval_seconds: float = pd.Field(0.0, ge=0)
    #: Where the watch-mode inventory snapshot (+ resourceVersions) persists
    #: so a warm restart skips the cold relist. None = serve derives
    #: ``discovery-inventory.json`` inside the sharded state directory
    #: (``<state_path>.discovery-inventory.json`` beside a legacy file);
    #: standalone loaders without a state path keep the inventory
    #: memory-only.
    discovery_snapshot_path: Optional[str] = None
    # Push-based metrics ingest (`krr_tpu_torch.ingest`).
    #: How serve ticks get their samples. "pull" issues Prometheus range
    #: queries every tick (the classic shape). "push" runs a remote-write
    #: listener and folds buffered samples at tick time — a steady-state
    #: tick issues ZERO range queries; the range path remains the cold-start
    #: seed, the per-series-watermark gap backfill, and the periodic
    #: divergence audit's ground truth.
    metrics_mode: Literal["pull", "push"] = "pull"
    #: Remote-write listener bind port (push mode). 0 = ephemeral (tests;
    #: the chosen port is logged and shown on /statusz).
    ingest_port: int = pd.Field(9201, ge=0, le=65535)
    #: Push-mode ground-truth audit cadence: every this many seconds the
    #: tick's push-fed windows are ALSO range-fetched and compared row for
    #: row — divergence is logged, counted
    #: (``krr_tpu_ingest_verify_divergences_total``), and repaired by
    #: adopting the range rows and invalidating the diverged series buffers.
    #: 0 = auto: four scan intervals. Mirrors the discovery audit's ladder.
    ingest_verify_interval_seconds: float = pd.Field(0.0, ge=0)
    #: Largest accepted remote-write POST body (compressed bytes); larger
    #: declarations are refused with 413 before the body is read.
    ingest_max_body_bytes: int = pd.Field(16 << 20, gt=0)
    #: Staleness horizon for grid evaluation: a grid point takes the newest
    #: buffered sample no older than this (the Prometheus staleness default,
    #: so push folds see what a range query would have returned).
    ingest_lookback_seconds: float = pd.Field(300.0, gt=0)
    #: Per-series buffer cap; overflow sheds the oldest samples (counted)
    #: and pulls the series' completeness watermark forward so affected
    #: windows fall back to the range path instead of folding short.
    ingest_max_samples_per_series: int = pd.Field(8192, gt=0)
    #: Resident series cap: new series beyond it are rejected (counted) —
    #: a mislabeled fleet can't balloon the plane.
    ingest_max_series: int = pd.Field(500_000, gt=0)

    # Logging settings
    format: str = "table"
    strategy: str = "simple"
    log_to_stderr: bool = False
    #: "console" = rich prefixed lines (the reference UX); "json" = one
    #: structured object per line carrying scan_id/span_id from the active
    #: trace span, so log lines join back to --trace output.
    log_format: Literal["console", "json"] = "console"

    # Observability (`krr_tpu_torch.obs`)
    #: Write a Chrome trace-event JSON of the scan's spans to this file at
    #: exit. None = the no-op tracer.
    trace_path: Optional[str] = None
    #: Completed scan traces the in-memory ring retains (serve's
    #: GET /debug/trace window; also the CLI export buffer).
    trace_ring_scans: int = pd.Field(16, ge=1)
    #: Write a Prometheus text-exposition snapshot of the scan's metrics
    #: registry to this file at exit.
    metrics_dump_path: Optional[str] = None
    #: Exit nonzero when any object's fetch failed terminally (rows rendered
    #: UNKNOWN).
    strict: bool = False
    #: Write a one-shot SLO evaluation (`krr_tpu_torch.obs.health`, the
    #: objectives the JAX package's serve exposes on GET /statusz,
    #: evaluated once over this scan's registry) as JSON to this file at
    #: exit.
    statusz_path: Optional[str] = None
    #: Write the scan's critical-path attribution report
    #: (`krr_tpu_torch.obs.profile`, the JSON `analyze` produces) to this
    #: file at exit. Implies a recording tracer, like --trace.
    profile_path: Optional[str] = None

    # SLO engine (`krr_tpu_torch.obs.health`) — serve evaluates per scheduler
    # tick; one-shot scans evaluate once for --statusz.
    #: Error budget for the scan-failure objective: the fraction of scans
    #: allowed to abort before the budget burns.
    slo_scan_failure_budget: float = pd.Field(0.05, gt=0, le=1)
    #: Error budget for the fetch failed-row objective: the fraction of
    #: object fetches allowed to fail terminally (rows rendered UNKNOWN).
    slo_fetch_failure_budget: float = pd.Field(0.05, gt=0, le=1)
    #: Scan-latency objective limit in seconds. 0 = auto: one scan cadence
    #: (``scan_interval_seconds``).
    slo_scan_latency_seconds: float = pd.Field(0.0, ge=0)
    #: Freshness objective limit in seconds. 0 = auto: three scan cadences.
    slo_freshness_seconds: float = pd.Field(0.0, ge=0)
    #: Burn-rate windows: the FAST window makes detection quick, the SLOW
    #: window keeps a brief blip from alerting.
    slo_fast_window_seconds: float = pd.Field(300.0, gt=0)
    slo_slow_window_seconds: float = pd.Field(3600.0, gt=0)
    #: Burn-rate thresholds (windowed bad ratio ÷ budget; 1.0 = consuming
    #: exactly the budget).
    slo_fast_burn: float = pd.Field(10.0, gt=0)
    slo_slow_burn: float = pd.Field(5.0, gt=0)

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

    # Server (`krr-tpu serve`) settings
    server_host: str = "127.0.0.1"
    #: 0 = an ephemeral port (tests; the chosen port is logged).
    server_port: int = pd.Field(8080, ge=0, le=65535)
    #: Seconds between incremental delta scans (each fetches only the window
    #: since the last fold).
    scan_interval_seconds: float = pd.Field(900.0, gt=0)
    #: Seconds between fleet re-discoveries (workload churn pickup + store
    #: compaction); effectively rounded up to the scan cadence, since
    #: discovery staleness is checked at each scan tick.
    discovery_interval_seconds: float = pd.Field(3600.0, gt=0)
    #: Degraded-tick floor: a serve tick whose fetch-success fraction falls
    #: BELOW this percentage aborts (nothing folds, the window refetches
    #: next tick) instead of publishing a mostly-empty fleet — a mostly-dead
    #: Prometheus must not publish garbage. At or above it, failed workloads
    #: quarantine (carry forward last-good digests, marked stale) and the
    #: successful remainder still folds and publishes. 100 restores the
    #: all-or-nothing pre-quarantine behavior.
    min_fetch_success_pct: float = pd.Field(50.0, ge=0, le=100)
    # High-QPS read path (`krr_tpu_torch.server.state.ResponseCache` + the app's
    # bounded render pool).
    #: Epoch-keyed rendered-response cache for GET /recommendations: False
    #: restores the render-per-request behavior (the bench loadtest's
    #: uncached control, and an escape hatch).
    response_cache_enabled: bool = True
    #: Entry bound on the response cache — one entry per (format,
    #: canonicalized filters, page, encoding) combination, evicted LRU.
    response_cache_max_entries: int = pd.Field(256, ge=1)
    #: Byte budget (MiB) on cached response bodies — adversarial filter
    #: cardinality must not OOM the server.
    response_cache_max_mb: float = pd.Field(64.0, gt=0)
    #: Concurrent cache-miss renders (worker threads) the read path allows.
    server_render_concurrency: int = pd.Field(4, ge=1)
    #: Requests allowed to WAIT behind a saturated render pool before the
    #: rest shed with 503/Retry-After (0 = shed as soon as every worker is
    #: busy).
    server_render_queue: int = pd.Field(16, ge=0)
    #: Read-path latency SLO: the per-tick GET /recommendations p99 must
    #: stay under this many seconds (threshold objective, like
    #: scan_latency). 0 disables the objective.
    slo_read_p99_seconds: float = pd.Field(0.0, ge=0)

    # Durable digest store (`krr_tpu_torch.core.durastore`) — the sharded
    # state-directory persistence behind the strategy's --state_path (the
    # on-disk FORMAT is the strategy's --store_format; these tune the
    # sharded engine).
    #: Rows per base-snapshot shard file: compaction slices the store into
    #: contiguous row ranges of this size.
    store_shard_rows: int = pd.Field(32768, ge=1)
    #: Compaction trigger: fold the delta WAL back into base shards once it
    #: exceeds this fraction of the base snapshots' bytes (replay time
    #: stays bounded while the per-tick persist stays one small append).
    store_compact_wal_ratio: float = pd.Field(0.5, gt=0)
    #: Compaction floor in MiB: below this WAL size, never compact — tiny
    #: stores must not pay a base rewrite per handful of ticks.
    store_compact_min_wal_mb: float = pd.Field(16.0, ge=0)

    # Scan flight recorder + regression sentinel (`krr_tpu_torch.obs.timeline`,
    # `krr_tpu_torch.obs.sentinel`) — serve-only: each completed tick appends one
    # durable timeline record, and the sentinel classifies it against
    # rolling median/MAD baselines.
    #: Timeline file override. None = derive from the strategy's state_path
    #: (``<state_dir>/timeline.log`` in a sharded state directory,
    #: ``<state_path>.timeline`` beside a legacy single file); an explicit
    #: empty string keeps the recorder memory-only even with a state_path.
    timeline_path: Optional[str] = None
    #: Scan records the recorder retains (in memory and, via retention
    #: compaction, on disk).
    timeline_retain_records: int = pd.Field(4096, ge=1)
    #: The --no-sentinel escape hatch: False records the timeline without
    #: classifying it.
    sentinel_enabled: bool = True
    #: Nominal scans of a kind (full|delta) the sentinel must observe
    #: before issuing verdicts for that kind — a cold server must not page
    #: on its first tick.
    sentinel_warmup_scans: int = pd.Field(8, ge=2)
    #: Rolling baseline window: nominal values per (kind, category) the
    #: median/MAD bands are computed over. Also the consecutive-regression
    #: count after which a sustained level shift rebases as the new normal.
    sentinel_baseline_scans: int = pd.Field(64, ge=2)
    #: Deviation threshold in band units: a category regresses when its
    #: value exceeds ``median + sigma × max(1.4826·MAD, floors)``.
    sentinel_sigma: float = pd.Field(3.0, gt=0)
    #: Relative band floor as a fraction of the median — keeps a
    #: near-constant series (MAD ≈ 0) from flagging noise.
    sentinel_rel_floor: float = pd.Field(0.10, ge=0)
    #: Absolute band floor in seconds (same purpose, for tiny medians).
    sentinel_abs_floor_seconds: float = pd.Field(0.05, ge=0)
    #: Register the optional ``scan_regressions`` SLO objective: regressed
    #: scans burn its error budget like aborted scans burn scan_failures'.
    sentinel_slo_enabled: bool = False
    #: Error budget for that objective: the fraction of classified scans
    #: allowed to regress before the budget burns.
    sentinel_slo_budget: float = pd.Field(0.10, gt=0, le=1)

    #: One-shot recovery flag for ``--fetch-downsample`` over a persisted
    #: window cursor that predates the flag (unaligned grid): drop the
    #: cursor and accumulated rows at startup so the next tick runs a
    #: grid-ALIGNED full backfill and downsampling actually engages.
    realign_window_grid: bool = False

    #: Staleness budget for quarantined workloads: how old a quarantined
    #: workload's last folded sample may grow while its digests carry
    #: forward. Past the budget the workload's accumulated row is dropped
    #: and it re-enters as fresh (full-window backfill on the next
    #: successful fetch) — incremental catch-up that far back would exceed
    #: what the operator is willing to serve as "last known good".
    #: 0 = auto: ten scan cadences.
    max_staleness_seconds: float = pd.Field(0.0, ge=0)

    # Multi-cluster federation (`krr_tpu_torch.federation`)
    #: ``host:port`` the serve process accepts scanner-shard delta streams
    #: on — setting it turns serve into the federation AGGREGATOR: the
    #: scheduler stops scanning and each tick replays queued shard records
    #: into the fleet store instead, publishing the merged view through the
    #: unchanged read path. None = classic single-process serve.
    federation_listen: Optional[str] = None
    #: ``host:port`` of the aggregator a ``shard`` process streams
    #: its delta records to.
    federation_aggregator: Optional[str] = None
    #: Shard identity in the federation (epoch watermarks key on it).
    #: Default: the shard's configured cluster list joined with '/'.
    federation_shard_id: Optional[str] = None
    #: Shard staleness budget at the aggregator: a shard whose newest
    #: delivered window is older than this serves carried-forward rows with
    #: ``stale_since`` marks (the federation twin of the quarantine marks).
    #: 0 = auto: three scan cadences.
    federation_staleness_seconds: float = pd.Field(0.0, ge=0)
    #: Record-count bound on BOTH sides of the federation stream: the
    #: aggregator queues at most this many decoded-but-unapplied records
    #: per shard before back-pressuring that shard's connection, and a
    #: shard whose unacked buffer exceeds it collapses the backlog into
    #: one snapshot record (bounded memory through an aggregator outage
    #: of any length).
    federation_queue_records: int = pd.Field(4096, ge=1)
    #: Key-range partitioned aggregation plane
    #: (`krr_tpu_torch.federation.ring`): ``name=host:port[|host:port...],...``
    #: names each aggregator and its endpoint(s) — a shard splits every
    #: tick's delta record by consistent-hash key owner and streams each
    #: partition to its owning aggregator; a node listing extra endpoints
    #: replicates its stream to standbys (HA failover with zero lost
    #: epochs). Mutually exclusive with ``federation_aggregator`` on a
    #: shard (the ring subsumes the single-aggregator case).
    federation_ring: Optional[str] = None
    #: Ceiling on the federation reconnect backoff ladder (uplinks AND
    #: replica feeds): waits grow 0.25·2^(n−1) seconds, capped here before
    #: ±50% jitter — the same retry semantics as
    #: ``prometheus_backoff_cap_seconds``.
    federation_backoff_cap_seconds: float = pd.Field(5.0, gt=0)
    #: ``host:port`` of a HIGHER-tier aggregator this serve process
    #: uplinks its OWN store's deltas to (requires ``federation_listen``):
    #: region aggregators uplink to a global one over the same shard
    #: protocol, so the tiers compose without a second wire format.
    federation_uplink: Optional[str] = None
    #: End-to-end freshness lineage: when on, every shard tick stamps its
    #: delta records with a lineage block (newest-sample → fold → apply →
    #: publish → install timestamps accumulate hop by hop) and the
    #: aggregator fires ``krr_tpu_e2e_freshness_seconds{stage}`` per epoch.
    #: Metadata-only — stores and served bytes are bit-identical either
    #: way. Off = the no-lineage control (bench overhead gate).
    federation_lineage_enabled: bool = True

    # Recommendation history + hysteresis (`krr_tpu_torch.history`, serve publish path)
    #: Journal file recording every recompute's raw recommendations (the
    #: flight recorder behind GET /history, GET /drift, and `krr-tpu diff`).
    #: None = derive ``<state_path>.journal`` when the strategy's state_path
    #: is set, else keep the journal memory-only; an explicit empty string
    #: forces memory-only even with a state_path.
    history_path: Optional[str] = None
    #: Journal retention window — records older than this are dropped by the
    #: per-tick compaction, bounding journal growth at fleet scale.
    history_retention_seconds: float = pd.Field(7 * 24 * 3600.0, gt=0)
    #: Hysteresis dead band: a workload's published recommendation holds
    #: until the raw recommendation drifts more than this percentage from
    #: it (relative, per resource)...
    hysteresis_dead_band_pct: float = pd.Field(5.0, ge=0)
    #: ...for this many CONSECUTIVE scan ticks (then it jumps straight to
    #: the current raw value).
    hysteresis_confirm_ticks: int = pd.Field(2, ge=1)
    #: The --no-hysteresis escape hatch: False publishes every recompute
    #: verbatim (bit-exact legacy behavior); the journal still records
    #: every tick either way.
    hysteresis_enabled: bool = True

    # Quality evaluation (`krr_tpu_torch.eval`)
    #: Replay ticks the ``eval`` command walks the recorded grid in: each
    #: tick the strategy sees the history so far and its raw recommendation
    #: routes through the real hysteresis gate before scoring.
    eval_replay_ticks: int = pd.Field(16, ge=1)
    #: Serve the journal-derived fleet savings block on GET /statusz (and
    #: the krr_tpu_eval_* gauges it refreshes); False skips the computation
    #: entirely on scrape.
    savings_enabled: bool = True


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
            log_format=self.log_format,
        )

    def create_tracer(self):
        """A recording tracer when ``--trace`` or ``--profile`` asked for
        one (both consume the recorded ring at exit), else the no-op tracer —
        the disabled path must stay free (`krr_tpu_torch.obs.trace`). Serve
        swaps in a recording tracer unconditionally (its ring backs
        ``GET /debug/trace``)."""
        from krr_tpu_torch.obs.trace import NULL_TRACER, Tracer

        if self.trace_path or self.profile_path:
            return Tracer(ring_scans=self.trace_ring_scans)
        return NULL_TRACER
