"""CLI: one sub-command per registered strategy, flags reflected from settings.

Port of the one-shot scan commands of `krr_tpu/main.py`: the same UX —
``krr-tpu-torch simple --cpu_percentile 95 -n default -f json`` — built
programmatically on click. Each strategy's pydantic settings model is
introspected and its fields become typed ``--flags``; defining a
strategy/formatter subclass before calling ``krr_tpu_torch.run()`` adds a
command/option, preserving the plugin contract. A scan runs on the card
(``--device cuda``, the default) unless the caller passes ``--device cpu``.

The scan commands carry the JAX package's observability options:
``--trace``, ``--metrics-dump``, ``--statusz`` with the ``--slo-*`` knobs,
``--profile``, ``--log-format`` and the ``profile_dir`` strategy option; a
scan installs the SIGUSR2 debug dump. ``analyze`` renders a ``--trace``
file's critical-path attribution, stitches several traces, or (``--trend``)
replays a serve flight recorder's timeline through the regression sentinel.
``serve`` runs the long-lived service (`krr_tpu_torch.server`) and ``diff``
renders the delta between two journal points or a journal point and a live
scan (`krr_tpu_torch.history.diff`); both ride the ``tdigest`` strategy.
``eval`` replays registered strategies over recorded usage and ranks them
(`krr_tpu_torch.eval`), on ``--device``. Federation
(`krr_tpu_torch.federation`): ``shard`` streams one partition's delta ops
to a ``serve --federation-listen`` aggregator, ``replica`` serves an
aggregator's epoch feed, and ``fleet-status`` prints its ``GET /fleet``
census; ``shard`` takes ``--device`` like ``serve``, ``replica`` and
``fleet-status`` run no strategy and take none. ``serve --metrics-mode push``
runs the remote-write listener and folds its buffered streams
(`krr_tpu_torch.ingest`), configured by the ``--ingest-*`` flags.
"""

from __future__ import annotations

import asyncio
import datetime
import decimal
import types
import typing
import uuid
from typing import Any

import click
import pydantic_core

from krr_tpu_torch.core.config import DEFAULT_MAX_STREAMED_SAMPLES
from krr_tpu_torch.utils.version import get_version


#: Settings fields that tune the device backend rather than the strategy's
#: recommendation math — rendered in their own help panel.
DEVICE_BACKEND_FIELDS = {"use_mesh", "mesh_time_axis", "device", "profile_dir", "host_stream_mb", "exact_sketch_budget"}

#: Help-panel render order (any unlisted panel prints after these).
PANEL_ORDER = (
    "General Settings",
    "Server Settings",
    "SLO Settings",
    "Logging Settings",
    "Strategy Settings",
    "Device Backend Settings",
)


class PanelOption(click.Option):
    """A click option carrying the help panel it renders under."""

    def __init__(self, *args: Any, panel: str = "General Settings", **kwargs: Any):
        super().__init__(*args, **kwargs)
        self.panel = panel


class PanelCommand(click.Command):
    """Groups ``--help`` output into titled option panels, mirroring the
    reference CLI's ``rich_help_panel`` sections
    (`robusta_krr/main.py:79-82`)."""

    def format_options(self, ctx: click.Context, formatter: click.HelpFormatter) -> None:
        panels: dict[str, list[tuple[str, str]]] = {}
        for param in self.get_params(ctx):
            record = param.get_help_record(ctx)
            if record is not None:  # click's auto --help lands in General
                panels.setdefault(getattr(param, "panel", "General Settings"), []).append(record)
        ordered = [p for p in PANEL_ORDER if p in panels]
        ordered += [p for p in panels if p not in PANEL_ORDER]
        for panel in ordered:
            with formatter.section(panel):
                formatter.write_dl(panels[panel])


def _click_type(annotation: Any) -> Any:
    """Map a settings-field annotation to a click param type (the analogue of
    the reference's ``__process_type``, `robusta_krr/main.py:29-36`,
    which unwraps Optional and passes UUID through). ``Optional[T]`` unwraps
    to T; unknown types round-trip as str and pydantic re-validates."""
    origin = typing.get_origin(annotation)
    if origin in (typing.Union, types.UnionType):
        non_none = [a for a in typing.get_args(annotation) if a is not type(None)]
        if len(non_none) == 1:  # Optional[T] -> T
            return _click_type(non_none[0])
        return str
    if annotation is bool:
        return bool
    if annotation is int:
        return int
    if annotation in (float, decimal.Decimal):
        return float
    if annotation is uuid.UUID:
        return click.UUID
    if annotation is datetime.datetime:
        return click.DateTime()
    return str  # unknown types round-trip as str; pydantic re-validates


def _element_type(annotation: Any) -> Any:
    """For a list/set/tuple annotation, the click type of its elements —
    rendered as a repeatable flag (``--field a --field b``); None for
    non-sequence annotations."""
    origin = typing.get_origin(annotation)
    if origin in (typing.Union, types.UnionType):
        non_none = [a for a in typing.get_args(annotation) if a is not type(None)]
        return _element_type(non_none[0]) if len(non_none) == 1 else None
    if origin in (list, set, frozenset, tuple):
        args = typing.get_args(annotation)
        return _click_type(args[0]) if args else str
    return None


def _strategy_options(strategy_type: Any) -> list[click.Option]:
    """Reflect a StrategySettings model's fields into click options."""
    options: list[click.Option] = []
    for field_name, field in strategy_type.get_settings_type().model_fields.items():
        # get_default resolves default_factory fields too; truly required
        # fields come back as PydanticUndefined -> no CLI default.
        default = field.get_default(call_default_factory=True)
        if default is pydantic_core.PydanticUndefined:
            default = None
        if isinstance(default, decimal.Decimal):
            default = float(default)
        element = _element_type(field.annotation)
        if element is not None and isinstance(default, (list, set, frozenset)):
            default = tuple(default)  # click multiple options take tuples
        # Optional[list[...]] = None: click resolves an absent repeatable
        # flag to (), which pydantic would coerce to [] — masking the
        # model's None default (None may mean "no filtering" while [] means
        # "filter everything"). () can only mean "flag absent", so map it
        # back to the model's None.
        callback = (
            (lambda ctx, param, value: None if value == () else value)
            if element is not None and default is None
            else None
        )
        options.append(
            PanelOption(
                [f"--{field_name}"],
                type=element if element is not None else _click_type(field.annotation),
                multiple=element is not None,
                default=default,
                callback=callback,
                show_default=True,
                help=field.description or "",
                panel="Device Backend Settings" if field_name in DEVICE_BACKEND_FIELDS else "Strategy Settings",
            )
        )
    return options


def _common_options() -> list[click.Option]:
    from krr_tpu_torch.formatters.base import BaseFormatter

    # Enumerated at command-build time, so plugin formatters defined before
    # krr_tpu_torch.run() appear in the help (reference `main.py:81`).
    formatter_names = ", ".join(BaseFormatter.get_all())
    return [
        PanelOption(
            ["--cluster", "-c", "clusters"],
            multiple=True,
            help="List of clusters to run on. By default, will run on the current cluster. Use '*' to run on all clusters.",
        ),
        PanelOption(
            ["--namespace", "-n", "namespaces"],
            multiple=True,
            help="List of namespaces to run on. By default, will run on all namespaces.",
        ),
        PanelOption(
            ["--prometheus-url", "-p", "prometheus_url"],
            default=None,
            help="Prometheus URL. If not provided, will attempt to find it in kubernetes cluster",
        ),
        PanelOption(["--prometheus-auth-header"], default=None, help="Prometheus authentication header."),
        PanelOption(["--prometheus-ssl-enabled"], is_flag=True, default=False, help="Enable SSL for Prometheus requests."),
        PanelOption(
            ["--prometheus-max-connections"],
            type=int,
            default=32,
            show_default=True,
            help="Max concurrent Prometheus range-query connections for the bulk fetch.",
        ),
        PanelOption(
            ["--prometheus-max-streamed-samples"],
            type=int,
            default=DEFAULT_MAX_STREAMED_SAMPLES,
            show_default=True,
            help=(
                "Per-window total-sample budget for streamed (stats-ingest) "
                "range queries. Default sits under Prometheus's default "
                "--query.max-samples=50000000; raise it alongside a raised "
                "server limit to fetch wide fleets in fewer windows."
            ),
        ),
        PanelOption(
            ["--backoff-cap-seconds", "prometheus_backoff_cap_seconds"],
            type=float,
            default=5.0,
            show_default=True,
            help=(
                "Cap on one jittered exponential backoff sleep between "
                "Prometheus retry attempts (deep ladders cannot balloon a "
                "scan's wall into minutes of sleeping)."
            ),
        ),
        PanelOption(
            ["--retry-deadline-seconds", "prometheus_retry_deadline_seconds"],
            type=float,
            default=60.0,
            show_default=True,
            help=(
                "Per-scan retry deadline budget: total backoff seconds all of "
                "a scan's Prometheus queries may burn combined; once spent, "
                "transient failures fail terminally instead of retrying. 0 disables."
            ),
        ),
        PanelOption(
            ["--breaker-threshold", "prometheus_breaker_threshold"],
            type=int,
            default=10,
            show_default=True,
            help=(
                "Circuit breaker: consecutive retry-ladder exhaustions "
                "(transport errors / 5xx; exhaustions overlapping a sibling's "
                "success don't count) that open the breaker on a Prometheus "
                "target, after which its queries fail fast instead of burning a "
                "backoff ladder each. 0 disables the breaker."
            ),
        ),
        PanelOption(
            ["--breaker-cooldown-seconds", "prometheus_breaker_cooldown_seconds"],
            type=float,
            default=30.0,
            show_default=True,
            help=(
                "Seconds an open breaker fails fast before letting one "
                "half-open probe query through (success closes it, failure "
                "re-opens for another cooldown)."
            ),
        ),
        PanelOption(
            ["--fetch-plan"],
            type=click.Choice(["adaptive", "fixed"]),
            default="adaptive",
            show_default=True,
            help=(
                "Query-plan shape for batched fleet fetches: 'adaptive' "
                "coalesces small namespaces into one multi-namespace query and "
                "shards giant ones by pod regex, from the previous scan's "
                "telemetry; 'fixed' pins one query per (namespace, resource) — "
                "the escape hatch (results are bit-exact either way)."
            ),
        ),
        PanelOption(
            ["--fetch-plan-target-series", "fetch_plan_target_series"],
            type=int,
            default=0,
            show_default=True,
            help=(
                "Series-count target for one planned query: namespaces expected "
                "to return at least twice this shard, namespaces under a quarter "
                "of it coalesce. 0 = auto (one sample-budget's worth of series "
                "per query, derived from the route's samples budget and the "
                "scan's window points)."
            ),
        ),
        PanelOption(
            ["--fetch-plan-max-shards", "fetch_plan_max_shards"],
            type=int,
            default=16,
            show_default=True,
            help="Most shards one giant namespace may split into under the adaptive plan.",
        ),
        PanelOption(
            ["--fetch-autotune"],
            type=bool,
            default=True,
            show_default=True,
            help=(
                "AIMD-autotune the in-flight Prometheus query limit between 1 "
                "and --prometheus-max-connections from live queue-wait/TTFB/"
                "failure signals; false pins the fixed-width semaphore."
            ),
        ),
        PanelOption(
            ["--fetch-compression"],
            type=click.Choice(["auto", "gzip", "off"]),
            default="auto",
            show_default=True,
            help=(
                "Compressed transport for Prometheus range responses: 'auto' "
                "sends Accept-Encoding gzip (zstd too when a zstd module is "
                "importable) and stream-decompresses into the native ingest; "
                "'gzip' pins gzip; 'off' keeps identity requests byte-"
                "identical to the pre-compression transport. Wire byte "
                "counters report compressed bytes; decoded bytes report the "
                "post-inflate stream."
            ),
        ),
        PanelOption(
            ["--fetch-downsample"],
            type=click.Choice(["auto", "off"]),
            default="off",
            show_default=True,
            help=(
                "Server-side pre-aggregation for stats-route queries (the "
                "count+max memory ingest): 'auto' rewrites eligible queries "
                "as count/max_over_time subqueries into grid-aligned coarse "
                "buckets — one value per bucket instead of every raw sample, "
                "bit-exact by construction — with automatic per-namespace "
                "fallback to raw when the backend rejects subqueries. Scans "
                "engage when --scan-end-timestamp lands on the grid. "
                "The CPU digest route never downsamples (its histogram "
                "needs every sample)."
            ),
        ),
        PanelOption(
            ["--fetch-downsample-factor", "fetch_downsample_factor"],
            type=int,
            default=0,
            show_default=True,
            help=(
                "Grid points per downsample bucket. 0 = auto (up to 60, "
                "bounded so at least two full buckets fit the window and the "
                "coarse step survives the Prometheus duration format exactly)."
            ),
        ),
        PanelOption(["--kubeconfig"], default=None, help="Path to kubeconfig file (defaults to $KUBECONFIG or ~/.kube/config)."),
        PanelOption(
            ["--batched-fleet-queries"],
            type=bool,
            default=True,
            show_default=True,
            help=(
                "Fetch usage history with one Prometheus range query per "
                "(namespace, resource), routing series to workloads client-side "
                "(O(namespaces) round trips); false = one query per workload. "
                "Failed batched queries fall back to per-workload automatically."
            ),
        ),
        PanelOption(
            ["--bulk-pod-discovery"],
            type=bool,
            default=True,
            show_default=True,
            help=(
                "Resolve workload pods from one pod listing per namespace with "
                "client-side selector matching (O(namespaces) apiserver requests); "
                "false = one server-side selector query per workload."
            ),
        ),
        PanelOption(
            ["--scan-end-timestamp"],
            type=float,
            default=None,
            help=(
                "Pin the scan window's right edge to an absolute unix timestamp "
                "(reproducible scans / offline benchmarks). Default: now."
            ),
        ),
        PanelOption(
            ["--pipeline-depth"],
            type=int,
            default=4,
            show_default=True,
            help=(
                "Streamed scan-pipeline depth for digest-ingest scans: fetch the "
                "fleet as per-namespace batches and fold each batch while the rest "
                "still fetch, with at most this many batches in flight per stage "
                "(bounded backpressure). 0 = the staged gather-then-fold path."
            ),
        ),
        PanelOption(
            ["--trace", "trace_path"],
            default=None,
            help=(
                "Write the scan's spans (scan → discover → fetch → "
                "compute, plus per-Prometheus-query children) as Chrome "
                "trace-event JSON to this file at exit — load it in "
                "chrome://tracing or Perfetto. Off by default (no-op tracer)."
            ),
        ),
        PanelOption(
            ["--metrics-dump", "metrics_dump_path"],
            default=None,
            help=(
                "Write a Prometheus text-exposition snapshot of the scan's "
                "metrics (per-query latency/retries/points, build info) to "
                "this file at exit."
            ),
        ),
        PanelOption(
            ["--statusz", "statusz_path"],
            default=None,
            help=(
                "Write a one-shot SLO evaluation (scan failures, fetch failed "
                "rows, latency, freshness — evaluated once over this scan) as "
                "JSON to this file at exit."
            ),
        ),
        PanelOption(
            ["--profile", "profile_path"],
            default=None,
            help=(
                "Write the scan's critical-path attribution report (per-category "
                "wall split incl. fetch transport/decode phases, what-if-fetch-"
                "were-free estimate, critical path) as JSON to this file at exit. "
                "Implies recording spans like --trace; `analyze` renders the "
                "same report from a --trace file."
            ),
        ),
        PanelOption(
            ["--strict"],
            is_flag=True,
            default=False,
            help=(
                "Exit nonzero when any object's history fetch failed terminally "
                "(rows rendered UNKNOWN) — for CI/cron scans that must not "
                "mistake a half-fetched fleet for a clean run."
            ),
        ),
        PanelOption(
            ["--slow-query-seconds", "prometheus_slow_query_seconds"],
            type=float,
            default=10.0,
            show_default=True,
            help=(
                "Log a warning for any Prometheus range query slower than this "
                "many seconds (retries included); 0 disables the slow-query log."
            ),
        ),
        PanelOption(
            ["--log-format", "log_format"],
            type=click.Choice(["console", "json"]),
            default="console",
            show_default=True,
            panel="Logging Settings",
            help=(
                "console = rich prefixed lines; json = one structured object "
                "per line carrying scan_id/span_id from the active trace span."
            ),
        ),
        PanelOption(["--cpu-min-value"], type=int, default=5, show_default=True, help="Minimum CPU recommendation, in millicores."),
        PanelOption(["--memory-min-value"], type=int, default=10, show_default=True, help="Minimum memory recommendation, in megabytes."),
        PanelOption(
            ["--formatter", "-f", "format"],
            default="table",
            show_default=True,
            help=f"Output formatter ({formatter_names})",
        ),
        PanelOption(["--verbose", "-v"], is_flag=True, default=False, panel="Logging Settings", help="Enable verbose mode"),
        PanelOption(["--quiet", "-q"], is_flag=True, default=False, panel="Logging Settings", help="Enable quiet mode"),
        PanelOption(
            ["--logtostderr", "log_to_stderr"],
            is_flag=True,
            default=False,
            panel="Logging Settings",
            help="Pass logs to stderr",
        ),
        PanelOption(
            ["--max-fleet-rows-per-device"],
            type=int,
            default=200_000,
            show_default=True,
            panel="Device Backend Settings",
            help=(
                "Process the fleet in row chunks of at most this many containers, "
                "bounding the packed host/device footprint (row-local strategies "
                "give identical results chunked or not)."
            ),
        ),
    ]

def _server_options() -> list[click.Option]:
    """The serve plane's options: the JAX command's, the push-ingest flags
    among them."""
    from krr_tpu_torch.core.config import Config

    defaults = {name: Config.model_fields[name].default for name in (
        "server_host", "server_port", "scan_interval_seconds", "discovery_interval_seconds",
        "history_retention_seconds", "hysteresis_dead_band_pct", "hysteresis_confirm_ticks",
        "trace_ring_scans", "store_shard_rows", "store_compact_wal_ratio",
        "store_compact_min_wal_mb", "response_cache_max_entries",
        "response_cache_max_mb", "server_render_concurrency", "server_render_queue",
        "ingest_port", "ingest_verify_interval_seconds", "ingest_max_body_bytes",
        "ingest_lookback_seconds", "ingest_max_samples_per_series", "ingest_max_series",
    )}
    return [
        PanelOption(
            ["--trace-ring-scans"],
            type=int,
            default=defaults["trace_ring_scans"],
            show_default=True,
            panel="Server Settings",
            help=(
                "Completed scan ticks the in-memory trace ring retains — "
                "the window GET /debug/trace exports."
            ),
        ),
        PanelOption(
            ["--host", "server_host"],
            default=defaults["server_host"],
            show_default=True,
            panel="Server Settings",
            help="Address to bind the HTTP server to.",
        ),
        PanelOption(
            ["--port", "server_port"],
            type=int,
            default=defaults["server_port"],
            show_default=True,
            panel="Server Settings",
            help="Port to bind the HTTP server to (0 = ephemeral).",
        ),
        PanelOption(
            ["--scan-interval", "scan_interval_seconds"],
            type=float,
            default=defaults["scan_interval_seconds"],
            show_default=True,
            panel="Server Settings",
            help="Seconds between incremental delta scans (each fetches only the window since the last fold).",
        ),
        PanelOption(
            ["--discovery-interval", "discovery_interval_seconds"],
            type=float,
            default=defaults["discovery_interval_seconds"],
            show_default=True,
            panel="Server Settings",
            help="Seconds between fleet re-discoveries (workload churn pickup + digest store compaction).",
        ),
        PanelOption(
            ["--discovery-mode", "discovery_mode"],
            type=click.Choice(["relist", "watch"]),
            default="relist",
            show_default=True,
            panel="Server Settings",
            help=(
                "Inventory maintenance: 'relist' re-fetches the whole fleet "
                "per discovery round (the classic shape); 'watch' keeps a "
                "resident inventory fed by Kubernetes watch streams so each "
                "discovery tick is an in-memory O(churn) reconcile, with "
                "the relist kept as the cold-start seed and the 410/desync "
                "resync path."
            ),
        ),
        PanelOption(
            ["--discovery-verify-interval", "discovery_verify_interval_seconds"],
            type=float,
            default=0.0,
            show_default=True,
            panel="Server Settings",
            help=(
                "Watch-mode ground-truth audit cadence: every this many "
                "seconds a full relist diffs the watched inventory against "
                "the apiserver, counting + repairing any divergence. "
                "0 = auto (four discovery intervals)."
            ),
        ),
        PanelOption(
            ["--metrics-mode", "metrics_mode"],
            type=click.Choice(["pull", "push"]),
            default="pull",
            show_default=True,
            panel="Server Settings",
            help=(
                "Metric acquisition: 'pull' range-queries Prometheus each "
                "tick (the classic shape); 'push' runs a remote-write "
                "listener that buffers samples as they arrive so a "
                "steady-state tick folds the buffered window with zero "
                "range queries, keeping the range path as the cold-start "
                "seed and the gap-backfill ladder."
            ),
        ),
        PanelOption(
            ["--ingest-port", "ingest_port"],
            type=int,
            default=defaults["ingest_port"],
            show_default=True,
            panel="Server Settings",
            help=(
                "Port the remote-write ingest listener binds in push mode "
                "(0 = ephemeral)."
            ),
        ),
        PanelOption(
            ["--ingest-verify-interval", "ingest_verify_interval_seconds"],
            type=float,
            default=defaults["ingest_verify_interval_seconds"],
            show_default=True,
            panel="Server Settings",
            help=(
                "Push-mode ground-truth audit cadence: every this many "
                "seconds the push-fed windows are compared against a "
                "range-fetched control, counting + repairing any drift. "
                "0 = auto (four scan intervals)."
            ),
        ),
        PanelOption(
            ["--ingest-max-body-bytes", "ingest_max_body_bytes"],
            type=int,
            default=defaults["ingest_max_body_bytes"],
            show_default=True,
            panel="Server Settings",
            help="Largest remote-write POST body the listener accepts (413 past it).",
        ),
        PanelOption(
            ["--ingest-lookback", "ingest_lookback_seconds"],
            type=float,
            default=defaults["ingest_lookback_seconds"],
            show_default=True,
            panel="Server Settings",
            help=(
                "Staleness window for push-fed grid evaluation — a grid "
                "point sees the newest sample at most this old, matching "
                "Prometheus range-query semantics."
            ),
        ),
        PanelOption(
            ["--ingest-max-samples-per-series", "ingest_max_samples_per_series"],
            type=int,
            default=defaults["ingest_max_samples_per_series"],
            show_default=True,
            panel="Server Settings",
            help=(
                "Per-series ingest buffer cap; overflow sheds oldest samples "
                "and the affected windows fall back to range fetches."
            ),
        ),
        PanelOption(
            ["--ingest-max-series", "ingest_max_series"],
            type=int,
            default=defaults["ingest_max_series"],
            show_default=True,
            panel="Server Settings",
            help="Resident-series ceiling; new series past it are rejected with a counter.",
        ),
        PanelOption(
            ["--min-fetch-success-pct", "min_fetch_success_pct"],
            type=float,
            default=50.0,
            show_default=True,
            panel="Server Settings",
            help=(
                "Degraded-tick floor: abort a serve tick (refetch next tick) "
                "when fewer than this percentage of workload fetches succeed; "
                "at or above it, failed workloads quarantine with stale marks "
                "while the rest publish. 100 = all-or-nothing."
            ),
        ),
        PanelOption(
            ["--max-staleness", "max_staleness_seconds"],
            type=float,
            default=0.0,
            show_default=True,
            panel="Server Settings",
            help=(
                "Freshness budget for quarantined workloads' carried-forward "
                "recommendations: past this age their accumulated digests drop "
                "and they re-enter with a full-window backfill. 0 = auto "
                "(ten scan cadences)."
            ),
        ),
        PanelOption(
            ["--store-shard-rows", "store_shard_rows"],
            type=int,
            default=defaults["store_shard_rows"],
            show_default=True,
            panel="Server Settings",
            help=(
                "Rows per base-snapshot shard file in the sharded digest "
                "state directory (compaction slices the store into "
                "contiguous row ranges of this size)."
            ),
        ),
        PanelOption(
            ["--store-compact-wal-ratio", "store_compact_wal_ratio"],
            type=float,
            default=defaults["store_compact_wal_ratio"],
            show_default=True,
            panel="Server Settings",
            help=(
                "Fold the digest store's delta WAL back into base shards "
                "once it exceeds this fraction of the base snapshots' bytes "
                "(bounds recovery replay time; per-tick persists stay one "
                "small append)."
            ),
        ),
        PanelOption(
            ["--store-compact-min-wal-mb", "store_compact_min_wal_mb"],
            type=float,
            default=defaults["store_compact_min_wal_mb"],
            show_default=True,
            panel="Server Settings",
            help=(
                "Never compact the digest store's WAL below this many MiB — "
                "tiny stores must not pay a base rewrite per handful of ticks."
            ),
        ),
        PanelOption(
            ["--response-cache/--no-response-cache", "response_cache_enabled"],
            default=True,
            panel="Server Settings",
            help=(
                "--no-response-cache disables the epoch-keyed rendered-"
                "response cache on GET /recommendations: every non-fast-path "
                "read renders per request (the uncached control / escape "
                "hatch)."
            ),
        ),
        PanelOption(
            ["--response-cache-entries", "response_cache_max_entries"],
            type=int,
            default=defaults["response_cache_max_entries"],
            show_default=True,
            panel="Server Settings",
            help=(
                "Entry bound on the response cache (one entry per format + "
                "canonicalized filters + page + encoding, evicted LRU)."
            ),
        ),
        PanelOption(
            ["--response-cache-mb", "response_cache_max_mb"],
            type=float,
            default=defaults["response_cache_max_mb"],
            show_default=True,
            panel="Server Settings",
            help=(
                "Byte budget (MiB) on cached response bodies — adversarial "
                "filter cardinality must not OOM the server."
            ),
        ),
        PanelOption(
            ["--render-pool", "server_render_concurrency"],
            type=int,
            default=defaults["server_render_concurrency"],
            show_default=True,
            panel="Server Settings",
            help=(
                "Concurrent cache-miss renders (worker threads) the read "
                "path allows."
            ),
        ),
        PanelOption(
            ["--render-queue", "server_render_queue"],
            type=int,
            default=defaults["server_render_queue"],
            show_default=True,
            panel="Server Settings",
            help=(
                "Requests allowed to wait behind a saturated render pool "
                "before the rest shed with 503/Retry-After."
            ),
        ),
        PanelOption(
            ["--history-path", "history_path"],
            default=None,
            panel="Server Settings",
            help=(
                "Journal file recording every recompute's raw recommendations "
                "(GET /history, GET /drift, diff). Default: "
                "<state_path>.journal when --state_path is set; pass an empty "
                "string to keep the journal memory-only."
            ),
        ),
        PanelOption(
            ["--history-retention", "history_retention_seconds"],
            type=float,
            default=defaults["history_retention_seconds"],
            show_default=True,
            panel="Server Settings",
            help="Seconds of recommendation history the journal retains (older records are compacted away).",
        ),
        PanelOption(
            ["--dead-band-pct", "hysteresis_dead_band_pct"],
            type=float,
            default=defaults["hysteresis_dead_band_pct"],
            show_default=True,
            panel="Server Settings",
            help=(
                "Hysteresis dead band: a workload's published recommendation "
                "holds until the raw recommendation drifts more than this "
                "percentage from it..."
            ),
        ),
        PanelOption(
            ["--confirm-ticks", "hysteresis_confirm_ticks"],
            type=int,
            default=defaults["hysteresis_confirm_ticks"],
            show_default=True,
            panel="Server Settings",
            help="...for this many consecutive scan ticks (then it jumps to the current raw value).",
        ),
        # Dual-name boolean: a single inverted flag (is_flag + flag_value=
        # False) silently loses its default=True under click 8.3 — the serve
        # CLI was running every deployment with hysteresis OFF. The
        # documented --no-hysteresis switch is unchanged.
        PanelOption(
            ["--hysteresis/--no-hysteresis", "hysteresis_enabled"],
            default=True,
            panel="Server Settings",
            help=(
                "--no-hysteresis publishes every recompute verbatim (no "
                "dead-band gate) — bit-exact legacy behavior; the journal "
                "still records every tick."
            ),
        ),
        PanelOption(
            ["--savings/--no-savings", "savings_enabled"],
            default=True,
            panel="Server Settings",
            help=(
                "--no-savings drops the journal-derived fleet savings block "
                "from GET /statusz (and stops refreshing the krr_tpu_eval_* "
                "window gauges on scrape)."
            ),
        ),
        PanelOption(
            ["--federation-listen", "federation_listen"],
            default=None,
            panel="Server Settings",
            help=(
                "host:port to accept federation scanner-shard delta streams "
                "on — turns this serve into the central AGGREGATOR: scanner "
                "shards (krr-tpu shard) own discover+fetch+fold and stream "
                "their ticks' delta ops here; the scheduler replays them "
                "into the fleet store and publishes the merged view through "
                "the unchanged read path."
            ),
        ),
        PanelOption(
            ["--federation-staleness", "federation_staleness_seconds"],
            type=float,
            default=0.0,
            show_default=True,
            panel="Server Settings",
            help=(
                "Shard staleness budget: a shard whose newest delivered "
                "window is older than this serves carried-forward rows with "
                "stale_since marks. 0 = auto (three scan cadences)."
            ),
        ),
        PanelOption(
            ["--federation-queue-records", "federation_queue_records"],
            type=int,
            default=4096,
            show_default=True,
            panel="Server Settings",
            help=(
                "Most decoded-but-unapplied delta records the aggregator "
                "queues per shard before back-pressuring that shard's stream."
            ),
        ),
        PanelOption(
            ["--federation-uplink", "federation_uplink"],
            default=None,
            panel="Server Settings",
            help=(
                "host:port of a HIGHER-tier aggregator this serve uplinks "
                "its own merged store's deltas to (requires "
                "--federation-listen): region aggregators uplink to a "
                "global one over the same shard protocol, so tiers compose "
                "without a second wire format."
            ),
        ),
        PanelOption(
            ["--lineage/--no-lineage", "federation_lineage_enabled"],
            default=True,
            panel="Server Settings",
            help=(
                "End-to-end freshness lineage: stamp every epoch with the "
                "newest-sample → fold → apply → publish → install timestamp "
                "chain (krr_tpu_e2e_freshness_seconds, /statusz lineage "
                "block, per-hop sentinel bands). Metadata-only — stores and "
                "served bytes are bit-identical either way."
            ),
        ),
        PanelOption(
            ["--realign-window-grid", "realign_window_grid"],
            is_flag=True,
            default=False,
            panel="Server Settings",
            help=(
                "One-shot recovery for --fetch-downsample over a persisted "
                "window cursor that predates the flag (unaligned grid): drop "
                "the cursor and accumulated digest rows at startup so the "
                "next tick runs a grid-aligned full backfill and downsampling "
                "engages."
            ),
        ),
        PanelOption(
            ["--timeline-path", "timeline_path"],
            default=None,
            panel="Server Settings",
            help=(
                "Scan flight-recorder file (one durable record per completed "
                "tick; GET /debug/timeline, analyze --trend). Default: "
                "derived from --state_path (timeline.log inside the state "
                "directory); pass an empty string to keep the recorder "
                "memory-only."
            ),
        ),
        PanelOption(
            ["--timeline-retain", "timeline_retain_records"],
            type=int,
            default=Config.model_fields["timeline_retain_records"].default,
            show_default=True,
            panel="Server Settings",
            help=(
                "Scan records the flight recorder retains (retention "
                "compaction bounds the file for arbitrarily long serves)."
            ),
        ),
        PanelOption(
            ["--sentinel/--no-sentinel", "sentinel_enabled"],
            default=True,
            panel="Server Settings",
            help=(
                "--no-sentinel records the scan timeline without classifying "
                "it: no regression verdicts, metrics, or /statusz trend section."
            ),
        ),
        PanelOption(
            ["--sentinel-warmup", "sentinel_warmup_scans"],
            type=int,
            default=Config.model_fields["sentinel_warmup_scans"].default,
            show_default=True,
            panel="Server Settings",
            help=(
                "Nominal scans per kind (full|delta) the sentinel observes "
                "before issuing regression verdicts for that kind."
            ),
        ),
        PanelOption(
            ["--sentinel-baseline", "sentinel_baseline_scans"],
            type=int,
            default=Config.model_fields["sentinel_baseline_scans"].default,
            show_default=True,
            panel="Server Settings",
            help=(
                "Rolling baseline window: nominal values per category the "
                "median/MAD bands cover (also the consecutive-regression "
                "count after which a sustained level shift rebases)."
            ),
        ),
        PanelOption(
            ["--sentinel-sigma", "sentinel_sigma"],
            type=float,
            default=Config.model_fields["sentinel_sigma"].default,
            show_default=True,
            panel="Server Settings",
            help=(
                "Deviation threshold in band units: a category regresses "
                "past median + sigma x max(1.4826*MAD, floors)."
            ),
        ),
        PanelOption(
            ["--sentinel-rel-floor", "sentinel_rel_floor"],
            type=float,
            default=Config.model_fields["sentinel_rel_floor"].default,
            show_default=True,
            panel="Server Settings",
            help=(
                "Relative band floor (fraction of the median): keeps a "
                "near-constant category from flagging noise as regression."
            ),
        ),
        PanelOption(
            ["--sentinel-abs-floor", "sentinel_abs_floor_seconds"],
            type=float,
            default=Config.model_fields["sentinel_abs_floor_seconds"].default,
            show_default=True,
            panel="Server Settings",
            help="Absolute band floor in seconds (the same guard for tiny medians).",
        ),
        PanelOption(
            ["--sentinel-slo", "sentinel_slo_enabled"],
            is_flag=True,
            default=False,
            panel="SLO Settings",
            help=(
                "Register the scan_regressions SLO objective: sentinel-"
                "regressed scans burn its error budget like aborted scans "
                "burn scan_failures'."
            ),
        ),
        PanelOption(
            ["--sentinel-slo-budget", "sentinel_slo_budget"],
            type=float,
            default=Config.model_fields["sentinel_slo_budget"].default,
            show_default=True,
            panel="SLO Settings",
            help="Error budget for --sentinel-slo: the fraction of classified scans allowed to regress.",
        ),
    ]


def _slo_options() -> list[click.Option]:
    """The SLO engine's knobs (`krr_tpu_torch.obs.health`), read by the
    ``--statusz`` evaluation of a one-shot scan."""
    from krr_tpu_torch.core.config import Config

    defaults = {name: Config.model_fields[name].default for name in (
        "slo_scan_failure_budget", "slo_fetch_failure_budget",
        "slo_scan_latency_seconds", "slo_freshness_seconds",
        "slo_fast_window_seconds", "slo_slow_window_seconds",
        "slo_fast_burn", "slo_slow_burn", "slo_read_p99_seconds",
    )}

    def option(flags: list, help_text: str) -> PanelOption:
        return PanelOption(
            flags, type=float, default=defaults[flags[1]], show_default=True, panel="SLO Settings", help=help_text
        )

    return [
        option(["--slo-scan-failure-budget", "slo_scan_failure_budget"],
               "SLO error budget: the fraction of scans allowed to abort."),
        option(["--slo-fetch-failure-budget", "slo_fetch_failure_budget"],
               "SLO error budget: the fraction of object fetches allowed to fail terminally."),
        option(["--slo-scan-latency", "slo_scan_latency_seconds"],
               "Scan-latency SLO limit in seconds (0 = auto: one scan cadence)."),
        option(["--slo-freshness", "slo_freshness_seconds"],
               "Freshness SLO limit in seconds for the published window's age (0 = auto: three scan cadences)."),
        option(["--slo-read-p99", "slo_read_p99_seconds"],
               "Read-path latency SLO limit in seconds for the serve plane's per-tick "
               "GET /recommendations p99 (0 = objective disabled)."),
        option(["--slo-fast-window", "slo_fast_window_seconds"],
               "Fast burn-rate window in seconds (detection speed)."),
        option(["--slo-slow-window", "slo_slow_window_seconds"],
               "Slow burn-rate window in seconds (blip damping)."),
        option(["--slo-fast-burn", "slo_fast_burn"],
               "Fast-window burn-rate threshold (windowed bad ratio ÷ budget)."),
        option(["--slo-slow-burn", "slo_slow_burn"],
               "Slow-window burn-rate threshold — alerts fire only while BOTH windows burn past their thresholds."),
    ]


def _settings_error(error: Any) -> click.UsageError:
    """A pydantic validation error as a usage error naming each flag."""
    details = "; ".join(
        f"--{'.'.join(str(p) for p in err['loc']) or 'config'}: {err['msg']}" for err in error.errors()
    )
    return click.UsageError(f"Invalid settings — {details}")


def _config_from_kwargs(strategy_name: str, settings_fields: list, kwargs: dict, **extra: Any):
    """The ``Config`` of a strategy-backed command from its parsed flags;
    bad settings become a usage error naming the flag."""
    import pydantic

    from krr_tpu_torch.core.config import Config

    clusters = list(kwargs.pop("clusters") or [])
    namespaces = list(kwargs.pop("namespaces") or [])
    other_args = {name: kwargs.pop(name) for name in settings_fields}
    try:
        return Config(
            clusters="*" if "*" in clusters else (clusters or None),
            namespaces="*" if ("*" in namespaces or not namespaces) else namespaces,
            strategy=strategy_name,
            other_args=other_args,
            **extra,
            **kwargs,
        )
    except pydantic.ValidationError as e:
        raise _settings_error(e) from e


def _make_serve_command(strategy_name: str, strategy_type: Any) -> click.Command:
    """``serve``: the long-running service (`krr_tpu_torch.server`).

    Rides the digest-backed strategy (tdigest) — incremental delta scans
    fold into resident per-container digests, whose integer-count
    mergeability is what makes a delta fold equal a cold full-window scan.
    The strategy's settings surface as flags exactly like a scan command's,
    ``--device`` among them: the service binds the strategy to ``cuda``
    unless it is asked for the CPU, and without a card it exits 1.
    """
    settings_fields = list(strategy_type.get_settings_type().model_fields)

    def callback(**kwargs: Any) -> None:
        import pydantic

        from krr_tpu_torch.server.app import run_server

        config = _config_from_kwargs(strategy_name, settings_fields, kwargs, format="json")
        try:
            config.create_strategy()  # validate settings and the device up front
        except pydantic.ValidationError as e:
            raise _settings_error(e) from e
        except RuntimeError as e:
            # A `cuda` device without a card: a clear error and a nonzero
            # exit, never a quiet CPU service.
            raise click.ClickException(str(e)) from e
        asyncio.run(run_server(config))

    # The serve command takes the scan commands' common options MINUS the
    # one-shot-only flags: the formatter (responses pick a format per
    # request) and --statusz (serve exposes the live GET /statusz route;
    # nothing would read a statusz_path at exit).
    common = [o for o in _common_options() if o.name not in ("format", "statusz_path")]
    return PanelCommand(
        "serve",
        callback=callback,
        params=common + _server_options() + _slo_options() + _strategy_options(strategy_type),
        help=(
            "Run krr-tpu-torch as a long-running HTTP service: a background scheduler "
            "keeps per-container digests fresh with incremental delta scans, and "
            "GET /recommendations answers from the resident state "
            "(also: GET /healthz, GET /metrics)."
        ),
    )


def _make_shard_command(strategy_name: str, strategy_type: Any) -> click.Command:
    """``shard``: one federation scanner shard (`krr_tpu_torch.federation`).

    Runs the discover→fetch→fold half of serve over ITS clusters (pick them
    with ``-c``, or partition one big cluster by namespace with ``-n``) and
    streams each tick's delta ops — the durable store's WAL records, on the
    wire — to a central ``serve --federation-listen`` aggregator. The
    strategy binds ``--device`` like ``serve``'s: ``cuda`` unless asked for
    the CPU, and without a card the command exits 1.
    """
    settings_fields = list(strategy_type.get_settings_type().model_fields)

    def callback(**kwargs: Any) -> None:
        import pydantic

        from krr_tpu_torch.federation.shard import run_shard

        config = _config_from_kwargs(strategy_name, settings_fields, kwargs, format="json")
        if not (config.federation_aggregator or config.federation_ring):
            raise click.UsageError(
                "--aggregator host:port (or --federation-ring "
                "name=host:port[,name=...]) is required"
            )
        try:
            config.create_strategy()  # validate settings and the device up front
        except pydantic.ValidationError as e:
            raise _settings_error(e) from e
        except (RuntimeError, NotImplementedError) as e:
            # A `cuda` device without a card: a clear error and a nonzero
            # exit, never a quiet CPU shard.
            raise click.ClickException(str(e)) from e
        asyncio.run(run_shard(config, logger=config.create_logger()))

    shard_options = [
        PanelOption(
            ["--aggregator", "federation_aggregator"],
            default=None,
            panel="Server Settings",
            help="host:port of the krr-tpu serve --federation-listen aggregator (required).",
        ),
        PanelOption(
            ["--federation-ring", "federation_ring"],
            default=None,
            panel="Server Settings",
            help=(
                "Key-range partitioned aggregation plane: "
                "name=host:port[|host:port...],name2=... names each "
                "aggregator and its endpoint(s). The shard splits every "
                "tick's delta record by consistent-hash key owner and "
                "streams each partition to its owner; extra endpoints on a "
                "node replicate its stream to standbys (HA failover with "
                "zero lost epochs). Subsumes --aggregator."
            ),
        ),
        PanelOption(
            ["--shard-id", "federation_shard_id"],
            default=None,
            panel="Server Settings",
            help=(
                "Shard identity in the federation (epoch watermarks key on "
                "it). Default: the configured cluster list."
            ),
        ),
        PanelOption(
            ["--uplink-backoff-cap-seconds", "federation_backoff_cap_seconds"],
            type=float,
            default=5.0,
            show_default=True,
            panel="Server Settings",
            help=(
                "Ceiling on the uplink reconnect backoff ladder: waits grow "
                "0.25*2^(n-1) seconds, capped here before +/-50% jitter — "
                "the same retry semantics as the Prometheus "
                "--backoff-cap-seconds."
            ),
        ),
        PanelOption(
            ["--host", "server_host"],
            default="127.0.0.1",
            show_default=True,
            panel="Server Settings",
            help="Address to bind the shard's status HTTP server to.",
        ),
        PanelOption(
            ["--port", "server_port"],
            type=int,
            default=0,
            show_default=True,
            panel="Server Settings",
            help=(
                "Shard status HTTP port (GET /healthz: scan + uplink "
                "posture; GET /metrics: the shard-side krr_tpu_federation_* "
                "family). 0 = ephemeral (logged at startup)."
            ),
        ),
        PanelOption(
            ["--federation-queue-records", "federation_queue_records"],
            type=int,
            default=4096,
            show_default=True,
            panel="Server Settings",
            help=(
                "Unacked-record buffer bound: past it the backlog collapses "
                "into one snapshot record (bounded memory through an "
                "aggregator outage of any length)."
            ),
        ),
        PanelOption(
            ["--scan-interval", "scan_interval_seconds"],
            type=float,
            default=900.0,
            show_default=True,
            panel="Server Settings",
            help="Seconds between incremental delta scans on this shard.",
        ),
        PanelOption(
            ["--discovery-interval", "discovery_interval_seconds"],
            type=float,
            default=3600.0,
            show_default=True,
            panel="Server Settings",
            help="Seconds between fleet re-discoveries on this shard.",
        ),
        PanelOption(
            ["--discovery-mode", "discovery_mode"],
            type=click.Choice(["relist", "watch"]),
            default="relist",
            show_default=True,
            panel="Server Settings",
            help=(
                "Shard inventory maintenance: 'watch' reconciles a resident "
                "watch-fed inventory per tick (O(churn)); 'relist' re-fetches "
                "per discovery interval."
            ),
        ),
        PanelOption(
            ["--discovery-verify-interval", "discovery_verify_interval_seconds"],
            type=float,
            default=0.0,
            show_default=True,
            panel="Server Settings",
            help=(
                "Watch-mode verify-relist cadence on this shard "
                "(0 = auto: four discovery intervals)."
            ),
        ),
        PanelOption(
            ["--lineage/--no-lineage", "federation_lineage_enabled"],
            default=True,
            panel="Server Settings",
            help=(
                "Stamp this shard's delta records with the freshness lineage "
                "fragment (newest-sample + fold timestamps) the aggregator "
                "folds into the per-epoch krr_tpu_e2e_freshness_seconds "
                "chain. Metadata-only."
            ),
        ),
    ]
    # Shards take the scan commands' common options minus the one-shot-only
    # flags (no formatter — output is the delta stream; no --statusz dump).
    common = [o for o in _common_options() if o.name not in ("format", "statusz_path")]
    return PanelCommand(
        "shard",
        callback=callback,
        params=shard_options + common + _strategy_options(strategy_type),
        help=(
            "Run one federation scanner shard: discover+fetch+fold its "
            "clusters locally and stream each tick's delta ops to a central "
            "`serve --federation-listen` aggregator."
        ),
    )


def _make_replica_command() -> click.Command:
    """``replica``: a stateless read replica (`krr_tpu_torch.federation.replica`).

    Subscribes to a serve/aggregator's published-epoch feed and serves the
    full HTTP read path (response cache, conditional GETs, pushdown,
    pre-compressed variants) from the installed snapshots — byte-identical
    bodies and validators, no scheduler, no store, no metric backend. N
    replicas behind a load balancer multiply read RPS horizontally.
    """

    def callback(**kwargs: Any) -> None:
        import pydantic

        from krr_tpu_torch.core.config import Config
        from krr_tpu_torch.federation.replica import run_replica

        try:
            config = Config(format="json", **kwargs)
            if not config.federation_aggregator:
                raise click.UsageError("--source host:port is required")
        except pydantic.ValidationError as e:
            details = "; ".join(
                f"--{'.'.join(str(p) for p in err['loc']) or 'config'}: {err['msg']}" for err in e.errors()
            )
            raise click.UsageError(f"Invalid settings — {details}") from e
        asyncio.run(run_replica(config, logger=config.create_logger()))

    replica_options = [
        PanelOption(
            ["--source", "federation_aggregator"],
            default=None,
            panel="Server Settings",
            help=(
                "host:port of the serve/aggregator federation listener "
                "publishing the epoch feed (required)."
            ),
        ),
        PanelOption(
            ["--replica-id", "federation_shard_id"],
            default=None,
            panel="Server Settings",
            help="Replica identity in the feed handshake. Default: a random id.",
        ),
        PanelOption(
            ["--host", "server_host"],
            default="127.0.0.1",
            show_default=True,
            panel="Server Settings",
            help="Address to bind the replica's HTTP server to.",
        ),
        PanelOption(
            ["--port", "server_port"],
            type=int,
            default=8080,
            show_default=True,
            panel="Server Settings",
            help="Replica HTTP port (0 = ephemeral, logged at startup).",
        ),
        PanelOption(
            ["--scan-interval", "scan_interval_seconds"],
            type=float,
            default=900.0,
            show_default=True,
            panel="Server Settings",
            help=(
                "The SOURCE's publish cadence — three missed cadences "
                "without an installed epoch marks /healthz stale."
            ),
        ),
        PanelOption(
            ["--backoff-cap-seconds", "federation_backoff_cap_seconds"],
            type=float,
            default=5.0,
            show_default=True,
            panel="Server Settings",
            help="Ceiling on the feed reconnect backoff ladder (pre-jitter).",
        ),
        PanelOption(
            ["--response-cache/--no-response-cache", "response_cache_enabled"],
            default=True,
            panel="Server Settings",
            help=(
                "The epoch-keyed rendered-response cache (the feed pre-warms "
                "it with the source's rendered variants)."
            ),
        ),
        PanelOption(
            ["--response-cache-entries", "response_cache_max_entries"],
            type=int,
            default=256,
            show_default=True,
            panel="Server Settings",
            help="Entry bound on the response cache.",
        ),
        PanelOption(
            ["--response-cache-mb", "response_cache_max_mb"],
            type=float,
            default=64.0,
            show_default=True,
            panel="Server Settings",
            help="Body-byte bound on the response cache (MB).",
        ),
        PanelOption(
            ["--render-concurrency", "server_render_concurrency"],
            type=int,
            default=4,
            show_default=True,
            panel="Server Settings",
            help="Bounded render pool width for cache-miss renders.",
        ),
        PanelOption(
            ["--render-queue", "server_render_queue"],
            type=int,
            default=16,
            show_default=True,
            panel="Server Settings",
            help="Renders allowed to QUEUE behind the pool before shedding 503s.",
        ),
        PanelOption(
            ["--trace", "trace_path"],
            default=None,
            panel="Observability",
            help=(
                "Write the replica's install spans (feed frame → decode → "
                "install, remote-linked to the publishing aggregator) as "
                "Chrome trace-event JSON to this file at exit. SIGUSR2 dumps "
                "the same ring mid-run."
            ),
        ),
        PanelOption(
            ["--profile", "profile_path"],
            default=None,
            panel="Observability",
            help=(
                "Write the install-path critical-path attribution report as "
                "JSON to this file at exit; `krr-tpu analyze` renders it."
            ),
        ),
        PanelOption(
            ["--metrics-dump", "metrics_dump_path"],
            default=None,
            panel="Observability",
            help=(
                "Write a Prometheus text-exposition snapshot of the replica's "
                "metrics to this file at exit — the offline twin of /metrics."
            ),
        ),
        PanelOption(["-q", "--quiet", "quiet"], is_flag=True, default=False, panel="Logging"),
        PanelOption(["-v", "--verbose", "verbose"], is_flag=True, default=False, panel="Logging"),
        PanelOption(
            ["--log-format", "log_format"],
            type=click.Choice(["console", "json"]),
            default="console",
            show_default=True,
            panel="Logging",
            help="Structured log output format.",
        ),
    ]
    return PanelCommand(
        "replica",
        callback=callback,
        params=replica_options,
        help=(
            "Run a stateless read replica: subscribe to a serve/aggregator's "
            "published-epoch feed and serve GET /recommendations (and the "
            "whole read path) byte-identically — N replicas behind a load "
            "balancer scale reads horizontally."
        ),
    )


def _make_diff_command(strategy_name: str, strategy_type: Any) -> click.Command:
    """``diff``: render the delta between two recommendation points.

    Points come from a serve journal (two tick timestamps; defaults are the
    newest two) or, with ``--live``, the newest journal tick vs a fresh
    one-shot scan. The delta renders through the formatter registry
    (`krr_tpu_torch.history.diff` — a diff IS a scan result whose "current"
    allocations are the baseline point). Only ``--live`` scans, so only
    ``--live`` needs the card (or ``--device cpu``).
    """
    settings_fields = list(strategy_type.get_settings_type().model_fields)
    settings_type = strategy_type.get_settings_type()

    def callback(**kwargs: Any) -> None:
        import pydantic

        journal_path = kwargs.pop("journal_path")
        at = kwargs.pop("at")
        baseline = kwargs.pop("baseline")
        live = kwargs.pop("live")
        config = _config_from_kwargs(strategy_name, settings_fields, kwargs)
        try:
            # The settings alone: a journal diff never touches the device.
            settings = settings_type(**config.other_args)
        except pydantic.ValidationError as e:
            raise _settings_error(e) from e

        if journal_path is None:
            state_path = config.other_args.get("state_path")
            if state_path:
                journal_path = f"{state_path}.journal"
            else:
                raise click.UsageError("pass --journal (or --state_path to derive <state_path>.journal)")

        from krr_tpu_torch.history.diff import (
            build_diff_result,
            live_values,
            newest_at_or_before,
            resolve_ticks,
            tick_values,
        )
        from krr_tpu_torch.history.journal import RecommendationJournal

        logger = config.create_logger()
        try:
            # readonly: a diff must never create, repair, or truncate a
            # journal — including one a running server is mid-append on.
            journal = RecommendationJournal(
                journal_path,
                retention_seconds=config.history_retention_seconds,
                logger=logger,
                readonly=True,
            )
        except ValueError as e:
            raise click.UsageError(str(e)) from e
        if journal.record_count == 0:
            raise click.UsageError(f"journal at {journal_path} holds no ticks")
        if live and baseline is not None:
            raise click.UsageError(
                "--baseline picks a second JOURNAL point and --live replaces that "
                "point with a fresh scan — pass one or the other (use --at to pick "
                "the journal tick a live diff compares against)"
            )

        def scoped(values: dict) -> dict:
            # The server journals the WHOLE fleet; honor -n/-c on the
            # journal side too, or a filtered --live scan renders everything
            # outside the filter as spuriously vanished (and in
            # journal-vs-journal mode the flags would be silently ignored).
            from krr_tpu_torch.core.streaming import split_object_key

            if config.namespaces == "*" and not isinstance(config.clusters, list):
                return values
            out = {}
            for key, point in values.items():
                cluster, namespace, _name, _container, _kind = split_object_key(key)
                if config.namespaces != "*" and namespace not in config.namespaces:
                    continue
                if isinstance(config.clusters, list) and (cluster or "") not in config.clusters:
                    continue
                out[key] = point
            return out

        try:
            if live:
                base_ts = newest_at_or_before(journal, at)
                baseline_values = scoped(tick_values(journal, base_ts))
                try:
                    target_values = scoped(asyncio.run(live_values(config)))
                except (RuntimeError, NotImplementedError) as e:
                    # A `cuda` device without a card: the live scan refuses.
                    raise click.ClickException(str(e)) from e
                logger.info(f"diff: journal tick {base_ts:.0f} vs live scan")
            else:
                base_ts, at_ts = resolve_ticks(journal, at=at, baseline=baseline)
                baseline_values = scoped(tick_values(journal, base_ts))
                target_values = scoped(tick_values(journal, at_ts))
                logger.info(f"diff: journal tick {base_ts:.0f} vs {at_ts:.0f}")
        except ValueError as e:
            raise click.UsageError(str(e)) from e
        result = build_diff_result(
            baseline_values,
            target_values,
            cpu_min_value=config.cpu_min_value,
            memory_min_value=config.memory_min_value,
            # The journal stores PRE-buffer raw memory; re-apply the
            # strategy's buffer so diff memory matches served values.
            memory_buffer_percentage=settings.memory_buffer_percentage,
        )
        logger.print_result(result.format(config.format))

    diff_options = [
        PanelOption(
            ["--journal", "journal_path"],
            default=None,
            help="Path to the serve journal file (default: <state_path>.journal when --state_path is set).",
        ),
        PanelOption(
            ["--at"],
            type=float,
            default=None,
            help="Target point: the newest journal tick at or before this unix timestamp (default: the newest tick).",
        ),
        PanelOption(
            ["--baseline"],
            type=float,
            default=None,
            help="Baseline point: the newest journal tick at or before this unix timestamp (default: the tick before the target).",
        ),
        PanelOption(
            ["--live"],
            is_flag=True,
            default=False,
            help="Diff the newest journal tick against a fresh one-shot scan instead of a second journal point.",
        ),
    ]
    return PanelCommand(
        "diff",
        callback=callback,
        params=diff_options + _common_options() + _strategy_options(strategy_type),
        help=(
            "Render the delta between two recommendation points — two serve "
            "journal ticks, or (--live) the newest tick vs a fresh scan — "
            "through any registered formatter."
        ),
    )


def _make_eval_command() -> click.Command:
    """``eval``: the what-if replay scoreboard.

    Replays registered strategies tick-by-tick over recorded usage — a serve
    journal (read-only, the diff open path) or an ``.npz`` usage grid — each
    raw recommendation routed through a REAL hysteresis gate, then scores
    would-have-been OOM/throttle incidents, over-provisioned core-/GB-hours,
    and gate flaps (`krr_tpu_torch.eval`), rendering the ranked board through
    the formatter registry. The strategies and the scoring reduce run on
    ``--device`` (``cuda`` unless asked for ``cpu``); without a card it exits
    1.
    """

    def callback(**kwargs: Any) -> None:
        import pydantic

        from krr_tpu_torch.core.config import Config

        journal_path = kwargs.pop("journal_path")
        usage_path = kwargs.pop("usage_path")
        state_path = kwargs.pop("state_path")
        device = kwargs.pop("device")
        strategy_names = list(kwargs.pop("strategies") or [])
        clusters = list(kwargs.pop("clusters") or [])
        namespaces = list(kwargs.pop("namespaces") or [])
        try:
            config = Config(
                clusters="*" if "*" in clusters else (clusters or None),
                namespaces="*" if ("*" in namespaces or not namespaces) else namespaces,
                **kwargs,
            )
        except pydantic.ValidationError as e:
            raise _settings_error(e) from e

        from krr_tpu_torch.eval import (
            ReplayInput,
            build_scoreboard,
            render_scoreboard,
            replay,
            score_replay,
        )
        from krr_tpu_torch.strategies.base import BaseStrategy
        from krr_tpu_torch.utils.device import resolve_device

        logger = config.create_logger()
        if usage_path is not None and journal_path is not None:
            raise click.UsageError("--usage and --journal are two sources for ONE grid; pass one")
        if usage_path is not None:
            inputs = ReplayInput.load_npz(usage_path)
        else:
            if journal_path is None:
                if state_path:
                    journal_path = f"{state_path}.journal"
                else:
                    raise click.UsageError(
                        "pass --journal (or --state_path to derive <state_path>.journal), "
                        "or --usage for an .npz grid"
                    )
            try:
                # readonly: like diff, an eval must never create, repair, or
                # truncate a journal — including one a running server owns.
                inputs = ReplayInput.from_journal(
                    journal_path,
                    retention_seconds=config.history_retention_seconds,
                    logger=logger,
                )
            except ValueError as e:
                raise click.UsageError(str(e)) from e
        inputs = inputs.scoped(
            namespaces=None if config.namespaces == "*" else tuple(config.namespaces),
            clusters=tuple(config.clusters) if isinstance(config.clusters, list) else None,
        )
        if not inputs.keys:
            raise click.UsageError("no workloads left to replay after -n/-c scoping")

        available = BaseStrategy.get_all()
        names = strategy_names or sorted(available)
        unknown = [n for n in names if n not in available]
        if unknown:
            raise click.UsageError(
                f"unknown strategy {', '.join(unknown)} (available: {', '.join(sorted(available))})"
            )
        try:
            # A `cuda` device without a card: a clear error and a nonzero
            # exit, never a quiet CPU replay.
            resolve_device(device)
        except (RuntimeError, ValueError) as e:
            raise click.ClickException(str(e)) from e
        rows = []
        for name in names:
            strategy_type = available[name]
            settings_type = strategy_type.get_settings_type()
            # Every replayed strategy that computes on a device takes
            # --device; a plugin without the setting runs as it is.
            settings = settings_type(**({"device": device} if "device" in settings_type.model_fields else {}))
            strategy = strategy_type(settings)
            replayed = replay(
                inputs,
                strategy,
                name=name,
                ticks=config.eval_replay_ticks,
                dead_band_pct=config.hysteresis_dead_band_pct,
                confirm_ticks=config.hysteresis_confirm_ticks,
                hysteresis=config.hysteresis_enabled,
            )
            rows.append(score_replay(inputs, replayed, device=device))
            logger.info(
                f"eval: replayed {name} over {len(inputs.keys)} workload(s) x "
                f"{len(inputs.timestamps)} samples in {len(replayed.tick_indices)} tick(s)"
            )
        window = (
            float(inputs.timestamps[-1] - inputs.timestamps[0]) if len(inputs.timestamps) else 0.0
        )
        board = build_scoreboard(rows, samples=len(inputs.timestamps), window_seconds=window)
        logger.print_result(render_scoreboard(board, config.format))

    from krr_tpu_torch.core.config import Config

    eval_options = [
        PanelOption(
            ["--journal", "journal_path"],
            default=None,
            help="Path to the serve journal to replay (default: <state_path>.journal when --state_path is set).",
        ),
        PanelOption(
            ["--usage", "usage_path"],
            default=None,
            help="Path to an .npz usage grid (keys/timestamps/cpu/mem arrays) to replay instead of a journal.",
        ),
        PanelOption(
            ["--state_path"],
            default=None,
            help="Digest state path whose <state_path>.journal sibling holds the recorded history.",
        ),
        PanelOption(
            ["--strategy", "strategies"],
            multiple=True,
            help="Strategy to replay (repeatable; default: every registered strategy, with default settings).",
        ),
        PanelOption(
            ["--replay-ticks", "eval_replay_ticks"],
            type=int,
            default=Config.model_fields["eval_replay_ticks"].default,
            show_default=True,
            help="Replay ticks to walk the recorded grid in (each re-runs the strategy on the history so far).",
        ),
        PanelOption(
            ["--dead-band-pct", "hysteresis_dead_band_pct"],
            type=float,
            default=Config.model_fields["hysteresis_dead_band_pct"].default,
            show_default=True,
            help="Hysteresis dead band the replayed recommendations gate through.",
        ),
        PanelOption(
            ["--confirm-ticks", "hysteresis_confirm_ticks"],
            type=int,
            default=Config.model_fields["hysteresis_confirm_ticks"].default,
            show_default=True,
            help="Consecutive out-of-band replay ticks before the gate republishes.",
        ),
        PanelOption(
            ["--hysteresis/--no-hysteresis", "hysteresis_enabled"],
            default=True,
            help="--no-hysteresis replays every raw recommendation verbatim (gate pass-through).",
        ),
        PanelOption(
            ["--device"],
            default="cuda",
            show_default=True,
            panel="Device Backend Settings",
            help="Compute device of the replayed strategies and the scoring reduce: 'cuda' or 'cpu'.",
        ),
    ]
    return PanelCommand(
        "eval",
        callback=callback,
        params=eval_options + _common_options(),
        help=(
            "Score registered strategies against recorded usage: replay a "
            "serve journal (read-only) or an .npz grid tick-by-tick through "
            "the real hysteresis gate and rank the would-have-been "
            "OOM/throttle incidents, over-provisioned core/GB-hours, and "
            "flap counts per strategy."
        ),
    )


def _strategy_device(strategy: Any) -> str:
    """The device a strategy computes on: its ``device`` setting, or the
    CPU for a plugin strategy without one (it runs host code)."""
    return str(getattr(strategy.settings, "device", "cpu"))


def _finish_observability(config: Any, session: Any) -> None:
    """The exit hooks of a one-shot scan, in the JAX package's order: the
    session tracer's ring as Chrome trace JSON (``--trace``), its
    critical-path attribution (``--profile``), a one-shot SLO evaluation
    (``--statusz``) and the shared metrics registry as a Prometheus
    exposition snapshot with build info and process self-metrics refreshed
    (``--metrics-dump``)."""
    if config.trace_path:
        from krr_tpu_torch.obs.trace import write_chrome_trace

        write_chrome_trace(session.tracer, config.trace_path)
    if config.profile_path:
        from krr_tpu_torch.obs.profile import write_profile_report

        write_profile_report(session.tracer, config.profile_path)
    if config.statusz_path:
        import json

        from krr_tpu_torch.obs.health import engine_from_config

        # One evaluation whose window is the whole scan (the engine seeds a
        # zero baseline at construction). Evaluated BEFORE the metrics dump
        # so the krr_tpu_slo_* series it fires land in the same exposition.
        engine = engine_from_config(session.metrics, config, one_shot=True, logger=session.logger)
        engine.evaluate()
        with open(config.statusz_path, "w") as f:
            json.dump(engine.status(), f, indent=2)
            f.write("\n")
    if config.metrics_dump_path:
        from krr_tpu_torch.obs.metrics import record_build_info, refresh_process_metrics

        record_build_info(session.metrics, _strategy_device(session.strategy))
        refresh_process_metrics(session.metrics)
        with open(config.metrics_dump_path, "w") as f:
            f.write(session.metrics.render())


def _make_analyze_command() -> click.Command:
    """``analyze``: critical-path attribution over a recorded scan trace
    (`krr_tpu_torch.obs.profile`) — where the wall went (fetch transport vs
    decode vs fold vs compute vs idle), the what-if-fetch-were-free
    estimate, and the critical path itself. Input is a ``--trace`` Chrome
    JSON file, or ``--url`` against a live process's ``/debug/trace`` ring;
    ``--stitch`` merges several sources into one trace. ``--trend`` switches
    to the scan TIMELINE instead (`krr_tpu_torch.obs.sentinel` over the
    flight recorder's records): per-scan regression verdicts with baseline
    bands, from a ``--timeline`` file or a live server's
    ``/debug/timeline``."""

    def _render_out(rendered: str, output: Any) -> None:
        if output:
            with open(output, "w") as f:
                f.write(rendered)
        else:
            click.echo(rendered, nl=False)

    def _trend(timeline: Any, url: Any, n: int, fmt: str, output: Any) -> None:
        import json

        from krr_tpu_torch.obs.sentinel import render_trend_text, trend_report
        from krr_tpu_torch.obs.timeline import ScanTimeline

        if (timeline is None) == (url is None):
            raise click.UsageError(
                "pass exactly one of --timeline FILE or --url URL with --trend"
            )
        live_report = None
        if timeline is not None:
            try:
                # Read EVERYTHING: warm-up and baselines are honest only
                # over the full timeline (the HTTP route does the same);
                # -n limits the rendered records below, never the replay.
                records = ScanTimeline.read_records(timeline)
            except OSError as e:
                raise click.UsageError(f"cannot read timeline file {timeline}: {e}") from e
            except ValueError as e:
                raise click.UsageError(str(e)) from e
        else:
            import urllib.error
            import urllib.request

            target = url.rstrip("/") + "/debug/timeline?format=json" + (
                f"&n={n}" if n > 0 else ""
            )
            try:
                with urllib.request.urlopen(target, timeout=30) as response:
                    payload = json.load(response)
            except (OSError, urllib.error.URLError, json.JSONDecodeError) as e:
                raise click.UsageError(f"cannot fetch {target}: {e}") from e
            records = payload.get("records", [])
            # The server already replayed the FULL retained timeline with
            # the live sentinel's configured band knobs — prefer its trend
            # over a default-knob recompute, so offline verdicts can't
            # contradict /statusz on a server running custom --sentinel-*.
            live_report = payload.get("trend")
        if not records:
            # A fresh server (or empty file) is a benign state, not an error.
            click.echo("no completed scans recorded yet — the timeline is empty")
            return
        report = live_report or trend_report(records)
        shown = records[-n:] if n > 0 else records
        rendered = (
            json.dumps({"records": shown, "trend": report}, indent=2) + "\n"
            if fmt == "json"
            else render_trend_text(report, shown)
        )
        _render_out(rendered, output)

    def _load_trace_file(path: str) -> dict:
        import json

        try:
            with open(path) as f:
                return json.load(f)
        except OSError as e:
            raise click.UsageError(f"cannot read trace file {path}: {e}") from e
        except json.JSONDecodeError as e:
            raise click.UsageError(f"{path} is not Chrome trace JSON: {e}") from e

    def _fetch_trace_url(base: str, n: int) -> dict:
        import json
        import urllib.error
        import urllib.request

        target = base.rstrip("/") + "/debug/trace" + (f"?n={n}" if n > 0 else "")
        try:
            with urllib.request.urlopen(target, timeout=30) as response:
                return json.load(response)
        except (OSError, urllib.error.URLError, json.JSONDecodeError) as e:
            raise click.UsageError(f"cannot fetch {target}: {e}") from e

    def callback(
        trace: Any,
        url: Any,
        n: int,
        fmt: str,
        output: Any,
        trend: bool,
        timeline: Any,
        stitch: bool,
    ) -> None:
        import json

        from krr_tpu_torch.obs.profile import profile_chrome_payload, render_text

        traces = list(trace or ())
        urls = list(url or ())
        if trend or timeline is not None:
            if traces or stitch:
                raise click.UsageError(
                    "--trend reads a --timeline file (or --url), not --trace/--stitch"
                )
            if len(urls) > 1:
                raise click.UsageError("--trend takes a single --url")
            return _trend(timeline, urls[0] if urls else None, n, fmt, output)
        if stitch:
            from krr_tpu_torch.obs.trace import stitch_chrome

            if not traces and not urls:
                raise click.UsageError("--stitch needs at least one --trace FILE or --url URL")
            payloads = [_load_trace_file(p) for p in traces]
            payloads += [_fetch_trace_url(u, n) for u in urls]
            stitched = stitch_chrome(payloads)
            if not stitched.get("traceEvents"):
                click.echo("no completed spans in any source — nothing to stitch")
                return
            _render_out(json.dumps(stitched, indent=2) + "\n", output)
            return
        if len(traces) + len(urls) != 1:
            raise click.UsageError(
                "pass exactly one of --trace FILE or --url URL "
                "(repeat sources only with --stitch)"
            )
        payload = _load_trace_file(traces[0]) if traces else _fetch_trace_url(urls[0], n)
        report = profile_chrome_payload(payload, n=n)
        if urls and not report["scans"]:
            # A live process whose trace ring is empty is a FRESH one, not a
            # broken one: say so plainly and exit clean.
            click.echo(
                "no completed scans yet — the server's trace ring is empty "
                "(retry after the first scheduler tick)"
            )
            return
        rendered = json.dumps(report, indent=2) + "\n" if fmt == "json" else render_text(report)
        _render_out(rendered, output)
        if not report["scans"]:
            raise click.ClickException("trace holds no completed scan spans")

    return PanelCommand(
        "analyze",
        callback=callback,
        params=[
            PanelOption(
                ["--trace", "trace"],
                multiple=True,
                default=(),
                help=(
                    "Chrome trace-event JSON file recorded by --trace. Repeat "
                    "with --stitch to merge several processes."
                ),
            ),
            PanelOption(
                ["--url", "url"],
                multiple=True,
                default=(),
                help=(
                    "Base URL of a live process; reads its /debug/trace ring "
                    "(or /debug/timeline with --trend). Repeat with --stitch "
                    "to merge several processes."
                ),
            ),
            PanelOption(
                ["--stitch", "stitch"],
                is_flag=True,
                default=False,
                help=(
                    "Merge the trace rings from every --trace/--url source into "
                    "ONE Chrome trace: remote links join spans across processes, "
                    "with one lane block per source."
                ),
            ),
            PanelOption(
                ["--trend", "trend"],
                is_flag=True,
                default=False,
                help=(
                    "Analyze the scan TIMELINE instead of a trace: replay the "
                    "flight recorder's records through the regression sentinel "
                    "(baseline bands, per-scan verdicts, suspect layers)."
                ),
            ),
            PanelOption(
                ["--timeline", "timeline"],
                default=None,
                help=(
                    "Scan timeline file (timeline.log in the serve state "
                    "directory); implies --trend."
                ),
            ),
            PanelOption(
                ["-n", "n"],
                type=int,
                default=0,
                show_default=True,
                help="Analyze only the newest N scans (0 = all recorded).",
            ),
            PanelOption(
                ["--format", "-f", "fmt"],
                type=click.Choice(["text", "json"]),
                default="text",
                show_default=True,
                help="Report rendering: human text or JSON.",
            ),
            PanelOption(
                ["--output", "-o", "output"],
                default=None,
                help="Write the report to this file instead of stdout.",
            ),
        ],
        help=(
            "Attribute a recorded scan's wall clock across fetch transport/decode, "
            "fold, compute, publish, and idle; estimate the wall if fetch were "
            "free; and print the critical path. Reads a --trace file or a live "
            "process's /debug/trace ring. With --trend: replay the scan timeline "
            "through the regression sentinel instead."
        ),
    )


def _make_fleet_status_command() -> click.Command:
    """``fleet-status``: the aggregator's fleet topology census —
    every node it has heard from (shard HELLOs, replica subscribes) with
    health, acked-vs-current epoch lag, end-to-end freshness, and the
    fleet_health SLO burn — fetched from a live aggregator's ``GET /fleet``."""

    def callback(url: Any, fmt: str, output: Any) -> None:
        import json
        import urllib.error
        import urllib.request

        target = url.rstrip("/") + f"/fleet?format={fmt}"
        try:
            with urllib.request.urlopen(target, timeout=30) as response:
                body = response.read().decode()
        except (OSError, urllib.error.URLError) as e:
            raise click.UsageError(f"cannot fetch {target}: {e}") from e
        if fmt == "json":
            try:
                body = json.dumps(json.loads(body), indent=2) + "\n"
            except json.JSONDecodeError as e:
                raise click.UsageError(f"{target} returned non-JSON: {e}") from e
        if output:
            with open(output, "w") as f:
                f.write(body)
        else:
            click.echo(body, nl=False)

    return PanelCommand(
        "fleet-status",
        callback=callback,
        params=[
            PanelOption(
                ["--url", "url"],
                required=True,
                help="Base URL of the aggregator (the serve with --federation-listen).",
            ),
            PanelOption(
                ["--format", "-f", "fmt"],
                type=click.Choice(["text", "json"]),
                default="text",
                show_default=True,
                help="Census rendering: the human table or the JSON /fleet serves.",
            ),
            PanelOption(
                ["--output", "-o", "output"],
                default=None,
                help="Write the census to this file instead of stdout.",
            ),
        ],
        help=(
            "Show the fleet topology census from a live aggregator's GET "
            "/fleet: per-node health, acked-vs-current epoch lag, end-to-end "
            "freshness, and the fleet_health SLO burn."
        ),
    )


def _make_strategy_command(strategy_name: str, strategy_type: Any) -> click.Command:
    settings_fields = list(strategy_type.get_settings_type().model_fields)

    def callback(**kwargs: Any) -> None:
        import pydantic

        from krr_tpu_torch.core.runner import Runner

        config = _config_from_kwargs(strategy_name, settings_fields, kwargs)
        try:
            runner = Runner(config)  # validates strategy settings (other_args)
        except pydantic.ValidationError as e:
            raise _settings_error(e) from e
        except (RuntimeError, NotImplementedError) as e:
            # A `cuda` device without a card, or a setting that reaches a
            # path not ported yet: a clear error and a nonzero exit, never
            # a quiet CPU scan.
            raise click.ClickException(str(e)) from e
        from krr_tpu_torch.obs.dump import install_signal_dump

        # kill -USR2 <pid> mid-scan dumps the trace ring + metrics snapshot.
        install_signal_dump(
            runner.session.tracer,
            runner.session.metrics,
            device=_strategy_device(runner.session.strategy),
            trace_target=config.trace_path,
            metrics_target=config.metrics_dump_path,
            logger=runner.logger,
        )

        async def run_and_close() -> None:
            # Close the session INSIDE the loop: the loaders' HTTP clients
            # must close before asyncio.run tears the loop down under their
            # open transports.
            try:
                await runner.run()
            finally:
                await runner.session.close()

        try:
            asyncio.run(run_and_close())
        finally:
            # Dump even when the scan raised: a partial trace of a failed
            # scan is exactly what --trace exists to capture.
            _finish_observability(config, runner.session)
        failed_rows = int(runner.stats.get("failed_rows", 0))
        if config.strict and failed_rows:
            raise SystemExit(3)

    return PanelCommand(
        strategy_name,
        callback=callback,
        params=_common_options() + _slo_options() + _strategy_options(strategy_type),
        help=f"Run krr-tpu-torch using the `{strategy_name}` strategy",
    )


@click.group(invoke_without_command=False)
def app() -> None:
    """krr-tpu-torch: the PyTorch/CUDA port of the Kubernetes Resource Recommender."""


@app.command()
def version() -> None:
    """Print the version and exit."""
    click.echo(get_version())


def load_commands() -> None:
    from krr_tpu_torch.strategies.base import BaseStrategy

    strategies = BaseStrategy.get_all()
    for strategy_name, strategy_type in strategies.items():
        if strategy_name not in app.commands:
            app.add_command(_make_strategy_command(strategy_name, strategy_type))
    if "tdigest" in strategies and "serve" not in app.commands:
        # The serve + history subsystems ride the digest strategy.
        app.add_command(_make_serve_command("tdigest", strategies["tdigest"]))
        app.add_command(_make_shard_command("tdigest", strategies["tdigest"]))
        app.add_command(_make_replica_command())
        app.add_command(_make_diff_command("tdigest", strategies["tdigest"]))
    if "analyze" not in app.commands:
        app.add_command(_make_analyze_command())
    if "fleet-status" not in app.commands:
        app.add_command(_make_fleet_status_command())
    if "eval" not in app.commands:
        app.add_command(_make_eval_command())


def run() -> None:
    load_commands()
    app()


if __name__ == "__main__":
    run()
