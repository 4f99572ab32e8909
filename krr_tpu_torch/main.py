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
file's critical-path attribution or stitches several traces.

Not ported yet (ROADMAP): the ``serve``, ``shard``, ``replica``, ``diff``,
``eval`` and ``fleet-status`` commands, and ``analyze --trend/--timeline``
(they read the serve plane's flight recorder).
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
DEVICE_BACKEND_FIELDS = {"device", "profile_dir", "host_stream_mb", "exact_sketch_budget"}

#: Help-panel render order (any unlisted panel prints after these).
PANEL_ORDER = (
    "General Settings",
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

        record_build_info(session.metrics, str(session.strategy.settings.device))
        refresh_process_metrics(session.metrics)
        with open(config.metrics_dump_path, "w") as f:
            f.write(session.metrics.render())


def _make_analyze_command() -> click.Command:
    """``analyze``: critical-path attribution over a recorded scan trace
    (`krr_tpu_torch.obs.profile`) — where the wall went (fetch transport vs
    decode vs fold vs compute vs idle), the what-if-fetch-were-free
    estimate, and the critical path itself. Input is a ``--trace`` Chrome
    JSON file, or ``--url`` against a live process's ``/debug/trace`` ring;
    ``--stitch`` merges several sources into one trace. The JAX command's
    ``--trend``/``--timeline`` read the serve plane's flight recorder and
    arrive with it."""

    def _render_out(rendered: str, output: Any) -> None:
        if output:
            with open(output, "w") as f:
                f.write(rendered)
        else:
            click.echo(rendered, nl=False)

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

    def callback(trace: Any, url: Any, n: int, fmt: str, output: Any, stitch: bool) -> None:
        import json

        from krr_tpu_torch.obs.profile import profile_chrome_payload, render_text

        traces = list(trace or ())
        urls = list(url or ())
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
                    "Base URL of a live process; reads its /debug/trace ring. "
                    "Repeat with --stitch to merge several processes."
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
            "process's /debug/trace ring."
        ),
    )


def _make_strategy_command(strategy_name: str, strategy_type: Any) -> click.Command:
    settings_fields = list(strategy_type.get_settings_type().model_fields)

    def callback(**kwargs: Any) -> None:
        import pydantic

        from krr_tpu_torch.core.config import Config
        from krr_tpu_torch.core.runner import Runner

        clusters = list(kwargs.pop("clusters") or [])
        namespaces = list(kwargs.pop("namespaces") or [])
        other_args = {name: kwargs.pop(name) for name in settings_fields}
        try:
            config = Config(
                clusters="*" if "*" in clusters else (clusters or None),
                namespaces="*" if ("*" in namespaces or not namespaces) else namespaces,
                strategy=strategy_name,
                other_args=other_args,
                **kwargs,
            )
            runner = Runner(config)  # validates strategy settings (other_args)
        except pydantic.ValidationError as e:
            details = "; ".join(
                f"--{'.'.join(str(p) for p in err['loc']) or 'config'}: {err['msg']}" for err in e.errors()
            )
            raise click.UsageError(f"Invalid settings — {details}") from e
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
            device=str(runner.session.strategy.settings.device),
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

    for strategy_name, strategy_type in BaseStrategy.get_all().items():
        if strategy_name not in app.commands:
            app.add_command(_make_strategy_command(strategy_name, strategy_type))
    if "analyze" not in app.commands:
        app.add_command(_make_analyze_command())


def run() -> None:
    load_commands()
    app()


if __name__ == "__main__":
    run()
