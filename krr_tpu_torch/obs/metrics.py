"""Dependency-free Prometheus text-format metrics — the scan's shared registry.

A trimmed copy of `krr_tpu/obs/metrics.py`: the one-shot scan, the
Kubernetes loader and the Prometheus loader record into one registry, and
``--metrics-dump FILE`` snapshots it. The exposition format (version 0.0.4)
is simple enough that a registry is ~150 lines: counters, gauges, summaries
(sum + count), and native histograms (cumulative ``le`` buckets +
``_sum``/``_count``), with labels. Values live in plain dicts mutated from
the event loop and worker threads — each mutation is a single dict item
assignment (atomic under the GIL).

The metric names keep the ``krr_tpu_`` prefix, so dashboards and recording
rules read both packages alike. Only the families this package fires are
declared; the serve, store, federation, ingest and SLO families arrive with
the slices that fire them (the one-shot ``state_path`` scan passes no
registry to the durable store, as in the JAX package).
"""

from __future__ import annotations

import bisect
import gc
import os
import time
from typing import Iterable, Optional

#: The classic Prometheus seconds ladder — shared by every latency
#: histogram so recording rules see one bucket scheme.
DEFAULT_SECONDS_BUCKETS: tuple[float, ...] = (
    0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)

#: (name, kind, help[, buckets]) for every metric this package emits —
#: declared up front so an exposition carries complete HELP/TYPE headers
#: from the first dump, not only for series that happen to have fired.
SCAN_METRICS: tuple[tuple, ...] = (
    ("krr_tpu_build_info", "gauge", "Constant 1 labeled with the running build: krr-tpu-torch version, torch version, compute device."),
    ("krr_tpu_scans_total", "counter", "Completed scans by kind (cli for one-shot scans)."),
    ("krr_tpu_scan_failures_total", "counter", "Scans aborted by an unexpected error."),
    ("krr_tpu_discovery_cluster_failures_total", "counter", "Per-cluster discovery listing failures that fail-soft degraded that cluster to an empty inventory (the fleet silently scans smaller until it recovers)."),
    ("krr_tpu_scan_duration_seconds", "gauge", "Last scan's wall seconds by leg (discover|fetch|compute)."),
    ("krr_tpu_scan_failed_rows", "gauge", "Object fetches that failed terminally in the last scan (rows rendered UNKNOWN)."),
    ("krr_tpu_fetch_rows_total", "counter", "Cumulative object fetches attempted by completed scans."),
    ("krr_tpu_fetch_failed_rows_total", "counter", "Cumulative object fetches that failed terminally."),
    ("krr_tpu_last_scan_timestamp_seconds", "gauge", "Unix time of the last scan's window end."),
    # The streamed scan pipeline of digest-ingest scans
    # (`krr_tpu_torch.core.pipeline`).
    ("krr_tpu_scan_pipeline_wait_seconds", "gauge", "Last scan's streamed-pipeline wait time by side: producer_blocked = producers stalled in put() (fold-bound), consumer_starved = the consumer parked in get() (fetch-bound)."),
    ("krr_tpu_scan_pipeline_queue_depth", "gauge", "Live streamed-pipeline queue occupancy, sampled at every put and get."),
    ("krr_tpu_prom_query_seconds", "histogram", "Prometheus range-query latency by data plane (buffered|streamed), retries included.", DEFAULT_SECONDS_BUCKETS),
    ("krr_tpu_prom_query_retries_total", "counter", "Prometheus range-query retry attempts beyond each query's first try."),
    ("krr_tpu_prom_points_total", "counter", "Evaluation-grid points covered by successful Prometheus range queries."),
    ("krr_tpu_prom_phase_seconds", "histogram", "Prometheus range-query time by transport phase (queue_wait|connect|request_write|ttfb|body_read|decode|sink), one observation per query per phase that occurred.", DEFAULT_SECONDS_BUCKETS),
    ("krr_tpu_prom_retry_backoff_seconds", "histogram", "Backoff sleeps between Prometheus range-query retry attempts — kept out of the phase split so retries can't masquerade as slow transport.", DEFAULT_SECONDS_BUCKETS),
    ("krr_tpu_prom_breaker_state", "gauge", "Per-target Prometheus circuit-breaker state: 0 closed, 1 half-open (probe in flight), 2 open (failing fast)."),
    ("krr_tpu_prom_breaker_transitions_total", "counter", "Prometheus circuit-breaker state transitions by target and destination state (open|half_open|closed)."),
    ("krr_tpu_prom_breaker_fast_failures_total", "counter", "Range queries failed fast (zero I/O) by an open Prometheus circuit breaker."),
    # Adaptive fetch engine (`krr_tpu_torch.core.fetchplan`): planner +
    # autotuner decisions, and the raw transport's connection churn.
    ("krr_tpu_prom_inflight", "gauge", "In-flight Prometheus range queries per target, sampled as queries clear the concurrency gate."),
    ("krr_tpu_prom_inflight_limit", "gauge", "Live AIMD in-flight query limit per target (--fetch-autotune), floating between 1 and --prometheus-max-connections."),
    ("krr_tpu_prom_connections_opened_total", "counter", "Fresh TCP/TLS connections opened by the raw Prometheus transport (pool misses and keep-alive replacements)."),
    ("krr_tpu_prom_connections_reused_total", "counter", "Keep-alive connections reused from the raw Prometheus transport's idle pool."),
    ("krr_tpu_fetch_plan_coalesced_total", "counter", "Coalesced (multi-namespace) batched queries issued by adaptive fetch plans, per cluster (one per plan group per resource, counted at issue time)."),
    ("krr_tpu_fetch_plan_sharded_total", "counter", "Shard queries issued by adaptive fetch plans over giant namespaces, per cluster (one per shard group per resource, counted at issue time)."),
    ("krr_tpu_prom_wire_bytes_total", "counter", "Response body bytes read off the Prometheus transport by data plane (buffered|streamed) — COMPRESSED bytes when the response negotiated an encoding, so this counter always means what crossed the network."),
    ("krr_tpu_prom_decoded_bytes_total", "counter", "Decoded bytes behind the wire counter: post-inflate body bytes on compressed responses, parsed sample-array bytes on buffered identity parses (decoded ÷ wire is the live compression ratio)."),
    ("krr_tpu_prom_wire_encoding_total", "counter", "Range-query responses by negotiated Content-Encoding (identity|gzip|zstd) — identity climbing while --fetch-compression is on means something on the path stripped Accept-Encoding."),
    ("krr_tpu_fetch_downsampled_total", "counter", "Stats-route queries rewritten as grid-aligned server-side subquery downsamples (--fetch-downsample), per cluster, counted at issue time."),
    ("krr_tpu_fetch_downsample_fallback_total", "counter", "Downsampled stats queries that fell back to the raw fetch after a non-transient backend rejection (the namespaces are pinned to raw in the plan telemetry)."),
    # Process self-metrics (refreshed on dump).
    ("krr_tpu_process_resident_bytes", "gauge", "Resident set size of this process."),
    ("krr_tpu_process_open_fds", "gauge", "Open file descriptors of this process."),
    ("krr_tpu_process_uptime_seconds", "gauge", "Seconds since this process imported the metrics core (≈ process start for the CLI)."),
    ("krr_tpu_process_gc_collections_total", "counter", "Cyclic-GC collections by generation."),
)


def _escape_label(value: str) -> str:
    return value.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _format_value(value: float) -> str:
    # Prometheus text format accepts integers and floats; keep integers
    # unadorned so counters read naturally.
    if float(value).is_integer() and abs(value) < 2**53:
        return str(int(value))
    return repr(float(value))


def _format_le(bound: float) -> str:
    return "+Inf" if bound == float("inf") else _format_value(bound)


class MetricsRegistry:
    """Declared-up-front counters/gauges/summaries/histograms with labeled
    series."""

    def __init__(self, declarations: Iterable[tuple] = SCAN_METRICS):
        self._meta: dict[str, tuple[str, str]] = {}
        #: name -> {sorted-label-tuple -> value}; summaries keep two inner
        #: maps under name+"_sum" / name+"_count" (histograms too, plus the
        #: per-bucket counts under ``_buckets``).
        self._values: dict[str, dict[tuple[tuple[str, str], ...], float]] = {}
        #: histogram name -> upper bounds (excluding +Inf).
        self._bounds: dict[str, tuple[float, ...]] = {}
        #: histogram name -> {series -> per-bucket NON-cumulative counts
        #: (len(bounds) + 1, last slot = +Inf)}; cumulated at render.
        self._buckets: dict[str, dict[tuple[tuple[str, str], ...], list[float]]] = {}
        for declaration in declarations:
            self.declare(*declaration)

    def declare(
        self,
        name: str,
        kind: str,
        help_text: str,
        buckets: Optional[Iterable[float]] = None,
    ) -> None:
        if kind not in ("counter", "gauge", "summary", "histogram"):
            raise ValueError(f"unknown metric kind {kind!r}")
        self._meta[name] = (kind, help_text)
        if kind in ("summary", "histogram"):
            self._values.setdefault(name + "_sum", {})
            self._values.setdefault(name + "_count", {})
            if kind == "histogram":
                bounds = tuple(sorted(buckets or DEFAULT_SECONDS_BUCKETS))
                if not bounds:
                    raise ValueError(f"histogram {name} needs at least one bucket")
                self._bounds[name] = bounds
                self._buckets.setdefault(name, {})
        else:
            self._values.setdefault(name, {})

    def _series(self, name: str, labels: dict) -> tuple[tuple[str, str], ...]:
        return tuple(sorted((k, str(v)) for k, v in labels.items()))

    def inc(self, name: str, amount: float = 1.0, **labels: str) -> None:
        series = self._series(name, labels)
        bucket = self._values[name]
        bucket[series] = bucket.get(series, 0.0) + amount

    def set(self, name: str, value: float, **labels: str) -> None:
        self._values[name][self._series(name, labels)] = float(value)

    def observe(self, name: str, value: float, **labels: str) -> None:
        """One observation. Summaries get ``name_sum`` += value and
        ``name_count`` += 1; histograms additionally count the value into
        its cumulative ``le`` bucket (rendered cumulatively)."""
        series = self._series(name, labels)
        for suffix, amount in (("_sum", float(value)), ("_count", 1.0)):
            bucket = self._values[name + suffix]
            bucket[series] = bucket.get(series, 0.0) + amount
        bounds = self._bounds.get(name)
        if bounds is not None:
            counts = self._buckets[name].setdefault(series, [0.0] * (len(bounds) + 1))
            counts[bisect.bisect_left(bounds, float(value))] += 1.0

    def value(self, name: str, **labels: str) -> Optional[float]:
        """Read one series back (tests and the scan summary)."""
        return self._values.get(name, {}).get(self._series(name, labels))

    def total(self, name: str) -> float:
        """Sum of a metric's series across ALL label values. Summaries and
        histograms: pass the explicit ``_sum``/``_count`` name."""
        return float(sum(self._values.get(name, {}).values()))

    def render(self) -> str:
        """Prometheus exposition format 0.0.4."""
        out: list[str] = []
        for name, (kind, help_text) in self._meta.items():
            out.append(f"# HELP {name} {help_text}")
            out.append(f"# TYPE {name} {kind}")
            if kind == "histogram":
                for series, counts in sorted(self._buckets[name].items()):
                    running = 0.0
                    for bound, count in zip((*self._bounds[name], float("inf")), counts):
                        running += count
                        rendered_labels = ",".join(
                            f'{key}="{_escape_label(val)}"' for key, val in series
                        ) + ("," if series else "") + f'le="{_format_le(bound)}"'
                        out.append(f"{name}_bucket{{{rendered_labels}}} {_format_value(running)}")
            suffixes = ("_sum", "_count") if kind in ("summary", "histogram") else ("",)
            for suffix in suffixes:
                for series, value in sorted(self._values[name + suffix].items()):
                    if series:
                        rendered_labels = ",".join(
                            f'{key}="{_escape_label(val)}"' for key, val in series
                        )
                        out.append(f"{name}{suffix}{{{rendered_labels}}} {_format_value(value)}")
                    else:
                        out.append(f"{name}{suffix} {_format_value(value)}")
        return "\n".join(out) + "\n"


def record_build_info(registry: MetricsRegistry, device: str) -> None:
    """Fire ``krr_tpu_build_info`` so dumps identify the running build: the
    port's version, the torch version, and the compute device in use."""
    import torch

    from krr_tpu_torch.utils.version import get_version

    registry.set(
        "krr_tpu_build_info", 1, version=get_version(), torch=torch.__version__, backend=device
    )


#: Anchor for the uptime gauge. This module imports in the first moments of
#: the CLI (config → runner → metrics), so the delta is process uptime for
#: all practical purposes without touching /proc parsing.
_PROCESS_START = time.time()


def refresh_process_metrics(registry: MetricsRegistry) -> None:
    """Refresh the process self-metrics (RSS, open fds, uptime, GC
    collections) into ``registry`` — called at dump time, so the gauges are
    as fresh as the exposition that carries them. Every probe is defensive:
    /proc may be absent (non-Linux) and a metrics snapshot must never fail
    because of it."""
    registry.set("krr_tpu_process_uptime_seconds", time.time() - _PROCESS_START)
    try:
        with open("/proc/self/statm") as f:
            resident_pages = int(f.read().split()[1])
        registry.set(
            "krr_tpu_process_resident_bytes", resident_pages * os.sysconf("SC_PAGE_SIZE")
        )
    except (OSError, ValueError, IndexError):
        pass
    try:
        registry.set("krr_tpu_process_open_fds", len(os.listdir("/proc/self/fd")))
    except OSError:
        pass
    for generation, stats in enumerate(gc.get_stats()):
        registry.set(
            "krr_tpu_process_gc_collections_total",
            stats.get("collections", 0),
            generation=str(generation),
        )
