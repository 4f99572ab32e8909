"""Dependency-free Prometheus text-format metrics — the scan's shared registry.

A trimmed copy of `krr_tpu/obs/metrics.py`: the one-shot scan, the serve
plane, the Kubernetes loader and the Prometheus loader record into one
registry; ``--metrics-dump FILE`` snapshots it and serve's ``GET /metrics``
exposes it. The exposition format (version 0.0.4)
is simple enough that a registry is ~150 lines: counters, gauges, summaries
(sum + count), and native histograms (cumulative ``le`` buckets +
``_sum``/``_count``), with labels. Values live in plain dicts mutated from
the event loop and worker threads — each mutation is a single dict item
assignment (atomic under the GIL).

The metric names keep the ``krr_tpu_`` prefix, so dashboards and recording
rules read both packages alike. Only the families this package fires are
declared: the federation, replica and fleet families with federation, the
``krr_tpu_ingest_*`` families with push ingest.
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
SERVER_METRICS: tuple[tuple, ...] = (
    ("krr_tpu_build_info", "gauge", "Constant 1 labeled with the running build: krr-tpu-torch version, torch version, compute device."),
    ("krr_tpu_scans_total", "counter", "Completed scans by kind (full|delta for serve ticks, cli for one-shot scans)."),
    ("krr_tpu_scans_skipped_total", "counter", "Scheduler ticks skipped because no new window had elapsed."),
    ("krr_tpu_scan_failures_total", "counter", "Scans aborted by an unexpected error."),
    ("krr_tpu_discovery_failures_total", "counter", "Discoveries that returned no objects while the store held rows — treated as transient inventory failures (no compaction)."),
    ("krr_tpu_discovery_cluster_failures_total", "counter", "Per-cluster discovery listing failures that fail-soft degraded that cluster to an empty inventory (the fleet silently scans smaller until it recovers; /healthz names the failing clusters)."),
    # Watch-driven incremental discovery (`--discovery-mode watch`).
    ("krr_tpu_discovery_watch_events_total", "counter", "Watch events applied to the resident inventory, by kind (Deployment|StatefulSet|DaemonSet|Job|Pod) and type (added|modified|deleted|bookmark)."),
    ("krr_tpu_discovery_relists_total", "counter", "Full relists by reason: seed (cold start), 410 (compacted watch history), watch_error (repeated stream failures), verify (the periodic ground-truth audit)."),
    ("krr_tpu_discovery_watch_restarts_total", "counter", "Watch stream reconnects (clean server-side timeouts, disconnects, and transport errors — resumed from the last seen resourceVersion, no relist)."),
    ("krr_tpu_discovery_verify_divergences_total", "counter", "Streams whose watched inventory diverged from the verify relist's ground truth (logged and repaired by adopting the relist)."),
    ("krr_tpu_discovery_inventory_age_seconds", "gauge", "Seconds since the watch-maintained inventory last reconciled into an object list."),
    ("krr_tpu_discovery_watch_lag_seconds", "gauge", "Seconds since the stalest watch stream last made progress (event, bookmark, or relist)."),
    # Push-based metrics ingest (`krr_tpu_torch.ingest`, --metrics-mode push).
    ("krr_tpu_ingest_requests_total", "counter", "Remote-write POSTs to the ingest listener by response code (204 accepted, 400 malformed, 413 oversized, 500 unexpected)."),
    ("krr_tpu_ingest_bytes_total", "counter", "Compressed remote-write body bytes accepted by the ingest listener."),
    ("krr_tpu_ingest_samples_total", "counter", "Samples accepted into the ingest plane's series buffers (the push samples/s ceiling reads off this counter's rate)."),
    ("krr_tpu_ingest_rejected_samples_total", "counter", "Samples rejected by the ingest plane by reason (out_of_order|duplicate|unknown_metric|filtered|missing_labels|malformed_labels|series_limit|buffer_overflow) — rejected, counted, never folded."),
    ("krr_tpu_ingest_tombstones_total", "counter", "Non-finite remote-write samples treated as tombstones: the series watermark advances, nothing folds."),
    ("krr_tpu_ingest_series", "gauge", "Series buffers resident in the ingest plane."),
    ("krr_tpu_ingest_buffered_samples", "gauge", "Samples buffered across the ingest plane's series, post-prune."),
    ("krr_tpu_ingest_freshness_seconds", "gauge", "Age of the STALEST ingest series watermark at the last tick — push-plane lag; climbing means the remote-writer stalled and ticks are falling back to range backfill."),
    ("krr_tpu_ingest_push_objects_total", "counter", "Workload windows folded from the push plane (zero range queries) across all ticks."),
    ("krr_tpu_ingest_verify_total", "counter", "Push-mode divergence audits run: push-fed windows re-fetched as range ground truth and compared bit for bit."),
    ("krr_tpu_ingest_verify_divergences_total", "counter", "Push-fed windows that diverged from the audit's range-fetched ground truth (logged, repaired by adopting the range rows, buffers invalidated)."),
    ("krr_tpu_scan_duration_seconds", "gauge", "Last scan's wall seconds by leg (discover|fetch|fold|compute)."),
    ("krr_tpu_scan_pipeline_seconds", "gauge", "Last scan's streamed-pipeline stage busy seconds (fetch = producer span, fold = consumer busy)."),
    ("krr_tpu_scan_overlap_pct", "gauge", "Fetch/fold overlap of the last scan's streamed pipeline as a percentage of the shorter stage (100 = fully hidden)."),
    ("krr_tpu_scan_window_seconds", "gauge", "Width of the last scan's fetched time window."),
    ("krr_tpu_scan_failed_rows", "gauge", "Object fetches that failed terminally in the last scan (rows rendered UNKNOWN; on serve ticks, quarantined)."),
    ("krr_tpu_scans_degraded_total", "counter", "Serve ticks that published with quarantined workloads: partial fetch failure above the --min-fetch-success-pct abort floor."),
    ("krr_tpu_scan_failed_batches", "gauge", "Pipeline fetch batches that failed terminally in the last streamed serve tick (the batch-granular view between failed rows and the degraded-tick counter)."),
    ("krr_tpu_stale_workloads", "gauge", "Workloads currently quarantined by degraded ticks — their published recommendations carry forward last-good digests with stale_since marks."),
    ("krr_tpu_quarantine_expired_total", "counter", "Quarantined workloads whose staleness exceeded --max-staleness: their accumulated store rows were dropped and they re-enter with a full-window backfill."),
    ("krr_tpu_fetch_rows_total", "counter", "Cumulative object fetches attempted by completed scans (the denominator of the fetch failed-row SLO)."),
    ("krr_tpu_fetch_failed_rows_total", "counter", "Cumulative object fetches that failed terminally (the numerator of the fetch failed-row SLO)."),
    ("krr_tpu_fetch_window_seconds_total", "counter", "Cumulative fetched window seconds by kind — a delta-scan server grows this by the delta width per tick, a re-fetching one by the full history width."),
    ("krr_tpu_backfilled_objects_total", "counter", "Late-discovered workloads given a full-window backfill fetch."),
    ("krr_tpu_last_scan_timestamp_seconds", "gauge", "Unix time of the last published scan's window end."),
    ("krr_tpu_fleet_objects", "gauge", "Scannable objects in the last discovery."),
    ("krr_tpu_digest_store_rows", "gauge", "Rows (containers) resident in the digest store."),
    ("krr_tpu_digest_store_bytes", "gauge", "Resident bytes of the digest store's row arrays."),
    ("krr_tpu_store_compacted_rows_total", "counter", "Store rows dropped by churn compaction."),
    # Durable sharded digest store (`krr_tpu_torch.core.durastore`).
    ("krr_tpu_persist_failures_total", "counter", "Digest state persist attempts that failed on a disk fault (ENOSPC/EIO) — serve keeps publishing from memory and retries with the backlog next tick."),
    ("krr_tpu_store_wal_bytes", "gauge", "Bytes in the durable store's delta WAL since the last compaction (framing header included)."),
    ("krr_tpu_store_wal_records", "gauge", "Delta records appended to the durable store's WAL since the last compaction."),
    ("krr_tpu_store_compactions_total", "counter", "Durable-store compactions: the delta WAL folded back into fresh base shards and the manifest flipped."),
    ("krr_tpu_store_recovery_seconds", "gauge", "Wall seconds the last durable-store open spent reconstructing state (base shard loads + checksum verification + WAL replay)."),
    # Recommendation history + hysteresis (`krr_tpu_torch.history`).
    ("krr_tpu_recommendation_churn_total", "counter", "Published recommendation changes: workloads whose published values moved this tick (first-time publishes excluded)."),
    ("krr_tpu_hysteresis_suppressed_total", "counter", "Workload-ticks where an out-of-dead-band recommendation change was withheld by the hysteresis gate."),
    ("krr_tpu_journal_records", "gauge", "Recommendation-tick records resident in the history journal."),
    ("krr_tpu_journal_bytes", "gauge", "Resident bytes of the history journal's record array."),
    ("krr_tpu_journal_span_seconds", "gauge", "Time between the journal's oldest and newest records (retention coverage)."),
    ("krr_tpu_journal_compacted_records_total", "counter", "Journal records dropped by retention compaction."),
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
    ("krr_tpu_http_requests_total", "counter", "HTTP requests by route and status code."),
    ("krr_tpu_http_request_seconds", "histogram", "HTTP request latency by route.", DEFAULT_SECONDS_BUCKETS),
    # High-QPS read path (`krr_tpu_torch.server.state.ResponseCache` + the
    # app's conditional-GET / bounded-render machinery).
    ("krr_tpu_http_response_bytes_total", "counter", "HTTP response body bytes written to the wire by route and negotiated content encoding (identity|gzip|zstd); HEAD responses and 304 revalidations write none."),
    ("krr_tpu_http_cache_hits_total", "counter", "Read-path response-cache lookups served from the epoch-keyed rendered-body cache (no render, no encode)."),
    ("krr_tpu_http_cache_misses_total", "counter", "Read-path response-cache lookups that had to render (counted before the bounded render pool admits or sheds them)."),
    ("krr_tpu_http_renders_shed_total", "counter", "Cache-miss renders shed with 503/Retry-After because the bounded render pool (width + wait queue) was saturated."),
    ("krr_tpu_http_response_cache_entries", "gauge", "Entries resident in the epoch-keyed response cache (bounded by --response-cache-entries)."),
    ("krr_tpu_http_response_cache_bytes", "gauge", "Body bytes resident in the epoch-keyed response cache (bounded by --response-cache-mb)."),
    ("krr_tpu_http_read_requests", "gauge", "GET /recommendations requests served during the last completed scheduler tick's window (0 = a quiet tick; gates the read-p99 SLO sample)."),
    ("krr_tpu_http_read_p99_seconds", "gauge", "Estimated p99 GET /recommendations request latency over the last completed tick's window (histogram-bucket interpolation; stale while krr_tpu_http_read_requests is 0)."),
    # Device-level compute observability (`krr_tpu_torch.obs.device`). The
    # port has no JIT: its compile is the nvcc build of
    # `krr_tpu_torch.ops.cuda_build`, so only the backend_compile phase
    # ever fires (the JAX trace and lower phases have no counterpart).
    ("krr_tpu_compile_cache_hits_total", "counter", "Kernel libraries loaded from an existing nvcc build (csrc/build/, keyed by a hash of the sources and flags) instead of recompiling."),
    ("krr_tpu_compile_cache_misses_total", "counter", "Kernel sources nvcc had to compile because no build of them existed."),
    ("krr_tpu_compile_seconds", "summary", "nvcc build wall time by phase (backend_compile only: the JAX trace and lower phases have no counterpart in the port) — fires when a kernel library is built; loading an existing build skips it."),
    ("krr_tpu_pad_waste_pct", "gauge", "Padding waste of the last packed batch by resource: percent of the rectangular [rows x capacity] matrix that is padding, not real samples."),
    ("krr_tpu_packed_elements", "gauge", "Elements of the last packed batch by resource and kind — a partition: real samples plus padding sum to the rectangular [rows x capacity] matrix."),
    ("krr_tpu_pack_workers", "gauge", "Threads that filled the last packed batch by resource: 1 on the serial path, more when its pod series are long enough for row blocks on the host's cores."),
    ("krr_tpu_h2d_bytes_total", "counter", "Bytes the resident paths copied host to device by resource: the float32 values of each row block and the int32 counts of each packed batch (the h2d stages' bytes)."),
    ("krr_tpu_h2d_blocks_total", "counter", "Row blocks the resident paths copied host to device by resource, through one reused device buffer a batch (one h2d stage each)."),
    ("krr_tpu_stream_bytes_total", "counter", "Host bytes the streamed paths read into pinned chunks by resource, every pass (the stream_fill stages' bytes)."),
    ("krr_tpu_stream_chunks_total", "counter", "Time chunks the streamed paths copied to the device and folded by resource, every pass."),
    ("krr_tpu_device_memory_bytes", "gauge", "CUDA device memory by device and kind (bytes_in_use = allocated now, peak_bytes_in_use = allocated peak, both from torch.cuda.memory_stats; bytes_limit = the card's total memory); not set when the strategy computes on the CPU."),
    # Scan flight recorder + regression sentinel (`krr_tpu_torch.obs.timeline`,
    # `krr_tpu_torch.obs.sentinel`).
    ("krr_tpu_timeline_records", "gauge", "Scan records retained by the flight recorder's in-memory ring (the durable timeline file may hold up to 2x before retention compaction)."),
    ("krr_tpu_timeline_bytes", "gauge", "Bytes of the durable scan-timeline file (magic header + CRC-framed records); 0 for the memory-only recorder."),
    ("krr_tpu_timeline_compactions_total", "counter", "Scan-timeline retention compactions: the file atomically rewritten down to the newest retain_records records."),
    ("krr_tpu_timeline_append_failures_total", "counter", "Scan-timeline appends that failed on a disk fault (ENOSPC/EIO) — the record survives in memory only and the next append truncates the torn tail first."),
    ("krr_tpu_scan_regression", "gauge", "Regression sentinel deviation by category: the last classified scan's sigmas above its median/MAD baseline band while that category is regressed, 0 while nominal."),
    ("krr_tpu_scan_regressions_total", "counter", "Scans the regression sentinel classified as regressed, by the dominant deviating category."),
    # Multi-cluster federation (`krr_tpu_torch.federation`): the aggregator's
    # shard census + wire accounting, and the shard side's uplink state.
    ("krr_tpu_federation_shards", "gauge", "Scanner shards known to the federation aggregator (connected or not; persisted watermarks count)."),
    ("krr_tpu_federation_connected_shards", "gauge", "Scanner shards with a live connection to the federation aggregator."),
    ("krr_tpu_federation_stale_shards", "gauge", "Shards whose newest applied window is older than the federation staleness budget — their workloads serve carried-forward values with stale_since marks."),
    ("krr_tpu_federation_records_total", "counter", "Delta records accepted (decoded + queued) by the federation aggregator, by shard."),
    ("krr_tpu_federation_duplicate_records_total", "counter", "Delta records discarded as duplicates by the aggregator's epoch watermark (exactly-once replay across shard re-sends), by shard."),
    ("krr_tpu_federation_bytes_total", "counter", "Delta-record payload bytes received by the federation aggregator, by shard — the federation wire cost."),
    ("krr_tpu_federation_queue_records", "gauge", "Decoded delta records queued at the aggregator awaiting the next aggregate tick (per-shard streams back-pressure past --federation-queue-records)."),
    ("krr_tpu_federation_apply_seconds", "histogram", "Wall seconds an aggregate tick spent replaying queued shard delta records into the fleet store.", DEFAULT_SECONDS_BUCKETS),
    ("krr_tpu_federation_shard_epoch", "gauge", "Newest delta epoch applied into the fleet store, by shard."),
    ("krr_tpu_federation_shard_lag_seconds", "gauge", "Age of each shard's newest applied window at the last aggregate tick, by shard."),
    ("krr_tpu_federation_disconnects_total", "counter", "Shard connections the aggregator lost (clean closes, torn frames, and protocol errors alike), by shard."),
    ("krr_tpu_federation_unacked_records", "gauge", "Delta records a shard holds buffered awaiting the aggregator's epoch ack (re-sent on reconnect)."),
    ("krr_tpu_federation_sent_bytes_total", "counter", "Delta-record bytes a shard has streamed to its aggregator (re-sends included)."),
    ("krr_tpu_federation_reconnects_total", "counter", "Aggregator connections (re-)established by a shard."),
    ("krr_tpu_federation_uplink_retries_total", "counter", "Failed federation connect attempts retried through the capped jittered backoff ladder (shard uplinks and the region tier's global uplink alike)."),
    # Key-range partitioned aggregation (`krr_tpu_torch.federation.ring`).
    ("krr_tpu_federation_ring_nodes", "gauge", "Aggregator nodes on the shard's consistent-hash ring (--federation-ring)."),
    ("krr_tpu_federation_ring_keys", "gauge", "Object keys of this shard's store owned by each ring node — the shard-side view of the key-range partition, by node."),
    # Read replicas (`krr_tpu_torch.federation.replica` + the aggregator's
    # epoch-feed broadcast).
    ("krr_tpu_replica_subscribers", "gauge", "Read replicas currently subscribed to this aggregator's epoch feed."),
    ("krr_tpu_replica_feed_bytes_total", "counter", "Epoch-feed payload bytes: sent to subscribed replicas (on the aggregator) or received from the source (on a replica)."),
    ("krr_tpu_replica_epoch", "gauge", "Newest epoch this replica installed from its feed (its X-KRR-Epoch matches the source's at this value)."),
    ("krr_tpu_replica_epochs_applied_total", "counter", "Epoch-feed frames installed by this replica (stale replays drop idempotently and don't count)."),
    ("krr_tpu_replica_feed_lag_seconds", "gauge", "Age of the replica's newest installed epoch against its own clock at install time (wall-vs-wall: clock skew shows up honestly)."),
    ("krr_tpu_replica_reconnects_total", "counter", "Feed connections (re-)established by a replica."),
    # Fleet observability: end-to-end freshness lineage + topology census
    # (the /fleet surface). Freshness buckets run far wider than request
    # latencies — an epoch's age spans scan cadences, not milliseconds.
    ("krr_tpu_e2e_freshness_seconds", "histogram", "Recommendation age (stage timestamp minus the epoch's newest sample timestamp) when each lineage stage finished, by stage (fold|apply|publish|install) — the end-to-end freshness chain of every published epoch.", (0.1, 1.0, 5.0, 15.0, 60.0, 300.0, 900.0, 1800.0, 3600.0, 7200.0, 21600.0, 86400.0)),
    ("krr_tpu_fleet_nodes", "gauge", "Nodes in the aggregator's fleet census, by role (aggregator|shard|replica) — everything a HELLO or feed subscription ever introduced."),
    ("krr_tpu_fleet_epoch_lag", "gauge", "Acked-vs-current epoch lag per fleet node: how many epochs the node trails what it should hold (0 = fully caught up), by node."),
    ("krr_tpu_fleet_node_checks_total", "counter", "Fleet census health checks: one per known node per aggregate tick — the denominator of the fleet_health SLO rollup."),
    ("krr_tpu_fleet_node_unhealthy_total", "counter", "Fleet census health checks that found the node disconnected or stale — the fleet_health SLO rollup's error-budget burn."),
    # SLO engine (`krr_tpu_torch.obs.health`).
    ("krr_tpu_slo_burn_rate", "gauge", "Error-budget burn rate by objective and window (fast|slow): windowed bad ratio divided by the objective's budget; 1.0 consumes exactly the budget over the window."),
    ("krr_tpu_slo_error_budget_remaining", "gauge", "Fraction of the objective's error budget left over the slow window (negative = overspent)."),
    ("krr_tpu_slo_alert_firing", "gauge", "1 while the objective's fast AND slow burn rates exceed their thresholds, else 0."),
    ("krr_tpu_slo_alert_transitions_total", "counter", "SLO alert state transitions by objective and direction (firing|resolved)."),
    # The journal-derived fleet savings posture (`krr_tpu_torch.eval.score`)
    # refreshed on /statusz scrape, plus the scheduler's instantaneous
    # gate-vs-raw over-provision snapshot each publish tick.
    ("krr_tpu_eval_oom_incidents", "gauge", "Would-have-been OOM incidents over the journal window: rising edges where recorded raw memory demand exceeded the published recommendation."),
    ("krr_tpu_eval_throttle_incidents", "gauge", "Would-have-been CPU throttle incidents over the journal window: rising edges where recorded raw CPU demand exceeded the published recommendation."),
    ("krr_tpu_eval_overprovision_core_hours", "gauge", "Core-hours of published-above-demand CPU slack integrated over the journal window (the reclaimable CPU savings)."),
    ("krr_tpu_eval_overprovision_gb_hours", "gauge", "GB-hours of published-above-demand memory slack integrated over the journal window (the reclaimable memory savings)."),
    ("krr_tpu_eval_overprovision_cores", "gauge", "Instantaneous gate-held CPU above raw demand summed over the fleet at the last publish tick."),
    ("krr_tpu_eval_overprovision_gb", "gauge", "Instantaneous gate-held memory above raw demand (GB) summed over the fleet at the last publish tick."),
    ("krr_tpu_eval_replay_seconds", "gauge", "Wall seconds the last /statusz savings computation spent replaying the journal."),
    # Process self-metrics (refreshed on scrape and dump).
    ("krr_tpu_process_resident_bytes", "gauge", "Resident set size of this process."),
    ("krr_tpu_process_open_fds", "gauge", "Open file descriptors of this process."),
    ("krr_tpu_process_uptime_seconds", "gauge", "Seconds since this process imported the metrics core (≈ process start for the CLI and serve)."),
    ("krr_tpu_process_gc_collections_total", "counter", "Cyclic-GC collections by generation."),
    ("krr_tpu_debug_dumps_total", "counter", "On-demand debug dumps written (SIGUSR2)."),
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

    def __init__(self, declarations: Iterable[tuple] = SERVER_METRICS):
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
        """Read one series back (tests, the scan summary, the health route)."""
        return self._values.get(name, {}).get(self._series(name, labels))

    def total(self, name: str) -> float:
        """Sum of a metric's series across ALL label values. Summaries and
        histograms: pass the explicit ``_sum``/``_count`` name."""
        return float(sum(self._values.get(name, {}).values()))

    def series(self, name: str) -> "dict[tuple[tuple[str, str], ...], float]":
        """Every labeled series of one metric (label tuple → value) — for
        readers that need per-series values where a sum would lie (the
        timeline recorder snapshots the per-target in-flight LIMIT gauge,
        where summing across targets is meaningless)."""
        return dict(self._values.get(name, {}))

    def histogram_buckets(
        self, name: str, **labels: str
    ) -> "Optional[list[tuple[float, float]]]":
        """One histogram series as cumulative ``(le, count)`` pairs ending in
        ``(+Inf, total)`` — the representation the SLO engine and Prometheus
        quantile rules share. None when the series never fired."""
        bounds = self._bounds.get(name)
        counts = self._buckets.get(name, {}).get(self._series(name, labels))
        if bounds is None or counts is None:
            return None
        out, running = [], 0.0
        for bound, count in zip((*bounds, float("inf")), counts):
            running += count
            out.append((bound, running))
        return out

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


def histogram_quantile(
    pairs: "list[tuple[float, float]]", q: float
) -> Optional[float]:
    """Quantile estimate from cumulative ``(le, count)`` pairs (the
    :meth:`MetricsRegistry.histogram_buckets` representation, or a delta of
    two such snapshots — cumulative minus cumulative stays cumulative).
    Linear interpolation inside the winning bucket, Prometheus
    ``histogram_quantile`` style; a quantile landing in the +Inf bucket
    clamps to the last finite bound. None when the histogram holds no
    observations."""
    if not pairs:
        return None
    total = pairs[-1][1]
    if total <= 0:
        return None
    rank = q * total
    prev_bound, prev_count = 0.0, 0.0
    for bound, count in pairs:
        if count >= rank:
            if bound == float("inf"):
                return prev_bound
            span = count - prev_count
            if span <= 0:
                return bound
            return prev_bound + (bound - prev_bound) * (rank - prev_count) / span
        prev_bound, prev_count = bound, count
    return prev_bound


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
