"""The asyncio HTTP surface of `serve`.

A port of `krr_tpu/server/app.py`: the same routes, bodies, headers and
status codes. ``GET /fleet`` (the federation census) answers 404 here, as
on a JAX serve that is not an aggregator; the aggregator, the region uplink
and the push ingest listener are ROADMAP M10b.

Deliberately framework-free: the API is a handful of GET routes serving
pre-rendered or worker-thread-rendered bodies, and the stdlib's
``asyncio.start_server`` plus ~100 lines of HTTP/1.1 parsing covers it — no
router, no middleware stack, no dependency the image doesn't already carry.
(aiohttp stays a TEST dependency: the fakes use it, the product doesn't.)

Routes:

* ``GET /recommendations`` — the last published scan. Whole fleet by
  default (a byte copy of the snapshot's pre-rendered JSON); filter with
  repeatable ``namespace=``, and ``workload=`` / ``container=``; paginate
  with ``limit=``/``offset=``; pick a machine format with
  ``format=json|yaml|pprint``. 503 until the first scan publishes.
  High-QPS read path: every non-fast-path response is served from an
  epoch-keyed rendered+encoded cache (`krr_tpu_torch.server.state.ResponseCache`,
  invalidated wholesale when a publish changes bytes), conditional GETs
  (``ETag: "<epoch>-<changed-at-ms>"`` / ``If-None-Match``,
  ``Last-Modified`` / ``If-Modified-Since``) answer 304 with zero render
  work, responses
  compress per ``Accept-Encoding`` (gzip always, zstd when importable),
  and cache misses render through a bounded pool that sheds 503 +
  ``Retry-After`` past saturation. HEAD is answered on every route with
  identical status/headers and an empty body.
* ``GET /history``   — per-workload journal of recommendation ticks (the
  raw series behind the hysteresis-gated snapshot); same filters, plus
  ``limit=`` for the newest N ticks per workload.
* ``GET /drift``     — fleet drift summary (`krr_tpu_torch.history.drift`): raw
  vs published drift, flap counts, regime-change flags.
* ``GET /healthz``   — liveness + scan freshness + journal age (JSON); the
  verdict downgrades to ``degraded`` (still 200) while any SLO alert fires.
* ``GET /metrics``   — Prometheus text format (`krr_tpu_torch.obs.metrics`),
  process self-metrics refreshed per scrape.
* ``GET /statusz``   — the SLO engine's posture (`krr_tpu_torch.obs.health`):
  objectives, burn rates, error budgets, firing alerts. JSON by default,
  ``?format=text`` for humans.
* ``GET /debug/trace`` — the last N scan ticks' spans as Chrome trace-event
  JSON (`krr_tpu_torch.obs.trace` ring; load in ``chrome://tracing``/Perfetto).
* ``GET /debug/profile`` — critical-path attribution over the same ring
  (`krr_tpu_torch.obs.profile`): per-category wall split (fetch-transport /
  fetch-decode / fold / compute / …), the what-if-fetch-were-free
  estimate, and the critical path per scan. JSON by default,
  ``?format=text`` for humans, ``?n=`` limits scans.
* ``GET /debug/timeline`` — the durable scan flight recorder
  (`krr_tpu_torch.obs.timeline`): one compact record per completed tick
  (category seconds, transport phases, fetch-plan shape, publish/persist
  outcome) plus the regression sentinel's trend report over them
  (`krr_tpu_torch.obs.sentinel`). JSON by default, ``?format=text`` for humans,
  ``?n=`` limits the records returned.
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import os
import time
import urllib.parse
from typing import Optional

from krr_tpu_torch.core.config import Config
from krr_tpu_torch.core.runner import ScanSession
from krr_tpu_torch.core.streaming import DigestStore
from krr_tpu_torch.models.result import Result
from krr_tpu_torch.obs.metrics import record_build_info
from krr_tpu_torch.obs.trace import NULL_TRACER, NullTracer, Tracer
from krr_tpu_torch.server.scheduler import ScanScheduler, check_ported
from krr_tpu_torch.server.state import ServerState
from krr_tpu_torch.utils.logging import KrrLogger

#: Request-line / header-section bounds (anything past them is a client bug
#: or an attack; real Prometheus and most proxies cap around 8 KB too).
MAX_REQUEST_LINE = 8192
MAX_HEADER_LINES = 100

_STATUS_REASONS = {
    200: "OK",
    304: "Not Modified",
    400: "Bad Request",
    404: "Not Found",
    405: "Method Not Allowed",
    411: "Length Required",
    431: "Request Header Fields Too Large",
    503: "Service Unavailable",
}

#: Output formats a query may ask for — the machine formatters only (the
#: table formatter renders a rich object for terminals, not an HTTP body).
_FORMATS = {
    "json": "application/json",
    "yaml": "application/x-yaml",
    "pprint": "text/plain; charset=utf-8",
}

_METRICS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def _json_body(payload: dict) -> bytes:
    return (json.dumps(payload) + "\n").encode()


# ------------------------------------------------------- content negotiation
def _zstd_compressor_factory():
    """zstd compression when a zstd module is importable (the image may not
    carry one) — the serve-side twin of the fetch plane's
    `krr_tpu_torch.integrations.prometheus.accept_encoding_for` negotiation."""
    try:
        import zstandard
    except ImportError:
        return None
    return lambda: zstandard.ZstdCompressor()


_ZSTD_FACTORY = _zstd_compressor_factory()

#: Content encodings the read path can serve, most-preferred first.
SUPPORTED_ENCODINGS: "tuple[str, ...]" = (
    ("zstd", "gzip") if _ZSTD_FACTORY is not None else ("gzip",)
)


def negotiate_encoding(accept_encoding: str) -> str:
    """Pick the response ``Content-Encoding`` for a request's
    ``Accept-Encoding`` header: zstd when offered and importable, else gzip,
    else identity. Minimal q-value handling: an encoding offered with
    ``q=0`` is refused, ``*`` matches anything not explicitly listed."""
    if not accept_encoding:
        return "identity"
    offered: dict[str, float] = {}
    for token in accept_encoding.split(","):
        name, _, params = token.strip().partition(";")
        name = name.strip().lower()
        if not name:
            continue
        q = 1.0
        params = params.strip()
        if params.startswith("q="):
            try:
                q = float(params[2:])
            except ValueError:
                q = 0.0
        offered[name] = q
    for candidate in SUPPORTED_ENCODINGS:
        q = offered[candidate] if candidate in offered else offered.get("*", 0.0)
        if q > 0:
            return candidate
    return "identity"


def encode_body(body: bytes, encoding: str) -> bytes:
    """Compress an identity body for a negotiated encoding. gzip uses
    ``mtime=0`` so cached variants are deterministic bytes — the
    cache-correctness tests compare them exactly."""
    if encoding == "gzip":
        import gzip

        return gzip.compress(body, mtime=0)
    if encoding == "zstd":
        return _ZSTD_FACTORY().compress(body)
    return body


def _http_date(ts: float) -> str:
    from email.utils import formatdate

    return formatdate(ts, usegmt=True)


def _parse_http_date(value: str) -> Optional[float]:
    from email.utils import parsedate_to_datetime

    try:
        return parsedate_to_datetime(value).timestamp()
    except (TypeError, ValueError):
        return None


def _conditional_hit(headers: "dict[str, str]", etag: str, changed_at: float) -> bool:
    """Whether the request's validators prove the client's copy current:
    ``If-None-Match`` (exact or weak ``W/`` match, or ``*``) wins over
    ``If-Modified-Since`` (second-granularity HTTP dates, so the comparison
    truncates ``changed_at``), per RFC 9110 precedence."""
    if_none_match = headers.get("if-none-match")
    if if_none_match is not None:
        candidates = {tag.strip().removeprefix("W/") for tag in if_none_match.split(",")}
        return "*" in candidates or etag in candidates
    since = headers.get("if-modified-since")
    if since:
        parsed = _parse_http_date(since)
        return parsed is not None and int(changed_at) <= parsed
    return False


class RenderShed(Exception):
    """Raised when the bounded render pool is saturated (every worker busy
    AND the wait queue full): the request sheds with 503/``Retry-After``
    instead of joining an unbounded ``asyncio.to_thread`` stampede."""


class RenderPool:
    """Semaphore-bounded worker-thread renders for cache-miss reads.

    At most ``width`` renders run concurrently and at most ``queue_limit``
    callers wait behind them; everything past that raises
    :class:`RenderShed` (counted in ``krr_tpu_http_renders_shed_total``).
    Bounding matters more than fairness here: a fleet-wide render is far
    slower than a cache hit, and an unbounded thread fan-out under a
    cache-cold burst is exactly the stampede the cache exists to prevent."""

    def __init__(self, width: int, queue_limit: int, metrics=None) -> None:
        self.width = max(1, int(width))
        self.queue_limit = max(0, int(queue_limit))
        self.metrics = metrics
        self._semaphore = asyncio.Semaphore(self.width)
        self._waiting = 0

    async def run(self, fn):
        if self._semaphore.locked() and self._waiting >= self.queue_limit:
            if self.metrics is not None:
                self.metrics.inc("krr_tpu_http_renders_shed_total")
            raise RenderShed()
        self._waiting += 1
        try:
            await self._semaphore.acquire()
        finally:
            self._waiting -= 1
        try:
            return await asyncio.to_thread(fn)
        finally:
            self._semaphore.release()


def _count_param(
    query: dict[str, list[str]], name: str = "n"
) -> "tuple[Optional[int], Optional[tuple[int, str, bytes]]]":
    """Shared ``?n=`` / count-parameter validation for the debug routes:
    ``(value_or_None, error_response_or_None)``. A non-integer OR negative
    value is a 400 with a JSON error — never a 500, and never a silently
    absorbed ``-3`` (0 and absent both mean "all")."""
    raw = (query.get(name) or ["0"])[-1]
    try:
        value = int(raw)
    except ValueError:
        return None, (
            400,
            "application/json",
            _json_body({"error": f"{name} must be an integer, got {raw!r}"}),
        )
    if value < 0:
        return None, (
            400,
            "application/json",
            _json_body({"error": f"{name} must be >= 0, got {value}"}),
        )
    return (value if value > 0 else None), None


class HttpApp:
    """Route table + HTTP/1.1 plumbing over a :class:`ServerState`.

    ``stale_after_seconds``: /healthz flips to 503 "stale" once the
    published scan's window end falls this far behind the clock — a wedged
    or perpetually-failing scheduler must trip liveness probes instead of
    serving days-old recommendations as "ok" forever.
    """

    def __init__(
        self,
        state: ServerState,
        logger: KrrLogger,
        *,
        stale_after_seconds: float = float("inf"),
        clock=time.time,
        drift_dead_band_pct: float = 5.0,
        drift_confirm_ticks: int = 2,
        hysteresis_enabled: bool = True,
        tracer: NullTracer = NULL_TRACER,
        render_concurrency: int = 4,
        render_queue: int = 16,
        savings_enabled: bool = True,
    ) -> None:
        self.state = state
        self.logger = logger
        self.stale_after_seconds = stale_after_seconds
        self.clock = clock
        #: Bounded worker pool for cache-miss read renders (`RenderPool`):
        #: past width + queue, requests shed 503/Retry-After.
        self.render_pool = RenderPool(
            render_concurrency, render_queue, metrics=state.metrics
        )
        #: The scan session's tracer ring, exported by GET /debug/trace.
        self.tracer = tracer
        #: The gate knobs, echoed by /drift so its out-of-band/regime flags
        #: are interpretable without reading the server's flags.
        self.drift_dead_band_pct = float(drift_dead_band_pct)
        self.drift_confirm_ticks = int(drift_confirm_ticks)
        self.hysteresis_enabled = bool(hysteresis_enabled)
        #: Trend-report memo for /debug/timeline: ``(key, report)`` where
        #: the key is (record count, newest ts). The replay over a
        #: full-retention timeline is real CPU (median/MAD over thousands
        #: of records) and is IDENTICAL between scheduler ticks — a poller
        #: must not burn a core-second per scrape recomputing it.
        self._trend_memo: "Optional[tuple[tuple, dict]]" = None
        #: Whether /statusz serves the journal-derived fleet savings block
        #: (and refreshes the krr_tpu_eval_* gauges). Memoized like the
        #: trend report — the journal replay is identical between ticks.
        self.savings_enabled = bool(savings_enabled)
        self._savings_memo: "Optional[tuple[tuple, Optional[dict]]]" = None
        #: Open client connections, for shutdown: ``Server.close()`` stops
        #: the listener but never touches established keep-alive
        #: connections, and on Python ≥ 3.12.1 ``wait_closed()`` waits for
        #: their handlers — which sit blocked in ``readline()`` — so an idle
        #: scraper connection would hang shutdown past the kill grace.
        self._connections: "set[asyncio.StreamWriter]" = set()

    def abort_connections(self) -> None:
        """Close every open client connection (shutdown): unblocks each
        handler's pending ``readline()`` with EOF so it unwinds cleanly."""
        for writer in list(self._connections):
            writer.close()

    # -------------------------------------------------------------- routes
    async def route(
        self,
        method: str,
        path: str,
        query: dict[str, list[str]],
        headers: "Optional[dict[str, str]]" = None,
    ):
        """Dispatch → ``(status, content_type, body)`` or ``(status,
        content_type, body, extra_headers)`` (the connection handler
        normalizes; see :meth:`_normalize`). HEAD dispatches exactly like
        GET — the handler suppresses the body bytes while keeping the
        status, Content-Length, and validators identical, so load-balancer
        HEAD probes see the same read path GET clients do."""
        if method not in ("GET", "HEAD"):
            return (
                405,
                "application/json",
                _json_body({"error": "only GET and HEAD are supported"}),
                {"Allow": "GET, HEAD"},
            )
        headers = headers or {}
        if path == "/healthz":
            return await self._healthz()
        if path == "/metrics":
            from krr_tpu_torch.obs.metrics import refresh_process_metrics

            refresh_process_metrics(self.state.metrics)
            return 200, _METRICS_CONTENT_TYPE, self.state.metrics.render().encode()
        if path == "/statusz":
            return await self._statusz(query)
        if path == "/recommendations":
            return await self._recommendations(query, headers)
        if path == "/history":
            return await self._history(query, headers)
        if path == "/drift":
            return await self._drift(headers)
        if path == "/debug/trace":
            return await self._debug_trace(query)
        if path == "/debug/profile":
            return await self._debug_profile(query)
        if path == "/debug/timeline":
            return await self._debug_timeline(query)
        if path == "/fleet":
            return await self._fleet(query)
        return 404, "application/json", _json_body({"error": f"no route for {path}"})

    @staticmethod
    def _normalize(response) -> "tuple[int, str, bytes, dict[str, str]]":
        """Pad 3-tuple route responses with empty extra headers."""
        if len(response) == 3:
            status, content_type, body = response
            return status, content_type, body, {}
        return response

    async def _debug_trace(self, query: dict[str, list[str]]) -> tuple[int, str, bytes]:
        """The last N completed scan ticks' spans as Chrome trace-event JSON
        (``?n=`` limits; default the whole ring). Rendered in a worker
        thread — a full ring of wide-fleet scans is thousands of events."""
        n, error = _count_param(query)
        if error is not None:
            return error

        def render() -> bytes:
            return _json_body(self.tracer.export_chrome(n))

        return 200, "application/json", await asyncio.to_thread(render)

    async def _debug_profile(self, query: dict[str, list[str]]) -> tuple[int, str, bytes]:
        """Critical-path attribution of the last N completed scan ticks
        (`krr_tpu_torch.obs.profile` over the trace ring). Worker-thread rendered:
        the sweep walks every span of every ringed scan."""
        n, error = _count_param(query)
        if error is not None:
            return error
        fmt = (query.get("format") or ["json"])[-1]
        if fmt not in ("json", "text"):
            return 400, "application/json", _json_body(
                {"error": f"unknown format {fmt!r}; one of ['json', 'text']"}
            )

        def render() -> bytes:
            from krr_tpu_torch.obs.profile import profile_traces, render_text

            report = profile_traces(self.tracer.traces(n))
            if fmt == "text":
                return render_text(report).encode()
            return _json_body(report)

        content_type = "text/plain; charset=utf-8" if fmt == "text" else "application/json"
        return 200, content_type, await asyncio.to_thread(render)

    async def _debug_timeline(self, query: dict[str, list[str]]) -> tuple[int, str, bytes]:
        """The scan flight recorder's records plus the sentinel trend report
        over them (`krr_tpu_torch.obs.timeline` / `krr_tpu_torch.obs.sentinel`).
        ``?n=`` limits the RECORDS returned; the trend always replays the
        whole retained timeline so warm-up and baselines are honest."""
        n, error = _count_param(query)
        if error is not None:
            return error
        fmt = (query.get("format") or ["json"])[-1]
        if fmt not in ("json", "text"):
            return 400, "application/json", _json_body(
                {"error": f"unknown format {fmt!r}; one of ['json', 'text']"}
            )
        timeline = self.state.timeline
        if timeline is None:
            return 404, "application/json", _json_body(
                {"error": "no scan timeline on this server"}
            )

        def render() -> bytes:
            from krr_tpu_torch.obs.sentinel import render_trend_text, sentinel_knobs, trend_report

            records = timeline.records()
            sentinel = self.state.sentinel
            key = (len(records), records[-1].get("ts") if records else None)
            memo = self._trend_memo
            if memo is not None and memo[0] == key:
                report = memo[1]
            else:
                report = trend_report(records, **sentinel_knobs(sentinel))
                # Benign race (worker threads): worst case is one duplicate
                # compute, never a torn result — the tuple swap is atomic.
                self._trend_memo = (key, report)
            window = records[-(n or len(records)):]
            if fmt == "text":
                return render_trend_text(report, window).encode()
            # Per-record verdicts follow the SAME window as the records:
            # a full-retention timeline's verdict list is per-category
            # deviation dicts for thousands of scans — multi-MB per scrape
            # for data the regressions + status summaries already carry.
            report = {**report, "verdicts": report["verdicts"][-(n or len(records)):]}
            payload = {
                "records": window,
                "trend": report,
                "live": sentinel.status() if sentinel is not None else None,
            }
            return _json_body(payload)

        content_type = "text/plain; charset=utf-8" if fmt == "text" else "application/json"
        return 200, content_type, await asyncio.to_thread(render)

    async def _fleet(self, query: dict[str, list[str]]) -> tuple[int, str, bytes]:
        """The fleet topology census lives on a federation aggregator
        (ROADMAP M10b): this server answers the JAX non-aggregator's 404."""
        return 404, "application/json", _json_body(
            {"error": "no fleet census on this server (not an aggregator)"}
        )

    async def _statusz(self, query: dict[str, list[str]]) -> tuple[int, str, bytes]:
        """The SLO engine's posture. READ-ONLY: burn rates recompute at the
        request clock from the tick-cadenced samples — scrape traffic never
        appends events (`krr_tpu_torch.obs.health.SloEngine.status`)."""
        engine = self.state.slo
        if engine is None:
            return 404, "application/json", _json_body(
                {"error": "no SLO engine on this server"}
            )
        fmt = (query.get("format") or ["json"])[-1]
        if fmt == "text":
            text = engine.render_text()
            if self.state.sentinel is not None:
                text += self._trend_text()
            savings = await asyncio.to_thread(self._savings_block)
            if savings is not None:
                text += self._savings_text(savings)
            return 200, "text/plain; charset=utf-8", text.encode()
        if fmt != "json":
            return 400, "application/json", _json_body(
                {"error": f"unknown format {fmt!r}; one of ['json', 'text']"}
            )
        payload = engine.status()
        # The trend section: the sentinel's warm-up posture, current
        # median/MAD bands, and the last verdict — serve-only, like the
        # server summary below.
        if self.state.sentinel is not None:
            payload["trend"] = self.state.sentinel.status()
        # The serve-side degraded-state summary rides along (the one-shot
        # --statusz dump has no server, so this section is serve-only).
        payload["server"] = {
            "stale_workloads": len(self.state.stale_workloads),
            "consecutive_scan_failures": self.state.consecutive_scan_failures,
            "last_scan_error": self.state.last_scan_error,
            "persist_failing": self.state.persist_failing,
            "persist_failures": self.state.persist_failures,
            "last_persist_error": self.state.last_persist_error,
            "discovery_failed_clusters": dict(self.state.discovery_failed_clusters),
            "discovery": dict(self.state.discovery),
            "ingest": dict(self.state.ingest),
        }
        # The fleet "savings" summary: what the journal says the published
        # recommendations would have cost/saved over the retention window
        # (`krr_tpu_torch.eval.score.journal_savings`) — serve-only, like trend.
        savings = await asyncio.to_thread(self._savings_block)
        if savings is not None:
            payload["savings"] = savings
        return 200, "application/json", _json_body(payload)

    def _savings_block(self) -> "Optional[dict]":
        """The journal-derived fleet savings summary, memoized on (record
        count, newest tick) — a scrape never re-replays an unchanged
        journal — with the ``krr_tpu_eval_*`` gauges refreshed whenever the
        replay actually runs."""
        journal = self.state.journal
        if not self.savings_enabled or journal is None:
            return None
        key = (journal.record_count, journal.newest_ts)
        if self._savings_memo is not None and self._savings_memo[0] == key:
            return self._savings_memo[1]
        from krr_tpu_torch.eval.score import journal_savings

        started = time.monotonic()
        block = journal_savings(journal)
        if block is not None:
            metrics = self.state.metrics
            metrics.set("krr_tpu_eval_oom_incidents", block["oom_incidents"])
            metrics.set("krr_tpu_eval_throttle_incidents", block["throttle_incidents"])
            metrics.set(
                "krr_tpu_eval_overprovision_core_hours", block["overprovisioned_core_hours"]
            )
            metrics.set(
                "krr_tpu_eval_overprovision_gb_hours", block["overprovisioned_gb_hours"]
            )
            metrics.set(
                "krr_tpu_eval_replay_seconds", round(time.monotonic() - started, 6)
            )
        self._savings_memo = (key, block)
        return block

    def _savings_text(self, block: "dict") -> str:
        """The human savings lines appended to ``/statusz?format=text``."""
        hours = block["window_seconds"] / 3600.0
        return (
            "\n"
            "savings (journal replay):\n"
            f"  {block['workloads']} workload(s) over {block['ticks']} tick(s) ({hours:.1f}h)\n"
            f"  would-have-been incidents: {block['oom_incidents']} OOM, "
            f"{block['throttle_incidents']} throttle\n"
            f"  reclaimable slack: {block['overprovisioned_core_hours']:.3f} core-h, "
            f"{block['overprovisioned_gb_hours']:.3f} GB-h\n"
            f"  {block['published_records']} published / {block['suppressed_records']} "
            f"suppressed journal records\n"
        )

    def _trend_text(self) -> str:
        """The human trend lines appended to ``/statusz?format=text``."""
        sentinel = self.state.sentinel
        status = sentinel.status()
        lines = ["", "trend (regression sentinel):"]
        for kind, posture in sorted(status["baselines"].items()):
            flag = "warm" if posture["warmed"] else f"warming ({posture['observed']} seen)"
            lines.append(f"  [{kind}] {flag}")
        verdict = status.get("last_verdict")
        if verdict is None:
            lines.append("  no classified scans yet")
        elif verdict["status"] == "regressed":
            lines.append(
                f"  last scan REGRESSED: {verdict['dominant']} "
                f"+{verdict['sigma']:.1f}σ → {verdict['suspect']}"
            )
        else:
            lines.append(f"  last scan: {verdict['status']}")
        lines.append(
            f"  {status['regressed_scans']} of {status['classified_scans']} "
            f"classified scans regressed this process"
        )
        return "\n".join(lines) + "\n"

    def _snapshot_stale(self, snapshot) -> bool:
        return float(self.clock()) - snapshot.window_end > self.stale_after_seconds

    async def _healthz(self) -> tuple[int, str, bytes]:
        snapshot = await self.state.snapshot()
        firing = self.state.slo.firing() if self.state.slo is not None else []
        if snapshot is None:
            status = "starting"
        elif self._snapshot_stale(snapshot):
            status = "stale"
        elif firing or self.state.persist_failing:
            # SLO burn — or a failing state persist (ENOSPC/EIO: serve
            # keeps publishing from memory and retries each tick) —
            # downgrades the verdict without failing liveness: the pod is
            # alive and serving, but needs attention — /statusz has the
            # details. ``stale`` (503) outranks it.
            status = "degraded"
        else:
            status = "ok"
        journal = self.state.journal
        journal_newest = journal.newest_ts if journal is not None else None
        body = {
            "status": status,
            "uptime_seconds": round(time.time() - self.state.started_at, 3),
            # The publish epoch — the read path's cache key and ETag value
            # (conditional clients can learn the current epoch from a cheap
            # /healthz probe instead of a full fetch).
            "epoch": snapshot.epoch if snapshot is not None else None,
            "scans": len(snapshot.result.scans) if snapshot is not None else 0,
            "last_scan_unix": snapshot.window_end if snapshot is not None else None,
            "last_scan_id": self.state.last_scan_id,
            "store_rows": len(self.state.store.keys),
            # Hysteresis visibility: a fleet publishing nothing is either
            # genuinely quiet (suppressed 0) or held behind the gate
            # (suppressed > 0) — operators need the distinction.
            "last_publish_suppressed": self.state.last_publish_suppressed,
            "last_publish_changed": self.state.last_publish_changed,
            "journal_records": journal.record_count if journal is not None else 0,
            "journal_age_seconds": (
                round(float(self.clock()) - journal_newest, 3)
                if journal_newest is not None
                else None
            ),
            # Degraded-state visibility without grepping logs: quarantined
            # workloads serving carried-forward values, how many ticks in a
            # row have aborted, the last abort's error, and any cluster
            # whose discovery listing failed (the fleet is silently smaller
            # than configured until it recovers).
            "discovery_failed_clusters": dict(self.state.discovery_failed_clusters),
            # Discovery posture: the active mode and, in watch mode, how
            # fresh the resident inventory and its watch streams are
            # (inventory_age_seconds / watch_lag_seconds).
            "discovery": dict(self.state.discovery),
            # Metrics-acquisition posture: the active metrics mode.
            "ingest": dict(self.state.ingest),
            "stale_workloads": len(self.state.stale_workloads),
            "consecutive_scan_failures": self.state.consecutive_scan_failures,
            "last_scan_error": self.state.last_scan_error,
            # Durable-store posture: a failing persist means restarts lose
            # the unpersisted ticks (refetched, not corrupted) — degraded,
            # not dead.
            "persist_failing": self.state.persist_failing,
            "persist_failures": self.state.persist_failures,
            "last_persist_error": self.state.last_persist_error,
            "slo_firing": firing,
        }
        extra = (
            {"X-KRR-Epoch": str(snapshot.epoch)} if snapshot is not None else {}
        )
        return (
            (200 if status in ("ok", "degraded") else 503),
            "application/json",
            _json_body(body),
            extra,
        )

    def _snapshot_validators(self, snapshot, encoding: str = "identity") -> "dict[str, str]":
        # The ETag carries the epoch AND the content change's millisecond
        # timestamp: the epoch alone is only unique within one process
        # lifetime (a restarted memory-only server recounts from 0, and a
        # client — or shared proxy cache — holding a pre-restart ETag would
        # false-304 once the new process counted back up to the old value
        # with different bytes). epoch+changed_at can't collide across
        # restarts; suppressed republishes carry both forward, so the tag
        # stays stable at steady state. Non-identity variants suffix the
        # encoding (the Apache mod_deflate convention): distinct
        # representations must carry distinct strong tags, or an ETag-keyed
        # intermediary could freshen the wrong variant off a 304.
        suffix = "" if encoding == "identity" else f"-{encoding}"
        return {
            "ETag": f'"{snapshot.epoch}-{int(snapshot.changed_at * 1000.0)}{suffix}"',
            "Last-Modified": _http_date(snapshot.changed_at),
            "X-KRR-Epoch": str(snapshot.epoch),
            "Vary": "Accept-Encoding",
        }

    async def _rendered(self, render):
        """Bounded-pool admission with the shared shed response:
        ``(body, None)`` on success, ``(None, 503-response)`` when the pool
        is saturated — one place defines what shedding looks like."""
        try:
            return await self.render_pool.run(render), None
        except RenderShed:
            return None, (
                503,
                "application/json",
                _json_body({"error": "render pool saturated; retry shortly"}),
                {"Retry-After": "1"},
            )

    async def _recommendations(
        self, query: dict[str, list[str]], headers: "dict[str, str]"
    ):
        snapshot = await self.state.snapshot()
        if snapshot is None:
            return 503, "application/json", _json_body(
                {"error": "no scan has completed yet; retry shortly"}
            ), {"Retry-After": "1"}
        # Repeated format= params are pinned last-wins (the [-1]).
        fmt = (query.get("format") or ["json"])[-1]
        content_type = _FORMATS.get(fmt)
        if content_type is None:
            return 400, "application/json", _json_body(
                {"error": f"unknown format {fmt!r}; one of {sorted(_FORMATS)}"}
            )
        # Pagination pushdown: the shared count-param hygiene (non-integer
        # or negative → 400), 0/absent meaning "all"/"from the start".
        limit, error = _count_param(query, "limit")
        if error is not None:
            return error
        offset, error = _count_param(query, "offset")
        if error is not None:
            return error
        offset = offset or 0
        namespaces = frozenset(query.get("namespace", ()))
        workloads = frozenset(query.get("workload", ()))
        containers = frozenset(query.get("container", ()))

        # Negotiated BEFORE the conditional check: the ETag is
        # per-representation (encoding-suffixed), so a client revalidates
        # against the tag of the variant it would be served now.
        encoding = negotiate_encoding(headers.get("accept-encoding", ""))
        validators = self._snapshot_validators(snapshot, encoding)
        if _conditional_hit(headers, validators["ETag"], snapshot.changed_at):
            # Revalidation: zero render work, zero body bytes — the whole
            # point of the epoch ETag. 304 carries the same validators.
            return 304, content_type, b"", validators

        unfiltered = not (namespaces or workloads or containers)
        unpaged = limit is None and not offset
        if unfiltered and unpaged and fmt == "json" and encoding == "identity":
            # The pre-rendered fast path: a byte copy of the publish-time
            # body, no cache entry needed.
            return 200, content_type, snapshot.body_json, validators

        cache = self.state.response_cache
        cache_key = (
            fmt,
            tuple(sorted(namespaces)),
            tuple(sorted(workloads)),
            tuple(sorted(containers)),
            limit,
            offset,
        )
        cached_identity: "Optional[bytes]" = None
        if cache is not None:
            body = cache.get(snapshot.epoch, (*cache_key, encoding))
            if body is not None:
                extra = dict(validators)
                if encoding != "identity":
                    extra["Content-Encoding"] = encoding
                return 200, content_type, body, extra
            if encoding != "identity":
                # An encoded-variant miss whose identity sibling is already
                # cached only needs the COMPRESSION leg, not a re-render.
                cached_identity = cache.peek(snapshot.epoch, (*cache_key, "identity"))

        def render() -> "tuple[bytes, bytes]":
            # Pushdown + render + encode (+ compress) all in the worker
            # thread — at fleet scale even the filter pass over every key
            # is time the event loop can't afford.
            identity = cached_identity
            if identity is None:
                identity = self._render_recommendations(
                    snapshot, fmt, namespaces, workloads, containers, limit, offset
                )
            return identity, encode_body(identity, encoding)

        rendered, shed = await self._rendered(render)
        if shed is not None:
            return shed
        identity, encoded = rendered
        if cache is not None:
            # Identity and the negotiated variant cached side by side: a
            # later reader with either Accept-Encoding hits without
            # re-rendering OR re-compressing.
            cache.put(snapshot.epoch, (*cache_key, "identity"), identity)
            if encoding != "identity":
                cache.put(snapshot.epoch, (*cache_key, encoding), encoded)
        extra = dict(validators)
        if encoding != "identity":
            extra["Content-Encoding"] = encoding
        return 200, content_type, encoded, extra

    @staticmethod
    def _render_recommendations(
        snapshot, fmt, namespaces, workloads, containers, limit, offset
    ) -> bytes:
        """The identity body for one (format, filters, page) combination.
        Filters resolve to row indices against the snapshot's KEY TABLE
        (`krr_tpu_torch.core.streaming.filter_key_indices` — the same key grammar
        the digest store rows carry) and pagination slices the index list,
        so only the selected scan objects are ever touched; the selected
        subset renders through the identical ``Result`` path the pre-cache
        code used, which is what keeps filtered responses bit-identical to
        render-then-slice. NOTE the published scans go through the
        hysteresis gate — re-querying ``DigestStore.query_recommendation``
        per request would serve RAW values the gate withheld, so the
        pushdown stops at the key table and reuses the published scans."""
        from krr_tpu_torch.core.streaming import filter_key_indices, object_key

        unfiltered = not (namespaces or workloads or containers)
        if unfiltered and limit is None and not offset:
            if fmt == "json":
                return snapshot.body_json
            return snapshot.result.format(fmt).encode()
        scans = snapshot.result.scans
        keys = snapshot.keys
        if len(keys) != len(scans):  # snapshots built without a key table
            keys = [object_key(scan.object) for scan in scans]
        indices = filter_key_indices(keys, namespaces, workloads, containers)
        window = indices[offset : (offset + limit) if limit is not None else None]
        return Result(scans=[scans[i] for i in window]).format(fmt).encode()

    def _journal_validators(self, journal) -> "tuple[dict[str, str], float]":
        """(validators, changed_at) for the journal-backed routes. The
        journal gains records every tick — including hysteresis-suppressed
        ones — so the publish epoch alone would false-304 a grown journal;
        the ETag carries the journal's record count and newest timestamp
        alongside it."""
        snapshot = self.state.peek()
        epoch = snapshot.epoch if snapshot is not None else 0
        newest = journal.newest_ts or self.state.started_at
        etag = f'"{epoch}-{journal.record_count}-{newest}"'
        return {
            "ETag": etag,
            "Last-Modified": _http_date(newest),
            "X-KRR-Epoch": str(epoch),
        }, float(newest)

    async def _history(self, query: dict[str, list[str]], headers: "dict[str, str]"):
        """Per-workload journal series: every recompute's raw recommendation
        with its published flag — the audit trail behind the gated snapshot."""
        journal = self.state.journal
        if journal is None:
            return 404, "application/json", _json_body({"error": "no journal on this server"})
        namespaces = set(query.get("namespace", ()))
        workloads = set(query.get("workload", ()))
        containers = set(query.get("container", ()))
        limit, error = _count_param(query, "limit")
        if error is not None:
            return error
        validators, changed_at = self._journal_validators(journal)
        if _conditional_hit(headers, validators["ETag"], changed_at):
            return 304, "application/json", b"", validators

        def render() -> bytes:
            from krr_tpu_torch.core.streaming import split_object_key
            from krr_tpu_torch.history.drift import finite_or_none
            from krr_tpu_torch.history.journal import FLAG_PUBLISHED

            payload: dict = {
                "records": journal.record_count,
                "oldest_ts": journal.oldest_ts,
                "newest_ts": journal.newest_ts,
                "retention_seconds": journal.retention_seconds,
                "workloads": [],
            }
            for key, group in journal.records_by_workload():
                unresolved = "/" not in key  # hex fallback: lost key sidecar
                if unresolved:
                    # Splitting a hash as an object key would scatter it
                    # into the wrong identity fields; it matches no filter.
                    if namespaces or workloads or containers:
                        continue
                    cluster = namespace = name = container = kind = None
                else:
                    cluster, namespace, name, container, kind = split_object_key(key)
                    if namespaces and namespace not in namespaces:
                        continue
                    if workloads and name not in workloads:
                        continue
                    if containers and container not in containers:
                        continue
                if limit:
                    group = group[-limit:]
                payload["workloads"].append(
                    {
                        "key": key,
                        "unresolved": unresolved,
                        "cluster": cluster,
                        "namespace": namespace,
                        "workload": name,
                        "container": container,
                        "kind": kind,
                        "ticks": [
                            {
                                "ts": float(row["ts"]),
                                "cpu": finite_or_none(row["cpu"]),
                                "memory_mb": finite_or_none(row["mem"]),
                                "published": bool(row["flags"] & FLAG_PUBLISHED),
                            }
                            for row in group
                        ],
                    }
                )
            return _json_body(payload)

        # Journal renders walk every record per request and have no
        # response cache — the bounded pool (not a bare to_thread) is what
        # keeps a cache-cold burst from stampeding worker threads.
        body, shed = await self._rendered(render)
        if shed is not None:
            return shed
        return 200, "application/json", body, validators

    async def _drift(self, headers: "dict[str, str]"):
        """Fleet drift posture from the journal (`krr_tpu_torch.history.drift`)."""
        journal = self.state.journal
        if journal is None:
            return 404, "application/json", _json_body({"error": "no journal on this server"})
        validators, changed_at = self._journal_validators(journal)
        if _conditional_hit(headers, validators["ETag"], changed_at):
            return 304, "application/json", b"", validators

        def render() -> bytes:
            from krr_tpu_torch.history.drift import fleet_drift

            rows = fleet_drift(
                journal,
                dead_band_pct=self.drift_dead_band_pct,
                confirm_ticks=self.drift_confirm_ticks,
            )
            out_of_band = sum(1 for row in rows if row.out_of_band_streak > 0)
            payload = {
                "dead_band_pct": self.drift_dead_band_pct,
                "confirm_ticks": self.drift_confirm_ticks,
                "hysteresis_enabled": self.hysteresis_enabled,
                "last_publish_suppressed": self.state.last_publish_suppressed,
                "summary": {
                    "workloads": len(rows),
                    "out_of_band": out_of_band,
                    "regime_changes": sum(1 for row in rows if row.regime_change),
                    "flaps": sum(row.flaps for row in rows),
                },
                "workloads": [row.as_dict() for row in rows],
            }
            return _json_body(payload)

        body, shed = await self._rendered(render)
        if shed is not None:
            return shed
        return 200, "application/json", body, validators

    # ------------------------------------------------------------ plumbing
    async def handle_connection(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        self._connections.add(writer)
        try:
            while True:
                keep_alive = await self._handle_one(reader, writer)
                if not keep_alive:
                    break
        except (ConnectionError, asyncio.IncompleteReadError, asyncio.LimitOverrunError):
            pass  # client went away mid-request: nothing to serve
        except asyncio.CancelledError:
            raise
        except Exception:
            self.logger.debug_exception()
        finally:
            self._connections.discard(writer)
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass

    async def _handle_one(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> bool:
        """Serve one request; returns whether to keep the connection open."""
        request_line = await reader.readline()
        if not request_line:
            return False
        if len(request_line) > MAX_REQUEST_LINE:
            self._respond(writer, 400, "application/json", _json_body({"error": "request line too long"}), False)
            await writer.drain()
            return False
        parts = request_line.decode("latin-1").strip().split()
        if len(parts) != 3 or not parts[2].startswith("HTTP/1"):
            self._respond(writer, 400, "application/json", _json_body({"error": "malformed request line"}), False)
            await writer.drain()
            return False
        method, target, version = parts

        headers: dict[str, str] = {}
        header_lines = 0  # count LINES read, not dict entries — repeated
        while True:        # names would otherwise evade the cap unconsumed
            line = await reader.readline()
            if line in (b"\r\n", b"\n", b""):
                break
            header_lines += 1
            if header_lines > MAX_HEADER_LINES:
                self._respond(writer, 431, "application/json", _json_body({"error": "too many headers"}), False)
                await writer.drain()
                return False
            name, _, value = line.decode("latin-1").partition(":")
            headers[name.strip().lower()] = value.strip()

        # GET carries no body; drain a declared one anyway so keep-alive
        # framing survives odd clients. A body we won't fully drain (or a
        # length we can't parse) closes the connection — anything else
        # desyncs the framing and parses body bytes as the next request.
        if "chunked" in headers.get("transfer-encoding", "").lower():
            # No chunked decoding here: keeping the connection would parse
            # the chunk stream as the next request line.
            self._respond(writer, 411, "application/json", _json_body({"error": "chunked requests unsupported"}), False)
            await writer.drain()
            return False
        try:
            length = int(headers.get("content-length") or 0)
        except ValueError:
            length = -1
        if length < 0 or length > (1 << 20):
            self._respond(writer, 400, "application/json", _json_body({"error": "bad content-length"}), False)
            await writer.drain()
            return False
        if length:
            await reader.readexactly(length)

        split = urllib.parse.urlsplit(target)
        query = urllib.parse.parse_qs(split.query, keep_blank_values=False)

        t0 = time.perf_counter()
        status, content_type, body, extra_headers = self._normalize(
            await self.route(method, split.path, query, headers)
        )
        route_label = (
            split.path
            if split.path
            in ("/healthz", "/metrics", "/statusz", "/recommendations", "/history", "/drift", "/fleet", "/debug/trace", "/debug/profile", "/debug/timeline")
            else "other"
        )
        self.state.metrics.inc("krr_tpu_http_requests_total", route=route_label, code=str(status))
        self.state.metrics.observe(
            "krr_tpu_http_request_seconds", time.perf_counter() - t0, route=route_label
        )
        # Bytes actually written to the wire, by negotiated encoding (a HEAD
        # response writes none; 304s count their zero-length bodies for free).
        head_only = method == "HEAD"
        if not head_only and body:
            self.state.metrics.inc(
                "krr_tpu_http_response_bytes_total",
                len(body),
                route=route_label,
                encoding=extra_headers.get("Content-Encoding", "identity"),
            )

        keep_alive = headers.get("connection", "" if version == "HTTP/1.1" else "close").lower() != "close"
        self._respond(writer, status, content_type, body, keep_alive, extra_headers, head_only=head_only)
        await writer.drain()
        return keep_alive

    @staticmethod
    def _respond(
        writer: asyncio.StreamWriter,
        status: int,
        content_type: str,
        body: bytes,
        keep_alive: bool,
        extra_headers: "Optional[dict[str, str]]" = None,
        *,
        head_only: bool = False,
    ) -> None:
        """``head_only`` (a HEAD request) sends the IDENTICAL status line and
        headers — Content-Length and validators included, which is what
        load-balancer probes key on — with the body bytes suppressed."""
        reason = _STATUS_REASONS.get(status, "OK")
        lines = [
            f"HTTP/1.1 {status} {reason}",
            f"Content-Type: {content_type}",
            f"Content-Length: {len(body)}",
        ]
        for name, value in (extra_headers or {}).items():
            lines.append(f"{name}: {value}")
        lines.append(f"Connection: {'keep-alive' if keep_alive else 'close'}")
        head = "\r\n".join(lines) + "\r\n\r\n"
        writer.write(head.encode("latin-1") + (b"" if head_only else body))


class KrrServer:
    """Composition root: session + state + scheduler + HTTP, one lifecycle.

    ``clock`` is injectable so tests (and offline replays) can pin scan
    windows; the ``session`` injection point takes a pre-built
    :class:`ScanSession` with fake inventory/history sources.
    """

    def __init__(
        self,
        config: Config,
        *,
        session: Optional[ScanSession] = None,
        clock=time.time,
        logger: Optional[KrrLogger] = None,
    ) -> None:
        self.config = config
        self.session = session or ScanSession(config, logger=logger)
        self.logger = logger or self.session.logger
        settings = self.session.strategy.settings
        if not hasattr(settings, "cpu_spec"):
            raise ValueError(
                "krr-tpu serve requires a digest-backed strategy (tdigest): "
                "incremental delta folds ride on the digest's mergeability"
            )
        # The resident store; with state_path configured it resumes the
        # persisted digests through the durable engine
        # (`krr_tpu_torch.core.durastore`): sharded state DIRECTORY by default
        # (legacy single-file state auto-migrates on first open; the
        # strategy's --store_format legacy keeps the old single-file
        # shape), per-tick delta WAL appends, threshold compaction, and
        # kill-proof recovery. The journal rides alongside: default path
        # <state_path>.journal (memory-only when neither is set;
        # --history-path "" forces memory-only even with a state_path).
        from krr_tpu_torch.history.journal import RecommendationJournal

        check_ported(config)
        state_path = getattr(settings, "state_path", None)
        journal_path = config.history_path
        if journal_path is None and state_path:
            journal_path = f"{state_path}.journal"
        # Serve always records traces: the ring is what GET /debug/trace
        # serves, and the per-tick span cost is noise next to a scan. The
        # swap happens before any scan, so lazily-built Prometheus loaders
        # pick up the recording tracer. An injected session that already
        # carries a recording tracer (tests pinning their own ring) is
        # respected.
        # Node identity stamps every exported span so stitched fleet traces
        # (`analyze --stitch`) can label this process's lane.
        node_id = "serve"
        if not self.session.tracer.enabled:
            self.session.tracer = Tracer(ring_scans=config.trace_ring_scans, node=node_id)
        elif getattr(self.session.tracer, "node", None) is None:
            self.session.tracer.node = node_id
        if state_path:
            from krr_tpu_torch.core.durastore import DurableStore

            with DigestStore.locked(state_path):
                self.durable: "Optional[DurableStore]" = DurableStore.open(
                    state_path,
                    settings.cpu_spec(),
                    store_format=getattr(settings, "store_format", "sharded"),
                    shard_rows=config.store_shard_rows,
                    compact_wal_ratio=config.store_compact_wal_ratio,
                    compact_min_bytes=int(config.store_compact_min_wal_mb * (1 << 20)),
                    metrics=self.session.metrics,
                    logger=self.logger,
                )
            store = self.durable.store
        else:
            self.durable = None
            store = DigestStore(spec=settings.cpu_spec())
        # Watch-mode discovery persists its inventory snapshot (+ watch
        # resourceVersions) beside the window cursor, so a warm restart
        # skips the cold relist entirely. The store's layout (sharded or
        # legacy) decides the sidecar's name.
        if config.discovery_mode == "watch" and state_path and not config.discovery_snapshot_path:
            config.discovery_snapshot_path = (
                os.path.join(state_path, "discovery-inventory.json")
                if self.durable is not None and self.durable.fmt == "sharded"
                else f"{state_path}.discovery-inventory.json"
            )
        self.state = ServerState(
            store,
            journal=RecommendationJournal(
                journal_path or None,
                retention_seconds=config.history_retention_seconds,
                logger=self.logger,
            ),
            # One registry for the whole process: the session's loaders fire
            # per-query telemetry into the same exposition /metrics serves.
            metrics=self.session.metrics,
        )
        # The read path's epoch-keyed response cache (`ResponseCache`), and
        # the epoch floor: seeding from the durable store's persist epoch
        # keeps ETags monotonic across restarts, so a pre-restart client's
        # If-None-Match can never false-304 against new content.
        if config.response_cache_enabled:
            from krr_tpu_torch.server.state import ResponseCache

            self.state.response_cache = ResponseCache(
                max_entries=config.response_cache_max_entries,
                max_bytes=int(config.response_cache_max_mb * (1 << 20)),
                metrics=self.session.metrics,
            )
        if self.durable is not None and self.durable.fmt == "sharded":
            self.state.seed_epoch(self.durable.epoch)
        # Epoch reconciliation: a crash between the journal append and the
        # store persist leaves the journal one publish ahead — truncate it
        # back to the store's durable epoch (deterministic) before the
        # scheduler seeds the hysteresis gate from it.
        if (
            self.durable is not None
            and self.durable.fmt == "sharded"
            and self.state.journal is not None
            and self.state.journal.path
        ):
            self.state.journal.reconcile_epoch(self.durable.epoch)
        # The SLO engine rides the same registry and clock: the scheduler
        # evaluates per tick, /statusz renders it, /healthz downgrades to
        # ``degraded`` while it fires (`krr_tpu_torch.obs.health`).
        from krr_tpu_torch.obs.health import engine_from_config

        self.state.slo = engine_from_config(
            self.session.metrics, config, clock=clock, logger=self.logger
        )
        # The discovery posture is visible from the first /healthz on —
        # a restarted server that resume-publishes before its first full
        # tick must not render an empty block. The scheduler's per-tick
        # stats refine it (ages, event deltas) as ticks complete.
        self.state.discovery = {"mode": getattr(config, "discovery_mode", "relist")}
        # The scan flight recorder + regression sentinel
        # (`krr_tpu_torch.obs.timeline` / `krr_tpu_torch.obs.sentinel`): the durable
        # timeline lives beside the durable store (inside the sharded state
        # directory, a ``.timeline`` sidecar beside a legacy single file);
        # without a state path the recorder is memory-only — /debug/timeline
        # and the sentinel still work, they just don't survive a restart.
        from krr_tpu_torch.obs.sentinel import RegressionSentinel
        from krr_tpu_torch.obs.timeline import ScanTimeline

        timeline_path = config.timeline_path
        if timeline_path is None and state_path:
            timeline_path = (
                os.path.join(state_path, "timeline.log")
                if self.durable is not None and self.durable.fmt == "sharded"
                else f"{state_path}.timeline"
            )
        self.state.timeline = ScanTimeline.open(
            timeline_path or None,
            retain_records=config.timeline_retain_records,
            metrics=self.session.metrics,
            logger=self.logger,
        )
        if config.sentinel_enabled:
            self.state.sentinel = RegressionSentinel(
                warmup_scans=config.sentinel_warmup_scans,
                baseline_scans=config.sentinel_baseline_scans,
                sigma=config.sentinel_sigma,
                rel_floor=config.sentinel_rel_floor,
                abs_floor_seconds=config.sentinel_abs_floor_seconds,
                metrics=self.session.metrics,
                logger=self.logger,
            )
            # Baselines survive restarts by construction: the durable
            # timeline replays through the same classification.
            self.state.sentinel.seed(self.state.timeline.records())
            if config.sentinel_slo_enabled and self.state.slo is not None:
                from krr_tpu_torch.obs.health import Objective

                sentinel = self.state.sentinel
                self.state.slo.add_objective(
                    Objective(
                        name="scan_regressions",
                        description=(
                            "Scans must stay inside their baseline cost bands: "
                            "sentinel-regressed scans burn this budget."
                        ),
                        budget=config.sentinel_slo_budget,
                        sample=lambda: (
                            float(sentinel.regressed_scans),
                            float(sentinel.classified_scans),
                        ),
                    )
                )
        # The metrics-acquisition posture is visible from the first /healthz
        # on.
        self.state.ingest = {"mode": config.metrics_mode}
        self.scheduler = ScanScheduler(
            self.session,
            self.state,
            scan_interval=config.scan_interval_seconds,
            discovery_interval=config.discovery_interval_seconds,
            clock=clock,
            logger=self.logger,
            durable=self.durable,
        )
        self.app = HttpApp(
            self.state,
            self.logger,
            # Three missed scan cadences (or grid steps, whichever is
            # coarser) without a published window = stale.
            stale_after_seconds=3.0 * max(config.scan_interval_seconds, self.scheduler._step_seconds()),
            clock=clock,
            drift_dead_band_pct=config.hysteresis_dead_band_pct,
            drift_confirm_ticks=config.hysteresis_confirm_ticks,
            hysteresis_enabled=config.hysteresis_enabled,
            tracer=self.session.tracer,
            render_concurrency=config.server_render_concurrency,
            render_queue=config.server_render_queue,
            savings_enabled=config.savings_enabled,
        )
        self._server: Optional[asyncio.AbstractServer] = None

    @property
    def port(self) -> int:
        assert self._server is not None, "server not started"
        return self._server.sockets[0].getsockname()[1]

    async def start(self, *, run_scheduler: bool = True) -> None:
        # Scrapes identify the running build from the first response on.
        record_build_info(self.state.metrics, str(self.session.strategy.device))
        self._server = await asyncio.start_server(
            self.app.handle_connection, self.config.server_host, self.config.server_port
        )
        if run_scheduler:
            self.scheduler.start()
        self.logger.info(
            f"Serving on http://{self.config.server_host}:{self.port} "
            f"(scan every {self.scheduler.scan_interval:.0f}s, "
            f"re-discover every {self.scheduler.discovery_interval:.0f}s)"
        )

    async def shutdown(self) -> None:
        """Graceful: stop scans first (a cancelled scan leaves state
        consistent — see ``ScanScheduler.stop``), then the listener, then
        the outbound clients."""
        await self.scheduler.stop()
        if self._server is not None:
            self._server.close()
            # Established keep-alive connections survive close(); abort
            # them so wait_closed() (which awaits their handlers on
            # Python ≥ 3.12.1) can't hang on an idle scraper.
            self.app.abort_connections()
            await self._server.wait_closed()
            self._server = None
        if self.state.journal is not None:
            self.state.journal.close()
        if self.state.timeline is not None:
            self.state.timeline.close()
        if self.durable is not None:
            self.durable.close()
        await self.session.close()


async def run_server(config: Config, *, logger: Optional[KrrLogger] = None) -> None:
    """The ``serve`` entry point: run until SIGINT/SIGTERM."""
    import signal

    server = KrrServer(config, logger=logger)
    await server.start()
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        try:
            loop.add_signal_handler(sig, stop.set)
        except NotImplementedError:  # non-unix event loops
            pass
    # kill -USR2 <pid> dumps the trace ring + a metrics snapshot to
    # timestamped files without stopping the server (`krr_tpu_torch.obs.dump`).
    from krr_tpu_torch.obs.dump import install_signal_dump

    install_signal_dump(
        server.session.tracer,
        server.state.metrics,
        device=str(server.session.strategy.device),
        trace_target=config.trace_path,
        metrics_target=config.metrics_dump_path,
        logger=server.logger,
        loop=loop,
        timeline=server.state.timeline,
        sentinel=server.state.sentinel,
    )
    try:
        await stop.wait()
    finally:
        server.logger.info("Shutting down")
        await server.shutdown()
        if config.trace_path:
            # Same contract as a CLI scan's --trace: the ring (the last N
            # ticks) lands on disk as Chrome trace JSON at shutdown.
            from krr_tpu_torch.obs.trace import write_chrome_trace

            write_chrome_trace(server.session.tracer, config.trace_path)
        if config.profile_path:
            # The ring's critical-path attribution (the same report GET
            # /debug/profile serves live) — so a terminated server leaves
            # its bottleneck analysis behind, not just raw spans.
            from krr_tpu_torch.obs.profile import write_profile_report

            write_profile_report(server.session.tracer, config.profile_path)
