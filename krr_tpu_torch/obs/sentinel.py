"""The regression sentinel: baseline-banded per-scan trend classification.

A copy of `krr_tpu/obs/sentinel.py` (host arithmetic).

The timeline (`krr_tpu_torch.obs.timeline`) answers "what did scan N cost, by
category"; this module answers the question operators actually have:
"is scan N NORMAL for this fleet?". It maintains robust rolling baselines
— per-category median/MAD bands over the recorded timeline, kept per scan
KIND (a full-window scan and a delta tick live in different cost regimes)
— and classifies every completed scan as ``nominal`` or ``regressed``,
attributing a regression to the dominant deviating category and naming the
suspect layer (e.g. ``fetch_transport +2.1σ, ttfb-dominated → Prometheus
side``).

Band math:

* For each monitored series (the profile categories plus the whole wall),
  the baseline holds the last ``baseline_scans`` NOMINAL values. The band
  unit is ``max(1.4826·MAD, rel_floor·median, abs_floor)`` — the MAD term
  adapts to the fleet's real jitter, the relative and absolute floors keep
  a near-constant series (MAD ≈ 0) from flagging microsecond noise as an
  infinite-sigma regression.
* A category regresses when its value exceeds ``median + sigma·unit``. The
  scan's verdict is ``regressed`` when any category does; the DOMINANT
  category is the one with the largest excess seconds over its median —
  the one that actually added wall — and for ``fetch_transport`` the
  transport-phase bands name which phase dominates the deviation
  (ttfb vs connect vs body_read), which is the Prometheus-side vs
  network vs volume distinction.
* Warm-up gating: no verdicts until ``warmup_scans`` nominal records of
  the scan's kind have been observed — a cold server must not page on its
  first tick.
* Poison-proofing: regressed scans do NOT fold into the baseline, so a
  regression can't normalize itself away tick by tick. A sustained new
  regime is still accepted: after ``baseline_scans`` CONSECUTIVE regressed
  verdicts of one kind the sentinel rebases (folds the record, logs the
  acceptance) instead of alerting forever on a level shift the operator
  has evidently accepted.

Verdicts fire four ways: the ``krr_tpu_scan_regression{category}`` gauge
(deviation sigmas while regressed, 0 while nominal) and the
``krr_tpu_scan_regressions_total{category}`` counter, one structured log
event, the ``/statusz`` trend section, and (``--sentinel-slo``) an SLO
objective whose bad events are regressed scans. Everything here is pure
host arithmetic over the record dicts — the serve scheduler, ``analyze
--trend``, ``GET /debug/timeline`` and the SIGUSR2 trend artifact all drive
the SAME code.
"""

from __future__ import annotations

import statistics
import threading
from collections import deque
from typing import Optional

from krr_tpu_torch.obs.profile import CATEGORIES

#: Monitored categories — the profile partition minus ``idle`` (idle wall is
#: the scheduler waiting, not a cost regression), the whole wall, and the
#: tick's wire megabytes (``wire_mb`` — the one non-seconds series: a
#: silent fallback to identity transport multiplies wire bytes by the
#: compression ratio while every timing band may stay green, and it must
#: page as a trend verdict, not a mystery slowdown later).
#: ``read_p99_ms`` rides along the same way: the read path's per-tick p99
#: (milliseconds — a value band like wire_mb, not a scan-seconds band), so
#: a cache-hit-rate collapse or render-pool saturation pages as a trend
#: verdict instead of a mystery latency complaint from clients.
#: The four freshness-lineage hops (federation mode): each series is the
#: LATENCY OF ONE HOP of the epoch's end-to-end lineage chain (newest
#: sample → shard fold → aggregator apply → publish → replica install),
#: so a freshness regression pages with the guilty hop named instead of a
#: generic "replica lag regressed". Value bands (seconds of pipeline AGE,
#: not seconds of scan wall): a 300s delivery stall must not out-rank a
#: genuine compute regression in the dominant pool.
_FRESHNESS_HOPS = (
    "freshness_fold",
    "freshness_apply",
    "freshness_publish",
    "freshness_install",
)

MONITORED = (
    tuple(c for c in CATEGORIES if c != "idle")
    + ("wall", "wire_mb", "read_p99_ms")
    + _FRESHNESS_HOPS
)

#: Value-band series (not scan-seconds): excluded from the seconds-ranked
#: dominant pool, and rendered/reported in their own units.
_VALUE_BANDS = {"wire_mb": "MB", "read_p99_ms": "ms"}
_VALUE_BANDS.update({hop: "s" for hop in _FRESHNESS_HOPS})

#: Transport phases whose bands refine a fetch_transport attribution.
_PHASE_DETAIL = ("connect", "request_write", "ttfb", "body_read", "queue_wait")

#: category → the layer an operator should suspect first.
SUSPECT_LAYERS = {
    "fetch_transport": "Prometheus side / network transport",
    "fetch_decode": "response decode / native sink (client CPU)",
    "fetch_backoff": "retry backoff → flaky Prometheus backend",
    "fetch_other": "fetch routing / client-side query handling",
    "fold": "host fold stage (digest merge)",
    "compute": "device compute / recommendation stage",
    "discover": "Kubernetes inventory (apiserver)",
    "publish": "render + publish stage",
    "other": "scheduler / uncategorized host work",
    "wall": "whole-scan wall (no single dominant category)",
    "wire_mb": (
        "wire bytes up at steady timings → compression fell back to identity "
        "(a proxy stripping Accept-Encoding?) or response volume grew — "
        "check the record's encodings and downsample engagement"
    ),
    "read_p99_ms": (
        "read-path p99 up → response-cache hit rate collapsed (epoch churn? "
        "filter-cardinality evictions?) or the render pool saturated — "
        "check the record's readpath hits/misses/shed split"
    ),
    "freshness_fold": (
        "sample→fold hop up → the SHARD side: its scan cadence slipped or "
        "its fetch/fold leg slowed — check the shard's scan duration and "
        "consecutive-failure counters"
    ),
    "freshness_apply": (
        "fold→apply hop up → shard→aggregator DELIVERY: unacked backlog, "
        "reconnect churn, or aggregator backpressure — check "
        "krr_tpu_federation_unacked_records and the aggregate tick cadence"
    ),
    "freshness_publish": (
        "apply→publish hop up → the AGGREGATOR's compute/render/persist "
        "stage between replay and snapshot swap — check the tick's "
        "compute/persist seconds"
    ),
    "freshness_install": (
        "publish→install hop up → the REPLICA leg: feed broadcast, frame "
        "decode, or the install swap slowed (replica lag regressed) — "
        "check krr_tpu_replica_feed_lag_seconds and /fleet epoch lag"
    ),
}

#: phase → the refinement appended to a fetch_transport attribution.
_PHASE_SUSPECTS = {
    "ttfb": "ttfb-dominated → Prometheus side (server think time)",
    "connect": "connect-dominated → network / connection churn",
    "request_write": "request-write-dominated → uplink / proxy",
    "body_read": "body-read-dominated → response volume / bandwidth",
    "queue_wait": "queue-wait-dominated → client concurrency limit",
}


class _Baseline:
    """Rolling nominal history for one (kind, series) pair."""

    __slots__ = ("values",)

    def __init__(self, maxlen: int) -> None:
        self.values: "deque[float]" = deque(maxlen=maxlen)

    def band(self, rel_floor: float, abs_floor: float) -> "tuple[float, float]":
        """(median, unit) — unit is the 1σ band width."""
        values = list(self.values)
        med = statistics.median(values)
        mad = statistics.median(abs(v - med) for v in values)
        return med, max(1.4826 * mad, rel_floor * med, abs_floor)


class RegressionSentinel:
    """Classifies timeline records against rolling median/MAD baselines."""

    def __init__(
        self,
        *,
        warmup_scans: int = 8,
        baseline_scans: int = 64,
        sigma: float = 3.0,
        rel_floor: float = 0.10,
        abs_floor_seconds: float = 0.05,
        metrics=None,
        logger=None,
    ) -> None:
        self.warmup_scans = max(2, int(warmup_scans))
        self.baseline_scans = max(self.warmup_scans, int(baseline_scans))
        self.sigma = float(sigma)
        self.rel_floor = float(rel_floor)
        self.abs_floor_seconds = float(abs_floor_seconds)
        self.metrics = metrics
        self.logger = logger
        #: kind -> series name -> baseline.
        self._baselines: "dict[str, dict[str, _Baseline]]" = {}
        #: kind -> nominal records folded (the warm-up gate's counter).
        self._observed: "dict[str, int]" = {}
        #: kind -> consecutive regressed verdicts (regime-acceptance rebase).
        self._regressed_streak: "dict[str, int]" = {}
        #: kind -> the streak's observed values (newest ``baseline_scans``),
        #: so acceptance can REPLACE the baseline with the new regime in one
        #: step — folding a single value per window would take
        #: ~baseline_scans² ticks to actually move the median.
        self._streak_values: "dict[str, list[dict]]" = {}
        #: Cumulative verdicts — the optional SLO objective's event counts.
        self.classified_scans = 0
        self.regressed_scans = 0
        self.last_verdict: Optional[dict] = None
        #: Serve classifies on the event loop while ``/debug/timeline``
        #: renders and SIGUSR2 dumps call :meth:`status` from worker
        #: threads — the baseline deques must not mutate mid-iteration.
        #: Reentrant: :meth:`seed` replays through :meth:`observe`.
        self._lock = threading.RLock()

    # ------------------------------------------------------------ observation
    @staticmethod
    def _series_of(record: dict) -> "dict[str, float]":
        categories = record.get("categories") or {}
        values = {c: float(categories.get(c, 0.0)) for c in CATEGORIES if c != "idle"}
        values["wall"] = float(record.get("wall", 0.0))
        # Wire megabytes — a value band, not a timing band (its "excess" is
        # MB, not seconds). A record WITHOUT wire bytes (pre-compression
        # timeline files, fake-source deployments) contributes NO sample:
        # folding 0.0 would seed an all-zero baseline whose floor-width
        # band pages a guaranteed false "compression fell back" verdict on
        # the first real post-upgrade scan — the series must instead warm
        # up on its own real samples (the per-series warm-up gate in
        # `_observe` holds verdicts until it has them).
        wire_bytes = record.get("wire_bytes") or 0
        if wire_bytes:
            values["wire_mb"] = float(wire_bytes) / 1e6
        # Read-path p99 — same no-sample-when-absent discipline as wire_mb:
        # a quiet tick (no /recommendations traffic) or a pre-read-path
        # record contributes nothing, so the band warms only on ticks that
        # actually served reads.
        readpath = record.get("readpath") or {}
        if readpath.get("requests") and readpath.get("p99_ms") is not None:
            values["read_p99_ms"] = float(readpath["p99_ms"])
        # Freshness lineage hops — no-sample-when-absent like wire_mb: a
        # non-federation record (or lineage off) contributes nothing, and
        # the install hop only samples on ticks with a replica-acked epoch
        # (acks trail the publishing tick by design).
        lineage = record.get("lineage") or {}
        newest = lineage.get("newest_sample_ts")
        fold_ts = lineage.get("fold_ts")
        apply_ts = lineage.get("apply_ts")
        publish_ts = lineage.get("publish_ts")
        if newest is not None and fold_ts is not None:
            values["freshness_fold"] = max(0.0, float(fold_ts) - float(newest))
            if apply_ts is not None:
                values["freshness_apply"] = max(0.0, float(apply_ts) - float(fold_ts))
                if publish_ts is not None:
                    values["freshness_publish"] = max(
                        0.0, float(publish_ts) - float(apply_ts)
                    )
        install = lineage.get("install") or {}
        if (
            install.get("install_ts") is not None
            and install.get("publish_ts") is not None
        ):
            values["freshness_install"] = max(
                0.0, float(install["install_ts"]) - float(install["publish_ts"])
            )
        for phase, seconds in (record.get("phases") or {}).items():
            if phase in _PHASE_DETAIL:
                values[f"phase_{phase}"] = float(seconds)
        return values

    def _fold(self, kind: str, values: "dict[str, float]") -> None:
        baselines = self._baselines.setdefault(kind, {})
        for name, value in values.items():
            baseline = baselines.get(name)
            if baseline is None:
                baseline = baselines[name] = _Baseline(self.baseline_scans)
            baseline.values.append(value)
        self._observed[kind] = self._observed.get(kind, 0) + 1

    def observe(self, record: dict, *, fire: bool = True) -> dict:
        """Classify one record and (unless warming) update the verdict
        counters; ``fire=False`` suppresses metrics/log side effects — the
        seed replay and offline ``--trend`` reports ride the same path."""
        with self._lock:
            return self._observe(record, fire=fire)

    def _observe(self, record: dict, *, fire: bool) -> dict:
        kind = str(record.get("kind", "delta"))
        values = self._series_of(record)
        baselines = self._baselines.get(kind, {})
        warmed = self._observed.get(kind, 0) >= self.warmup_scans
        verdict: dict = {
            "ts": record.get("ts"),
            "scan_id": record.get("scan_id"),
            "kind": kind,
            "status": "warming" if not warmed else "nominal",
            "categories": {},
        }
        if not warmed:
            self._fold(kind, values)
            self.last_verdict = verdict
            if fire:
                self._fire(verdict)
            return verdict

        deviations: "dict[str, dict]" = {}
        for name, value in values.items():
            baseline = baselines.get(name)
            if baseline is None or len(baseline.values) < self.warmup_scans:
                continue
            median, unit = baseline.band(self.rel_floor, self.abs_floor_seconds)
            sigmas = (value - median) / unit if unit > 0 else 0.0
            deviations[name] = {
                "value": round(value, 6),
                "median": round(median, 6),
                "sigma": round(sigmas, 2),
                "regressed": sigmas >= self.sigma,
            }
        verdict["categories"] = {
            name: deviations[name] for name in deviations if not name.startswith("phase_")
        }
        regressed = [
            name
            for name, d in deviations.items()
            if d["regressed"] and not name.startswith("phase_") and name != "wall"
        ]
        self.classified_scans += 1
        if regressed:
            # Dominant = the category that ADDED the most wall, not the one
            # with the tightest band: attribution must name where the
            # seconds went. Value bands (wire_mb in megabytes, read_p99_ms
            # in milliseconds) — ranked against seconds their raw excess
            # would win almost every co-occurring regression at fleet
            # scale, so they only become dominant when no timing category
            # regressed alongside them.
            timing = [name for name in regressed if name not in _VALUE_BANDS]
            pool = timing or regressed
            dominant = max(
                pool, key=lambda name: deviations[name]["value"] - deviations[name]["median"]
            )
            detail = self._phase_detail(dominant, deviations)
            suspect = SUSPECT_LAYERS.get(dominant, dominant)
            if detail:
                suspect = f"{detail} ({suspect})"
            verdict.update(
                status="regressed",
                dominant=dominant,
                sigma=deviations[dominant]["sigma"],
                # In the dominant series' unit (see excess_unit) — seconds
                # for every timing category, megabytes for wire_mb.
                excess_seconds=round(
                    deviations[dominant]["value"] - deviations[dominant]["median"], 6
                ),
                excess_unit=_VALUE_BANDS.get(dominant, "s"),
                regressed=regressed,
                suspect=suspect,
            )
            self.regressed_scans += 1
            streak = self._regressed_streak.get(kind, 0) + 1
            buffer = self._streak_values.setdefault(kind, [])
            buffer.append(values)
            if len(buffer) > self.baseline_scans:
                del buffer[: len(buffer) - self.baseline_scans]
            if streak >= self.baseline_scans:
                # Regime acceptance: a level shift that held for a whole
                # baseline window is the new normal — REPLACE the baseline
                # with the streak itself, so the very next scan of the new
                # regime classifies nominal instead of paging on for
                # baseline_scans² ticks while single folds creep the median.
                self._baselines.pop(kind, None)
                for streak_values in buffer:
                    self._fold(kind, streak_values)
                buffer.clear()
                self._regressed_streak[kind] = 0
                if self.logger is not None and fire:
                    self.logger.info(
                        f"sentinel: accepting new {kind}-scan cost regime after "
                        f"{streak} consecutive regressed scans (rebasing baselines)"
                    )
            else:
                self._regressed_streak[kind] = streak
        else:
            # Only wall (or nothing) deviated: classify nominal — a wall
            # deviation with no category behind it is sweep noise.
            self._regressed_streak[kind] = 0
            self._streak_values.pop(kind, None)
            self._fold(kind, values)
        self.last_verdict = verdict
        if fire:
            self._fire(verdict)
        return verdict

    def _phase_detail(self, dominant: str, deviations: dict) -> Optional[str]:
        if dominant != "fetch_transport":
            return None
        best, best_excess = None, 0.0
        for phase in _PHASE_DETAIL:
            d = deviations.get(f"phase_{phase}")
            if d is None:
                continue
            excess = d["value"] - d["median"]
            if d["sigma"] >= self.sigma and excess > best_excess:
                best, best_excess = phase, excess
        return _PHASE_SUSPECTS.get(best) if best else None

    def _fire(self, verdict: dict) -> None:
        if self.metrics is not None:
            for name, d in verdict.get("categories", {}).items():
                self.metrics.set(
                    "krr_tpu_scan_regression",
                    d["sigma"] if d["regressed"] else 0.0,
                    category=name,
                )
            if verdict["status"] == "regressed":
                self.metrics.inc(
                    "krr_tpu_scan_regressions_total", category=verdict["dominant"]
                )
        if self.logger is not None and verdict["status"] == "regressed":
            self.logger.warning(
                f"scan regression: {verdict.get('scan_id') or 'scan'} "
                f"[{verdict['kind']}] {verdict['dominant']} "
                f"+{verdict['sigma']:.1f}σ (+{verdict['excess_seconds']:.3f}"
                f"{verdict.get('excess_unit', 's')} "
                f"over baseline) → {verdict['suspect']}"
            )

    def seed(self, records: "list[dict]") -> int:
        """Replay recovered timeline records WITHOUT side effects, so the
        baselines (and warm-up state) survive a restart exactly as the
        durable timeline does. Returns the number of records replayed."""
        with self._lock:
            for record in records:
                self._observe(record, fire=False)
            # A seeded sentinel starts its live verdict stream fresh: the
            # SLO objective must count this process's scans, not replayed
            # history.
            self.classified_scans = 0
            self.regressed_scans = 0
        return len(records)

    # ----------------------------------------------------------------- status
    def warmed(self, kind: str = "delta") -> bool:
        return self._observed.get(kind, 0) >= self.warmup_scans

    def status(self) -> dict:
        """The ``/statusz`` trend section: warm-up posture, current bands,
        and the last verdict. Thread-safe (see ``_lock``)."""
        with self._lock:
            return self._status()

    def _status(self) -> dict:
        baselines = {}
        for kind, series in self._baselines.items():
            rendered = {}
            for name in MONITORED:
                baseline = series.get(name)
                if baseline is None or len(baseline.values) < 2:
                    continue
                median, unit = baseline.band(self.rel_floor, self.abs_floor_seconds)
                rendered[name] = {
                    "median": round(median, 6),
                    "band": round(unit, 6),
                    "samples": len(baseline.values),
                }
            baselines[kind] = {
                "warmed": self.warmed(kind),
                "observed": self._observed.get(kind, 0),
                "series": rendered,
            }
        return {
            "warmup_scans": self.warmup_scans,
            "baseline_scans": self.baseline_scans,
            "sigma": self.sigma,
            "classified_scans": self.classified_scans,
            "regressed_scans": self.regressed_scans,
            "baselines": baselines,
            "last_verdict": self.last_verdict,
        }


def sentinel_knobs(sentinel: "Optional[RegressionSentinel]") -> dict:
    """A live sentinel's band knobs as :func:`trend_report` kwargs, so an
    offline replay classifies exactly as the serve-side sentinel does
    (defaults when no sentinel is configured)."""
    if sentinel is None:
        return {}
    return dict(
        warmup_scans=sentinel.warmup_scans,
        baseline_scans=sentinel.baseline_scans,
        sigma=sentinel.sigma,
        rel_floor=sentinel.rel_floor,
        abs_floor_seconds=sentinel.abs_floor_seconds,
    )


# ------------------------------------------------------------- trend reports
def trend_report(
    records: "list[dict]",
    *,
    warmup_scans: int = 8,
    baseline_scans: int = 64,
    sigma: float = 3.0,
    rel_floor: float = 0.10,
    abs_floor_seconds: float = 0.05,
) -> dict:
    """Replay a timeline through a FRESH sentinel — the offline twin of the
    serve-side classification (``analyze --trend``, ``GET /debug/timeline``
    and the SIGUSR2 trend artifact all call this), so online and offline
    verdicts can't drift apart."""
    sentinel = RegressionSentinel(
        warmup_scans=warmup_scans,
        baseline_scans=baseline_scans,
        sigma=sigma,
        rel_floor=rel_floor,
        abs_floor_seconds=abs_floor_seconds,
    )
    verdicts = [sentinel.observe(record, fire=False) for record in records]
    regressions = [v for v in verdicts if v["status"] == "regressed"]
    return {
        "scans": len(records),
        "regressed": len(regressions),
        "regressions": regressions,
        "verdicts": verdicts,
        "status": sentinel.status(),
    }


def render_trend_text(report: dict, records: "Optional[list[dict]]" = None) -> str:
    """Human rendering of a :func:`trend_report` — the ``?format=text`` body
    of ``GET /debug/timeline`` and the default ``analyze --trend`` output."""
    lines = [
        f"scan timeline: {report['scans']} recorded scan(s), "
        f"{report['regressed']} regressed"
    ]
    status = report.get("status") or {}
    for kind, posture in sorted((status.get("baselines") or {}).items()):
        flag = "warm" if posture["warmed"] else f"warming ({posture['observed']} seen)"
        lines.append(f"  baseline[{kind}]: {flag}")
        for name, band in posture["series"].items():
            if name.startswith("phase_"):
                continue
            unit = _VALUE_BANDS.get(name, "s")
            lines.append(
                f"    {name:<16} median {band['median']:>9.3f}{unit} "
                f"± {band['band']:.3f}{unit}  (n={band['samples']})"
            )
    for verdict in report.get("regressions", [])[-16:]:
        lines.append(
            f"  REGRESSED {verdict.get('scan_id') or verdict.get('ts')} "
            f"[{verdict['kind']}]: {verdict['dominant']} +{verdict['sigma']:.1f}σ "
            f"(+{verdict['excess_seconds']:.3f}{verdict.get('excess_unit', 's')}) "
            f"→ {verdict['suspect']}"
        )
    if records:
        tail = records[-8:]
        lines.append(f"  last {len(tail)} scan(s):")
        for record in tail:
            cats = record.get("categories") or {}
            top = max(cats, key=lambda c: cats[c], default=None)
            lines.append(
                f"    ts={record.get('ts')} [{record.get('kind')}] "
                f"wall {record.get('wall', 0.0):.3f}s"
                + (f", top {top} {cats[top]:.3f}s" if top else "")
                + f", rows {record.get('rows', 0)}"
            )
    return "\n".join(lines) + "\n"
