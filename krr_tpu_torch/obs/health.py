"""Dependency-free SLO engine: declarative objectives, rolling windows,
fast/slow burn-rate alerts.

A copy of `krr_tpu/obs/health.py` (host arithmetic, same JSON and text).
Deciding whether a scan was HEALTHY from a metrics dump needs a human; this
module closes the loop in-process, with the shape SRE practice converged on
for error budgets:

* An :class:`Objective` declares a service-level objective as an allowed
  **bad fraction** (the error budget): scan failure ratio, fetch failed-row
  ratio, scan latency, freshness. Each evaluation samples cumulative
  ``(bad, total)`` event counts — ratio objectives read counters off the
  shared :class:`~krr_tpu_torch.obs.metrics.MetricsRegistry`; threshold
  objectives (latency, freshness) contribute one good/bad event per
  evaluation by comparing an instantaneous value against a limit.

* The :class:`SloEngine` keeps a rolling ring of timestamped samples per
  objective and computes the **burn rate** over two windows: the windowed
  bad ratio divided by the budget (burn 1.0 = consuming exactly the budget;
  burn 20 = a full outage against a 5 % budget). An alert FIRES when both
  the fast and the slow burn exceed their thresholds AND the slow window
  holds at least ``min_slow_bad_events`` bad events; it RESOLVES as soon as
  the firing condition no longer holds.

* Transitions fire structured log lines and ``krr_tpu_slo_*`` metrics. The
  one-shot CLI evaluates once over its scan for ``--statusz``
  (:func:`engine_from_config` with ``one_shot=True``); the serve plane's
  per-tick evaluation and ``GET /statusz`` arrive with the serve slice.

Everything here is host arithmetic over a handful of floats — no
background task, no locking, no device.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Optional

from krr_tpu_torch.obs.metrics import MetricsRegistry

#: Allowed violation fraction for threshold objectives (latency,
#: freshness): up to 10% of evaluations may breach the limit before the
#: budget is spent. Ratio objectives carry their own budget knobs.
THRESHOLD_BUDGET = 0.1


@dataclass
class Objective:
    """One service-level objective.

    ``sample`` returns cumulative ``(bad, total)`` event counts for ratio
    objectives (monotone, read off counters). Threshold objectives instead
    set ``value``/``limit``: each evaluation reads the instantaneous value
    and counts one event, bad iff ``value > limit``. A ``None`` value means
    "nothing to observe this round" and records NO event — freshness before
    the first publish (the /healthz ``starting`` verdict owns that regime),
    or scan latency on a tick where no new scan completed (re-counting a
    stale gauge would turn one slow scan into a window full of bad events,
    and one fast scan into dilution that masks real ones)."""

    name: str
    description: str
    budget: float  # allowed bad fraction, in (0, 1]
    sample: Optional[Callable[[], tuple[float, float]]] = None
    value: Optional[Callable[[], Optional[float]]] = None
    limit: Optional[float] = None

    def __post_init__(self) -> None:
        if not 0.0 < self.budget <= 1.0:
            raise ValueError(f"objective {self.name}: budget must be in (0, 1]")
        if (self.sample is None) == (self.value is None):
            raise ValueError(
                f"objective {self.name}: exactly one of sample= (ratio) or "
                f"value=/limit= (threshold) must be set"
            )


@dataclass
class _AlertState:
    firing: bool = False
    since: Optional[float] = None
    #: Event totals accumulated by threshold objectives (ratio objectives
    #: read cumulative counters directly).
    bad: float = 0.0
    total: float = 0.0
    #: (ts, bad_cum, total_cum) samples, newest last.
    samples: deque = field(default_factory=deque)
    last_value: Optional[float] = None


class SloEngine:
    """Evaluates objectives over rolling windows and manages alert state."""

    def __init__(
        self,
        objectives: "list[Objective]",
        metrics: Optional[MetricsRegistry] = None,
        *,
        fast_window_seconds: float = 300.0,
        slow_window_seconds: float = 3600.0,
        fast_burn_threshold: float = 10.0,
        slow_burn_threshold: float = 5.0,
        min_slow_bad_events: int = 2,
        clock: Callable[[], float] = time.time,
        logger=None,
    ) -> None:
        self.objectives = list(objectives)
        self.metrics = metrics
        self.fast_window_seconds = float(fast_window_seconds)
        self.slow_window_seconds = max(float(slow_window_seconds), self.fast_window_seconds)
        self.fast_burn_threshold = float(fast_burn_threshold)
        self.slow_burn_threshold = float(slow_burn_threshold)
        self.min_slow_bad_events = max(1, int(min_slow_bad_events))
        self.clock = clock
        self.logger = logger
        self._state: dict[str, _AlertState] = {}
        now = float(clock())
        for objective in self.objectives:
            state = _AlertState()
            # Zero baseline: the first evaluation's window then covers
            # everything since engine construction (counters start at 0 for
            # a fresh process; a one-shot --statusz evaluation sees the
            # whole scan).
            state.samples.append((now, 0.0, 0.0))
            self._state[objective.name] = state

    def add_objective(self, objective: Objective, now: Optional[float] = None) -> None:
        """Register an objective after construction — same zero-baseline
        seeding as the constructor, so its first evaluation covers
        everything since registration."""
        self.objectives.append(objective)
        state = _AlertState()
        state.samples.append((float(self.clock()) if now is None else float(now), 0.0, 0.0))
        self._state[objective.name] = state

    # ----------------------------------------------------------- sampling
    def _sample(self, objective: Objective, state: _AlertState) -> None:
        if objective.sample is not None:
            bad, total = objective.sample()
            state.bad, state.total = float(bad), float(total)
            state.last_value = None
            return
        value = objective.value() if objective.value is not None else None
        if value is None:
            return  # nothing to observe this round: no event either way
        state.last_value = value
        violated = objective.limit is not None and value > objective.limit
        state.bad += 1.0 if violated else 0.0
        state.total += 1.0

    @staticmethod
    def _window_delta(samples: deque, now: float, window: float) -> tuple[float, float]:
        """``(bad, total)`` events inside ``[now - window, now]`` — deltas
        against the newest sample at or before the window start (or the
        oldest retained, for engines younger than the window)."""
        _newest_ts, newest_bad, newest_total = samples[-1]
        baseline = samples[0]
        cutoff = now - window
        for sample in samples:
            if sample[0] <= cutoff:
                baseline = sample
            else:
                break
        return max(0.0, newest_bad - baseline[1]), newest_total - baseline[2]

    @classmethod
    def _window_ratio(cls, samples: deque, now: float, window: float) -> float:
        bad, total = cls._window_delta(samples, now, window)
        return bad / total if total > 0 else 0.0

    def _prune(self, state: _AlertState, now: float) -> None:
        # Keep one sample at or before the slow-window start as the
        # baseline; everything older is dead weight.
        cutoff = now - self.slow_window_seconds
        samples = state.samples
        while len(samples) >= 2 and samples[1][0] <= cutoff:
            samples.popleft()

    # --------------------------------------------------------- evaluation
    def evaluate(self, now: Optional[float] = None) -> "list[dict]":
        """Sample every objective, update burn rates and alert states, fire
        metrics and transition logs. Returns the transitions (dicts with
        ``objective``/``to``), mostly for tests."""
        now = float(self.clock()) if now is None else float(now)
        transitions: list[dict] = []
        for objective in self.objectives:
            state = self._state[objective.name]
            self._sample(objective, state)
            state.samples.append((now, state.bad, state.total))
            self._prune(state, now)
            fast, slow = self._burns(objective, state, now)
            slow_bad, _ = self._window_delta(state.samples, now, self.slow_window_seconds)
            firing = (
                fast >= self.fast_burn_threshold
                and slow >= self.slow_burn_threshold
                # Ratios alone lie at coarse tick cadences (4 samples/hour
                # at the default serve interval): a SINGLE bad event is a
                # blip, never sustained burn, no matter how high its ratio.
                and slow_bad >= self.min_slow_bad_events
            )
            if firing != state.firing:
                state.firing = firing
                state.since = now
                to = "firing" if firing else "resolved"
                transitions.append({"objective": objective.name, "to": to, "at": now})
                if self.metrics is not None:
                    self.metrics.inc(
                        "krr_tpu_slo_alert_transitions_total", objective=objective.name, to=to
                    )
                if self.logger is not None:
                    message = (
                        f"SLO alert {to}: {objective.name} burn fast={fast:.1f} "
                        f"slow={slow:.1f} (budget {objective.budget:g}, thresholds "
                        f"{self.fast_burn_threshold:g}/{self.slow_burn_threshold:g})"
                    )
                    (self.logger.warning if firing else self.logger.info)(message)
            if self.metrics is not None:
                self.metrics.set(
                    "krr_tpu_slo_burn_rate", fast, objective=objective.name, window="fast"
                )
                self.metrics.set(
                    "krr_tpu_slo_burn_rate", slow, objective=objective.name, window="slow"
                )
                slow_ratio = self._window_ratio(state.samples, now, self.slow_window_seconds)
                self.metrics.set(
                    "krr_tpu_slo_error_budget_remaining",
                    1.0 - slow_ratio / objective.budget,
                    objective=objective.name,
                )
                self.metrics.set(
                    "krr_tpu_slo_alert_firing",
                    1.0 if state.firing else 0.0,
                    objective=objective.name,
                )
        return transitions

    def _burns(
        self, objective: Objective, state: _AlertState, now: float
    ) -> tuple[float, float]:
        fast = self._window_ratio(state.samples, now, self.fast_window_seconds) / objective.budget
        slow = self._window_ratio(state.samples, now, self.slow_window_seconds) / objective.budget
        return fast, slow

    # ------------------------------------------------------------ reading
    def firing(self) -> "list[str]":
        return [o.name for o in self.objectives if self._state[o.name].firing]

    def status(self, now: Optional[float] = None) -> dict:
        """Current posture for ``GET /statusz`` — READ-ONLY (burn rates are
        recomputed at ``now`` from the stored samples; no events are
        appended, so scrape traffic can't dilute tick-cadence sampling)."""
        now = float(self.clock()) if now is None else float(now)
        objectives = []
        for objective in self.objectives:
            state = self._state[objective.name]
            fast, slow = self._burns(objective, state, now)
            slow_ratio = self._window_ratio(state.samples, now, self.slow_window_seconds)
            objectives.append(
                {
                    "name": objective.name,
                    "description": objective.description,
                    "budget": objective.budget,
                    "kind": "ratio" if objective.sample is not None else "threshold",
                    "limit": objective.limit,
                    "last_value": state.last_value,
                    "events": {"bad": state.bad, "total": state.total},
                    "burn_rate": {
                        "fast": round(fast, 4),
                        "slow": round(slow, 4),
                        "fast_window_seconds": self.fast_window_seconds,
                        "slow_window_seconds": self.slow_window_seconds,
                    },
                    "error_budget_remaining": round(1.0 - slow_ratio / objective.budget, 4),
                    "firing": state.firing,
                    "since": state.since,
                }
            )
        return {
            "evaluated_at": now,
            "thresholds": {
                "fast_burn": self.fast_burn_threshold,
                "slow_burn": self.slow_burn_threshold,
            },
            "firing": self.firing(),
            "objectives": objectives,
        }

    def render_text(self, now: Optional[float] = None) -> str:
        """The human twin of :meth:`status` (``GET /statusz?format=text``)."""
        status = self.status(now)
        lines = [
            f"krr-tpu SLO status (thresholds: fast burn ≥ "
            f"{status['thresholds']['fast_burn']:g} AND slow burn ≥ "
            f"{status['thresholds']['slow_burn']:g})",
            f"firing: {', '.join(status['firing']) or 'none'}",
            "",
        ]
        for obj in status["objectives"]:
            burn = obj["burn_rate"]
            flag = "FIRING" if obj["firing"] else "ok"
            lines.append(
                f"[{flag:>6}] {obj['name']}: burn fast={burn['fast']:g} "
                f"slow={burn['slow']:g}, budget {obj['budget']:g}, "
                f"budget remaining {obj['error_budget_remaining']:g}"
            )
            detail = f"         {obj['description']}"
            if obj["kind"] == "threshold":
                value = "n/a" if obj["last_value"] is None else f"{obj['last_value']:g}"
                detail += f" (last value {value}, limit {obj['limit']:g})"
            lines.append(detail)
        return "\n".join(lines) + "\n"


def default_objectives(
    metrics: MetricsRegistry,
    *,
    scan_failure_budget: float,
    fetch_failure_budget: float,
    scan_latency_seconds: float,
    freshness_seconds: float,
    read_p99_seconds: float = 0.0,
    clock: Callable[[], float] = time.time,
) -> "list[Objective]":
    """The stock objective set, fed by the shared registry:

    * ``scan_failures``  — ratio of aborted scans to attempted scans.
    * ``fetch_failed_rows`` — ratio of terminally-failed object fetches.
    * ``scan_latency``   — the last scan's wall (summed legs) vs its limit.
    * ``freshness``      — age of the last published window vs its limit.
    * ``read_p99``       — (opt-in: ``read_p99_seconds`` > 0) the last
      tick's /recommendations p99 latency vs its limit — the read-path SLO
      the bench loadtest leg gates offline.
    """

    def scan_failures() -> tuple[float, float]:
        bad = metrics.total("krr_tpu_scan_failures_total")
        return bad, bad + metrics.total("krr_tpu_scans_total")

    def fetch_failed_rows() -> tuple[float, float]:
        return (
            metrics.total("krr_tpu_fetch_failed_rows_total"),
            metrics.total("krr_tpu_fetch_rows_total"),
        )

    #: Completed-scan count at the last latency observation: the gauge
    #: holds the LAST scan's legs, so without this guard every evaluation
    #: (skipped ticks included) would re-count the same scan as a fresh
    #: good/bad event.
    latency_seen = [0.0]

    def scan_wall() -> Optional[float]:
        count = metrics.total("krr_tpu_scans_total")
        if count <= latency_seen[0]:
            return None  # no NEW completed scan since the last observation
        latency_seen[0] = count
        return metrics.total("krr_tpu_scan_duration_seconds")

    def staleness() -> Optional[float]:
        last = metrics.value("krr_tpu_last_scan_timestamp_seconds")
        if last is None:
            return None
        return float(clock()) - last

    objectives = [
        Objective(
            name="scan_failures",
            description="Scans must complete: aborted scans burn this budget.",
            budget=scan_failure_budget,
            sample=scan_failures,
        ),
        Objective(
            name="fetch_failed_rows",
            description="Object fetches must succeed: rows rendered UNKNOWN burn this budget.",
            budget=fetch_failure_budget,
            sample=fetch_failed_rows,
        ),
        Objective(
            name="scan_latency",
            description="A scan's wall time must fit its cadence.",
            budget=THRESHOLD_BUDGET,
            value=scan_wall,
            limit=scan_latency_seconds,
        ),
        Objective(
            name="freshness",
            description="The published window must stay fresh.",
            budget=THRESHOLD_BUDGET,
            value=staleness,
            limit=freshness_seconds,
        ),
    ]
    if read_p99_seconds > 0:
        # Same stale-gauge guard as scan_latency: the p99 gauge holds the
        # LAST read-serving tick's value, so only a NEW completed scan may
        # contribute an event, and only when that tick actually served
        # reads (krr_tpu_http_read_requests > 0) — a quiet server must not
        # dilute (or burn) the budget with replayed values.
        read_seen = [0.0]

        def read_p99() -> Optional[float]:
            count = metrics.total("krr_tpu_scans_total")
            if count <= read_seen[0]:
                return None
            read_seen[0] = count
            if not (metrics.value("krr_tpu_http_read_requests") or 0.0):
                return None
            return metrics.value("krr_tpu_http_read_p99_seconds")

        objectives.append(
            Objective(
                name="read_p99",
                description=(
                    "GET /recommendations p99 latency must stay under its "
                    "limit: ticks whose read-path p99 breaches it burn this "
                    "budget."
                ),
                budget=THRESHOLD_BUDGET,
                value=read_p99,
                limit=read_p99_seconds,
            )
        )
    return objectives


def engine_from_config(
    metrics: MetricsRegistry,
    config,
    *,
    one_shot: bool = False,
    clock: Callable[[], float] = time.time,
    logger=None,
) -> SloEngine:
    """Build the engine from the ``--slo-*`` knobs (`krr_tpu_torch.core.config`),
    resolving the 0=auto limits against the serve scan cadence: latency
    defaults to one cadence, freshness to three (the /healthz stale
    threshold's shape). A pinned ``--scan-end-timestamp`` (reproducible /
    offline-benchmark scans) drops the freshness objective — the window's
    age is the point of pinning, not a health signal. ``one_shot`` (the
    CLI's single ``--statusz`` evaluation) lowers the min-slow-bad-events
    floor to 1: that floor exists to damp blips across a serve tick stream,
    and one scan can only ever contribute one bad event — a totally failed
    scan must report as firing, not as a "blip"."""
    latency = config.slo_scan_latency_seconds or config.scan_interval_seconds
    freshness = config.slo_freshness_seconds or 3.0 * config.scan_interval_seconds
    objectives = default_objectives(
        metrics,
        scan_failure_budget=config.slo_scan_failure_budget,
        fetch_failure_budget=config.slo_fetch_failure_budget,
        scan_latency_seconds=latency,
        freshness_seconds=freshness,
        read_p99_seconds=getattr(config, "slo_read_p99_seconds", 0.0),
        clock=clock,
    )
    if getattr(config, "scan_end_timestamp", None) is not None:
        objectives = [o for o in objectives if o.name != "freshness"]
    return SloEngine(
        objectives,
        metrics,
        fast_window_seconds=config.slo_fast_window_seconds,
        slow_window_seconds=config.slo_slow_window_seconds,
        fast_burn_threshold=config.slo_fast_burn,
        slow_burn_threshold=config.slo_slow_burn,
        min_slow_bad_events=1 if one_shot else 2,
        clock=clock,
        logger=logger,
    )
