"""Adaptive fetch planning + concurrency autotuning for the Prometheus fan-out.

Two host-side control loops that turn the fixed one-query-per-(namespace,
resource) fetch shape into an adaptive one (ROADMAP "kill the fetch wall";
the fixed shape is kept as the ``--fetch-plan fixed`` escape hatch and the
bit-exactness control):

* :class:`FetchPlanner` — a per-scan **query plan**. Small namespaces
  COALESCE into one multi-namespace matcher query (``namespace=~"a|b|c"``
  grouped ``by (namespace, pod, container)`` so series stay unambiguous —
  the native parser carries the namespace label through the series key),
  and giant namespaces SHARD into several queries over disjoint workload
  partitions (``pod=~"..."`` matchers over each shard's routed pods).
  Shapes are chosen from the PREVIOUS scan's per-query telemetry — observed
  series counts and response bytes per namespace — persisted by the serve
  scheduler beside the window cursor; the first scan falls back to the
  routed pod counts. Both transforms are exact: coalesced series keep their
  namespace in the key (no cross-namespace summing), and shards partition a
  namespace's WORKLOADS (each object's series arrive from exactly one
  shard), so adaptive-plan scans are bit-exact vs the fixed plan.

* :class:`AdaptiveLimiter` — AIMD autotuning of in-flight range queries per
  Prometheus target, replacing the fixed connection semaphore. Additive
  increase (+1) on each healthy completion that actually queued; one
  multiplicative decrease (×½, cooldown-limited) when a query's TTFB blows
  past the decayed-best baseline or its retry ladder saw transport
  errors/5xx — so one ``--prometheus-max-connections`` knob no longer has
  to fit cold backfills and warm delta ticks alike. Disabled
  (``--fetch-autotune false``) it is exactly the old semaphore.

Both live here (dependency-free, asyncio-only) so ``krr_tpu_torch.core`` owns the
policy and `krr_tpu_torch.integrations.prometheus` stays the mechanism.
"""

from __future__ import annotations

import asyncio
import math
import re
import time
from dataclasses import dataclass, field
from typing import Iterable, Optional


@dataclass(frozen=True)
class PlanGroup:
    """One range query's worth of fetch plan.

    ``kind``:

    * ``"single"`` — the fixed plan's shape: one whole namespace.
    * ``"coalesced"`` — several small namespaces in one query
      (multi-namespace matcher, namespace-labeled series keys).
    * ``"sharded"`` — a slice of one giant namespace: ``indices`` hold a
      workload partition, the query matches exactly those workloads' pods.

    ``indices`` are indices into the scan's object list; every object
    appears in exactly one group, so group-level failure handling (halved
    retry, per-workload fallback, row unwinding) owns a disjoint row set.
    """

    kind: str
    namespaces: tuple[str, ...]
    indices: tuple[int, ...]
    shard: Optional[tuple[int, int]] = None  # (shard ordinal, shard count)

    @property
    def label(self) -> str:
        if self.kind == "sharded" and self.shard is not None:
            return f"{self.namespaces[0]}[{self.shard[0] + 1}/{self.shard[1]}]"
        return ",".join(self.namespaces)


#: Largest downsample factor the auto policy will pick: one coarse bucket
#: per K grid points, capped so a bucket never spans more than an hour of a
#: minute-step grid (coarser buckets stop paying for themselves — two coarse
#: queries replace one raw one, so the wire reduction is ~K/2).
DOWNSAMPLE_MAX_FACTOR = 60


@dataclass(frozen=True)
class DownsamplePlan:
    """The exact window arithmetic of one downsampled stats fetch.

    A raw stats query evaluates at ``start, start + S, …`` (``n`` grid
    points); the stats route keeps only per-series (sample count, max).
    Both aggregates reconstruct EXACTLY from grid-aligned coarse buckets:
    ship ``count_over_time``/``max_over_time`` of the same expression over
    ``[K·S : S]`` subquery buckets and the sum of counts / max of maxes
    equals the raw window's count/max bit-for-bit (counts are small
    integers in float64, maxes are the same float64 values the raw parse
    would have seen — the server formats, we parse, no arithmetic in
    between changes them).

    Bucket geometry: Prometheus evaluates subquery INNER steps aligned to
    absolute time (multiples of ``S`` since the epoch), so eligibility
    requires ``start % S == 0`` — then an outer evaluation at
    ``start + (K-1)·S + j·K·S`` covers exactly grid points
    ``[jK, jK+K-1]`` (the half-open ``(t - K·S, t]`` subquery window). The
    ``q = n // K`` full buckets cover points ``[0, qK)``; the remaining
    ``n mod K`` points (``tail_start``..``tail_end``) ride one ordinary
    fine-grained query, so the union is exact with no bucket ever reaching
    outside the window."""

    factor: int
    step_seconds: int
    coarse_step_seconds: int
    coarse_start: float
    coarse_end: float
    buckets: int
    tail_start: Optional[float]
    tail_end: Optional[float]

    def subquery_suffix(self, closed_left: bool = False) -> str:
        """The ``[range:step]`` subquery selector for the rewritten query.

        Range-selector boundary semantics changed in Prometheus 3.0: a
        range ``[R]`` at evaluation time ``t`` covers ``(t-R, t]``
        (half-open) on 3.x but ``[t-R, t]`` (closed, one extra aligned
        boundary evaluation) on 2.x — the loader probes which one the
        backend speaks (`PrometheusLoader._subquery_semantics`). Under
        ``closed_left`` the range shrinks by one step so each bucket still
        covers exactly ``factor`` grid points; the outer evaluation
        positions are identical either way."""
        span = self.coarse_step_seconds - (self.step_seconds if closed_left else 0)
        return f"[{span}s:{self.step_seconds}s]"


def downsample_factor(step_seconds: int, n_points: int, requested: int = 0) -> int:
    """The downsample factor K for an ``n_points`` window at ``step_seconds``
    resolution — ``requested`` when the knob pins one (reduced if the window
    can't fit it), else auto. 0 = ineligible. Constraints: K ≥ 2, at least
    two full coarse buckets (``n // K ≥ 2``), and the coarse step ``K·S``
    must survive :func:`~krr_tpu_torch.integrations.prometheus.step_string`
    verbatim (sub-minute, or whole minutes — a silently rounded coarse step
    would desynchronize the buckets from the grid)."""
    step = int(step_seconds)
    if step <= 0 or n_points < 4:
        return 0
    cap = min(DOWNSAMPLE_MAX_FACTOR, n_points // 2)
    k = min(int(requested), cap) if requested > 0 else cap
    if k < 2:
        return 0
    if step >= 60:
        # Whole-minute steps (effective_step_seconds guarantees it): any
        # multiple is whole minutes too.
        return k
    if k * step < 60:
        return k
    # Sub-minute step whose coarse step would cross the minute mark: K must
    # make K·S a whole minute, or stay under one.
    minute_multiple = 60 // math.gcd(step, 60)
    aligned = (k // minute_multiple) * minute_multiple
    if aligned >= 2:
        return aligned
    sub_minute = (60 - 1) // step
    return sub_minute if sub_minute >= 2 else 0


def plan_downsample(
    start: float, end: float, step_seconds: int, factor: int = 0
) -> Optional[DownsamplePlan]:
    """Window arithmetic for one downsampled stats fetch, or None when the
    window is ineligible: unaligned start (subquery inner steps evaluate on
    the absolute ``step_seconds`` grid — a misaligned window would aggregate
    DIFFERENT samples than the raw query fetches), or too few points for at
    least two full coarse buckets. ``step_seconds`` must already be the
    effective (server-evaluated) step."""
    step = int(step_seconds)
    if step <= 0 or float(start) % step != 0:
        return None
    n = int((end - start) // step) + 1
    k = downsample_factor(step, n, factor)
    if not k:
        return None
    buckets = n // k
    coarse_step = k * step
    coarse_start = start + (k - 1) * step
    coarse_end = coarse_start + (buckets - 1) * coarse_step
    tail_points = n - buckets * k
    return DownsamplePlan(
        factor=k,
        step_seconds=step,
        coarse_step_seconds=coarse_step,
        coarse_start=coarse_start,
        coarse_end=coarse_end,
        buckets=buckets,
        tail_start=start + buckets * k * step if tail_points else None,
        tail_end=start + (n - 1) * step if tail_points else None,
    )


class FetchPlanner:
    """Builds per-scan query plans from routed fleet shape + prior telemetry.

    Planning inputs per namespace: the estimated SERIES count for one
    resource's batched query — the max of the previous scan's observed count
    (``observe``, fed by the loader's series-count probes and routed counts)
    and this scan's routed pod count — plus the observed bytes-per-series
    EWMA, which tightens the coalescing target so a group's expected
    response stays under ``target_bytes`` even when its series are fat.

    Rules (deterministic — same fleet + same telemetry → same plan):

    * ``series ≥ 2 × target_series`` and ≥ 2 workloads → SHARD into
      ``min(max_shards, ceil(series / target_series))`` contiguous workload
      partitions balanced by pod count.
    * ``series ≤ target_series / 4`` → coalesce CANDIDATE; candidates pack
      greedily (sorted by namespace) into groups whose summed series stay
      under the effective target; groups of ≥ 2 namespaces become one
      coalesced query, leftovers stay single.
    * everything else → single (the fixed shape).

    ``target_series=0`` (the default) sizes the target PER SCAN from the
    caller's sample budget: ``plan(..., auto_target=budget // points)`` —
    one query should carry about one response-budget's worth of samples.
    That alignment is what keeps the plan from ever ISSUING MORE queries
    than the fixed shape needs: a namespace whose series would force the
    sub-window fan-out to split the range into N windows instead shards
    into ~N whole-range queries (same count, but every series complete in
    one response — one fold, no window stitching), and small namespaces
    coalesce until a query is budget-full (strictly fewer queries).

    ``enabled=False`` (the ``--fetch-plan fixed`` escape hatch) always
    returns one single group per namespace — byte-identical queries to the
    pre-planner code."""

    #: Fallback target when neither the knob nor the caller provides one.
    DEFAULT_TARGET_SERIES = 4096

    #: Char budget for one coalesced group's namespace pattern ("a|b|c",
    #: regex-escaped). The loader keeps range queries on GET below its
    #: ~6 KB raw-query cut-over (POST maps to the `create` verb on the
    #: read-only apiserver service proxy), so a group's pattern must leave
    #: the query scaffolding comfortable headroom — without this bound a
    #: thousand one-series namespaces would pack into one group whose query
    #: can only POST, and the planner would rebuild the same failing group
    #: every scan (telemetry records series/bytes, never group failure).
    PATTERN_CHAR_BUDGET = 4096

    #: Telemetry entries retained (LRU by last observation). Namespace churn
    #: on a long-lived serve process (ephemeral CI/preview namespaces) must
    #: not grow the dict — and the persisted ``serve_fetch_plan`` snapshot
    #: beside the window cursor — without bound. Catch-up/partial scans see
    #: only a subset of namespaces, so eviction is by staleness, never by
    #: absence from one plan's fleet.
    MAX_NAMESPACES = 4096

    def __init__(
        self,
        *,
        enabled: bool = True,
        target_series: int = 0,
        max_shards: int = 16,
        target_bytes: float = 512e6,
    ) -> None:
        self.enabled = bool(enabled)
        self.target_series = max(0, int(target_series))
        self.max_shards = max(1, int(max_shards))
        self.target_bytes = float(target_bytes)
        #: namespace -> {"series": float, "bytes_per_series": float} — the
        #: persisted telemetry (EWMA-smoothed across scans).
        self.telemetry: dict[str, dict[str, float]] = {}
        #: Plan decisions of the last plan() call (observability/testing).
        self.last_plan: list[PlanGroup] = []

    # ------------------------------------------------------------ telemetry
    def _entry(self, namespace: str) -> dict[str, float]:
        """The namespace's telemetry entry, touched to the LRU tail (dict
        order IS the LRU order), evicting the stalest entry when full."""
        entry = self.telemetry.pop(namespace, None)
        if entry is None:
            entry = {}
            while len(self.telemetry) >= self.MAX_NAMESPACES:
                self.telemetry.pop(next(iter(self.telemetry)))
        self.telemetry[namespace] = entry
        return entry

    def observe(self, namespace: str, *, series: float, bytes_seen: float = 0.0) -> None:
        """Record one scan's observation for a namespace: the actual series
        count its queries returned/probed, and response WIRE bytes (per
        resource, summed across sub-windows; compressed transport reports
        compressed bytes, so the coalescing byte target bounds what actually
        crosses the network). EWMA (α=0.5) so one odd scan doesn't
        whipsaw the plan, while churn converges in a couple of scans."""
        entry = self._entry(namespace)
        prior = entry.get("series")
        entry["series"] = float(series) if prior is None else 0.5 * prior + 0.5 * float(series)
        if bytes_seen > 0 and series > 0:
            per = float(bytes_seen) / float(series)
            prior_per = entry.get("bytes_per_series")
            entry["bytes_per_series"] = per if prior_per is None else 0.5 * prior_per + 0.5 * per

    def forbid_shard(self, namespace: str) -> None:
        """Pin a namespace to the fixed single shape: its sharded queries
        were REJECTED with a non-transient answer. The canonical case is
        read-only RBAC on the apiserver service proxy, where the shard
        query must POST (fleet-width pod regexes overflow the GET cut-over
        by construction) and POST maps to the `create` verb → 403 every
        scan. Telemetry records series/bytes but never group failure, so
        without this flag the planner would rebuild the same failing shards
        (+ per-workload fallback storm) every tick. Persisted with the
        telemetry entry; clears only when the entry ages out of the LRU."""
        self._entry(namespace)["no_shard"] = 1.0

    def forbid_downsample(self, namespace: str) -> None:
        """Pin a namespace's stats queries to the raw (undownsampled) shape:
        its subquery rewrite was REJECTED with a non-transient answer — the
        canonical case is a backend without subquery support (Prometheus
        < 2.7, or a query frontend that rejects the syntax) answering 400
        every scan. Persisted with the telemetry entry, like
        :meth:`forbid_shard`, so a restarted server doesn't rediscover the
        rejection one fallback round-trip per tick."""
        self._entry(namespace)["no_downsample"] = 1.0

    def downsample_allowed(self, namespace: str) -> bool:
        return not self.telemetry.get(namespace, {}).get("no_downsample")

    def state(self) -> dict:
        """JSON-serializable snapshot (persisted beside the serve window
        cursor in the digest store's extra_meta)."""
        return {
            "namespaces": {
                ns: {k: round(v, 3) for k, v in entry.items()}
                for ns, entry in self.telemetry.items()
            }
        }

    def seed(self, state: Optional[dict]) -> None:
        """Restore a persisted snapshot (restart / new scan session)."""
        if not state:
            return
        entries = list((state.get("namespaces") or {}).items())
        for ns, entry in entries[-self.MAX_NAMESPACES:]:
            if isinstance(entry, dict):
                self.telemetry[str(ns)] = {
                    k: float(v) for k, v in entry.items() if isinstance(v, (int, float))
                }

    # ------------------------------------------------------------- planning
    def _estimate(self, namespace: str, routed_pods: int) -> float:
        """Expected series of one resource's batched query: never less than
        the routed pod count (this scan's ground truth for scanned series),
        raised by the previous scan's observation (which also counts
        unscanned series the query will return)."""
        observed = self.telemetry.get(namespace, {}).get("series")
        return max(float(routed_pods), observed or 0.0)

    def _effective_target(self, namespaces: Iterable[str], base: float) -> float:
        """Coalescing target, tightened when telemetry says series are fat:
        a group's expected bytes (series × bytes/series) should stay under
        ``target_bytes``."""
        per = [
            self.telemetry[ns]["bytes_per_series"]
            for ns in namespaces
            if "bytes_per_series" in self.telemetry.get(ns, {})
        ]
        if not per:
            return base
        worst = max(per)
        if worst <= 0:
            return base
        return max(1.0, min(base, self.target_bytes / worst))

    def plan(
        self, by_namespace: "dict[str, list[int]]", pods_per_object: "list[int]",
        auto_target: Optional[float] = None,
    ) -> list[PlanGroup]:
        """Build the scan's plan. ``by_namespace`` maps namespace → object
        indices (the fixed plan's unit); ``pods_per_object[i]`` is the routed
        pod count of object ``i``. ``auto_target`` is the caller's
        budget-derived series target (samples budget ÷ window points), used
        when the ``target_series`` knob is 0 (auto)."""
        namespaces = sorted(by_namespace)
        if not self.enabled:
            self.last_plan = [
                PlanGroup("single", (ns,), tuple(by_namespace[ns])) for ns in namespaces
            ]
            return self.last_plan

        base = max(1.0, float(self.target_series or auto_target or self.DEFAULT_TARGET_SERIES))
        groups: list[PlanGroup] = []
        candidates: list[tuple[str, float]] = []
        target = self._effective_target(namespaces, base)
        for ns in namespaces:
            indices = by_namespace[ns]
            routed = sum(pods_per_object[i] for i in indices)
            est = self._estimate(ns, routed)
            if (
                est >= 2 * base
                and len(indices) >= 2
                and not self.telemetry.get(ns, {}).get("no_shard")
            ):
                groups.extend(self._shard(ns, indices, pods_per_object, est, base))
            elif est <= target / 4:
                candidates.append((ns, est))
            else:
                groups.append(PlanGroup("single", (ns,), tuple(indices)))

        # Greedy packing of small namespaces, in sorted order so the plan is
        # stable scan-over-scan (stable plans keep the fake/server response
        # caches and the sink's row-mapping cache warm). Buckets are bounded
        # by summed series AND by the namespace pattern's char budget (see
        # PATTERN_CHAR_BUDGET — the group's query must stay GET-able).
        bucket: list[str] = []
        bucket_series = 0.0
        bucket_chars = 0
        for ns, est in candidates:
            ns_chars = len(re.escape(ns)) + 1  # +1 for the "|" separator
            if bucket and (
                bucket_series + est > target
                or bucket_chars + ns_chars > self.PATTERN_CHAR_BUDGET
            ):
                groups.append(self._flush(bucket, by_namespace))
                bucket, bucket_series, bucket_chars = [], 0.0, 0
            bucket.append(ns)
            bucket_series += est
            bucket_chars += ns_chars
        if bucket:
            groups.append(self._flush(bucket, by_namespace))
        self.last_plan = groups
        return groups

    @staticmethod
    def _flush(bucket: list[str], by_namespace: "dict[str, list[int]]") -> PlanGroup:
        indices = tuple(i for ns in bucket for i in by_namespace[ns])
        if len(bucket) == 1:
            return PlanGroup("single", (bucket[0],), indices)
        return PlanGroup("coalesced", tuple(bucket), indices)

    def _shard(
        self, namespace: str, indices: list[int], pods_per_object: "list[int]",
        est: float, base: float,
    ) -> list[PlanGroup]:
        """Partition a giant namespace's WORKLOADS into contiguous shards
        balanced by pod count. Sharding by workload (not by bare pod) keeps
        failure domains clean: an object's series arrive from exactly one
        shard, so a failed shard unwinds and falls back per-workload without
        touching sibling shards' rows."""
        count = min(self.max_shards, max(2, -(-int(est) // max(1, int(base)))), len(indices))
        total_pods = max(1, sum(pods_per_object[i] for i in indices))
        per_shard = total_pods / count
        shards: list[list[int]] = [[]]
        acc = 0.0
        for i in indices:
            if acc >= per_shard * len(shards) and len(shards) < count:
                shards.append([])
            shards[-1].append(i)
            acc += pods_per_object[i]
        shards = [s for s in shards if s]
        return [
            PlanGroup("sharded", (namespace,), tuple(s), shard=(j, len(shards)))
            for j, s in enumerate(shards)
        ]


class AdaptiveLimiter:
    """AIMD concurrency gate over in-flight Prometheus range queries.

    Semantics when ``enabled``:

    * the live limit floats in ``[1, max_inflight]``, starting at the max
      (optimistic — warm delta ticks must not pay a slow-start);
    * **additive increase**: +1 after a healthy completion that spent at
      least ``QUEUE_DEMAND_SECONDS`` queued while the limit is below max.
      The threshold matters: the queue_wait phase is a perf_counter delta
      around the limiter acquire, so an uncontended acquire still reports a
      few microseconds — gating on ``> 0`` would be vacuously true and let
      healthy completions march the limit straight back to max against the
      cooldown-limited decreases;
    * **multiplicative decrease**: limit ×= ½ when a completion reports
      degradation — TTFB above ``degrade_factor`` × the decayed-best
      baseline (+10 ms absolute floor, so microsecond baselines don't turn
      noise into collapse) or a failed/retried ladder — at most once per
      ``cooldown`` seconds so one burst maps to one decrease, not a freefall.

    The TTFB baseline is a decayed minimum: it ratchets down to the best
    observed first-byte latency and relaxes upward by 10%/observation, so a
    genuinely slower regime eventually becomes the new baseline instead of
    alerting forever. Disabled, ``acquire``/``release`` degrade to a plain
    counting semaphore at ``max_inflight`` — the pre-autotuner behavior.

    All state mutates on the event loop (acquire/release/note are called
    from coroutines); no locks.
    """

    #: Minimum queue_wait that counts as concurrency demand (see class doc).
    QUEUE_DEMAND_SECONDS = 0.001

    def __init__(
        self,
        max_inflight: int,
        *,
        enabled: bool = True,
        degrade_factor: float = 3.0,
        cooldown: float = 1.0,
        clock=time.monotonic,
    ) -> None:
        self.max = max(1, int(max_inflight))
        self.enabled = bool(enabled)
        self.limit = float(self.max)
        self.degrade_factor = float(degrade_factor)
        self.cooldown = float(cooldown)
        self.clock = clock
        self.inflight = 0
        self.baseline_ttfb: Optional[float] = None
        self.last_decrease = -float("inf")
        self.increases = 0
        self.decreases = 0
        self._waiters: "list[asyncio.Future]" = []

    # --------------------------------------------------------------- gating
    async def acquire(self) -> None:
        while self.inflight >= int(self.limit):
            waiter: asyncio.Future = asyncio.get_running_loop().create_future()
            self._waiters.append(waiter)
            try:
                await waiter
            except BaseException:
                # A cancelled waiter must not swallow the wake-up meant for
                # it — pass the slot to the next in line.
                if waiter.done() and not waiter.cancelled():
                    self._wake()
                raise
        self.inflight += 1

    def release(self) -> None:
        self.inflight = max(0, self.inflight - 1)
        self._wake()

    def _wake(self) -> None:
        while self._waiters and self.inflight < int(self.limit):
            waiter = self._waiters.pop(0)
            if not waiter.done():
                waiter.set_result(None)
                break

    async def __aenter__(self) -> "AdaptiveLimiter":
        await self.acquire()
        return self

    async def __aexit__(self, *exc) -> None:
        self.release()

    # ----------------------------------------------------------------- AIMD
    def note(
        self, *, ttfb: Optional[float], queued: float, failed: bool
    ) -> None:
        """One completed query's verdict (called once per query, after its
        retry ladder settles)."""
        if not self.enabled:
            return
        degraded = failed
        if ttfb is not None and ttfb > 0:
            if self.baseline_ttfb is None:
                self.baseline_ttfb = ttfb
            elif ttfb < self.baseline_ttfb:
                self.baseline_ttfb = ttfb
            else:
                # Relax the ratchet so a durably slower backend re-baselines.
                self.baseline_ttfb *= 1.10
            if ttfb > self.degrade_factor * self.baseline_ttfb + 0.010:
                degraded = True
        if degraded:
            now = self.clock()
            if now - self.last_decrease >= self.cooldown:
                self.last_decrease = now
                new_limit = max(1.0, self.limit / 2.0)
                if new_limit < self.limit:
                    self.limit = new_limit
                    self.decreases += 1
        elif queued >= self.QUEUE_DEMAND_SECONDS and self.limit < self.max:
            self.limit = min(float(self.max), self.limit + 1.0)
            self.increases += 1
            self._wake()
