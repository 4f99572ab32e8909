"""Render the delta between two recommendation points — `krr-tpu diff`.

A copy of `krr_tpu/history/diff.py`.

The trick: a diff IS a scan result. Take the baseline point's raw
recommendations as the object's "current allocations" and the target
point's as the "recommended" side, push both through the shared rounding
(`round_allocations`) and `ResourceScan.calculate` — and the existing
severity machinery scores the movement (GOOD = inside the noise floor,
WARNING/CRITICAL = big moves, one-sided None = workload appeared/vanished)
while EVERY registered formatter (table, json, yaml, pprint, plugins)
renders it unchanged. No bespoke diff formatter to maintain.

Points come from the journal (two tick timestamps) or from a live one-shot
scan (`live_values`), which reuses the serve scheduler's exact query path
(`DigestStore.query_recommendation`) over a freshly fetched window so diff
and serve can never disagree about what a recommendation is.
"""

from __future__ import annotations

from decimal import Decimal
from typing import Optional

import numpy as np

from krr_tpu_torch.history.journal import RecommendationJournal
from krr_tpu_torch.models.allocations import ResourceAllocations, ResourceType
from krr_tpu_torch.models.objects import K8sObjectData
from krr_tpu_torch.models.result import ResourceScan, Result

#: (cpu cores, memory MB) — one workload's raw recommendation at one point.
Point = "tuple[float, float]"


def parse_object_key(key: str) -> K8sObjectData:
    """Reconstruct workload identity from the store's ``object_key`` string
    (via the shared :func:`split_object_key`, so the /history filters and
    this renderer can never parse the same key differently)."""
    from krr_tpu_torch.core.streaming import split_object_key

    if "/" not in key:
        # A hex-hash fallback name (lost key-table sidecar): splitting it
        # as an object key would scatter the hash into the wrong identity
        # fields — surface it honestly as an unresolved name instead.
        cluster, namespace, name, container, kind = None, "", key, "", None
    else:
        cluster, namespace, name, container, kind = split_object_key(key)
    return K8sObjectData(
        cluster=cluster,
        namespace=namespace,
        name=name,
        container=container,
        kind=kind,
        pods=[],
        allocations=ResourceAllocations(requests={}, limits={}),
    )


def tick_values(journal: RecommendationJournal, ts: float) -> dict[str, tuple[float, float]]:
    """key → (cpu, mem) raw recommendations journaled at tick ``ts``."""
    recs = journal.records()
    mask = recs["ts"] == float(ts)
    return {
        journal.key_name(row["key_hash"]): (float(row["cpu"]), float(row["mem"]))
        for row in recs[mask]
    }


def newest_at_or_before(
    journal: RecommendationJournal, limit: Optional[float], what: str = "--at"
) -> float:
    """The newest journal tick ≤ ``limit`` (the latest tick when None) —
    THE tick-resolution rule, shared by journal-vs-journal and --live."""
    ticks = journal.tick_timestamps()
    if len(ticks) == 0:
        raise ValueError("the journal holds no ticks")
    eligible = ticks if limit is None else ticks[ticks <= limit]
    if len(eligible) == 0:
        raise ValueError(
            f"no journal tick at or before {what} {limit:.0f} "
            f"(journal spans [{ticks[0]:.0f}, {ticks[-1]:.0f}])"
        )
    return float(eligible[-1])


def resolve_ticks(
    journal: RecommendationJournal,
    at: Optional[float] = None,
    baseline: Optional[float] = None,
) -> tuple[float, float]:
    """(baseline_ts, at_ts): the newest tick ≤ each requested timestamp;
    defaults are the journal's latest tick and the one before it. A
    baseline that does not resolve OLDER than the target is an error — a
    silently inverted diff renders every movement backwards."""
    at_ts = newest_at_or_before(journal, at, "--at")
    if baseline is not None:
        base_ts = newest_at_or_before(journal, baseline, "--baseline")
        if base_ts >= at_ts:
            raise ValueError(
                f"--baseline resolves to tick {base_ts:.0f}, which is not older "
                f"than the target tick {at_ts:.0f} — swapped timestamps?"
            )
        return base_ts, at_ts
    ticks = journal.tick_timestamps()
    earlier = ticks[ticks < at_ts]
    if len(earlier) == 0:
        raise ValueError(
            f"the journal holds no tick before {at_ts:.0f} to diff against "
            f"(pass --baseline, or wait for a second scan tick)"
        )
    return float(earlier[-1]), at_ts


def _allocations(
    point: "Optional[tuple[float, float]]",
    *,
    cpu_min_value: int,
    memory_min_value: int,
    memory_buffer_percentage: Decimal,
) -> ResourceAllocations:
    """Raw (cpu cores, mem MB) → rounded allocations, through THE publish
    path's own conversion (``finalize_fleet`` on a 1-element fleet, then the
    shared rounding) — the journal stores PRE-buffer raw values, so the
    buffer must be re-applied here, and using finalize itself means diff
    output can never diverge from served recommendations if the finalize
    logic evolves. A missing point (workload absent at that tick) maps to
    all-None."""
    from krr_tpu_torch.core.rounding import as_decimal
    from krr_tpu_torch.core.runner import round_allocations
    from krr_tpu_torch.strategies.simple import finalize_fleet

    if point is None:
        return ResourceAllocations(
            requests={ResourceType.CPU: None, ResourceType.Memory: None},
            limits={ResourceType.CPU: None, ResourceType.Memory: None},
        )
    cpu, mem_mb = point
    raw = finalize_fleet(
        np.asarray([cpu], np.float32),
        np.asarray([mem_mb], np.float32),
        as_decimal(memory_buffer_percentage),
    )[0]
    return round_allocations(
        raw, cpu_min_value=cpu_min_value, memory_min_value=memory_min_value
    )


def build_diff_result(
    baseline: dict[str, tuple[float, float]],
    target: dict[str, tuple[float, float]],
    *,
    cpu_min_value: int = 5,
    memory_min_value: int = 10,
    memory_buffer_percentage: Decimal = Decimal(0),
) -> Result:
    """A `Result` whose "current allocations" are the baseline point and
    whose recommendations are the target point — renderable through any
    registered formatter. Pass the strategy's ``memory_buffer_percentage``
    so memory values match what /recommendations publishes."""
    convert = dict(
        cpu_min_value=cpu_min_value,
        memory_min_value=memory_min_value,
        memory_buffer_percentage=memory_buffer_percentage,
    )
    scans: list[ResourceScan] = []
    for key in sorted(set(baseline) | set(target)):
        obj = parse_object_key(key)
        obj.allocations = _allocations(baseline.get(key), **convert)
        scans.append(ResourceScan.calculate(obj, _allocations(target.get(key), **convert)))
    return Result(scans=scans)


async def live_values(config) -> dict[str, tuple[float, float]]:
    """One-shot scan → key → (cpu, mem) raw recommendations, through the
    SAME digest fold + store query the serve scheduler publishes from."""
    from krr_tpu_torch.core.runner import ScanSession
    from krr_tpu_torch.core.streaming import DigestStore, object_key
    from krr_tpu_torch.strategies.window import MEMORY_SCALE

    session = ScanSession(config)
    try:
        objects = await session.discover()
        settings = session.strategy.settings
        fleet = await session.gather_fleet_digests(
            objects,
            history_seconds=settings.history_timedelta.total_seconds(),
            step_seconds=settings.timeframe_timedelta.total_seconds(),
        )
        store = DigestStore(spec=settings.cpu_spec())
        rows = store.fold_fleet(fleet, MEMORY_SCALE)
        cpu, mem = store.query_recommendation(rows, float(settings.cpu_percentile))
        return {
            object_key(obj): (float(c), float(m))
            for obj, c, m in zip(fleet.objects, cpu, mem)
        }
    finally:
        await session.close()
