"""The journal-derived fleet savings posture behind serve's ``/statusz``.

A copy of `krr_tpu/eval/score.py` ``journal_savings`` (host numpy, no
device): the incident/slack math of the quality scoreboard applied to the
recommendation journal directly — raw series as observed demand vs the
forward-filled published series — powering the ``/statusz`` savings block
and the ``krr_tpu_eval_*`` gauges without a replay. The replay engine and
the scoreboard (ROADMAP M9) join this module later.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from krr_tpu_torch.history.journal import FLAG_PUBLISHED, RecommendationJournal

SECONDS_PER_HOUR = 3600.0


def journal_savings(journal: RecommendationJournal) -> "Optional[dict]":
    """The fleet savings posture derived from the journal alone.

    Usage proxy = the journal's RAW per-tick series (the percentile/peak the
    store actually observed); recommendation = the forward-fill of records
    flagged ``FLAG_PUBLISHED`` (exactly what the gate served, same
    construction as ``krr_tpu_torch.history.drift``). Incidents are raw-exceeds-
    published rising edges; slack integrates published-over-raw headroom
    using each workload's own tick spacing. One vectorized numpy sweep over
    the sorted record array — cheap enough to recompute per /statusz scrape.
    """
    recs = journal.records()
    n = len(recs)
    if n == 0:
        return None
    order = np.lexsort((recs["ts"], recs["key_hash"]))
    ts = recs["ts"][order]
    hashes = recs["key_hash"][order]
    cpu = recs["cpu"][order].astype(np.float64)
    mem = recs["mem"][order].astype(np.float64)  # raw MB, pre-buffer
    published = (recs["flags"][order] & FLAG_PUBLISHED) != 0

    starts = np.flatnonzero(np.r_[True, hashes[1:] != hashes[:-1]])
    counts = np.diff(np.r_[starts, n])
    seg_start = np.repeat(starts, counts)
    positions = np.arange(n)

    # Group-reset forward fill of the published series, per resource (the
    # drift module's construction: only FINITE published slots advance).
    def ffill_published(values: np.ndarray) -> np.ndarray:
        fmask = published & np.isfinite(values)
        last = np.maximum.accumulate(np.where(fmask, positions + 1, 0))
        valid = (last - 1) >= seg_start
        return np.where(valid, values[np.where(valid, last - 1, 0)], np.nan)

    pub_cpu = ffill_published(cpu)
    pub_mem = ffill_published(mem)

    # Each record's span: the gap to the NEXT record in its group (the
    # recommendation held until then); the group's last record spans the
    # workload's median gap so a fleet mid-flight isn't undercounted.
    has_next = positions < (seg_start + np.repeat(counts, counts) - 1)
    nxt = np.minimum(positions + 1, n - 1)
    gaps = np.where(has_next, ts[nxt] - ts, 0.0)
    gap_values = gaps[has_next]
    typical = float(np.median(gap_values)) if len(gap_values) else 0.0
    span_hours = np.where(has_next, gaps, typical) / SECONDS_PER_HOUR

    def one(raw: np.ndarray, pub: np.ndarray) -> "tuple[int, float]":
        finite = np.isfinite(raw) & np.isfinite(pub)
        exceed = finite & (raw > pub)
        has_prev = positions > seg_start
        prev = np.maximum(positions - 1, 0)
        edges = int(np.count_nonzero(exceed & ~(has_prev & exceed[prev])))
        slack = float(np.sum(np.where(finite & ~exceed, (pub - raw) * span_hours, 0.0)))
        return edges, slack

    throttle, core_hours = one(cpu, pub_cpu)
    oom, mb_hours = one(mem, pub_mem)
    return {
        "workloads": int(len(starts)),
        "ticks": int(len(np.unique(ts))),
        "window_seconds": float(ts[-1] - ts[0]) if n > 1 else 0.0,
        "oom_incidents": oom,
        "throttle_incidents": throttle,
        "overprovisioned_core_hours": round(core_hours, 6),
        # Journal memory is raw MB: MB-hours / 1000 = GB-hours.
        "overprovisioned_gb_hours": round(mb_hours / 1000.0, 6),
        "published_records": int(np.count_nonzero(published)),
        "suppressed_records": int(n - np.count_nonzero(published)),
    }


__all__ = ["journal_savings"]
