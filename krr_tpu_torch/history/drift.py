"""Vectorized drift analysis over the recommendation journal.

A copy of `krr_tpu/history/drift.py`.

Answers the operator questions a bare snapshot can't: how far has each
workload's RAW recommendation drifted from what is actually published, how
often does it flap direction, and is a sustained regime change under way
(drift out of the dead band, same direction, for the confirmation window)?
Everything derives from the journal alone — the published series is the
forward-fill of records flagged ``FLAG_PUBLISHED`` — so ``GET /drift`` and
offline tooling agree with the gate by construction.

The per-record passes (trailing-published forward fill with per-workload
resets, relative drift, tick-to-tick flap detection) are single vectorized
numpy sweeps over the sorted record array; only the per-workload summary
rows are assembled in a Python loop, which is O(workloads), not O(records).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from krr_tpu_torch.history.journal import FLAG_PUBLISHED, RecommendationJournal

_EPS = 1e-12


def finite_or_none(value: float) -> Optional[float]:
    """JSON-safe number: NaN/inf → None (strict JSON has no NaN literal).
    Shared by /drift (here) and /history."""
    return float(value) if np.isfinite(value) else None


@dataclass
class WorkloadDrift:
    """Latest drift posture of one workload, derived from its journal series."""

    key: str
    ticks: int
    first_ts: float
    last_ts: float
    cpu_drift_pct: Optional[float]  # latest raw vs trailing published
    mem_drift_pct: Optional[float]
    max_drift_pct: Optional[float]
    flaps: int  # tick-to-tick reversals of the out-of-band drift direction
    out_of_band_streak: int  # trailing consecutive out-of-band ticks, same direction
    regime_change: bool  # streak has reached the confirmation window
    raw_cpu: Optional[float]
    raw_mem: Optional[float]
    published_cpu: Optional[float]
    published_mem: Optional[float]

    def as_dict(self) -> dict:
        return {
            "key": self.key,
            "ticks": self.ticks,
            "first_ts": self.first_ts,
            "last_ts": self.last_ts,
            "cpu_drift_pct": self.cpu_drift_pct,
            "mem_drift_pct": self.mem_drift_pct,
            "max_drift_pct": self.max_drift_pct,
            "flaps": self.flaps,
            "out_of_band_streak": self.out_of_band_streak,
            "regime_change": self.regime_change,
            "raw_cpu": self.raw_cpu,
            "raw_mem": self.raw_mem,
            "published_cpu": self.published_cpu,
            "published_mem": self.published_mem,
        }


def _rel_pct(raw: np.ndarray, base: np.ndarray) -> np.ndarray:
    """Relative drift in percent; NaN wherever either side is missing."""
    out = np.full(len(raw), np.nan)
    both = np.isfinite(raw) & np.isfinite(base)
    out[both] = 100.0 * np.abs(raw[both] - base[both]) / np.maximum(np.abs(base[both]), _EPS)
    return out


def fleet_drift(
    journal: RecommendationJournal, *, dead_band_pct: float, confirm_ticks: int
) -> list[WorkloadDrift]:
    """Per-workload drift summaries over the journal's retained window."""
    recs = journal.records()
    n = len(recs)
    if n == 0:
        return []
    order = np.lexsort((recs["ts"], recs["key_hash"]))
    ts = recs["ts"][order]
    hashes = recs["key_hash"][order]
    cpu = recs["cpu"][order].astype(np.float64)
    mem = recs["mem"][order].astype(np.float64)
    published = (recs["flags"][order] & FLAG_PUBLISHED) != 0

    # Contiguous per-workload groups after the sort.
    starts = np.flatnonzero(np.r_[True, hashes[1:] != hashes[:-1]])
    counts = np.diff(np.r_[starts, n])
    seg_start = np.repeat(starts, counts)
    positions = np.arange(n)

    # Trailing published value per record: a global running max of published
    # positions, valid only where the found position falls inside the
    # record's own group (groups are contiguous, so >= group start suffices
    # — this is the group-reset forward fill without a Python loop). Filled
    # per RESOURCE, mirroring the gate: a publish with a NaN resource kept
    # that resource's prior finite held value, so only FINITE published
    # slots advance the baseline.
    def ffill_published(values: np.ndarray) -> np.ndarray:
        mask = published & np.isfinite(values)
        last = np.maximum.accumulate(np.where(mask, positions + 1, 0))
        valid = (last - 1) >= seg_start
        return np.where(valid, values[np.where(valid, last - 1, 0)], np.nan)

    pub_cpu = ffill_published(cpu)
    pub_mem = ffill_published(mem)

    drift_cpu = _rel_pct(cpu, pub_cpu)
    drift_mem = _rel_pct(mem, pub_mem)
    drift = np.fmax(drift_cpu, drift_mem)  # fmax: one-sided NaN yields the other
    out = np.nan_to_num(drift, nan=0.0) > dead_band_pct

    # Drift direction: the dominant resource's sign of (raw - published).
    dominant_cpu = np.nan_to_num(drift_cpu, nan=-1.0) >= np.nan_to_num(drift_mem, nan=-1.0)
    direction = np.where(dominant_cpu, np.sign(cpu - pub_cpu), np.sign(mem - pub_mem))
    direction = np.nan_to_num(direction, nan=0.0)

    # Flap: consecutive out-of-band ticks whose drift direction reverses.
    prev = np.maximum(positions - 1, 0)
    has_prev = positions > seg_start
    flap = (
        has_prev
        & out
        & out[prev]
        & (direction != 0)
        & (direction[prev] != 0)
        & (direction != direction[prev])
    )
    flaps_per_group = np.add.reduceat(flap.astype(np.int64), starts)

    results: list[WorkloadDrift] = []
    for g, (start, count) in enumerate(zip(starts, counts)):
        last = start + count - 1
        # Trailing same-direction out-of-band streak (bounded backward scan).
        streak = 0
        if out[last] and direction[last] != 0:
            i = last
            while i >= start and out[i] and direction[i] == direction[last]:
                streak += 1
                i -= 1
        results.append(
            WorkloadDrift(
                key=journal.key_name(hashes[start]),
                ticks=int(count),
                first_ts=float(ts[start]),
                last_ts=float(ts[last]),
                cpu_drift_pct=finite_or_none(drift_cpu[last]),
                mem_drift_pct=finite_or_none(drift_mem[last]),
                max_drift_pct=finite_or_none(drift[last]),
                flaps=int(flaps_per_group[g]),
                out_of_band_streak=streak,
                regime_change=streak >= confirm_ticks,
                raw_cpu=finite_or_none(cpu[last]),
                raw_mem=finite_or_none(mem[last]),
                published_cpu=finite_or_none(pub_cpu[last]),
                published_mem=finite_or_none(pub_mem[last]),
            )
        )
    return results
