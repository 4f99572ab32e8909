"""Vectorized quality scoring over replayed usage × recommendation grids.

A copy of `krr_tpu/eval/score.py`. The oracle behind the scoreboard: given
a usage grid ``[workloads × samples]`` and the recommendation each sample
would have run under (the replayed, gate-held series expanded onto the
sample grid), reduce to four numbers per resource pair:

* **would-have-been incidents** — rising edges of ``usage > recommendation``
  (memory → OOM kills, CPU → throttle episodes). An edge, not a sample
  count: a sustained breach is ONE incident, the next breach after recovery
  is another — matching how an OOM-looping container actually dies.
* **over-provisioned area** — ``Σ max(recommendation − usage, 0) · Δt`` where
  the recommendation covered usage, in core-hours (CPU) and GB-hours
  (memory): the reclaimable-capacity integral a rightsizing pitch is
  quoted in.

The reduction runs as PyTorch ops on an explicit device (``cuda`` unless
the caller asks for ``cpu``), one pass per grid. The arithmetic is the JAX
package's: its jitted reduce receives the float64 host arrays cast to
float32 (x64 is off there), so the comparison, the edge detection and the
terms ``rec − usage`` are float32 here too. Only the sum differs: the
float32 terms accumulate in float64 (ROADMAP Queue 3 item 10), so the slack
is closer to their exact sum than XLA's float32 sum is, and the counts are
equal. No floating-point atomics: two replays of the same inputs on one
device give the same bits, the property the scoreboard's byte-identity
contract relies on.

``journal_savings`` is the serve-side twin: the same incident/slack math
applied to the recommendation journal directly (raw series as observed
demand vs the forward-filled published series), powering the ``/statusz``
savings block and the ``krr_tpu_eval_*`` gauges without a replay. It is
host numpy, no device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from krr_tpu_torch.history.journal import FLAG_PUBLISHED, RecommendationJournal

SECONDS_PER_HOUR = 3600.0
BYTES_PER_GB = 1e9


def expand_ticks(
    tick_indices: np.ndarray, rec: np.ndarray, samples: int
) -> "tuple[np.ndarray, np.ndarray]":
    """Expand per-tick recommendations onto the sample grid.

    ``tick_indices[k]`` is the sample index tick ``k``'s window ended at
    (exclusive), so its recommendation governs samples ``[tick_indices[k],
    tick_indices[k+1])`` — a recommendation only applies FORWARD from the
    moment it was made. Samples before the first tick have no
    recommendation and come back masked out of scoring.

    Returns ``(full [W × samples], scored_mask [samples])``.
    """
    tick_indices = np.asarray(tick_indices, np.int64)
    grid = np.arange(samples)
    governing = np.searchsorted(tick_indices, grid, side="right") - 1
    mask = governing >= 0
    full = np.asarray(rec)[:, np.clip(governing, 0, None)]
    return full, mask


def reduce_grid(usage, rec, mask) -> "tuple":
    """Incident + slack reduction of one resource grid, on the tensors'
    device: float32 ``usage`` and ``rec``, bool ``mask``. Returns the
    incident count (int64) and the slack (float64), both 0-d tensors.

    Only finite inputs arrive: callers replace NaN (no recommendation / no
    sample) with masked-out slots, keeping the reduction a pure sum."""
    import torch

    exceed = (usage > rec) & mask
    prev = torch.zeros_like(exceed)
    prev[:, 1:] = exceed[:, :-1]
    incidents = torch.count_nonzero(exceed & ~prev)
    terms = torch.where(mask & ~exceed, rec - usage, torch.zeros((), dtype=rec.dtype, device=rec.device))
    return incidents, terms.sum(dtype=torch.float64)


def _reduce(usage: np.ndarray, rec: np.ndarray, mask: np.ndarray, device) -> "tuple[int, float]":
    import torch

    from krr_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)

    def put(array: np.ndarray, dtype) -> "torch.Tensor":
        return torch.from_numpy(np.ascontiguousarray(array, dtype)).to(dev)

    incidents, slack = reduce_grid(put(usage, np.float32), put(rec, np.float32), put(mask, bool))
    return int(incidents), float(slack)


def score_grids(
    usage_cpu: np.ndarray,
    usage_mem: np.ndarray,
    rec_cpu: np.ndarray,
    rec_mem: np.ndarray,
    tick_indices: np.ndarray,
    *,
    step_seconds: float,
    device="cuda",
) -> "dict[str, float | int]":
    """Score one strategy's replayed recommendations against usage.

    ``usage_*`` are ``[W × T]`` sample grids (cores / bytes); ``rec_*`` are
    ``[W × K]`` per-tick published values aligned with ``tick_indices``.
    Slots where either side is NaN (no samples, or the gate never published
    a finite value) are excluded from scoring rather than treated as zero.
    The reduce runs on ``device``; ``cuda`` without a card raises.
    """
    samples = usage_cpu.shape[1]
    full_cpu, mask_ticks = expand_ticks(tick_indices, rec_cpu, samples)
    full_mem, _ = expand_ticks(tick_indices, rec_mem, samples)
    step_hours = float(step_seconds) / SECONDS_PER_HOUR

    def one(usage: np.ndarray, rec: np.ndarray) -> "tuple[int, float]":
        finite = np.isfinite(usage) & np.isfinite(rec)
        mask = mask_ticks[None, :] & finite
        return _reduce(np.nan_to_num(usage), np.nan_to_num(rec), mask, device)

    throttle, cpu_slack = one(usage_cpu, full_cpu)
    oom, mem_slack = one(usage_mem, full_mem)
    return {
        "oom_incidents": oom,
        "throttle_incidents": throttle,
        "overprovisioned_core_hours": cpu_slack * step_hours,
        "overprovisioned_gb_hours": mem_slack * step_hours / BYTES_PER_GB,
        "samples_scored": int(np.count_nonzero(mask_ticks)),
    }


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


__all__ = ["expand_ticks", "journal_savings", "reduce_grid", "score_grids"]
