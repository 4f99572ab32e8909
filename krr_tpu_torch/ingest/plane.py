"""The ingest plane: per-series sample buffers + watermarks + window folds.

A copy of `krr_tpu/ingest/plane.py` over the port's modules.

Samples land here from the remote-write listener (event-loop thread) and are
folded into `DigestedFleet` windows by the scheduler (worker thread via
``asyncio.to_thread``) — every mutation holds the plane lock.

Correctness model (mirrors the pull path exactly):

- **Grid evaluation.** A range query evaluates the series at each grid point
  ``t`` as the newest sample with ``ts <= t`` inside the staleness window.
  The fold does the same over the buffered stream (``lookback_seconds`` = the
  Prometheus staleness default), so a push-fed window sees the identical
  sample vector a range fetch would have returned.
- **Watermarks.** Each series tracks ``joined_ms`` (oldest buffered sample)
  and ``last_ts`` (newest, tombstones included). An object may fold from the
  plane only when EVERY pod series of BOTH resources covers the window
  (``joined_ms <= window_start`` and ``last_ts >= window_end``); anything
  less falls back to the range path — the gap-backfill ladder.
- **Digest math.** Folds bucket through
  :func:`krr_tpu_torch.integrations.native.digest_samples` — the same
  implementation the range fetch uses — and merge with the pull path's exact
  semantics (count adds, peak maxes, merge only when the window is
  non-empty), so push-vs-pull is bit-exact, not just close.

Malformed and misordered input is rejected WITH A COUNTER, never folded:
out-of-order and duplicate timestamps drop per sample, unroutable label sets
drop per series, non-finite values advance the watermark without emitting
(tombstones), and full buffers shed their oldest samples while pulling
``joined_ms`` forward so completeness stays truthful.
"""

from __future__ import annotations

import math
import threading
from typing import TYPE_CHECKING, Iterable, Optional

import numpy as np

from krr_tpu_torch.ingest.router import Route, route_record
from krr_tpu_torch.integrations.native import decode_remote_write, digest_samples

if TYPE_CHECKING:  # pragma: no cover
    from krr_tpu_torch.models.objects import K8sObjectData
    from krr_tpu_torch.models.series import DigestedFleet

#: Sample-rejection reasons (the ``reason`` label on the rejected counter).
#: Router reasons (unknown_metric/filtered/missing_labels/malformed_labels)
#: ride the same counter.
OUT_OF_ORDER = "out_of_order"
DUPLICATE = "duplicate"
SERIES_LIMIT = "series_limit"
BUFFER_OVERFLOW = "buffer_overflow"


class _Series:
    """One routed series' buffered stream. ``ts`` is strictly increasing —
    the append path rejects anything else — so folds binary-search it."""

    __slots__ = ("ts", "values", "joined_ms", "last_ts")

    def __init__(self) -> None:
        self.ts: list[int] = []  # ms, strictly increasing
        self.values: list[float] = []
        self.joined_ms: Optional[int] = None  # oldest buffered sample
        self.last_ts: Optional[int] = None  # watermark (tombstones advance it)


class IngestPlane:
    def __init__(
        self,
        *,
        lookback_seconds: float = 300.0,
        max_samples_per_series: int = 4096,
        max_series: int = 200_000,
        max_decoded_bytes: int = 64 << 20,
        metrics=None,
    ) -> None:
        self.metrics = metrics
        self.lookback_ms = int(round(lookback_seconds * 1000.0))
        self.max_samples_per_series = int(max_samples_per_series)
        self.max_series = int(max_series)
        self.max_decoded_bytes = int(max_decoded_bytes)
        self._lock = threading.Lock()
        self._series: dict[Route, _Series] = {}
        # Monotonic counters, snapshotted by stats(): the obs layer reads
        # these into gauges/counters at tick and scrape time.
        self.samples_total = 0
        self.bodies_total = 0
        self.bytes_total = 0
        self.decode_errors_total = 0
        self.rejected: dict[str, int] = {}
        self.tombstones_total = 0

    # ------------------------------------------------------------- ingest
    def ingest_body(self, body: bytes) -> int:
        """Decode + route + buffer one remote-write POST body; returns the
        accepted sample count. Malformed bodies raise (RemoteWriteError /
        RemoteWriteTooLarge) with the decode-error counter incremented and
        NOTHING buffered — a bad frame can't poison a window."""
        try:
            decoded = decode_remote_write(body, self.max_decoded_bytes)
        except Exception:
            with self._lock:
                self.decode_errors_total += 1
            raise
        accepted = self.ingest_decoded(decoded)
        with self._lock:
            self.bodies_total += 1
            self.bytes_total += len(body)
        return accepted

    def ingest_decoded(self, decoded) -> int:
        names, values, timestamps, lens = decoded
        records = names.split(b"\n") if len(lens) else []
        accepted = 0
        offset = 0
        with self._lock:
            for rec_i, count in enumerate(lens):
                count = int(count)
                record = records[rec_i] if rec_i < len(records) else b""
                route = route_record(record)
                if isinstance(route, str):  # rejection reason
                    if count:
                        self._reject(route, count)
                    offset += count
                    continue
                series = self._series.get(route)
                if series is None:
                    if len(self._series) >= self.max_series:
                        self._reject(SERIES_LIMIT, max(count, 1))
                        offset += count
                        continue
                    series = self._series[route] = _Series()
                for j in range(offset, offset + count):
                    ts = int(timestamps[j])
                    if series.last_ts is not None and ts <= series.last_ts:
                        self._reject(DUPLICATE if ts == series.last_ts else OUT_OF_ORDER, 1)
                        continue
                    series.last_ts = ts
                    value = float(values[j])
                    if not math.isfinite(value):
                        # Tombstone: the stream is alive (watermark moves)
                        # but this point must not fold.
                        self.tombstones_total += 1
                        if self.metrics is not None:
                            self.metrics.inc("krr_tpu_ingest_tombstones_total")
                        continue
                    series.ts.append(ts)
                    series.values.append(value)
                    if series.joined_ms is None:
                        series.joined_ms = ts
                    accepted += 1
                offset += count
                excess = len(series.ts) - self.max_samples_per_series
                if excess > 0:
                    del series.ts[:excess]
                    del series.values[:excess]
                    # Completeness must stay truthful: windows reaching
                    # before the new oldest sample fall back to range.
                    series.joined_ms = series.ts[0]
                    self._reject(BUFFER_OVERFLOW, excess)
            self.samples_total += accepted
        return accepted

    def _reject(self, reason: str, count: int) -> None:
        self.rejected[reason] = self.rejected.get(reason, 0) + count
        if self.metrics is not None:
            self.metrics.inc(
                "krr_tpu_ingest_rejected_samples_total", float(count), reason=reason
            )

    # ------------------------------------------------- watermarks / windows
    def _object_routes(self, obj: "K8sObjectData") -> Iterable[Route]:
        for pod in obj.pods:
            yield ("cpu", obj.namespace, pod, obj.container)
            yield ("mem", obj.namespace, pod, obj.container)

    def push_ready(self, obj: "K8sObjectData", window_start: float, window_end: float) -> bool:
        """True when EVERY pod series of BOTH resources covers
        ``[window_start, window_end]`` — the object folds from the plane with
        zero range queries. Objects with no pods are vacuously ready (the
        pull path issues no query for them either)."""
        start_ms = int(round(window_start * 1000.0))
        end_ms = int(round(window_end * 1000.0))
        with self._lock:
            for route in self._object_routes(obj):
                series = self._series.get(route)
                if (
                    series is None
                    or series.joined_ms is None
                    or series.joined_ms > start_ms
                    or series.last_ts is None
                    or series.last_ts < end_ms
                ):
                    return False
        return True

    def _window_samples(self, series: _Series, grid_ms: np.ndarray) -> np.ndarray:
        """Evaluate the buffered stream at each grid point: newest sample
        with ``ts <= t`` inside the lookback — range-query semantics."""
        ts = np.asarray(series.ts, dtype=np.int64)
        if ts.size == 0:
            return np.empty(0, dtype=np.float64)
        idx = np.searchsorted(ts, grid_ms, side="right") - 1
        clipped = np.maximum(idx, 0)
        fresh = (idx >= 0) & (ts[clipped] > grid_ms - self.lookback_ms)
        values = np.asarray(series.values, dtype=np.float64)
        return values[idx[fresh]]

    def fold_fleet(
        self,
        objects: "list[K8sObjectData]",
        rows: Iterable[int],
        window_start: float,
        window_end: float,
        step_seconds: float,
        gamma: float,
        min_value: float,
        num_buckets: int,
    ) -> "DigestedFleet":
        """Fold ``rows`` (indices into ``objects``) from the buffered streams
        into a fresh fleet over the inclusive grid ``[window_start,
        window_end]`` — the push twin of ``gather_fleet_digests`` with the
        same merge semantics (first-per-pod is structural here: routes are
        exact, so each pod has at most one series per resource)."""
        from krr_tpu_torch.models.series import DigestedFleet

        fleet = DigestedFleet.empty(objects, gamma, min_value, num_buckets)
        step_ms = max(int(round(step_seconds * 1000.0)), 1)
        start_ms = int(round(window_start * 1000.0))
        end_ms = int(round(window_end * 1000.0))
        n_points = (end_ms - start_ms) // step_ms + 1
        grid_ms = start_ms + np.arange(n_points, dtype=np.int64) * step_ms
        with self._lock:
            for i in rows:
                obj = objects[i]
                for pod in obj.pods:
                    cpu = self._series.get(("cpu", obj.namespace, pod, obj.container))
                    if cpu is not None:
                        samples = self._window_samples(cpu, grid_ms)
                        if samples.size:  # merge only non-empty, like pull
                            counts, total, peak = digest_samples(
                                samples, gamma, min_value, num_buckets
                            )
                            fleet.merge_cpu_row(i, counts, total, peak)
                    mem = self._series.get(("mem", obj.namespace, pod, obj.container))
                    if mem is not None:
                        samples = self._window_samples(mem, grid_ms)
                        if samples.size:
                            # Stats pass: count + exact max, raw bytes (the
                            # store's fold applies MEMORY_SCALE).
                            fleet.merge_mem_row(i, float(samples.size), float(samples.max()))
        return fleet

    # ------------------------------------------------------- maintenance
    def invalidate_object(self, obj: "K8sObjectData") -> int:
        """Drop the object's buffered series (the audit's repair arm): the
        next tick finds it not push-ready and range-backfills ground truth."""
        dropped = 0
        with self._lock:
            for route in list(self._object_routes(obj)):
                if self._series.pop(route, None) is not None:
                    dropped += 1
        return dropped

    def prune(self, older_than_ms: int) -> int:
        """Shed samples older than the retention horizon (folded windows
        never look back past the lookback). ``joined_ms`` keeps the ORIGINAL
        join so completeness over already-covered history stays true."""
        shed = 0
        with self._lock:
            for series in self._series.values():
                ts = series.ts
                cut = 0
                while cut < len(ts) and ts[cut] < older_than_ms:
                    cut += 1
                if cut:
                    del series.ts[:cut]
                    del series.values[:cut]
                    shed += cut
        return shed

    def freshness_seconds(self, now: float) -> Optional[float]:
        """Age of the STALEST series watermark — the push plane's lag gauge
        (None with no resident series)."""
        with self._lock:
            if not self._series:
                return None
            oldest = min(
                s.last_ts for s in self._series.values() if s.last_ts is not None
            )
        return max(now - oldest / 1000.0, 0.0)

    def stats(self) -> dict:
        with self._lock:
            buffered = sum(len(s.ts) for s in self._series.values())
            return {
                "series": len(self._series),
                "buffered_samples": buffered,
                "samples_total": self.samples_total,
                "bodies_total": self.bodies_total,
                "bytes_total": self.bytes_total,
                "decode_errors_total": self.decode_errors_total,
                "tombstones_total": self.tombstones_total,
                "rejected": dict(self.rejected),
            }
