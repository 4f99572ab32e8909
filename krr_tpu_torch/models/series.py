"""The fleet batch: usage history for every scannable object, in both the
reference-compatible ragged form and the packed device form.

This is the structure the Runner hands to strategies. Plugin strategies written
against the reference contract (`BaseStrategy.run(history_data, object_data)`)
consume the ragged view; batched strategies consume the packed arrays.
``DigestedFleet`` is the digest-ingest form: history digested at parse time
(a copy of the JAX package's, with the same float64 arrays).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from decimal import Decimal
from typing import Mapping

import numpy as np

from krr_tpu_torch.models.allocations import ResourceType
from krr_tpu_torch.models.objects import K8sObjectData
from krr_tpu_torch.ops.packing import pack_ragged_with_workers

#: Reference-shaped history for one object: pod name → samples.
RaggedHistory = dict[str, np.ndarray]

#: Host dtype per resource for the unscaled packed view. CPU seconds fit
#: float32 exactly as far as the device math is concerned — the device casts
#: to float32 anyway, and casting f64→f32 at pack time is the identical single
#: rounding — so packing CPU at 4 bytes/sample halves the packed footprint.
#: Memory's raw view stays float64 (the interop view): byte counts overflow
#: float32's 24-bit mantissa, so the MB scaling must divide *before* any
#: float32 cast. The strategies never build it: they ask for memory with a
#: scale (``FleetBatch.packed_scaled``), and the pack's own fill
#: divides each sample in float64 and rounds it once into a float32 matrix.
PACK_DTYPES = {ResourceType.CPU: np.float32, ResourceType.Memory: np.float64}


@dataclass
class PackedSeries:
    """Left-justified packed samples: ``values[i, :counts[i]]`` are real."""

    values: np.ndarray  # [N, T] — PACK_DTYPES[resource] on the host; float32 when scaled
    counts: np.ndarray  # [N] int32
    #: Threads that filled ``values`` (1: the serial path).
    workers: int = 1

    @property
    def capacity(self) -> int:
        return self.values.shape[1]


@dataclass
class DigestedFleet:
    """Pre-digested usage history: the O(buckets) ingest form.

    Produced by the fused native parse+digest path
    (`krr_tpu_torch.integrations.native.parse_matrix_digest`) when the strategy asks
    for digest ingest: raw sample arrays are never materialized — each
    response's samples fold straight into per-object log-bucket digests at
    parse time. CPU carries full bucket counts (any-percentile queries);
    memory needs only exact totals/peaks (max × buffer).
    """

    objects: list[K8sObjectData]
    gamma: float
    min_value: float
    cpu_counts: np.ndarray  # [N, num_buckets] float64 bucket counts
    cpu_total: np.ndarray  # [N] float64
    cpu_peak: np.ndarray  # [N] float64, -inf when empty
    mem_total: np.ndarray  # [N] float64
    mem_peak: np.ndarray  # [N] float64 bytes, -inf when empty
    #: Row indices whose fetch TERMINALLY failed (batched query + fallback
    #: both exhausted) and degraded to the empty state. One-shot scans
    #: render them UNKNOWN and move on; an incremental consumer (the serve
    #: scheduler) must instead treat the whole window as unfetched — folding
    #: the empty rows and advancing its cursor would silently drop those
    #: samples from the accumulated history.
    failed_rows: "set[int]" = field(default_factory=set)

    def __len__(self) -> int:
        return len(self.objects)

    def merge_cpu_row(self, i: int, counts: np.ndarray, total: float, peak: float) -> None:
        """Fold one CPU series digest into object ``i`` (exact count add / peak max)."""
        self.cpu_counts[i] += counts
        self.cpu_total[i] += total
        self.cpu_peak[i] = max(self.cpu_peak[i], peak)

    def merge_mem_row(self, i: int, total: float, peak: float) -> None:
        """Fold one memory series' count/max into object ``i``."""
        self.mem_total[i] += total
        self.mem_peak[i] = max(self.mem_peak[i], peak)

    def clear_cpu_rows(self, indices: "list[int]") -> None:
        """Reset CPU state for ``indices`` to the empty-digest state — the
        failed-query unwind: streamed fetches fold windows into these rows
        incrementally, so a mid-query failure must clear its partial folds
        before any retry or per-workload fallback refetches (else samples
        double-count). Sound because each (namespace, resource) query owns
        a disjoint row set."""
        rows = np.asarray(indices, dtype=np.int64)
        self.cpu_counts[rows] = 0.0
        self.cpu_total[rows] = 0.0
        self.cpu_peak[rows] = -np.inf

    def clear_mem_rows(self, indices: "list[int]") -> None:
        """Memory-resource counterpart of :meth:`clear_cpu_rows`."""
        rows = np.asarray(indices, dtype=np.int64)
        self.mem_total[rows] = 0.0
        self.mem_peak[rows] = -np.inf

    def merge_from(self, sub: "DigestedFleet", indices: "list[int] | np.ndarray") -> None:
        """Fold a sub-fleet (same spec, ``sub``'s row ``j`` → our row
        ``indices[j]``) into this fleet — the cross-cluster merge and the
        scan pipeline's per-batch fold. Vectorized: a contiguous ascending
        ``indices`` range (the common per-batch layout) merges as slice ops
        at memory bandwidth; arbitrary orders scatter via ``np.add.at`` /
        ``np.maximum.at`` (exact for repeated targets too). Either way the
        arithmetic is the per-row merge's — integer-valued count adds and
        peak maxes — so fold order across batches cannot change the result."""
        rows = np.asarray(indices, dtype=np.int64)
        if rows.size and np.array_equal(rows, np.arange(rows[0], rows[0] + rows.size)):
            window = slice(int(rows[0]), int(rows[0]) + rows.size)
            self.cpu_counts[window] += sub.cpu_counts
            self.cpu_total[window] += sub.cpu_total
            np.maximum(self.cpu_peak[window], sub.cpu_peak, out=self.cpu_peak[window])
            self.mem_total[window] += sub.mem_total
            np.maximum(self.mem_peak[window], sub.mem_peak, out=self.mem_peak[window])
        else:
            np.add.at(self.cpu_counts, rows, sub.cpu_counts)
            np.add.at(self.cpu_total, rows, sub.cpu_total)
            np.maximum.at(self.cpu_peak, rows, sub.cpu_peak)
            np.add.at(self.mem_total, rows, sub.mem_total)
            np.maximum.at(self.mem_peak, rows, sub.mem_peak)
        self.failed_rows.update(int(rows[j]) for j in sub.failed_rows)

    @classmethod
    def empty(cls, objects: list[K8sObjectData], gamma: float, min_value: float, num_buckets: int) -> "DigestedFleet":
        n = len(objects)
        return cls(
            objects=objects,
            gamma=gamma,
            min_value=min_value,
            cpu_counts=np.zeros((n, num_buckets), dtype=np.float64),
            cpu_total=np.zeros(n, dtype=np.float64),
            cpu_peak=np.full(n, -np.inf, dtype=np.float64),
            mem_total=np.zeros(n, dtype=np.float64),
            mem_peak=np.full(n, -np.inf, dtype=np.float64),
        )


@dataclass
class FleetBatch:
    """Everything a strategy needs to right-size the whole fleet in one call."""

    objects: list[K8sObjectData]
    ragged: dict[ResourceType, list[RaggedHistory]]
    #: Row indices whose history fetch failed terminally (their empty
    #: histories mean UNKNOWN, not idle) — same contract as
    #: ``DigestedFleet.failed_rows``.
    failed_rows: "set[int]" = field(default_factory=set)
    #: Packed views by (resource, scale).
    _packed: dict[tuple[ResourceType, float], PackedSeries] = field(default_factory=dict)
    #: Minimum packed time capacity per resource. Row-sliced sub-batches pin
    #: this to the parent's full-fleet capacity so every chunk packs to the
    #: SAME width, and capacity-dependent decisions agree across chunks.
    _capacity: dict[ResourceType, int] = field(default_factory=dict)

    def __len__(self) -> int:
        return len(self.objects)

    def packed(self, resource: ResourceType) -> PackedSeries:
        """Packed [N, T] view for one resource, in ``PACK_DTYPES[resource]``
        (cached)."""
        return self._pack(resource, 1.0)

    def packed_scaled(self, resource: ResourceType, scale: float) -> PackedSeries:
        """Packed [N, T] float32 view of ``samples / scale`` for one resource
        (cached apart from :meth:`packed`): the fill itself divides in
        float64 and rounds once (`krr_tpu_torch.ops.packing.pack_ragged`),
        so no unscaled matrix is built."""
        return self._pack(resource, scale)

    def _pack(self, resource: ResourceType, scale: float) -> PackedSeries:
        key = (resource, scale)
        if key not in self._packed:
            values, counts, workers = pack_ragged_with_workers(
                self.ragged[resource],
                dtype=PACK_DTYPES.get(resource, np.float64) if scale == 1.0 else np.float32,
                capacity=self._capacity.get(resource),
                scale=scale,
            )
            self._packed[key] = PackedSeries(values=values, counts=counts, workers=workers)
        return self._packed[key]

    def _row_length(self, resource: ResourceType, i: int) -> int:
        return sum(np.asarray(s).size for s in self.ragged[resource][i].values())

    def row_slice(self, start: int, stop: int) -> "FleetBatch":
        """A sub-batch of rows ``[start, stop)`` — objects and ragged views
        share the originals; the packed cache is fresh, so the sub-batch packs
        only its own rows. The packed capacity is pinned to the parent's
        full-fleet capacity (see ``_capacity``)."""
        capacity = {
            r: self._capacity.get(
                r, max((self._row_length(r, i) for i in range(len(self.objects))), default=0)
            )
            for r in self.ragged
        }
        return FleetBatch(
            objects=self.objects[start:stop],
            ragged={r: series[start:stop] for r, series in self.ragged.items()},
            _capacity=capacity,
        )

    def history_for(self, index: int) -> dict[ResourceType, dict[str, list[Decimal]]]:
        """Reference-shaped ``HistoryData`` for one object (Decimal samples) —
        the compatibility path for per-object plugin strategies."""
        return {
            resource: {pod: [Decimal(repr(float(v))) for v in samples] for pod, samples in per_object[index].items()}
            for resource, per_object in self.ragged.items()
        }

    @classmethod
    def build(
        cls,
        objects: list[K8sObjectData],
        histories: Mapping[ResourceType, list[RaggedHistory]],
    ) -> "FleetBatch":
        if not all(len(objects) == len(v) for v in histories.values()):
            raise ValueError("every resource needs exactly one history per object")
        return cls(objects=objects, ragged=dict(histories))

    @classmethod
    def from_history(
        cls,
        history_data: Mapping[ResourceType, Mapping[str, "list[Decimal] | np.ndarray"]],
        object_data: K8sObjectData,
    ) -> "FleetBatch":
        """Wrap one object's reference-shaped ``HistoryData`` into a singleton
        batch — the per-object → batched compatibility shim."""
        return cls.build(
            [object_data],
            {
                resource: [
                    {
                        pod: np.asarray([float(v) for v in samples], dtype=np.float64)
                        for pod, samples in history_data.get(resource, {}).items()
                    }
                ]
                for resource in ResourceType
            },
        )
