"""The fleet batch: usage history for every scannable object, in both the
reference-compatible ragged form and the packed device form.

This is the structure the Runner hands to strategies. Plugin strategies written
against the reference contract (`BaseStrategy.run(history_data, object_data)`)
consume the ragged view; batched strategies consume the packed arrays.
(The JAX package's ``DigestedFleet`` — history digested at ingest — arrives
with the ``digest_ingest`` slice, after the CLI and the loaders.)
"""

from __future__ import annotations

from dataclasses import dataclass, field
from decimal import Decimal
from typing import Mapping

import numpy as np

from krr_tpu_torch.models.allocations import ResourceType
from krr_tpu_torch.models.objects import K8sObjectData
from krr_tpu_torch.ops.packing import pack_ragged

#: Reference-shaped history for one object: pod name → samples.
RaggedHistory = dict[str, np.ndarray]

#: Host dtype per resource for the packed view. CPU seconds fit float32
#: exactly as far as the device math is concerned — the device casts to
#: float32 anyway, and casting f64→f32 at pack time is the identical single
#: rounding — so packing CPU at 4 bytes/sample halves the packed footprint.
#: Memory stays float64 on host: byte counts overflow float32's 24-bit
#: mantissa, and the MB scaling must divide *before* any float32 cast.
PACK_DTYPES = {ResourceType.CPU: np.float32, ResourceType.Memory: np.float64}


@dataclass
class PackedSeries:
    """Left-justified packed samples: ``values[i, :counts[i]]`` are real."""

    values: np.ndarray  # [N, T] — PACK_DTYPES[resource] on the host
    counts: np.ndarray  # [N] int32

    @property
    def capacity(self) -> int:
        return self.values.shape[1]


@dataclass
class FleetBatch:
    """Everything a strategy needs to right-size the whole fleet in one call."""

    objects: list[K8sObjectData]
    ragged: dict[ResourceType, list[RaggedHistory]]
    #: Row indices whose history fetch failed terminally (their empty
    #: histories mean UNKNOWN, not idle).
    failed_rows: "set[int]" = field(default_factory=set)
    _packed: dict[ResourceType, PackedSeries] = field(default_factory=dict)
    #: Minimum packed time capacity per resource. Row-sliced sub-batches pin
    #: this to the parent's full-fleet capacity so every chunk packs to the
    #: SAME width, and capacity-dependent decisions agree across chunks.
    _capacity: dict[ResourceType, int] = field(default_factory=dict)

    def __len__(self) -> int:
        return len(self.objects)

    def packed(self, resource: ResourceType) -> PackedSeries:
        """Packed [N, T] view for one resource (cached)."""
        if resource not in self._packed:
            values, counts = pack_ragged(
                self.ragged[resource],
                dtype=PACK_DTYPES.get(resource, np.float64),
                capacity=self._capacity.get(resource),
            )
            self._packed[resource] = PackedSeries(values=values, counts=counts)
        return self._packed[resource]

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
