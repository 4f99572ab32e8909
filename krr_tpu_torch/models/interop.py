"""Build the port's fleet from plain data.

The fleet (objects plus their ragged histories) is this system's state. This
module takes it in the form any producer can hand over without importing
either package's models: ``K8sObjectData.model_dump(mode="json")`` dicts and
``{resource value: [{pod: samples}, ...]}`` histories of numpy arrays — so a
test can feed the JAX package and the port byte-for-byte identical inputs.
"""

from __future__ import annotations

from typing import Any, Mapping, Sequence

import numpy as np

from krr_tpu_torch.models.allocations import ResourceType
from krr_tpu_torch.models.objects import K8sObjectData
from krr_tpu_torch.models.series import FleetBatch, RaggedHistory


def objects_from_dicts(objects: Sequence[Mapping[str, Any]]) -> list[K8sObjectData]:
    """``K8sObjectData.model_dump(mode="json")`` dicts → port objects."""
    return [K8sObjectData.model_validate(obj) for obj in objects]


def histories_from_dicts(
    histories: Mapping[str, Sequence[Mapping[str, np.ndarray]]],
) -> dict[ResourceType, list[RaggedHistory]]:
    """``{"cpu": [{pod: samples}, ...], "memory": [...]}`` → port-keyed
    ragged histories. Sample arrays are shared, not copied."""
    return {
        ResourceType(resource): [dict(per_pod) for per_pod in per_object]
        for resource, per_object in histories.items()
    }


def fleet_batch_from_dicts(
    objects: Sequence[Mapping[str, Any]],
    histories: Mapping[str, Sequence[Mapping[str, np.ndarray]]],
) -> FleetBatch:
    """A port ``FleetBatch`` from plain object dicts and histories; every
    resource the port knows must be present, one history per object."""
    ragged = histories_from_dicts(histories)
    missing = set(ResourceType) - set(ragged)
    if missing:
        raise ValueError(f"histories lack resources: {sorted(r.value for r in missing)}")
    return FleetBatch.build(objects_from_dicts(objects), ragged)
