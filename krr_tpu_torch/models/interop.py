"""Build the port's fleet and sketch state from plain data.

The fleet (objects plus their ragged histories) and the mergeable sketch
state are this system's state. This module takes them in the form any
producer can hand over without importing either package's models:
``K8sObjectData.model_dump(mode="json")`` dicts, ``{resource value:
[{pod: samples}, ...]}`` histories of numpy arrays, and a sketch's fields as
numpy arrays — so a test can feed the JAX package and the port byte-for-byte
identical inputs, and a digest or top-K sketch built by one package merges
with one built by the other.
"""

from __future__ import annotations

from typing import Any, Mapping, Sequence

import numpy as np

import torch

from krr_tpu_torch.models.allocations import ResourceType
from krr_tpu_torch.models.objects import K8sObjectData
from krr_tpu_torch.models.series import FleetBatch, RaggedHistory
from krr_tpu_torch.ops.digest import Digest
from krr_tpu_torch.ops.topk_sketch import TopKSketch


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


def _f32(array: np.ndarray, device: "torch.device | str") -> torch.Tensor:
    return torch.tensor(np.asarray(array, dtype=np.float32), device=device)  # a copy: the source may be read-only


def digest_from_arrays(
    counts: np.ndarray, total: np.ndarray, peak: np.ndarray, *, device: "torch.device | str"
) -> Digest:
    """A digest's ``counts [N, B]``, ``total [N]`` and ``peak [N]`` (as
    numpy, e.g. ``np.asarray`` of a JAX-built ``Digest``'s fields) → the
    port's :class:`~krr_tpu_torch.ops.digest.Digest` on ``device``."""
    return Digest(counts=_f32(counts, device), total=_f32(total, device), peak=_f32(peak, device))


def topk_from_arrays(values: np.ndarray, total: np.ndarray, *, device: "torch.device | str") -> TopKSketch:
    """A top-K sketch's ``values [N, K]`` and ``total [N]`` (as numpy) → the
    port's :class:`~krr_tpu_torch.ops.topk_sketch.TopKSketch` on ``device``."""
    return TopKSketch(values=_f32(values, device), total=_f32(total, device))
