"""Host-side Decimal rounding of device results.

Behavior-compatible with ``Runner._round_value``
(`robusta_krr/core/runner.py:49-77`):

* CPU rounds **up** to 1 millicore granularity, memory rounds **up** to 1 MB
  (decimal megabyte) granularity, any other resource to 1;
* then clamps to the configured floors (CPU ``cpu_min_value`` millicores,
  memory ``memory_min_value`` MB);
* NaN passes through (it becomes ``"?"`` downstream), None passes through.

Keeping this on the host in exact Decimal arithmetic is deliberate: the ±1 %
parity gate with the reference is decided by well-defined integer ceilings, not
float rounding (SURVEY.md §7 "Host edge").
"""

from __future__ import annotations

import math
from decimal import Decimal
from typing import Optional, Union

from krr_tpu_torch.models.allocations import ResourceType

Number = Union[Decimal, float, int]


def as_decimal(value: Number) -> Decimal:
    """Convert a device result to Decimal via ``repr`` (shortest round-trip),
    so a float32-derived 0.105000004 doesn't smuggle phantom digits past the
    ceiling below."""
    if isinstance(value, Decimal):
        return value
    return Decimal(repr(float(value)))


def resource_minimum(resource: ResourceType, cpu_min_value: int, memory_min_value: int) -> Decimal:
    if resource == ResourceType.CPU:
        return Decimal(cpu_min_value) / 1000  # millicores → cores
    if resource == ResourceType.Memory:
        return Decimal(memory_min_value) * 1_000_000  # MB → bytes
    return Decimal(0)


def round_value(
    value: Optional[Number],
    resource: ResourceType,
    *,
    cpu_min_value: int = 5,
    memory_min_value: int = 10,
) -> Optional[Decimal]:
    """Ceil to resource granularity and clamp to the configured floor."""
    if value is None:
        return None

    value = as_decimal(value)
    if value.is_nan():
        return Decimal("nan")

    if resource == ResourceType.CPU:
        granularity = Decimal("0.001")  # 1 millicore
    elif resource == ResourceType.Memory:
        granularity = Decimal(1_000_000)  # 1 MB
    else:
        granularity = Decimal(1)

    rounded = Decimal(math.ceil(value / granularity)) * granularity
    return max(rounded, resource_minimum(resource, cpu_min_value, memory_min_value))
