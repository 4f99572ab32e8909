"""What a scan has to recommend for every container, worked out from the
raw samples in plain NumPy and ``decimal``.

The semantics are robusta-krr's ``simple`` strategy and runner, as the
configuration states them:

* CPU request: the sample at rank ``floor((n - 1) * p / 100)`` of the
  container's samples (its pods concatenated), sorted; no CPU limit;
* memory request = limit: the largest sample of any of its pods, in MB
  (the bytes divided by 10^6, then held in the configuration's precision),
  times ``1 + buffer / 100``;
* each value becomes a ``Decimal`` through the shortest ``repr`` of the
  float, is rounded up to 1 millicore or 1 MB, and is raised to the floor
  (5 millicores, 10 MB).

``precision`` is the float type the samples and results are held in:
``"float32"`` as the configuration states, or ``"bfloat16"``, the control
that a sound comparison has to fail.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from decimal import Decimal
from fractions import Fraction

import numpy as np

MILLICORE = Decimal("0.001")
MEGABYTE = Decimal(1_000_000)


@dataclass(frozen=True)
class Answers:
    """Per container: the unrounded CPU percentile (float) and the rendered
    CPU request, memory request and memory limit (``Decimal``; ``"?"`` for
    a container without samples)."""

    cpu_value: np.ndarray
    cpu_request: list
    memory_request: list
    memory_limit: list


def to_precision(values: np.ndarray, precision: str) -> np.ndarray:
    """``values`` as float32, or rounded to the nearest bfloat16 (ties to
    even) and held as float32."""
    values = np.asarray(values, dtype=np.float32)
    if precision == "float32":
        return values
    if precision != "bfloat16":
        raise ValueError(f"unknown precision {precision!r}")
    bits = values.view(np.uint32)
    # No carry leaves 32 bits below the negative NaNs (0xFFFF8000 and up).
    rounded = (bits + np.uint32(0x7FFF) + ((bits >> 16) & np.uint32(1))) & np.uint32(0xFFFF0000)
    return rounded.view(np.float32)


def _ceil_to(value: Decimal, granularity: Decimal, floor: Decimal) -> Decimal:
    return max(Decimal(math.ceil(value / granularity)) * granularity, floor)


def _as_decimal(value) -> Decimal:
    return Decimal(repr(float(value)))


def recommend(
    cpu: np.ndarray,
    memory: np.ndarray,
    replicas: np.ndarray,
    pod_samples: np.ndarray,
    *,
    cpu_percentile: "int | str" = 99,
    memory_buffer_percentage: "int | str" = 5,
    cpu_min_millicores: int = 5,
    memory_min_mb: int = 10,
    precision: str = "float32",
) -> Answers:
    """Every container's answers from the flat raw samples (pods in
    container order, ``pod_samples`` each; ``replicas`` pods a container)."""
    pod_samples = np.asarray(pod_samples, dtype=np.int64)
    pod_starts = np.concatenate([[0], np.cumsum(pod_samples)[:-1]]).astype(np.int64)
    first_pod = np.concatenate([[0], np.cumsum(replicas)[:-1]]).astype(np.int64)
    row_start = pod_starts[first_pod]
    row_samples = np.add.reduceat(pod_samples, first_pod)

    q = Fraction(str(cpu_percentile))
    cpu_low = to_precision(cpu, precision)
    cpu_value = np.empty(len(replicas), dtype=np.float32)
    for i, (start, n) in enumerate(zip(row_start.tolist(), row_samples.tolist())):
        rank = min(max(math.floor((n - 1) * q / 100), 0), n - 1)
        cpu_value[i] = np.partition(cpu_low[start : start + n], rank)[rank]

    pod_max = np.maximum.reduceat(np.asarray(memory, dtype=np.float64), pod_starts)
    row_max = np.maximum.reduceat(pod_max, first_pod)
    memory_mb = to_precision(row_max / 1_000_000.0, precision)

    cpu_floor = Decimal(cpu_min_millicores) * MILLICORE
    memory_floor = Decimal(memory_min_mb) * MEGABYTE
    buffer = 1 + Decimal(str(memory_buffer_percentage)) / 100
    cpu_request = [_ceil_to(_as_decimal(v), MILLICORE, cpu_floor) for v in cpu_value.tolist()]
    memory_value = [_ceil_to(_as_decimal(v) * MEGABYTE * buffer, MEGABYTE, memory_floor) for v in memory_mb.tolist()]
    return Answers(cpu_value=cpu_value, cpu_request=cpu_request, memory_request=memory_value,
                   memory_limit=list(memory_value))
