"""Scan results, severity scoring, and the formatter entry point.

Severity semantics are behavior-compatible with
`robusta_krr/core/models/result.py:14-89`:

* relative diff ``(current - recommended) / recommended``;
  ``> 1.0`` or ``< -0.5``  → CRITICAL;
  ``> 0.5`` or ``< -0.25`` → WARNING; else GOOD;
* both values None → OK; exactly one None → WARNING; any ``"?"`` → UNKNOWN;
* per-scan severity is the worst cell across {cpu, memory} × {requests,
  limits}, scanned in the order CRITICAL → WARNING → OK → GOOD → UNKNOWN.

One deliberate divergence: the reference's ``Result.score`` is a stub (its
``__percentage_difference`` returns the constant 1, so every non-empty result
scores ≈ 99 — `robusta_krr/core/models/result.py:115-127`).
Here the percentage difference is computed for real (clipped absolute relative
difference), feeding the same ``100 - avg/…`` aggregation shape.
"""

from __future__ import annotations

import enum
import itertools
from decimal import Decimal
from typing import Any, Union

import pydantic as pd

from krr_tpu_torch.models.allocations import RecommendationValue, ResourceAllocations, ResourceType
from krr_tpu_torch.models.objects import K8sObjectData


class Severity(str, enum.Enum):
    """The severity of a recommendation cell (or a whole scan)."""

    UNKNOWN = "UNKNOWN"
    GOOD = "GOOD"
    OK = "OK"
    WARNING = "WARNING"
    CRITICAL = "CRITICAL"

    @property
    def color(self) -> str:
        # "gray" is not a parseable rich color, so OK cells render UNSTYLED
        # on every output path — a deliberate parity quirk: the reference
        # ships the same string (`result.py:28`) with the same effect.
        return {
            Severity.UNKNOWN: "dim",
            Severity.GOOD: "green",
            Severity.OK: "gray",
            Severity.WARNING: "yellow",
            Severity.CRITICAL: "red",
        }[self]

    @classmethod
    def calculate(cls, current: RecommendationValue, recommended: RecommendationValue) -> "Severity":
        if isinstance(current, str) or isinstance(recommended, str):
            return cls.UNKNOWN
        if current is None and recommended is None:
            return cls.OK
        if current is None or recommended is None:
            return cls.WARNING

        # Guard the reference doesn't have (it would raise DivisionByZero,
        # reachable with --cpu-min-value 0 and an idle container): a zero
        # recommendation with a non-zero allocation is maximal over-provisioning.
        if recommended == 0:
            return cls.GOOD if current == 0 else cls.CRITICAL

        diff = (current - recommended) / recommended
        if diff > 1 or diff < Decimal("-0.5"):
            return cls.CRITICAL
        if diff > Decimal("0.5") or diff < Decimal("-0.25"):
            return cls.WARNING
        return cls.GOOD


#: Scan order used to pick a whole-object severity: the first severity in this
#: list that appears in any of the four cells wins.
_SEVERITY_PRECEDENCE = [Severity.CRITICAL, Severity.WARNING, Severity.OK, Severity.GOOD, Severity.UNKNOWN]


class Recommendation(pd.BaseModel):
    value: RecommendationValue
    severity: Severity


class ResourceRecommendation(pd.BaseModel):
    """Processed recommendations with per-cell severities (output shape)."""

    requests: dict[ResourceType, Recommendation]
    limits: dict[ResourceType, Recommendation]


class ResourceScan(pd.BaseModel):
    object: K8sObjectData
    recommended: ResourceRecommendation
    severity: Severity
    #: Set by the serve scheduler on quarantined workloads (degraded ticks):
    #: unix time of the last usage window actually folded for this object —
    #: the recommendation is carried forward from digests that old. None
    #: (the overwhelmingly common case, and always for one-shot scans)
    #: means fresh; the key is OMITTED from dumps then, so the fleet-scale
    #: JSON renders pay nothing for a feature that is idle almost always.
    stale_since: "float | None" = None

    @pd.model_serializer(mode="wrap")
    def _omit_fresh_stale_mark(self, handler):
        out = handler(self)
        if isinstance(out, dict) and out.get("stale_since") is None:
            out.pop("stale_since", None)
        return out

    @classmethod
    def calculate(cls, object: K8sObjectData, recommendation: ResourceAllocations) -> "ResourceScan":
        processed = ResourceRecommendation(requests={}, limits={})

        for resource in ResourceType:
            for selector in ("requests", "limits"):
                current = getattr(object.allocations, selector).get(resource)
                recommended = getattr(recommendation, selector).get(resource)
                cell = Recommendation(value=recommended, severity=Severity.calculate(current, recommended))
                getattr(processed, selector)[resource] = cell

        for severity in _SEVERITY_PRECEDENCE:
            for selector in ("requests", "limits"):
                for cell in getattr(processed, selector).values():
                    if cell.severity == severity:
                        return cls(object=object, recommended=processed, severity=severity)

        return cls(object=object, recommended=processed, severity=Severity.UNKNOWN)


def _percentage_difference(current: RecommendationValue, recommended: RecommendationValue) -> float:
    """Absolute relative difference between allocation and recommendation, in
    percent, clipped to [0, 200]. Cells without enough information contribute 0.

    (Implemented for real — the reference stubs this to the constant 1,
    `robusta_krr/core/models/result.py:115-127`.)
    """
    if isinstance(current, str) or isinstance(recommended, str):
        return 0.0
    if current is None or recommended is None:
        return 0.0
    if recommended == 0:
        return 200.0
    return float(min(abs((current - recommended) / recommended) * 100, Decimal(200)))


class Result(pd.BaseModel):
    scans: list[ResourceScan]
    score: int = 0
    resources: list[str] = ["cpu", "memory"]

    def __init__(self, *args: Any, **kwargs: Any) -> None:
        super().__init__(*args, **kwargs)
        self.score = self.__calculate_score()

    def format(self, formatter: Union[type, str], **kwargs: Any) -> Any:
        """Render through a formatter found by name in the registry."""
        from krr_tpu_torch.formatters.base import BaseFormatter

        formatter_type = BaseFormatter.find(formatter) if isinstance(formatter, str) else formatter
        return formatter_type(**kwargs).format(self)

    def __calculate_score(self) -> int:
        if not self.scans:
            return 0
        total = 0.0
        for scan, resource in itertools.product(self.scans, ResourceType):
            # .get: a container may have no allocation set, and a strategy may
            # omit a resource entirely (empty history) — both contribute 0.
            requests_cell = scan.recommended.requests.get(resource)
            limits_cell = scan.recommended.limits.get(resource)
            total += _percentage_difference(
                scan.object.allocations.requests.get(resource),
                requests_cell.value if requests_cell is not None else None,
            )
            total += _percentage_difference(
                scan.object.allocations.limits.get(resource),
                limits_cell.value if limits_cell is not None else None,
            )
        # Average percentage diff per cell (2 resources × 2 selectors), mapped
        # onto 0-100: a fleet perfectly at its recommendations scores 100.
        avg = total / (len(self.scans) * len(ResourceType) * 2)
        return int(max(0.0, round(100 - avg / 2, 2)))
