"""Resource types and request/limit allocations.

Behavior-compatible with `robusta_krr/core/models/allocations.py:13-81`
(ported to pydantic v2, which is what this image ships):

* ``ResourceType`` is a string enum {cpu, memory}; adding a member here makes
  the new resource flow through the whole pipeline (severity, formatters, CLI).
* ``RecommendationValue`` is ``Decimal | "?" | None`` — ``None`` means "not
  set / not recommended", ``"?"`` means "unknown" (e.g. no usage data), and a
  Decimal is an absolute value in base units (cores / bytes).
* Parsing accepts k8s quantity strings (``"100m"``, ``"128Mi"``); ``NaN``
  Decimals normalize to ``"?"``.
* JSON serialization renders Decimals as floats (matching the reference's
  pydantic-v1 output so downstream consumers of ``-f json`` see numbers).
"""

from __future__ import annotations

import enum
from decimal import Decimal
from typing import Any, Literal, Mapping, Union

import pydantic as pd
from pydantic import ConfigDict, field_validator
from pydantic.functional_serializers import PlainSerializer
from typing_extensions import Annotated

from krr_tpu_torch.utils import resource_units


class ResourceType(str, enum.Enum):
    """The resource dimensions being recommended. New members are automatically
    supported end-to-end (same contract as the reference's enum comment)."""

    CPU = "cpu"
    Memory = "memory"


def _decimal_to_json(value: Decimal) -> Union[float, str]:
    # NaN should have been normalized to "?" by validators; guard anyway since
    # strict JSON has no NaN literal.
    if value.is_nan():
        return "?"
    return float(value)


#: Decimal that serializes to a JSON number.
JsonDecimal = Annotated[Decimal, PlainSerializer(_decimal_to_json, when_used="json")]

RecommendationValue = Union[JsonDecimal, Literal["?"], None]


def parse_resource_value(value: Union[Decimal, float, int, str, None]) -> RecommendationValue:
    """Normalize a raw allocation value: strings parse as k8s quantities,
    NaN becomes ``"?"``, None passes through."""
    if value is None:
        return None
    if isinstance(value, str):
        if value == "?":
            return "?"
        return resource_units.parse(value)
    if not isinstance(value, Decimal):
        value = Decimal(str(value))
    if value.is_nan():
        return "?"
    return value


class ResourceAllocations(pd.BaseModel):
    """Requests and limits per resource type (current or recommended)."""

    model_config = ConfigDict(frozen=False)

    requests: dict[ResourceType, RecommendationValue]
    limits: dict[ResourceType, RecommendationValue]

    @field_validator("requests", "limits", mode="before")
    @classmethod
    def _parse_values(cls, value: Mapping[Any, Any]) -> dict[Any, Any]:
        return {rt: parse_resource_value(v) for rt, v in value.items()}
