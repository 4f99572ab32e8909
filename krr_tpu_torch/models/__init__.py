from krr_tpu_torch.models.allocations import (
    RecommendationValue,
    ResourceAllocations,
    ResourceType,
    parse_resource_value,
)
from krr_tpu_torch.models.objects import K8sObjectData
from krr_tpu_torch.models.result import Recommendation, ResourceRecommendation, ResourceScan, Result, Severity
from krr_tpu_torch.models.series import FleetBatch, PackedSeries, RaggedHistory

__all__ = [
    "RecommendationValue",
    "ResourceAllocations",
    "ResourceType",
    "parse_resource_value",
    "K8sObjectData",
    "Recommendation",
    "ResourceRecommendation",
    "ResourceScan",
    "Result",
    "Severity",
    "FleetBatch",
    "PackedSeries",
    "RaggedHistory",
]
