from krr_tpu_torch.models.allocations import RecommendationValue, ResourceAllocations, ResourceType
from krr_tpu_torch.models.objects import K8sObjectData
from krr_tpu_torch.models.result import Recommendation, ResourceScan, Result, Severity
from krr_tpu_torch.models.series import FleetBatch, PackedSeries
from krr_tpu_torch.strategies.base import HistoryData, ResourceRecommendation, RunResult

__all__ = [
    "RecommendationValue",
    "ResourceAllocations",
    "ResourceType",
    "K8sObjectData",
    "Recommendation",
    "ResourceScan",
    "Result",
    "Severity",
    "FleetBatch",
    "PackedSeries",
    "HistoryData",
    "ResourceRecommendation",
    "RunResult",
]
