from krr_tpu_torch.strategies.base import (
    AnyStrategy,
    BaseStrategy,
    BatchedStrategy,
    HistoryData,
    ResourceRecommendation,
    RunResult,
    StrategySettings,
)
from krr_tpu_torch.strategies.simple import SimpleStrategy, SimpleStrategySettings
from krr_tpu_torch.strategies.tdigest import TDigestStrategy, TDigestStrategySettings

__all__ = [
    "AnyStrategy",
    "BaseStrategy",
    "BatchedStrategy",
    "HistoryData",
    "ResourceRecommendation",
    "RunResult",
    "StrategySettings",
    "SimpleStrategy",
    "SimpleStrategySettings",
    "TDigestStrategy",
    "TDigestStrategySettings",
]
