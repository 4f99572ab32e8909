from krr_tpu_torch.strategies.base import BaseStrategy, BatchedStrategy, StrategySettings

__all__ = ["BaseStrategy", "BatchedStrategy", "StrategySettings"]
