from krr_tpu_torch.core.config import Config
from krr_tpu_torch.core.rounding import round_value

__all__ = ["Config", "round_value"]
