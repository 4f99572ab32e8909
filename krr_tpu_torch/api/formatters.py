from krr_tpu_torch.formatters.base import BaseFormatter

__all__ = ["BaseFormatter"]
