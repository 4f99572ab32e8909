from krr_tpu_torch.formatters.base import BaseFormatter
from krr_tpu_torch.formatters.machine import JSONFormatter, PPrintFormatter, YAMLFormatter
from krr_tpu_torch.formatters.table import TableFormatter

__all__ = ["BaseFormatter", "JSONFormatter", "PPrintFormatter", "YAMLFormatter", "TableFormatter"]
