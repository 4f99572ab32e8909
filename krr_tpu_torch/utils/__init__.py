from krr_tpu_torch.utils import resource_units
from krr_tpu_torch.utils.device import resolve_device
from krr_tpu_torch.utils.logging import KrrLogger

__all__ = ["resource_units", "resolve_device", "KrrLogger"]
