from krr_tpu_torch.ops import packing, quantile, selection
from krr_tpu_torch.ops.packing import pack_ragged

__all__ = ["packing", "quantile", "selection", "pack_ragged"]
