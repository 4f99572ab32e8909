from krr_tpu_torch.parallel.fleet import (
    gather_rows,
    pad_for_mesh,
    sharded_fleet_digest,
    sharded_fleet_topk,
    sharded_masked_max,
    sharded_percentile,
    sharded_percentile_bisect,
    transfer_to_mesh,
)
from krr_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    TIME_AXIS,
    Mesh,
    fleet_sharding,
    initialize_distributed,
    make_mesh,
    mesh_devices,
    rows_sharding,
)

__all__ = [
    "sharded_percentile_bisect",
    "sharded_masked_max",
    "transfer_to_mesh",
    "sharded_fleet_digest",
    "sharded_fleet_topk",
    "sharded_percentile",
    "gather_rows",
    "pad_for_mesh",
    "DATA_AXIS",
    "TIME_AXIS",
    "Mesh",
    "fleet_sharding",
    "initialize_distributed",
    "make_mesh",
    "mesh_devices",
    "rows_sharding",
]
