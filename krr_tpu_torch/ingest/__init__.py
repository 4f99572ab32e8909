"""Push-based metrics ingest plane.

A copy of `krr_tpu/ingest/__init__.py` over the port's modules.

A Prometheus **remote-write** listener (`listener.py`) feeds decoded samples
through the series router (`router.py`, the push twin of the pull path's
PromQL label filters) into grid-aligned per-series buffers (`plane.py`). At
steady state a serve tick folds only samples received since the last tick and
issues ZERO range queries; the range path remains the cold-start seed, the
per-series-watermark gap backfill, and the periodic divergence audit's ground
truth (`--ingest-verify-interval`).
"""

from krr_tpu_torch.ingest.listener import RemoteWriteListener
from krr_tpu_torch.ingest.plane import IngestPlane
from krr_tpu_torch.ingest.router import CPU_METRIC, MEM_METRIC, route_record

__all__ = [
    "CPU_METRIC",
    "MEM_METRIC",
    "IngestPlane",
    "RemoteWriteListener",
    "route_record",
]
