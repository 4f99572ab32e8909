"""The ``simple`` strategy: p99-CPU request, max+buffer memory request/limit.

Port of `krr_tpu/strategies/simple.py` (behavior-compatible with the
reference's `strategies/simple.py`, computing the true sorted percentile the
reference documents). The memory buffer multiplication and all rounding stay
on the host in exact Decimal arithmetic. The window reaches the device as
`krr_tpu_torch.strategies.window` places it; this module reduces its CPU
rows on each placement, each selecting the same sample:

* resident: the window's row blocks (`krr_tpu_torch.strategies.window.
  ResidentWindow`), each reduced into its rows of one ``[2, N]`` result —
  bit-space bisection for the CPU percentile, masked max for memory, as
  :func:`krr_tpu_torch.ops.cuda_select.fleet_exact` does for a whole
  window — with one readback;
* host stream: the exact top-K sketch when the percentile's rank-from-the-top
  fits ``exact_sketch_budget``, else the streamed radix select;
* mesh: ``bisect_select`` per row block, or the time-sharded radix select
  (``radix_digit_hist`` per shard and digit), merged exactly; a mesh that
  spans processes (`krr_tpu_torch.parallel.initialize_distributed`) merges
  across them by collectives, and every rank renders every row.

The legs are stages of the scan trace (``strategy.obs``,
`krr_tpu_torch.obs.device`): the window's, then ``quantile``
(``path=resident``, holding the blocks' ``h2d`` stages; ``host_stream`` or
``mesh``) and ``round``, each fenced
when the tracer records; a streamed ``quantile`` carries the stream's
totals. With ``profile_dir`` the device compute runs under ``torch.profiler``.
"""

from __future__ import annotations

from decimal import Decimal
from functools import partial
from typing import Optional

import numpy as np
import pydantic as pd
import torch

from krr_tpu_torch.core.rounding import as_decimal
from krr_tpu_torch.models.allocations import ResourceType
from krr_tpu_torch.models.series import FleetBatch, PackedSeries
from krr_tpu_torch.ops import topk_sketch as topk_ops
from krr_tpu_torch.ops.cuda_select import masked_max_cuda, masked_percentile_bisect_cuda
from krr_tpu_torch.ops.selection import masked_percentile_bisect_from_host
from krr_tpu_torch.parallel import sharded_percentile_bisect
from krr_tpu_torch.strategies.base import BatchedStrategy, ResourceRecommendation, RunResult, StrategySettings
from krr_tpu_torch.strategies.window import FleetWindow
from krr_tpu_torch.utils.device import resolve_device

#: Time-chunk width for host-streamed builds in the simple strategy.
HOST_STREAM_CHUNK = 8192


def finalize_fleet(
    cpu_values: np.ndarray,
    memory_mb_values: np.ndarray,
    memory_buffer_percentage: Decimal,
    cpu_limit: Optional[np.ndarray] = None,
) -> list[RunResult]:
    """Host Decimal edge: convert device reductions into per-object raw
    recommendations.

    * CPU: request = the selected percentile sample; **no limit** (reference
      `simple.py:47`).
    * Memory: request = limit = max × (1 + buffer/100), multiplied in Decimal
      (reference `simple.py:24-29`).
    """
    buffer_factor = 1 + memory_buffer_percentage / 100
    results: list[RunResult] = []
    for i in range(len(cpu_values)):
        cpu_request = as_decimal(cpu_values[i])
        mem_mb = as_decimal(memory_mb_values[i])
        mem_value = mem_mb * 1_000_000 * buffer_factor if not mem_mb.is_nan() else Decimal("nan")
        results.append(
            {
                ResourceType.CPU: ResourceRecommendation(
                    request=cpu_request,
                    limit=as_decimal(cpu_limit[i]) if cpu_limit is not None else None,
                ),
                ResourceType.Memory: ResourceRecommendation(request=mem_value, limit=mem_value),
            }
        )
    return results


def exact_topk_k(capacity: int, q: float, budget: int) -> Optional[int]:
    """K for the exact top-K sketch, or None when it exceeds ``budget`` and
    the caller must take another path (the histogram digest for tdigest).
    The single cut-over decision site, shared by every strategy and build
    flavor, so the paths can never disagree about which sketch serves a
    percentile."""
    k = topk_ops.required_k(capacity, q)
    return k if 0 < k <= budget else None


class SimpleStrategySettings(StrategySettings):
    cpu_percentile: Decimal = pd.Field(
        Decimal(99), gt=0, le=100, description="The percentile to use for the CPU recommendation."
    )
    memory_buffer_percentage: Decimal = pd.Field(
        Decimal(5), gt=0, description="The percentage of added buffer to the peak memory usage for memory recommendation."
    )
    use_mesh: bool = pd.Field(True, description="Shard the fleet over all devices when more than one is available.")
    mesh_time_axis: int = pd.Field(
        1, ge=1, description="Devices on the time (sequence-parallel) mesh axis; the rest shard containers."
    )
    device: str = pd.Field(
        "cuda",
        description=(
            "Device to compute on: 'cuda' (the hand-written kernels; raises without a card) "
            "or 'cpu' (the plain PyTorch versions)."
        ),
    )
    profile_dir: Optional[str] = pd.Field(
        None,
        description=(
            "Write a torch.profiler trace of the fleet compute (CPU and CUDA activities: the "
            "hand-written kernels as CUPTI sees them, the copies, the host ops) as Chrome trace "
            "JSON into this directory."
        ),
    )
    host_stream_mb: int = pd.Field(
        0,
        ge=-1,
        description=(
            "Stream the packed window from host memory in double-buffered time chunks when its "
            "float32 footprint exceeds this many MB per device, so the full matrix never lives in "
            "device memory. 0 = auto (stream past ~40% of device memory); -1 = never stream."
        ),
    )
    exact_sketch_budget: int = pd.Field(
        8192,
        ge=0,
        description=(
            "Max top-K sketch width for the exact high-percentile sketch "
            "(krr_tpu_torch.ops.topk_sketch): tdigest's --exact_upgrade takes it when the "
            "configured cpu_percentile's rank-from-the-top fits, and the histogram digest past "
            "it. 0 disables the top-K path."
        ),
    )


class SimpleStrategy(BatchedStrategy[SimpleStrategySettings]):
    """Exact batched reductions: bit-space bisection for the CPU percentile
    (bit-identical to a sort-and-index, on the mesh too) and the masked max
    for memory."""

    __display_name__ = "simple"
    #: Memory is max × 1.05: only each pod's exact max matters, so sources
    #: may ingest memory through the stats route — identical output, and the
    #: fleet batch ships [rows × pods] to the device instead of [rows × T].
    stats_only_resources = frozenset({ResourceType.Memory})

    def __init__(self, settings: SimpleStrategySettings):
        super().__init__(settings)
        self.device = resolve_device(settings.device)
        #: The last streamed ``run_batch``'s :class:`StreamStats` as a
        #: dict; None after a resident one.
        self.stream_stats: Optional[dict] = None


    def _streamed_percentile(self, cpu: PackedSeries, q: float, **where):
        """CPU's percentile with the window streamed from host: the one-pass
        exact top-K sketch when the rank-from-the-top fits, the three-pass
        streamed radix select otherwise — both select the sample the
        resident path selects. It may still be on the device (a tensor)."""
        k = exact_topk_k(cpu.capacity, q, self.settings.exact_sketch_budget)
        if k is not None:
            sketch = topk_ops.build_from_host(cpu.values, cpu.counts, k, HOST_STREAM_CHUNK, **where)
            return topk_ops.percentile(sketch, q)
        # Mid-range percentile: no bounded exact sketch.
        return masked_percentile_bisect_from_host(cpu.values, cpu.counts, q, HOST_STREAM_CHUNK, **where)

    def _run_mesh(self, window: FleetWindow, q: float) -> tuple:
        """The mesh ``quantile`` stage (`krr_tpu/strategies/simple.py:
        255-262`): the sharded percentile and the sharded memory max, each
        returned to the host."""
        with self.obs.stage("quantile", rows=len(window.batch), path="mesh"):
            cpu_p = sharded_percentile_bisect(window.cpu.values, window.cpu.counts, q, window.mesh)
            return cpu_p, window.mesh_memory_max()

    def _run_resident(self, window: FleetWindow, q: float) -> tuple:
        """The resident path: each resource's ``cast`` stage, then the
        ``quantile`` stage (carrying the window's ``blocks``): the CPU
        percentile of each CPU block into its rows of a ``[2, N]`` result,
        memory's max of each memory block into theirs, and one readback
        (the JAX package's ``fleet_exact`` contract)."""
        rows, resident = len(window.batch), window.resident()
        out = torch.empty((2, rows), dtype=torch.float32, device=self.device)
        with self.obs.stage("quantile", rows=rows, path="resident", blocks=resident.block_count):
            resident.reduce(ResourceType.CPU, partial(masked_percentile_bisect_cuda, q=q), out[0])
            resident.reduce(ResourceType.Memory, masked_max_cuda, out[1])
            stacked = out.cpu().numpy()
        return stacked[0], stacked[1]

    def run_batch(self, batch: FleetBatch) -> list[RunResult]:
        if not batch.objects:
            return []
        q = float(self.settings.cpu_percentile)
        with self.profile_span():
            window = FleetWindow(batch, self.settings, self.device, self.obs)
            if window.placement == "host_stream":
                cpu_p, mem_max = window.streamed_quantile(partial(self._streamed_percentile, q=q), HOST_STREAM_CHUNK)
            elif window.placement == "mesh":
                cpu_p, mem_max = self._run_mesh(window, q)
            else:
                cpu_p, mem_max = self._run_resident(window, q)
            self.stream_stats = window.stream_stats
            self.obs.record_device_memory(self.device)
        with self.obs.stage("round", rows=len(batch)):
            results = finalize_fleet(cpu_p, mem_max, self.settings.memory_buffer_percentage)
        return results
