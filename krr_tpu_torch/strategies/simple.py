"""The ``simple`` strategy: p99-CPU request, max+buffer memory request/limit.

Port of `krr_tpu/strategies/simple.py` (behavior-compatible with the
reference's `strategies/simple.py`, computing the true sorted percentile the
reference documents). The whole fleet's packed ``[N, T]`` history goes to the
device once and :func:`krr_tpu_torch.ops.cuda_select.fleet_exact` reduces it
in one program — bit-space bisection for the CPU percentile, masked max for
memory — with one readback. The memory buffer multiplication and all rounding
stay on the host in exact Decimal arithmetic.

A window past ``host_stream_mb`` stays in host memory and streams to the
device in time chunks (`krr_tpu_torch.ops.chunked`): the exact top-K sketch
when the percentile's rank-from-the-top fits ``exact_sketch_budget``, else
the streamed radix select, and the streamed max for memory — each selects
the same sample as the resident path. The multi-device mesh waits for a
later slice.
"""

from __future__ import annotations

import time
from decimal import Decimal
from typing import Optional

import numpy as np
import pydantic as pd
import torch

from krr_tpu_torch.core.rounding import as_decimal
from krr_tpu_torch.models.allocations import ResourceType
from krr_tpu_torch.models.series import FleetBatch
from krr_tpu_torch.ops import topk_sketch as topk_ops
from krr_tpu_torch.ops.chunked import StreamStats
from krr_tpu_torch.ops.cuda_select import fleet_exact
from krr_tpu_torch.ops.quantile import masked_max_from_host
from krr_tpu_torch.ops.selection import masked_percentile_bisect_from_host
from krr_tpu_torch.strategies.base import BatchedStrategy, ResourceRecommendation, RunResult, StrategySettings
from krr_tpu_torch.utils.device import resolve_device

#: Memory samples are byte counts that overflow float32's 24-bit mantissa;
#: scaling to (decimal) megabytes before device transfer keeps every value the
#: rounding layer can distinguish exactly representable (SURVEY.md §7 "Hard parts").
MEMORY_SCALE = 1_000_000.0

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


def fleet_device_arrays(
    batch: FleetBatch, resource: ResourceType, scale: float = 1.0, *, device: "torch.device | str"
) -> tuple[torch.Tensor, torch.Tensor]:
    """Packed host arrays → (float32 device values, int32 device counts).

    The scale divides the host pack (float64 for memory) BEFORE the float32
    cast, as the JAX package does; the cast is numpy's, so both packages
    round identically."""
    packed = batch.packed(resource)
    host = packed.values / scale if scale != 1.0 else packed.values
    values = torch.from_numpy(np.ascontiguousarray(host, dtype=np.float32)).to(device)
    counts = torch.from_numpy(np.ascontiguousarray(packed.counts, dtype=np.int32)).to(device)
    return values, counts


def exact_topk_k(capacity: int, q: float, budget: int) -> Optional[int]:
    """K for the exact top-K sketch, or None when it exceeds ``budget`` and
    the caller must take another path (the histogram digest for tdigest).
    The single cut-over decision site, shared by every strategy and build
    flavor, so the paths can never disagree about which sketch serves a
    percentile."""
    k = topk_ops.required_k(capacity, q)
    return k if 0 < k <= budget else None


def _stream_threshold_bytes(setting_mb: int, device: torch.device) -> Optional[int]:
    """Per-device bytes past which the window must stream from host; None = never."""
    if setting_mb == -1:
        return None
    if setting_mb > 0:
        return setting_mb * 1_000_000
    if device.type == "cuda":  # auto: leave room for temporaries
        return int(torch.cuda.mem_get_info(device)[1] * 0.4)
    return 6_000_000_000


def streamed_legs(pack: float, stream: float, stats: StreamStats, query: float, finalize: float) -> dict:
    """The legs of a streamed ``run_batch``: pack, the stream's wall, its
    host fill, copy wait and fold (device time on the card) summed over
    every pass, then query and finalize."""
    return {
        "pack": pack, "stream": stream, "host_fill": stats.host_fill_seconds,
        "copy_wait": stats.copy_wait_seconds, "fold": stats.fold_seconds, "query": query, "finalize": finalize,
    }


def use_host_stream(batch: FleetBatch, device: torch.device, setting_mb: int) -> bool:
    """Whether the packed window is too large to live on the device."""
    threshold = _stream_threshold_bytes(setting_mb, device)
    if threshold is None:
        return False
    cpu = batch.packed(ResourceType.CPU)
    mem = batch.packed(ResourceType.Memory)
    return 4 * (cpu.values.size + mem.values.size) > threshold


class SimpleStrategySettings(StrategySettings):
    cpu_percentile: Decimal = pd.Field(
        Decimal(99), gt=0, le=100, description="The percentile to use for the CPU recommendation."
    )
    memory_buffer_percentage: Decimal = pd.Field(
        Decimal(5), gt=0, description="The percentage of added buffer to the peak memory usage for memory recommendation."
    )
    device: str = pd.Field(
        "cuda",
        description=(
            "Device to compute on: 'cuda' (the hand-written kernels; raises without a card) "
            "or 'cpu' (the plain PyTorch versions)."
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
    (bit-identical to a sort-and-index) and the masked max for memory."""

    __display_name__ = "simple"
    #: Memory is max × 1.05: only each pod's exact max matters, so sources
    #: may ingest memory through the stats route — identical output, and the
    #: fleet batch ships [rows × pods] to the device instead of [rows × T].
    stats_only_resources = frozenset({ResourceType.Memory})

    def __init__(self, settings: SimpleStrategySettings):
        super().__init__(settings)
        self.device = resolve_device(settings.device)
        #: Wall seconds of the last ``run_batch``'s legs: resident (pack,
        #: h2d, fleet_exact incl. its one readback, finalize) or streamed
        #: (:func:`streamed_legs`).
        self.leg_seconds: dict[str, float] = {}
        #: The last streamed ``run_batch``'s :class:`StreamStats` as a
        #: dict; None after a resident one.
        self.stream_stats: Optional[dict] = None

    def _streamed_exact(self, batch: FleetBatch, q: float, stats: StreamStats) -> tuple:
        """(CPU percentile, memory peak in MB) with the window streamed from
        host: the one-pass exact top-K sketch when the rank-from-the-top
        fits, the three-pass streamed radix select otherwise — both select
        the sample the resident path selects. The percentile may still be
        on the device (a tensor); the peak is a host array."""
        cpu = batch.packed(ResourceType.CPU)
        mem = batch.packed(ResourceType.Memory)
        k = exact_topk_k(cpu.capacity, q, self.settings.exact_sketch_budget)
        if k is not None:
            sketch = topk_ops.build_from_host(
                cpu.values, cpu.counts, k, HOST_STREAM_CHUNK, device=self.device, stats=stats
            )
            cpu_p = topk_ops.percentile(sketch, q)
        else:  # mid-range percentile: no bounded exact sketch
            cpu_p = masked_percentile_bisect_from_host(
                cpu.values, cpu.counts, q, HOST_STREAM_CHUNK, device=self.device, stats=stats
            )
        mem_max = masked_max_from_host(
            mem.values, mem.counts, HOST_STREAM_CHUNK, scale=MEMORY_SCALE, device=self.device, stats=stats
        )
        return cpu_p, mem_max

    def _run_streamed(self, batch: FleetBatch, q: float, pack_seconds: float) -> list[RunResult]:
        stats = StreamStats()
        t0 = time.perf_counter()
        cpu_p, mem_max = self._streamed_exact(batch, q, stats)
        t1 = time.perf_counter()
        cpu_p = cpu_p.cpu().numpy() if isinstance(cpu_p, torch.Tensor) else cpu_p
        t2 = time.perf_counter()
        results = finalize_fleet(cpu_p, mem_max, self.settings.memory_buffer_percentage)
        self.leg_seconds = streamed_legs(pack_seconds, t1 - t0, stats, t2 - t1, time.perf_counter() - t2)
        self.stream_stats = stats.as_dict()
        return results

    def run_batch(self, batch: FleetBatch) -> list[RunResult]:
        if not batch.objects:
            return []
        q = float(self.settings.cpu_percentile)
        t0 = time.perf_counter()
        batch.packed(ResourceType.CPU)
        batch.packed(ResourceType.Memory)
        t1 = time.perf_counter()
        if use_host_stream(batch, self.device, self.settings.host_stream_mb):
            return self._run_streamed(batch, q, t1 - t0)
        self.stream_stats = None
        cpu_values, cpu_counts = fleet_device_arrays(batch, ResourceType.CPU, device=self.device)
        mem_values, mem_counts = fleet_device_arrays(
            batch, ResourceType.Memory, scale=MEMORY_SCALE, device=self.device
        )
        t2 = time.perf_counter()
        # One program, one readback (the JAX package's fleet_exact contract).
        stacked = fleet_exact(cpu_values, cpu_counts, mem_values, mem_counts, q).cpu().numpy()
        t3 = time.perf_counter()
        results = finalize_fleet(stacked[0], stacked[1], self.settings.memory_buffer_percentage)
        t4 = time.perf_counter()
        self.leg_seconds = {"pack": t1 - t0, "h2d": t2 - t1, "fleet_exact": t3 - t2, "finalize": t4 - t3}
        return results
