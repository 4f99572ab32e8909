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
the same sample as the resident path.

With more than one device and ``use_mesh`` (`krr_tpu/strategies/simple.py:
179-192`, :func:`resolve_mesh`), the fleet shards over a ``(data, time)``
mesh (`krr_tpu_torch.parallel`): ``bisect_select`` per row block, or the
time-sharded radix select (``radix_digit_hist`` per shard and digit), and
``row_max`` per shard, merged exactly. A streamed window with a mesh splits
its rows over every mesh device, each block streaming on its own. One
device, the CPU or ``use_mesh`` false take the single-device paths. A mesh
that spans processes (`krr_tpu_torch.parallel.initialize_distributed`)
merges across them by collectives, and every rank renders every row.

The legs are stages of the scan trace (``strategy.obs``,
`krr_tpu_torch.obs.device`): ``pack``, on the resident path ``cast`` and
``h2d`` for each resource (:func:`fleet_device_arrays`), ``quantile``
(``path=resident``, ``host_stream`` or ``mesh``) and ``round``, each fenced
when the tracer records; with ``profile_dir`` the device compute runs under
``torch.profiler``.
"""

from __future__ import annotations

from decimal import Decimal
from typing import Optional

import numpy as np
import pydantic as pd
import torch

from krr_tpu_torch.core.rounding import as_decimal
from krr_tpu_torch.models.allocations import ResourceType
from krr_tpu_torch.models.series import FleetBatch
from krr_tpu_torch.obs.device import NULL_DEVICE_OBS, DeviceObs
from krr_tpu_torch.ops import topk_sketch as topk_ops
from krr_tpu_torch.ops.chunked import RowSplit, StreamStats
from krr_tpu_torch.ops.cuda_select import fleet_exact
from krr_tpu_torch.ops.quantile import masked_max_from_host
from krr_tpu_torch.ops.selection import masked_percentile_bisect_from_host
from krr_tpu_torch.parallel import Mesh, make_mesh, mesh_devices, sharded_masked_max, sharded_percentile_bisect
from krr_tpu_torch.parallel.fleet import mesh_row_split
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
    batch: FleetBatch,
    resource: ResourceType,
    scale: float = 1.0,
    *,
    device: "torch.device | str",
    obs: DeviceObs = NULL_DEVICE_OBS,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Packed host arrays → (float32 device values, int32 device counts).

    The scale divides the host pack (float64 for memory) BEFORE the float32
    cast, as the JAX package does; the cast is numpy's, so both packages
    round identically. The scale and cast are ``obs``'s ``cast`` stage, the
    copies its ``h2d`` stage, whose ``bytes`` (the two tensors' bytes) also
    go to ``krr_tpu_h2d_bytes_total``."""
    packed = batch.packed(resource)
    with obs.stage("cast", resource=resource.value):
        host = packed.values / scale if scale != 1.0 else packed.values
        values = torch.from_numpy(np.ascontiguousarray(host, dtype=np.float32))
        counts = torch.from_numpy(np.ascontiguousarray(packed.counts, dtype=np.int32))
    copied = values.nbytes + counts.nbytes
    with obs.stage("h2d", resource=resource.value, bytes=copied):
        values, counts = obs.fence((values.to(device), counts.to(device)))
    obs.record_h2d(resource.value, copied)
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


def use_host_stream(batch: FleetBatch, device: torch.device, setting_mb: int, mesh: Optional[Mesh] = None) -> bool:
    """Whether the packed window is too large to live on the device (on
    each device of ``mesh``, which shares it out: every device of every
    rank, as the JAX package divides by the global device count)."""
    threshold = _stream_threshold_bytes(setting_mb, device)
    if threshold is None:
        return False
    cpu = batch.packed(ResourceType.CPU)
    mem = batch.packed(ResourceType.Memory)
    num_devices = 1 if mesh is None else mesh.size
    return 4 * (cpu.values.size + mem.values.size) / num_devices > threshold


def stream_devices(mesh: Optional[Mesh]) -> Optional[RowSplit]:
    """Where a streamed window's rows split: over every cell of the mesh,
    every rank's (each block folds its own rows; the blocks' results are
    then gathered to every rank), or None for the one device."""
    return None if mesh is None else mesh_row_split(mesh)


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


def resolve_mesh(settings: SimpleStrategySettings, device: "torch.device | str") -> Optional[Mesh]:
    """The strategy's device mesh over ``device``'s devices
    (`krr_tpu_torch.parallel.mesh_devices`: with a process group up, every
    rank's, as the JAX package meshes ``jax.devices()``), or None for the
    single-device path: ``use_mesh`` false, the CPU or one card. A
    ``mesh_time_axis`` that does not divide the device count raises, as
    ``make_mesh`` does, rather than degrade to a data-only mesh."""
    devices = mesh_devices(device)
    if not settings.use_mesh or len(devices) <= 1:
        return None
    return make_mesh(time=settings.mesh_time_axis, devices=devices)


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

    def _streamed_exact(self, batch: FleetBatch, q: float, stats: StreamStats, mesh: Optional[Mesh]) -> tuple:
        """(CPU percentile, memory peak in MB) with the window streamed from
        host: the one-pass exact top-K sketch when the rank-from-the-top
        fits, the three-pass streamed radix select otherwise — both select
        the sample the resident path selects. The percentile may still be
        on the device (a tensor); the peak is a host array."""
        cpu = batch.packed(ResourceType.CPU)
        mem = batch.packed(ResourceType.Memory)
        where = {"device": self.device, "stats": stats, "devices": stream_devices(mesh)}
        k = exact_topk_k(cpu.capacity, q, self.settings.exact_sketch_budget)
        if k is not None:
            sketch = topk_ops.build_from_host(cpu.values, cpu.counts, k, HOST_STREAM_CHUNK, **where)
            cpu_p = topk_ops.percentile(sketch, q)
        else:  # mid-range percentile: no bounded exact sketch
            cpu_p = masked_percentile_bisect_from_host(cpu.values, cpu.counts, q, HOST_STREAM_CHUNK, **where)
        mem_max = masked_max_from_host(mem.values, mem.counts, HOST_STREAM_CHUNK, scale=MEMORY_SCALE, **where)
        return cpu_p, mem_max

    def _run_streamed(self, batch: FleetBatch, q: float, mesh: Optional[Mesh]) -> tuple:
        """The streamed quantile stage: (CPU percentile, memory peak) as host
        arrays; the stream's legs go to :attr:`stream_stats`."""
        stats = StreamStats()
        cpu_p, mem_max = self.obs.fence(self._streamed_exact(batch, q, stats, mesh))
        cpu_p = cpu_p.cpu().numpy() if isinstance(cpu_p, torch.Tensor) else cpu_p
        self.stream_stats = stats.as_dict()
        return cpu_p, mem_max

    def _run_mesh(self, batch: FleetBatch, q: float, mesh: Mesh) -> tuple:
        """The mesh quantile stage (`krr_tpu/strategies/simple.py:255-262`):
        the sharded percentile and the sharded memory max, each returned to
        the host."""
        self.stream_stats = None
        cpu = batch.packed(ResourceType.CPU)
        mem = batch.packed(ResourceType.Memory)
        cpu_p = sharded_percentile_bisect(cpu.values, cpu.counts, q, mesh)
        mem_max = sharded_masked_max(mem.values / MEMORY_SCALE, mem.counts, mesh)
        return cpu_p, mem_max

    def _run_resident(self, batch: FleetBatch, q: float) -> tuple:
        """The resident path: each resource's ``cast`` and ``h2d`` stages,
        then the ``quantile`` stage: one ``fleet_exact`` program and its one
        readback."""
        self.stream_stats = None
        obs = self.obs
        cpu_values, cpu_counts = fleet_device_arrays(batch, ResourceType.CPU, device=self.device, obs=obs)
        mem_values, mem_counts = fleet_device_arrays(
            batch, ResourceType.Memory, scale=MEMORY_SCALE, device=self.device, obs=obs
        )
        with obs.stage("quantile", rows=len(batch), path="resident"):
            # One program, one readback (the JAX package's fleet_exact contract).
            stacked = fleet_exact(cpu_values, cpu_counts, mem_values, mem_counts, q).cpu().numpy()
        return stacked[0], stacked[1]

    def run_batch(self, batch: FleetBatch) -> list[RunResult]:
        if not batch.objects:
            return []
        q = float(self.settings.cpu_percentile)
        obs = self.obs
        with self.profile_span():
            # The pack stage brackets the ragged→rectangular host pack (the
            # packed views are cached on the batch, so re-reads below are
            # free), records the fill's threads and destination bytes, and
            # fires the padding-efficiency gauges.
            with obs.stage("pack", rows=len(batch)) as span:
                cpu = batch.packed(ResourceType.CPU)
                mem = batch.packed(ResourceType.Memory)
                span.set(workers_cpu=cpu.workers, workers_memory=mem.workers,
                         bytes=cpu.values.nbytes + mem.values.nbytes)
                obs.record_padding(ResourceType.CPU.value, cpu)
                obs.record_padding(ResourceType.Memory.value, mem)
            mesh = resolve_mesh(self.settings, self.device)
            if use_host_stream(batch, self.device, self.settings.host_stream_mb, mesh):
                with obs.stage("quantile", rows=len(batch), path="host_stream"):
                    cpu_p, mem_max = self._run_streamed(batch, q, mesh)
            elif mesh is not None:
                with obs.stage("quantile", rows=len(batch), path="mesh"):
                    cpu_p, mem_max = self._run_mesh(batch, q, mesh)
            else:
                cpu_p, mem_max = self._run_resident(batch, q)
            obs.record_device_memory(self.device)
        with obs.stage("round", rows=len(batch)):
            results = finalize_fleet(cpu_p, mem_max, self.settings.memory_buffer_percentage)
        return results
