"""The fleet window's way to the device, for every batched strategy.

A batch's packed history reaches the device in the one format this module
owns — CPU as packed (float32), memory in MB as float32 (:data:`MEMORY_SCALE`,
divided in the pack's own fill) — and by one of three placements, decided
here once per batch (:class:`FleetWindow`):

* ``host_stream``: the window's float32 footprint passes ``host_stream_mb``
  per device, so it stays in host memory and streams to the device in time
  chunks (`krr_tpu_torch.ops.chunked`), each resource with its own
  :class:`StreamStats`; with a mesh its rows split over every mesh device.
* ``mesh``: more than one device and ``use_mesh`` (:func:`resolve_mesh`,
  `krr_tpu/strategies/simple.py:179-192`): the window shards over a
  ``(data, time)`` mesh (`krr_tpu_torch.parallel`).
* ``resident``: both resources copied to the device whole
  (:func:`fleet_device_arrays`).

Memory's max on the stream and mesh placements is computed here too; the
strategies keep only their CPU reductions (and, resident, the one program
that reduces both resources). The legs are stages of the scan trace
(``obs``, `krr_tpu_torch.obs.device`): ``pack``, on the resident placement
``cast`` and ``h2d`` for each resource, and on the stream placement a
``stream_fill`` stage a chunk and a ``stream_wait`` stage a wait for a
pinned buffer.
"""

from __future__ import annotations

from typing import Callable, Literal, Optional

import numpy as np
import torch

from krr_tpu_torch.models.allocations import ResourceType
from krr_tpu_torch.models.series import FleetBatch, PackedSeries
from krr_tpu_torch.obs.device import DeviceObs
from krr_tpu_torch.ops.chunked import StreamStats
from krr_tpu_torch.ops.quantile import masked_max_from_host
from krr_tpu_torch.parallel import Mesh, make_mesh, mesh_devices, sharded_masked_max
from krr_tpu_torch.parallel.fleet import mesh_row_split

#: Memory samples are byte counts that overflow float32's 24-bit mantissa;
#: scaling to (decimal) megabytes before device transfer keeps every value the
#: rounding layer can distinguish exactly representable (SURVEY.md §7 "Hard parts").
MEMORY_SCALE = 1_000_000.0


def device_packed(batch: FleetBatch, resource: ResourceType) -> PackedSeries:
    """The packed view of ``resource`` the device reads, on every path, as
    a C-contiguous float32 matrix and int32 counts: memory in MB
    (``batch.packed_scaled(Memory, MEMORY_SCALE)``: the pack's own fill
    divides each byte count in float64 and rounds it once to float32, as
    the JAX package's ``(values / scale).astype(float32)`` does), CPU as
    packed (float32)."""
    if resource is ResourceType.Memory:
        return batch.packed_scaled(resource, MEMORY_SCALE)
    return batch.packed(resource)


def fleet_device_arrays(
    batch: FleetBatch,
    resource: ResourceType,
    *,
    device: "torch.device | str",
    obs: DeviceObs,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The device view's host arrays (:func:`device_packed`) → (float32
    device values, int32 device counts).

    The pack already holds float32 values (memory divided in its fill), so
    the ``cast`` stage takes the host matrix and counts as they are, with no
    copy: its ``copied_bytes``, the bytes it allocated, are 0. The copies
    are the ``h2d`` stage, whose ``bytes`` (the two tensors' bytes) also go
    to ``krr_tpu_h2d_bytes_total``."""
    packed = device_packed(batch, resource)
    with obs.stage("cast", resource=resource.value, copied_bytes=0):
        values, counts = torch.from_numpy(packed.values), torch.from_numpy(packed.counts)
    copied = values.nbytes + counts.nbytes
    with obs.stage("h2d", resource=resource.value, bytes=copied):
        values, counts = obs.fence((values.to(device), counts.to(device)))
    obs.record_h2d(resource.value, copied)
    return values, counts


def resolve_mesh(settings, device: "torch.device | str") -> Optional[Mesh]:
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


def use_host_stream(elements: int, device: torch.device, setting_mb: int, mesh: Optional[Mesh]) -> bool:
    """Whether a packed window of ``elements`` float32 values is too large
    to live on the device: past ``setting_mb`` MB on each device of
    ``mesh``, which shares it out (every device of every rank, as the JAX
    package divides by the global device count); -1 never streams."""
    if setting_mb == -1:
        return False
    if setting_mb > 0:
        threshold = setting_mb * 1_000_000
    elif device.type == "cuda":  # auto: leave room for temporaries
        threshold = int(torch.cuda.mem_get_info(device)[1] * 0.4)
    else:
        threshold = 6_000_000_000
    num_devices = 1 if mesh is None else mesh.size
    return 4 * elements / num_devices > threshold


def record_streams(obs: DeviceObs, stats: dict) -> StreamStats:
    """Each resource's :class:`StreamStats` (``stats``, by resource) into
    the stream counters (:meth:`DeviceObs.record_stream`, every scan), and
    the streams' total."""
    for resource, part in stats.items():
        obs.record_stream(resource.value, part)
    return StreamStats.total(stats.values())


class FleetWindow:
    """One batch's window on its way to the device: packed once (the
    ``pack`` stage), its placement decided once (:attr:`placement`), and
    the legs every strategy shares on that placement. It holds host arrays
    only: the resident device tensors go to the caller, which drops them
    after its readback, so nothing of one scan stays on the device into
    the next."""

    def __init__(self, batch: FleetBatch, settings, device: torch.device, obs: DeviceObs):
        self.batch, self.device, self.obs = batch, device, obs
        # The pack stage brackets the ragged→rectangular host pack, memory
        # divided to MB in its fill (the packed views are cached on the
        # batch), records the fill's threads and destination bytes, and
        # fires the padding-efficiency gauges.
        with obs.stage("pack", rows=len(batch)) as span:
            self.cpu = device_packed(batch, ResourceType.CPU)
            self.memory = device_packed(batch, ResourceType.Memory)
            span.set(workers_cpu=self.cpu.workers, workers_memory=self.memory.workers,
                     bytes=self.cpu.values.nbytes + self.memory.values.nbytes)
            obs.record_padding(ResourceType.CPU.value, self.cpu)
            obs.record_padding(ResourceType.Memory.value, self.memory)
        #: The strategy's mesh, or None for one device.
        self.mesh = resolve_mesh(settings, device)
        elements = self.cpu.values.size + self.memory.values.size
        self.placement: Literal["host_stream", "mesh", "resident"]
        if use_host_stream(elements, device, settings.host_stream_mb, self.mesh):
            self.placement = "host_stream"
        elif self.mesh is not None:
            self.placement = "mesh"
        else:
            self.placement = "resident"
        #: The streams' :class:`StreamStats` total as a dict once
        #: :meth:`stream` ran; None on the other placements.
        self.stream_stats: Optional[dict] = None

    def to_device(self) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
        """The resident placement: each resource's ``cast`` and ``h2d``
        stages, CPU first → (CPU values, CPU counts, memory values, memory
        counts) on the device."""
        cpu = fleet_device_arrays(self.batch, ResourceType.CPU, device=self.device, obs=self.obs)
        memory = fleet_device_arrays(self.batch, ResourceType.Memory, device=self.device, obs=self.obs)
        return (*cpu, *memory)

    def stream(self, build_cpu: Callable, chunk_size: int) -> tuple:
        """The host-stream placement: ``build_cpu(cpu, **where)`` streams
        the CPU window (``cpu``, a :class:`PackedSeries`; ``where``, the
        stream ops' ``device``, ``devices``, ``obs`` and CPU's ``stats``),
        then memory's max in MB streams in ``chunk_size`` chunks. Each
        resource's legs go to the stream counters (:func:`record_streams`)
        and their total to :attr:`stream_stats`. Returns (what
        ``build_cpu`` returned, memory's peak as a host array, the
        total)."""
        stats = {resource: StreamStats() for resource in ResourceType}
        # With a mesh the rows split over its every cell, every rank's: each
        # block folds its own rows, and the blocks' results are gathered to
        # every rank.
        devices = None if self.mesh is None else mesh_row_split(self.mesh)
        where = {"device": self.device, "devices": devices, "obs": self.obs}
        cpu = build_cpu(self.cpu, stats=stats[ResourceType.CPU], **where)
        mem_max = masked_max_from_host(self.memory.values, self.memory.counts, chunk_size,
                                       stats=stats[ResourceType.Memory], **where)
        total = record_streams(self.obs, stats)
        self.stream_stats = total.as_dict()
        return cpu, mem_max, total

    def streamed_quantile(self, build_cpu: Callable, chunk_size: int) -> tuple:
        """A one-shot scan's ``quantile`` stage on the host-stream placement
        (``path=host_stream``, carrying the streams' totals,
        :meth:`StreamStats.span_attributes`): :meth:`stream`, then the CPU
        percentile read back. Returns (CPU percentile, memory peak) as host
        arrays."""
        with self.obs.stage("quantile", rows=len(self.batch), path="host_stream") as span:
            cpu_p, mem_max, total = self.stream(build_cpu, chunk_size)
            cpu_p = self.obs.fence(cpu_p)
            if isinstance(cpu_p, torch.Tensor):
                cpu_p = cpu_p.cpu().numpy()
            span.set(**total.span_attributes())
        return cpu_p, mem_max

    def mesh_memory_max(self) -> np.ndarray:
        """The mesh placement: memory's per-row peak in MB
        (`krr_tpu/strategies/simple.py:255-262`), sharded and merged
        exactly, as a host array."""
        return sharded_masked_max(self.memory.values, self.memory.counts, self.mesh)
