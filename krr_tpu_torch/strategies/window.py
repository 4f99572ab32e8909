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
* ``resident``: the window goes to the device by row blocks through one
  reused device buffer (:class:`ResidentWindow`): every kernel of the
  resident paths writes each row's result from that row alone, so a block's
  kernel writes the block's rows of the whole-fleet result, and the device
  holds one block of one resource at a time (at most
  :data:`RESIDENT_BLOCK_BYTES` past one wave of rows, :func:`rows_per_block`)
  rather than the whole packed window.

Memory's max on the stream and mesh placements is computed here too; the
strategies keep only their CPU reductions. The legs are stages of the scan
trace (``obs``, `krr_tpu_torch.obs.device`): ``pack``; on the resident
placement ``cast`` for each resource and an ``h2d`` stage for each block's
copy (inside the caller's ``digest`` or ``quantile`` stage); on the stream
placement a ``stream_fill`` stage a chunk and a ``stream_wait`` stage a
wait for a pinned buffer.
"""

from __future__ import annotations

from typing import Callable, Iterator, Literal, Optional

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

#: The most float32 bytes of one resident row block, unless a single wave
#: of rows (:func:`device_wave`) takes more: the size of the device buffer
#: every block of a batch passes through.
RESIDENT_BLOCK_BYTES = 512 * 2**20


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


def device_wave(device: torch.device) -> int:
    """The rows that fill the device once: 8 one-row CTAs for each of a
    card's multiprocessors (every resident kernel launches one CTA a row);
    1 on the CPU."""
    if device.type != "cuda":
        return 1
    return 8 * torch.cuda.get_device_properties(device).multi_processor_count


def rows_per_block(row_bytes: int, rows: int, wave: int) -> int:
    """Rows of one resident block of ``rows`` rows of ``row_bytes`` bytes:
    all of them when they fit :data:`RESIDENT_BLOCK_BYTES`, else the
    largest whole number of ``wave``-row waves that fits it, and at least
    one wave (never more than ``rows``). The last block holds the rest."""
    if rows * row_bytes <= RESIDENT_BLOCK_BYTES:
        return max(rows, 1)
    waves = max(1, RESIDENT_BLOCK_BYTES // (wave * row_bytes))
    return min(rows, waves * wave)


class ResidentWindow:
    """The resident placement of one batch: its ``cast`` stages (one a
    resource, ``torch.from_numpy`` of the pack: ``copied_bytes`` 0), and
    one float32 device buffer, allocated here, that every row block of both
    resources is copied into in turn (:meth:`blocks`). Nothing of a block
    outlives the next block's copy, which the device's stream orders after
    the kernels that read the buffer. :meth:`close` drops the buffer."""

    def __init__(self, window: "FleetWindow"):
        self.obs, self.device = window.obs, window.device
        wave = device_wave(window.device)
        #: Each resource's host tensors (values, counts) and rows a block.
        self.host: dict = {}
        self.step: dict = {}
        for resource, packed in ((ResourceType.CPU, window.cpu), (ResourceType.Memory, window.memory)):
            with self.obs.stage("cast", resource=resource.value, copied_bytes=0):
                self.host[resource] = (torch.from_numpy(packed.values), torch.from_numpy(packed.counts))
            self.step[resource] = rows_per_block(4 * packed.capacity, len(packed.counts), wave)
        #: Each resource's number of blocks.
        self.blocks_of = {r: -(-len(self.host[r][1]) // step) for r, step in self.step.items()}
        elements = max(step * self.host[r][0].shape[1] for r, step in self.step.items())
        self.buffer: Optional[torch.Tensor] = torch.empty((elements,), dtype=torch.float32, device=self.device)

    @property
    def block_count(self) -> int:
        """The blocks of both resources."""
        return sum(self.blocks_of.values())

    def close(self) -> None:
        """Drop the device buffer: what follows (a sketch's query, the
        readback) takes its place on the device."""
        self.buffer = None

    def blocks(self, resource: ResourceType) -> Iterator[tuple[int, int, torch.Tensor, torch.Tensor]]:
        """``resource``'s row blocks on the device, in order: (first row,
        end row, the block's values in the buffer, its counts). Each copy is
        an ``h2d`` stage (``resource``, ``rows``, ``bytes``, ``block``),
        fenced when recording; the first also copies the resource's counts
        whole. The bytes of each go to ``krr_tpu_h2d_bytes_total`` and each
        block to ``krr_tpu_h2d_blocks_total``."""
        values, counts = self.host[resource]
        rows, width = values.shape
        step = self.step[resource]
        device_counts = None
        for block, r0 in enumerate(range(0, rows, step)):
            r1 = min(r0 + step, rows)
            view = self.buffer[: (r1 - r0) * width].view(r1 - r0, width)
            copied = view.nbytes + (counts.nbytes if device_counts is None else 0)
            with self.obs.stage("h2d", resource=resource.value, rows=r1 - r0, bytes=copied, block=block):
                if device_counts is None:
                    device_counts = counts.to(self.device)
                view.copy_(values[r0:r1])
                self.obs.fence((view, device_counts))
            self.obs.record_h2d(resource.value, copied)
            yield r0, r1, view, device_counts[r0:r1]

    def reduce(self, resource: ResourceType, reduce_rows: Callable, out: torch.Tensor) -> torch.Tensor:
        """``reduce_rows(values, counts, out=...)`` on each of
        ``resource``'s blocks, into the block's rows of ``out`` (a row of a
        whole-window result), each fenced when recording. Returns ``out``."""
        for r0, r1, values, counts in self.blocks(resource):
            self.obs.fence(reduce_rows(values, counts, out=out[r0:r1]))
        return out

    def gather(self, resource: ResourceType, build: Callable):
        """The whole window's ``build(values, counts)`` (a named tuple of
        row-major tensors, such as a digest or a top-K sketch), built a
        block at a time, each fenced when recording, into whole-window
        tensors; a window of one block returns its build as it is."""
        rows = len(self.host[resource][1])
        whole = None
        for r0, r1, values, counts in self.blocks(resource):
            part = self.obs.fence(build(values, counts))
            if r1 - r0 == rows:
                return part
            if whole is None:
                whole = type(part)(*(torch.empty((rows, *p.shape[1:]), dtype=p.dtype, device=p.device) for p in part))
            for into, p in zip(whole, part):
                into[r0:r1].copy_(p)
        return whole


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
    only: the resident placement's device buffer goes to the caller
    (:meth:`resident`), which drops it after its readback, so nothing of
    one scan stays on the device into the next."""

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

    def resident(self) -> ResidentWindow:
        """The resident placement: each resource's ``cast`` stage, and the
        device buffer its row blocks pass through."""
        return ResidentWindow(self)

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
