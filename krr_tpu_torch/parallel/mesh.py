"""Device mesh construction for fleet-scale scans.

Port of `krr_tpu/parallel/mesh.py`. The fleet recommendation problem has two
natural parallel axes: the **containers axis** (``data``: rows of the
``[N, T]`` matrix) and the **time axis** (``time``: long histories, merged
through exact reductions).

The JAX mesh is single-controller: one process meshes its own
``jax.devices()`` and runs every shard. So is this one: a :class:`Mesh` is a
``[data][time]`` grid of ``torch.device``, every shard's kernel launches on
its own device from this process, and the merges are explicit reductions
onto the row block's first device (`krr_tpu_torch.parallel.fleet`). A
device may stand in the grid more than once — the counterpart of the JAX
tests' virtual CPU devices, and how one card carries a mesh's shards — but
:func:`mesh_devices`, the seam that names the devices, never repeats one.

Multi-host (a process group across machines) is ROADMAP item M7b:
:func:`initialize_distributed` raises until it lands.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

DATA_AXIS = "data"
TIME_AXIS = "time"


@dataclass(frozen=True)
class Mesh:
    """A ``[data][time]`` grid of devices: row block ``d``'s time shard
    ``j`` lives on ``devices[d][j]``."""

    devices: tuple[tuple[torch.device, ...], ...]

    @property
    def shape(self) -> dict[str, int]:
        return {DATA_AXIS: len(self.devices), TIME_AXIS: len(self.devices[0])}

    @property
    def size(self) -> int:
        return len(self.devices) * len(self.devices[0])

    def flat(self) -> list[torch.device]:
        """Every device of the grid, data-major: the row split of a
        host-streamed scan, which spreads rows over the whole mesh."""
        return [device for row in self.devices for device in row]


def mesh_devices(device: "str | torch.device" = "cuda") -> list[torch.device]:
    """The devices a mesh may span, the counterpart of ``jax.devices()``:
    every visible card for ``cuda``, the one card named by ``cuda:i``, and
    the CPU for ``cpu``."""
    resolved = torch.device(device)
    if resolved.type == "cuda" and resolved.index is None:
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [resolved]


def make_mesh(
    data: Optional[int] = None,
    time: int = 1,
    devices: Optional[Sequence["str | torch.device"]] = None,
) -> Mesh:
    """Build a ``(data, time)`` mesh over the given devices (every card by
    default). With no arguments, all devices go to the data (containers)
    axis."""
    devices = [torch.device(d) for d in (devices if devices is not None else mesh_devices())]
    if data is None:
        if len(devices) % time != 0:
            raise ValueError(f"{len(devices)} devices not divisible by time={time}")
        data = len(devices) // time
    if data * time != len(devices):
        raise ValueError(f"mesh {data}x{time} != {len(devices)} devices")
    return Mesh(tuple(tuple(devices[d * time : (d + 1) * time]) for d in range(data)))


@dataclass(frozen=True)
class Sharding:
    """How a host array's blocks lie on a mesh: rows split evenly over the
    data axis; columns split evenly over the time axis (``time_sharded``,
    the fleet matrix) or each row block copied to every device along it
    (per-row vectors)."""

    mesh: Mesh
    time_sharded: bool

    def place(self, host: np.ndarray) -> list[list[torch.Tensor]]:
        """``[data][time]`` blocks of ``host``, each copied straight from its
        host slice to its device; the array's extents must divide the mesh
        (`krr_tpu_torch.parallel.fleet.pad_for_mesh`)."""
        data, time = self.mesh.shape[DATA_AXIS], self.mesh.shape[TIME_AXIS]
        rows, cols = host.shape[0], host.shape[1] if self.time_sharded else 0
        if rows % data or (self.time_sharded and cols % time):
            raise ValueError(f"shape {host.shape} does not divide the {data}x{time} mesh")
        block_rows, block_cols = rows // data, cols // time
        blocks = []
        for d, row in enumerate(self.mesh.devices):
            part = host[d * block_rows : (d + 1) * block_rows]
            blocks.append([
                torch.from_numpy(np.ascontiguousarray(
                    part[:, j * block_cols : (j + 1) * block_cols] if self.time_sharded else part
                )).to(device)
                for j, device in enumerate(row)
            ])
        return blocks


def fleet_sharding(mesh: Mesh) -> Sharding:
    """The packed ``[N, T]`` fleet matrix: rows over data, timesteps over time."""
    return Sharding(mesh, time_sharded=True)


def rows_sharding(mesh: Mesh) -> Sharding:
    """Per-row vectors (counts, results): split over data, on every device
    along time."""
    return Sharding(mesh, time_sharded=False)


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Multi-host bring-up (`krr_tpu/parallel/mesh.py:64-83`): not ported.
    A mesh across machines needs a process group; it is ROADMAP item M7b."""
    raise NotImplementedError(
        "initialize_distributed: a multi-host mesh needs a process group (ROADMAP M7b); "
        "the port's mesh spans the devices of one process"
    )
