"""Device mesh construction for fleet-scale scans.

Port of `krr_tpu/parallel/mesh.py`. The fleet recommendation problem has two
natural parallel axes: the **containers axis** (``data``: rows of the
``[N, T]`` matrix) and the **time axis** (``time``: long histories, merged
through exact reductions).

A :class:`Mesh` is a ``[data][time]`` grid of :class:`MeshDevice`: a
``torch.device`` and the rank of the process that owns it. In one process
every cell is this process's: each shard's kernel launches on its own
device and the merges are explicit reductions onto the row block's first
device (`krr_tpu_torch.parallel.fleet`). A device may stand in the grid
more than once — the counterpart of the JAX tests' virtual CPU devices,
and how one card carries a mesh's shards — but :func:`mesh_devices`, the
seam that names the devices, never repeats one.

Multi-process: call :func:`initialize_distributed` first (the launcher's
``env://`` variables or explicit arguments), as the JAX package calls
``jax.distributed.initialize``; then :func:`mesh_devices` names every
rank's devices in rank order, as ``jax.devices()`` does after that call,
and the same mesh code spans them. Every rank runs the same program on the
same host inputs (SPMD): each places and computes only its own cells, the
merges that cross ranks are collectives on the process group
(`krr_tpu_torch.parallel.collectives`), and every rank returns every row.
No CLI command starts a process group, as in the JAX package.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from datetime import timedelta
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from krr_tpu_torch.utils.device import resolve_device

DATA_AXIS = "data"
TIME_AXIS = "time"

#: How long a rendezvous or a collective waits for its peers before it
#: raises: a rank that died must not hold the others for the default half
#: hour.
COLLECTIVE_TIMEOUT = timedelta(minutes=5)


class MeshDevice(NamedTuple):
    """One device of a mesh and the rank of the process that owns it: the
    counterpart of a ``jax.Device`` and its ``process_index``."""

    rank: int
    device: torch.device


@dataclass
class World:
    """The process group :func:`initialize_distributed` started: this
    rank, the world size, the backend it chose, this rank's device, every
    rank's device and card identity (None on the CPU) in rank order, and
    the subgroups made for meshes so far (keyed by their sorted ranks;
    every rank makes them in one order)."""

    rank: int
    size: int
    backend: str
    device: torch.device
    devices: tuple[MeshDevice, ...]
    cards: tuple[Optional[str], ...]
    subgroups: dict = field(default_factory=dict)


#: The process group of this process, once :func:`initialize_distributed`
#: ran (process-wide, as ``torch.distributed``'s default group is).
_WORLD: Optional[World] = None


def world() -> Optional[World]:
    """The process group :func:`initialize_distributed` started, or None."""
    return _WORLD


def this_rank() -> int:
    """This process's rank: 0 without a process group."""
    return 0 if _WORLD is None else _WORLD.rank


def process_group(ranks: Sequence[int]):
    """The process group over ``ranks``: the default group when they are
    the whole world, else a subgroup, made on first use. Making one is
    collective: every rank of the world must ask for the same groups in the
    same order, which :func:`make_mesh` does for a mesh's groups."""
    ranks = tuple(sorted(set(ranks)))
    if _WORLD is None:
        raise RuntimeError(f"ranks {ranks}: no process group; call initialize_distributed first")
    if ranks == tuple(range(_WORLD.size)):
        return dist.group.WORLD
    if ranks not in _WORLD.subgroups:
        _WORLD.subgroups[ranks] = dist.new_group(list(ranks), timeout=COLLECTIVE_TIMEOUT)
    return _WORLD.subgroups[ranks]


def choose_backend(cards: Sequence[Optional[str]]) -> str:
    """The backend of a group whose ranks hold ``cards`` (each rank's card
    identity in rank order, None for a rank on the CPU): ``nccl`` when
    every rank holds a card of its own, else ``gloo`` — NCCL refuses two
    ranks on one card, and the CPU. Every rank decides from the same list,
    so the ranks agree whatever each host sees (its card count, its
    ``CUDA_VISIBLE_DEVICES``)."""
    if cards and None not in cards and len(set(cards)) == len(cards):
        return "nccl"
    return "gloo"


def local_card(local_rank: int, local_size: int, cards: int) -> int:
    """The index of a rank's card among the ``cards`` its process sees: its
    ``local_rank`` when the host shows a card per local rank, else the
    local ranks share the visible cards in turn (one visible card — a
    rank restricted to its own — is index 0)."""
    return local_rank if cards >= local_size else local_rank % cards


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device: "str | torch.device" = "cuda",
) -> World:
    """Multi-process bring-up (`krr_tpu/parallel/mesh.py:64-83`): start the
    ``torch.distributed`` process group and record this rank's device.

    ``coordinator_address`` (``"host:port"``, rank 0's listener),
    ``num_processes`` (the world size) and ``process_id`` (this rank) are
    the JAX function's arguments; each left None comes from the launcher's
    environment, as JAX reads the cluster's: ``MASTER_ADDR``/``MASTER_PORT``
    (``env://``), ``WORLD_SIZE`` and ``RANK``. ``LOCAL_RANK`` and
    ``LOCAL_WORLD_SIZE`` (default: this rank and the world size, one host)
    place the rank on its host.

    On ``cuda`` a rank takes the card :func:`local_card` names; on ``cpu``
    the CPU. The ranks then meet at the rendezvous and each posts its
    device and its card's identity (the card's UUID) to the rendezvous
    store, so every rank sees every rank's card before any picks the
    backend (:func:`choose_backend`): ``nccl`` when no two ranks share a
    card, ``gloo`` when some do or a rank is on the CPU. A ``cuda`` request
    without a card raises, as does a rendezvous that fails or times out
    (:data:`COLLECTIVE_TIMEOUT`): nothing is swapped."""
    global _WORLD
    resolved = resolve_device(device)
    env = os.environ
    rank = int(env["RANK"]) if process_id is None else process_id
    size = int(env["WORLD_SIZE"]) if num_processes is None else num_processes
    if resolved.type == "cuda":
        local = torch.device("cuda", local_card(int(env.get("LOCAL_RANK", rank)),
                                                int(env.get("LOCAL_WORLD_SIZE", size)), torch.cuda.device_count()))
        torch.cuda.set_device(local)
        card = str(torch.cuda.get_device_properties(local).uuid)
    else:
        local, card = torch.device("cpu"), None
    init_method = "env://" if coordinator_address is None else f"tcp://{coordinator_address}"
    store, _rank, _size = next(dist.rendezvous(init_method, rank, size, timeout=COLLECTIVE_TIMEOUT))
    store.set_timeout(COLLECTIVE_TIMEOUT)
    posted = dist.PrefixStore("krr_tpu_torch/devices", store)
    posted.set(str(rank), json.dumps([str(local), card]))
    posted.wait([str(r) for r in range(size)])
    ranks = [json.loads(posted.get(str(r))) for r in range(size)]
    cards = tuple(card for _device, card in ranks)
    backend = choose_backend(cards)
    dist.init_process_group(backend, store=store, world_size=size, rank=rank, timeout=COLLECTIVE_TIMEOUT)
    _WORLD = World(rank=rank, size=size, backend=backend, device=local, cards=cards,
                   devices=tuple(MeshDevice(r, torch.device(d)) for r, (d, _card) in enumerate(ranks)))
    return _WORLD


def mesh_devices(device: "str | torch.device" = "cuda") -> "list[torch.device] | list[MeshDevice]":
    """The devices a mesh may span, the counterpart of ``jax.devices()``.
    In one process: every visible card for ``cuda``, the one card named by
    ``cuda:i``, and the CPU for ``cpu``. With a process group up
    (:func:`initialize_distributed`): every rank's device in rank order,
    each a :class:`MeshDevice` naming its rank — of the type the group was
    started for; another type raises."""
    resolved = torch.device(device)
    if _WORLD is not None:
        if resolved.type != _WORLD.device.type:
            raise ValueError(f"device {str(resolved)!r}: the process group was started on {_WORLD.device.type}")
        return list(_WORLD.devices)
    if resolved.type == "cuda" and resolved.index is None:
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [resolved]


def as_mesh_device(device: "MeshDevice | str | torch.device") -> MeshDevice:
    """A mesh entry: a :class:`MeshDevice` as it is, a device of this rank's
    (a ``torch.device`` or its name) with this rank."""
    if isinstance(device, MeshDevice):
        return device
    return MeshDevice(this_rank(), torch.device(device))


@dataclass(frozen=True)
class Mesh:
    """A ``[data][time]`` grid of devices: row block ``d``'s time shard
    ``j`` lives on ``grid[d][j].device``, owned by rank ``grid[d][j].rank``."""

    grid: tuple[tuple[MeshDevice, ...], ...]

    @property
    def shape(self) -> dict[str, int]:
        return {DATA_AXIS: len(self.grid), TIME_AXIS: len(self.grid[0])}

    @property
    def size(self) -> int:
        """Every cell, across every rank (the JAX mesh's ``devices.size``)."""
        return len(self.grid) * len(self.grid[0])

    def flat(self) -> list[torch.device]:
        """Every device of the grid, data-major, across every rank."""
        return [cell.device for row in self.grid for cell in row]

    def cells(self) -> list[MeshDevice]:
        """Every cell of the grid, data-major: the row split of a
        host-streamed scan, which spreads rows over the whole mesh."""
        return [cell for row in self.grid for cell in row]

    def local_devices(self) -> list[torch.device]:
        """The devices of this rank's cells, data-major."""
        me = this_rank()
        return [cell.device for cell in self.cells() if cell.rank == me]

    def ranks(self) -> list[int]:
        """The ranks that own a cell, ascending."""
        return sorted({cell.rank for cell in self.cells()})

    def block_ranks(self, d: int) -> list[int]:
        """The ranks that own a time shard of row block ``d``, ascending:
        the group its merges along time run over."""
        return sorted({cell.rank for cell in self.grid[d]})


def make_mesh(
    data: Optional[int] = None,
    time: int = 1,
    devices: Optional[Sequence["MeshDevice | str | torch.device"]] = None,
) -> Mesh:
    """Build a ``(data, time)`` mesh over the given devices (every device of
    :func:`mesh_devices` by default). With no arguments, all devices go to
    the data (containers) axis. A device given without a rank is this
    rank's. A mesh whose cells span ranks makes its process groups here,
    so every rank must build it, in the same order as its other meshes."""
    devices = [as_mesh_device(d) for d in (devices if devices is not None else mesh_devices())]
    if data is None:
        if len(devices) % time != 0:
            raise ValueError(f"{len(devices)} devices not divisible by time={time}")
        data = len(devices) // time
    if data * time != len(devices):
        raise ValueError(f"mesh {data}x{time} != {len(devices)} devices")
    mesh = Mesh(tuple(tuple(devices[d * time : (d + 1) * time]) for d in range(data)))
    for ranks in sorted({tuple(mesh.block_ranks(d)) for d in range(data)} | {tuple(mesh.ranks())}):
        if len(ranks) > 1:
            process_group(ranks)
    return mesh


@dataclass(frozen=True)
class Sharding:
    """How a host array's blocks lie on a mesh: rows split evenly over the
    data axis; columns split evenly over the time axis (``time_sharded``,
    the fleet matrix) or each row block copied to every device along it
    (per-row vectors)."""

    mesh: Mesh
    time_sharded: bool

    def place(self, host: np.ndarray) -> list[list[Optional[torch.Tensor]]]:
        """``[data][time]`` blocks of ``host``, each of this rank's copied
        straight from its host slice to its device, None for another
        rank's; the array's extents must divide the mesh
        (`krr_tpu_torch.parallel.fleet.pad_for_mesh`)."""
        data, time = self.mesh.shape[DATA_AXIS], self.mesh.shape[TIME_AXIS]
        rows, cols = host.shape[0], host.shape[1] if self.time_sharded else 0
        if rows % data or (self.time_sharded and cols % time):
            raise ValueError(f"shape {host.shape} does not divide the {data}x{time} mesh")
        block_rows, block_cols = rows // data, cols // time
        me = this_rank()
        blocks = []
        for d, row in enumerate(self.mesh.grid):
            part = host[d * block_rows : (d + 1) * block_rows]
            blocks.append([
                torch.from_numpy(np.ascontiguousarray(
                    part[:, j * block_cols : (j + 1) * block_cols] if self.time_sharded else part
                )).to(cell.device) if cell.rank == me else None
                for j, cell in enumerate(row)
            ])
        return blocks


def fleet_sharding(mesh: Mesh) -> Sharding:
    """The packed ``[N, T]`` fleet matrix: rows over data, timesteps over time."""
    return Sharding(mesh, time_sharded=True)


def rows_sharding(mesh: Mesh) -> Sharding:
    """Per-row vectors (counts, results): split over data, on every device
    along time."""
    return Sharding(mesh, time_sharded=False)
