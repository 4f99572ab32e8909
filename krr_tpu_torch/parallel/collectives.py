"""The collectives of a mesh that spans processes, over ``torch.distributed``.

Where the JAX package's ``shard_map`` runs ``psum``/``pmax``/``all_gather``
across processes, the port's sharded functions (`krr_tpu_torch.parallel.
fleet`) and the streamed row split (`krr_tpu_torch.ops.chunked.split_rows`)
call these. Transport: each backend collects on its own device — ``gloo``
on CPU tensors (its CUDA support does not cover ``all_gather``), ``nccl``
on the rank's card (it refuses CPU tensors) — and a tensor elsewhere
(a card's on gloo; a host array's on nccl) is copied there, collected and
copied back to its device. Over the one rank of a group a collective is
the identity: the single-process meshes run the same code with no
process group. A failed or timed-out collective raises.

:data:`STATS` counts each collective's calls, the bytes this rank put in
and its host-clock seconds (staging copies included), so a run can say
what its merges cost.
"""

from __future__ import annotations

import time
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

from krr_tpu_torch.parallel.mesh import process_group, this_rank, world

#: Per collective: calls, bytes this rank contributed, host seconds.
STATS: dict[str, dict] = {}


def reset_stats() -> None:
    STATS.clear()


def _record(name: str, nbytes: int, seconds: float) -> None:
    entry = STATS.setdefault(name, {"calls": 0, "bytes": 0, "seconds": 0.0})
    entry["calls"] += 1
    entry["bytes"] += nbytes
    entry["seconds"] += seconds


def transport_device(backend: str) -> torch.device:
    """The device ``backend`` collects on: the CPU for ``gloo``, this
    rank's card for ``nccl``."""
    return torch.device("cpu") if backend == "gloo" else world().device


def all_reduce(tensor: torch.Tensor, op, ranks: Sequence[int]) -> torch.Tensor:
    """``op`` over ``tensor`` across ``ranks`` (this rank among them): a
    tensor on ``tensor``'s device; ``tensor`` itself over one rank.
    ``tensor`` may be overwritten."""
    if len(set(ranks)) == 1:
        return tensor
    group = process_group(ranks)
    started = time.perf_counter()
    work = tensor.to(transport_device(dist.get_backend(group))).contiguous()
    dist.all_reduce(work, op=op, group=group)
    out = work.to(tensor.device)
    _record("all_reduce", tensor.numel() * tensor.element_size(), time.perf_counter() - started)
    return out


def all_gather(tensor: torch.Tensor, ranks: Sequence[int]) -> list[torch.Tensor]:
    """Every rank's ``tensor`` (equal shapes), in rank order, each on this
    rank's ``tensor``'s device; ``[tensor]`` over one rank."""
    if len(set(ranks)) == 1:
        return [tensor]
    group = process_group(ranks)
    started = time.perf_counter()
    work = tensor.to(transport_device(dist.get_backend(group))).contiguous()
    parts = [torch.empty_like(work) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, work, group=group)
    out = [part.to(tensor.device) for part in parts]
    _record("all_gather", tensor.numel() * tensor.element_size(), time.perf_counter() - started)
    return out


def gather_row_parts(parts: list, owners: list[int], sizes: list[int], ranks: Sequence[int], like,
                     device: torch.device) -> list:
    """Row parts spread over ``ranks``, in row order, on every rank.

    Part ``i`` has ``sizes[i]`` rows and is held by rank ``owners[i]``:
    ``parts[i]`` is the part there and may be None elsewhere. Parts differ
    in rows but not in their trailing shape and type, which ``like`` (any
    part or an empty one of this rank's) shows: a host array, a tensor, or
    a tuple of them (a digest, a sketch), gathered field by field. Each
    rank sends its own parts concatenated and padded to the most rows any
    rank holds (``all_gather`` takes equal shapes); the receiver cuts each
    rank's rows back into its parts. Gathered tensors land on ``device``,
    host arrays stay host arrays, and a part this rank holds is returned as
    it is. Over one rank every part is this rank's, and comes back as it
    is."""
    if len(set(ranks)) == 1:
        return list(parts)
    if isinstance(like, tuple):
        fields = [
            gather_row_parts([None if part is None else part[f] for part in parts], owners, sizes, ranks, like[f],
                             device)
            for f in range(len(like))
        ]
        return [type(like)(*(field[i] for field in fields)) for i in range(len(parts))]
    me = this_rank()
    host = isinstance(like, np.ndarray)

    def as_tensor(part) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(part)) if host else part.to(device)

    held = {rank: sum(size for size, owner in zip(sizes, owners) if owner == rank) for rank in ranks}
    width = max(held.values())
    template = as_tensor(like)
    mine = [as_tensor(part) for part, owner in zip(parts, owners) if owner == me]
    block = torch.cat([*mine, template.new_zeros((width - held[me], *template.shape[1:]))])
    gathered = dict(zip(sorted(ranks), all_gather(block, ranks)))
    offsets = dict.fromkeys(ranks, 0)
    out = []
    for part, owner, size in zip(parts, owners, sizes):
        start = offsets[owner]
        offsets[owner] += size
        if owner == me:
            out.append(part)
        else:
            piece = gathered[owner][start : start + size]
            out.append(piece.numpy() if host else piece)
    return out
