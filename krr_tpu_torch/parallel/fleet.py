"""Sharded fleet reductions: the packed ``[N, T]`` matrix over a device mesh.

Port of `krr_tpu/parallel/fleet.py`. The matrix is laid out over a
``(data, time)`` mesh (`krr_tpu_torch.parallel.mesh`): rows split over
``data``, timesteps over ``time``. Each shard runs the resident kernel on its
own block on its own device, with its global time offset (a position is
valid iff ``offset + local position < count``), and the shards of a row
block merge by exact reductions, where the JAX package runs
``psum``/``pmax``/``all_gather`` inside ``shard_map``:

* the masked max (K2 ``row_max`` per shard): :func:`~krr_tpu_torch.ops.
  quantile.peak_max` of the shards' maxima;
* the digest (K3 ``digest_hist`` per shard): integer adds of the counts
  and totals, ``peak_max`` of the peaks;
* the top-K sketch (K4 ``topk_select`` per shard): the top K of the
  gathered slots, since the top K of a union lies in the union of top Ks;
* the percentile: K1 ``bisect_select`` per row block on a mesh with one
  time shard; with more, the radix select of
  :class:`~krr_tpu_torch.ops.selection.RadixSelect` over the time shards —
  per digit one K5 ``radix_digit_hist`` launch per shard, the bins summed,
  and the digit picked from the sum. The JAX package reduces a count per
  bisection step instead (31 ``psum``); both select the sample a sort
  selects.

A rank computes only its own cells (`krr_tpu_torch.parallel.mesh`: in one
process, every cell). It merges its shards of a row block onto the first
of their devices; when the block's time shards span ranks, the merge goes
on across them as collectives over the ranks that hold the block
(`krr_tpu_torch.parallel.collectives`): ``all_reduce`` sums of the integer
counts, totals and radix bins, an ``all_reduce`` max of the peaks' ordered
integer keys (:func:`~krr_tpu_torch.ops.quantile.peak_keys`: a NaN peak
stays NaN, which a float max does not promise), an ``all_gather`` of the
top-K slots. Every rank of those reaches the same digits, so the radix
prefixes agree with no further message. Last, a row block a rank did not
compute arrives by an ``all_gather`` along ``data``: every rank returns
every row. Over one rank each collective is the identity, so one process
runs the same code.

A streamed window splits its rows over the mesh's cells instead
(:func:`mesh_row_split`, handed to `krr_tpu_torch.ops.chunked.split_rows`):
each rank streams its own cells' blocks, and the blocks' results are
gathered to every rank.

Each function takes host arrays, as in the JAX package, and returns host
arrays cut to the real rows, or per-row-block results with the real row
count. Host→device padding (:func:`pad_for_mesh`): rows pad with count-0
entries (NaN results, sliced off), time pads with zeros past each row's
count — which a count past the real width counts as samples, as the JAX
package's sharded builds do.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from krr_tpu_torch.ops import digest as digest_ops
from krr_tpu_torch.ops.chunked import RowSplit, State, concat_parts, row_blocks
from krr_tpu_torch.ops import topk_sketch as topk_ops
from krr_tpu_torch.ops.cuda_select import masked_percentile_bisect_cuda, radix_digit_hist, row_max_chunk
from krr_tpu_torch.ops.digest import Digest, DigestSpec
from krr_tpu_torch.ops.quantile import key_peaks, peak_keys, peak_max
from krr_tpu_torch.ops.selection import RadixSelect
from krr_tpu_torch.ops.topk_sketch import TopKSketch
from krr_tpu_torch.parallel.collectives import all_gather, all_reduce, gather_row_parts
from krr_tpu_torch.parallel.mesh import DATA_AXIS, TIME_AXIS, Mesh, fleet_sharding, rows_sharding, this_rank

#: ``[data][time]`` blocks of an array on a mesh, one tensor per shard on its
#: device (None for a shard of another rank's).
Blocks = list[list[Optional[torch.Tensor]]]


class _Shard(NamedTuple):
    """One of this rank's shards of a row block: its time index, values and
    counts."""

    j: int
    values: torch.Tensor
    counts: torch.Tensor


def pad_for_mesh(values: np.ndarray, counts: np.ndarray, mesh: Mesh) -> tuple[np.ndarray, np.ndarray, int]:
    """Pad rows/time so both axes divide the mesh; returns (values, counts, real_rows)."""
    n, t = values.shape
    data_size = mesh.shape[DATA_AXIS]
    time_size = mesh.shape[TIME_AXIS]
    row_pad = (-n) % data_size
    time_pad = (-t) % time_size
    if row_pad or time_pad:
        values = np.pad(values, ((0, row_pad), (0, time_pad)))
        counts = np.pad(counts, (0, row_pad))
    return values, counts, n


def transfer_to_mesh(values: np.ndarray, counts: np.ndarray, mesh: Mesh) -> tuple[Blocks, Blocks, int]:
    """Pad + cast on host, then copy each of this rank's ``[row block, time
    block]`` from its host slice straight to its device: ``[data][time]``
    float32 value blocks, the ``[data][time]`` int32 count blocks beside
    them (each row block's counts on every device along time), None for
    another rank's, and the real row count.

    The cast happens in numpy, so the float32 bytes are the resident
    path's; routing through one device first would stage the full matrix
    there, which is the out-of-memory the mesh exists to avoid."""
    if this_rank() not in mesh.ranks():
        raise ValueError(f"rank {this_rank()} owns no device of the mesh (ranks {mesh.ranks()})")
    values, counts, real_rows = pad_for_mesh(values, counts, mesh)
    values_d = fleet_sharding(mesh).place(np.ascontiguousarray(values, dtype=np.float32))
    counts_d = rows_sharding(mesh).place(np.ascontiguousarray(counts, dtype=np.int32))
    return values_d, counts_d, real_rows


def _shards(row_values: list, row_counts: list) -> list[_Shard]:
    """This rank's shards of one row block."""
    return [_Shard(j, v, c) for j, (v, c) in enumerate(zip(row_values, row_counts)) if v is not None]


def _shard_eff(counts: torch.Tensor, shard: int, width: int) -> torch.Tensor:
    """Per row, the valid prefix of time shard ``shard`` (``width``
    columns each): ``clamp(count − shard·width, 0, width)``."""
    return torch.clamp(counts - shard * width, 0, width).to(torch.int32)


def _sum_counts(x: torch.Tensor, ranks: list[int]) -> torch.Tensor:
    """The sum over ``ranks`` of float32 counts holding exact integers,
    added as integers."""
    return all_reduce(x.to(torch.int32), dist.ReduceOp.SUM, ranks).to(torch.float32)


def _max_peaks(peak: torch.Tensor, ranks: list[int]) -> torch.Tensor:
    """:func:`peak_max` over ``ranks``: a max of the ordered integer keys."""
    return key_peaks(all_reduce(peak_keys(peak), dist.ReduceOp.MAX, ranks))


def _gather_blocks(mesh: Mesh, blocks: list, real_rows: int) -> list:
    """Every row block's result on every rank: a block this rank did not
    compute arrives from the rank holding the block's first time shard. In
    one process, or when every rank holds a shard of every block, nothing
    moves."""
    ranks = mesh.ranks()
    data = mesh.shape[DATA_AXIS]
    if all(mesh.block_ranks(d) == ranks for d in range(data)):
        return blocks
    like = next(block for block in blocks if block is not None)
    block_rows = -(-real_rows // data)  # pad_for_mesh's rows over the data axis
    return gather_row_parts(blocks, [row[0].rank for row in mesh.grid], [block_rows] * data, ranks, like,
                            mesh.local_devices()[0])


def gather_rows(blocks: Sequence, read: Callable[[object], torch.Tensor], real_rows: int) -> np.ndarray:
    """``read`` of each row block's result (a percentile, a digest's
    counts), concatenated on the host and cut to the real rows."""
    return np.concatenate([read(block).cpu().numpy() for block in blocks])[:real_rows]


def mesh_row_split(mesh: Mesh) -> RowSplit:
    """The rows of a host-streamed window split over ``mesh``'s cells
    (data-major, every rank's), as `krr_tpu_torch.ops.chunked.split_rows`
    splits them over devices: each rank runs the blocks of its own cells,
    and every block's result is gathered to every rank in row order
    (tensors onto this rank's first device of the mesh), each as long as it
    is. A rank whose cells get no rows gives the gather an empty block's
    result."""
    cells = mesh.cells()
    me = this_rank()
    home = mesh.local_devices()[0]

    def split(values: np.ndarray, counts: np.ndarray, run: Callable) -> State:
        blocks = list(zip(row_blocks(values.shape[0], len(cells)), cells))
        parts = [run(values[start:stop], counts[start:stop], cell.device) if cell.rank == me else None
                 for (start, stop), cell in blocks]
        like = next((part for part in parts if part is not None), None)
        if like is None:
            like = run(values[:0], counts[:0], home)
        if not blocks:
            return like
        parts = gather_row_parts(parts, [cell.rank for _block, cell in blocks],
                                 [stop - start for (start, stop), _cell in blocks], mesh.ranks(), like, home)
        return parts[0] if len(parts) == 1 else concat_parts(parts, home)

    return split


def sharded_fleet_digest(
    spec: DigestSpec,
    values: np.ndarray,
    counts: np.ndarray,
    mesh: Mesh,
) -> tuple[list[Digest], int]:
    """Build the fleet digest over a mesh: one ``digest_hist`` launch per
    shard, merged per row block. Returns (one digest per row block, real
    row count)."""
    values_d, counts_d, real_rows = transfer_to_mesh(values, counts, mesh)
    digests: list = []
    for d, (row_values, row_counts) in enumerate(zip(values_d, counts_d)):
        shards = _shards(row_values, row_counts)
        if not shards:
            digests.append(None)
            continue
        home = shards[0].counts.device
        merged = None
        for shard in shards:
            t_local = shard.values.shape[1]
            local = digest_ops.build_from_packed(spec, shard.values, shard.counts, time_offset=shard.j * t_local)
            local = Digest(*(field.to(home) for field in local))
            merged = local if merged is None else digest_ops.merge(merged, local)
        ranks = mesh.block_ranks(d)
        digests.append(Digest(_sum_counts(merged.counts, ranks), _sum_counts(merged.total, ranks),
                              _max_peaks(merged.peak, ranks)))
    return _gather_blocks(mesh, digests, real_rows), real_rows


def sharded_percentile(spec: DigestSpec, digests: Sequence[Digest], q: float, real_rows: int) -> np.ndarray:
    """Quantile extraction over the sharded digest, per row block on its
    device (no merge needed), concatenated on the host and cut to the real
    rows."""
    return gather_rows(digests, lambda digest: digest_ops.percentile(spec, digest, q), real_rows)


def sharded_fleet_topk(
    values: np.ndarray,
    counts: np.ndarray,
    k: int,
    mesh: Mesh,
) -> tuple[list[TopKSketch], int]:
    """Build the exact top-K sketch over the mesh (the sequence-parallel
    form of `krr_tpu_torch.ops.topk_sketch`): one ``topk_select`` launch per
    shard, then per row block the top K of the shards' gathered slots and
    the sum of their totals. Returns (one sketch per row block, real row
    count)."""
    values_d, counts_d, real_rows = transfer_to_mesh(values, counts, mesh)
    sketches: list = []
    for d, (row_values, row_counts) in enumerate(zip(values_d, counts_d)):
        shards = _shards(row_values, row_counts)
        if not shards:
            sketches.append(None)
            continue
        home = shards[0].counts.device
        locals_ = []
        for shard in shards:
            t_local = shard.values.shape[1]
            local = topk_ops.build_from_packed(shard.values, shard.counts, k, time_offset=shard.j * t_local)
            locals_.append(TopKSketch(*(field.to(home) for field in local)))
        ranks = mesh.block_ranks(d)
        mine = locals_[0].values
        if len(locals_) > 1:  # K slots from every rank: all_gather takes equal shapes
            mine = torch.topk(torch.cat([local.values for local in locals_], dim=1), k, dim=1).values
        gathered = all_gather(mine, ranks)
        top = mine if len(gathered) == 1 else torch.topk(torch.cat(gathered, dim=1), k, dim=1).values
        total = torch.stack([local.total for local in locals_]).sum(dim=0)
        sketches.append(TopKSketch(values=top, total=_sum_counts(total, ranks)))
    return _gather_blocks(mesh, sketches, real_rows), real_rows


def _host_rows(mesh: Mesh, blocks: list, real_rows: int) -> np.ndarray:
    """Per-row-block ``[rows]`` results, gathered to every rank,
    concatenated on the host and cut to the real rows."""
    return np.concatenate([block.cpu().numpy() for block in _gather_blocks(mesh, blocks, real_rows)])[:real_rows]


def sharded_masked_max(values: np.ndarray, counts: np.ndarray, mesh: Mesh) -> np.ndarray:
    """Exact per-row max over the mesh (memory recommendations): one
    ``row_max`` launch per shard on its valid prefix, −inf where the shard
    holds none of the row, merged with ``peak_max``; NaN for empty rows
    (and for every row of a window with no columns, as the resident max
    gives)."""
    values_d, counts_d, real_rows = transfer_to_mesh(values, counts, mesh)
    out: list = []
    for d, (row_values, row_counts) in enumerate(zip(values_d, counts_d)):
        shards = _shards(row_values, row_counts)
        if not shards:
            out.append(None)
            continue
        home_counts = shards[0].counts
        peak = None
        for shard in shards:
            t_local = shard.values.shape[1]
            local = row_max_chunk(shard.values, _shard_eff(shard.counts, shard.j, t_local)).to(home_counts.device)
            peak = local if peak is None else peak_max(peak, local)
        peak = _max_peaks(peak, mesh.block_ranks(d))
        empty = (home_counts <= 0) | (values.shape[1] == 0)
        out.append(torch.where(empty, torch.full_like(peak, float("nan")), peak))
    return _host_rows(mesh, out, real_rows)


def _select_over_time(shards: list[_Shard], ranks: list[int], q: float, width: int) -> torch.Tensor:
    """One row block's percentile over its time shards (``width`` columns
    in all): the passes of :class:`RadixSelect`, each one
    ``radix_digit_hist`` launch per shard under the block's prefixes, the
    shards' bins summed on this rank's first device of the block and over
    the ranks that hold the block."""
    home = shards[0].counts.device
    t_local = shards[0].values.shape[1]
    plan = RadixSelect(shards[0].counts, q, width)
    effs = [_shard_eff(plan.live.to(shard.values.device), shard.j, t_local) for shard in shards]

    def count_pass(prefix32: torch.Tensor, shift: int, bits: int) -> torch.Tensor:
        total = None
        for shard, eff in zip(shards, effs):
            local_values = shard.values
            bins = torch.zeros((local_values.shape[0], 1 << bits), dtype=torch.int32, device=local_values.device)
            bins = radix_digit_hist(local_values, eff, prefix32.to(local_values.device), bins, shift, bits)
            total = bins.to(home) if total is None else total + bins.to(home)
        return all_reduce(total, dist.ReduceOp.SUM, ranks)

    return plan.run(count_pass)


def sharded_percentile_bisect(values: np.ndarray, counts: np.ndarray, q: float, mesh: Mesh) -> np.ndarray:
    """Exact per-row percentile over the mesh: the sample the 31-step
    bit-space bisection selects (`krr_tpu_torch.ops.selection`), NaN for
    empty rows. With one time shard, one ``bisect_select`` launch per row
    block; with more, the time-sharded radix select (the module's
    docstring)."""
    values_d, counts_d, real_rows = transfer_to_mesh(values, counts, mesh)
    time_shards = mesh.shape[TIME_AXIS]
    out: list = []
    for d, (row_values, row_counts) in enumerate(zip(values_d, counts_d)):
        shards = _shards(row_values, row_counts)
        if not shards:
            out.append(None)
        elif time_shards == 1:
            out.append(masked_percentile_bisect_cuda(shards[0].values, shards[0].counts, q))
        else:
            width = shards[0].values.shape[1] * time_shards
            out.append(_select_over_time(shards, mesh.block_ranks(d), q, width))
    return _host_rows(mesh, out, real_rows)
