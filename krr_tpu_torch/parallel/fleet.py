"""Sharded fleet reductions: the packed ``[N, T]`` matrix over a device mesh.

Port of `krr_tpu/parallel/fleet.py`. The matrix is laid out over a
``(data, time)`` mesh (`krr_tpu_torch.parallel.mesh`): rows split over
``data``, timesteps over ``time``. Each shard runs the resident kernel on its
own block on its own device, with its global time offset (a position is
valid iff ``offset + local position < count``), and the shards of a row
block merge onto the block's first device by exact reductions, where the
JAX package runs ``psum``/``pmax``/``all_gather`` inside ``shard_map``:

* the masked max (K2 ``row_max`` per shard): :func:`~krr_tpu_torch.ops.
  quantile.peak_max` of the shards' maxima;
* the digest (K3 ``digest_hist`` per shard): integer adds of the counts
  and totals, ``peak_max`` of the peaks;
* the top-K sketch (K4 ``topk_select`` per shard): the top K of the
  gathered slots, since the top K of a union lies in the union of top Ks;
* the percentile: K1 ``bisect_select`` per row block on a mesh with one
  time shard; with more, the radix select of
  :class:`~krr_tpu_torch.ops.selection.RadixSelect` over the time shards —
  per digit one K5 ``radix_digit_hist`` launch per shard, the bins summed
  on the block's device, the digit picked there and sent back as the
  shards' next prefix. The JAX package reduces a count per bisection step
  instead (31 ``psum``); both select the sample a sort selects.

Each function takes host arrays, as in the JAX package, and returns host
arrays cut to the real rows, or per-row-block results with the real row
count. Host→device padding (:func:`pad_for_mesh`): rows pad with count-0
entries (NaN results, sliced off), time pads with zeros past each row's
count — which a count past the real width counts as samples, as the JAX
package's sharded builds do.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from krr_tpu_torch.ops import digest as digest_ops
from krr_tpu_torch.ops import topk_sketch as topk_ops
from krr_tpu_torch.ops.cuda_select import masked_percentile_bisect_cuda, radix_digit_hist, row_max_chunk
from krr_tpu_torch.ops.digest import Digest, DigestSpec
from krr_tpu_torch.ops.quantile import peak_max
from krr_tpu_torch.ops.selection import RadixSelect
from krr_tpu_torch.ops.topk_sketch import TopKSketch
from krr_tpu_torch.parallel.mesh import DATA_AXIS, TIME_AXIS, Mesh, fleet_sharding, rows_sharding

#: ``[data][time]`` blocks of an array on a mesh, one tensor per shard on its device.
Blocks = list[list[torch.Tensor]]


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
    """Pad + cast on host, then copy each ``[row block, time block]`` from
    its host slice straight to its device: ``[data][time]`` float32 value
    blocks, the ``[data][time]`` int32 count blocks beside them (each row
    block's counts on every device along time), and the real row count.

    The cast happens in numpy, so the float32 bytes are the resident
    path's; routing through one device first would stage the full matrix
    there, which is the out-of-memory the mesh exists to avoid."""
    values, counts, real_rows = pad_for_mesh(values, counts, mesh)
    values_d = fleet_sharding(mesh).place(np.ascontiguousarray(values, dtype=np.float32))
    counts_d = rows_sharding(mesh).place(np.ascontiguousarray(counts, dtype=np.int32))
    return values_d, counts_d, real_rows


def _shard_eff(counts: torch.Tensor, shard: int, width: int) -> torch.Tensor:
    """Per row, the valid prefix of time shard ``shard`` (``width``
    columns each): ``clamp(count − shard·width, 0, width)``."""
    return torch.clamp(counts - shard * width, 0, width).to(torch.int32)


def gather_rows(blocks: Sequence, read: Callable[[object], torch.Tensor], real_rows: int) -> np.ndarray:
    """``read`` of each row block's result (a percentile, a digest's
    counts), concatenated on the host and cut to the real rows."""
    return np.concatenate([read(block).cpu().numpy() for block in blocks])[:real_rows]


def sharded_fleet_digest(
    spec: DigestSpec,
    values: np.ndarray,
    counts: np.ndarray,
    mesh: Mesh,
) -> tuple[list[Digest], int]:
    """Build the fleet digest over a mesh: one ``digest_hist`` launch per
    shard, merged onto each row block's first device. Returns (one digest
    per row block, real row count)."""
    values_d, counts_d, real_rows = transfer_to_mesh(values, counts, mesh)
    digests = []
    for row_values, row_counts in zip(values_d, counts_d):
        home = row_counts[0].device
        merged = None
        for j, (local_values, local_counts) in enumerate(zip(row_values, row_counts)):
            t_local = local_values.shape[1]
            local = digest_ops.build_from_packed(spec, local_values, local_counts, time_offset=j * t_local)
            local = Digest(*(field.to(home) for field in local))
            merged = local if merged is None else digest_ops.merge(merged, local)
        digests.append(merged)
    return digests, real_rows


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
    sketches = []
    for row_values, row_counts in zip(values_d, counts_d):
        home = row_counts[0].device
        locals_ = []
        for j, (local_values, local_counts) in enumerate(zip(row_values, row_counts)):
            t_local = local_values.shape[1]
            local = topk_ops.build_from_packed(local_values, local_counts, k, time_offset=j * t_local)
            locals_.append(TopKSketch(*(field.to(home) for field in local)))
        if len(locals_) == 1:
            sketches.append(locals_[0])
            continue
        gathered = torch.cat([local.values for local in locals_], dim=1)
        total = torch.stack([local.total for local in locals_]).sum(dim=0)
        sketches.append(TopKSketch(values=torch.topk(gathered, k, dim=1).values, total=total))
    return sketches, real_rows


def sharded_masked_max(values: np.ndarray, counts: np.ndarray, mesh: Mesh) -> np.ndarray:
    """Exact per-row max over the mesh (memory recommendations): one
    ``row_max`` launch per shard on its valid prefix, −inf where the shard
    holds none of the row, merged with ``peak_max``; NaN for empty rows
    (and for every row of a window with no columns, as the resident max
    gives)."""
    values_d, counts_d, real_rows = transfer_to_mesh(values, counts, mesh)
    out = []
    for row_values, row_counts in zip(values_d, counts_d):
        home_counts = row_counts[0]
        peak = None
        for j, (local_values, local_counts) in enumerate(zip(row_values, row_counts)):
            t_local = local_values.shape[1]
            local = row_max_chunk(local_values, _shard_eff(local_counts, j, t_local)).to(home_counts.device)
            peak = local if peak is None else peak_max(peak, local)
        empty = (home_counts <= 0) | (values.shape[1] == 0)
        out.append(torch.where(empty, torch.full_like(peak, float("nan")), peak).cpu().numpy())
    return np.concatenate(out)[:real_rows]


def _select_over_time(row_values: list[torch.Tensor], row_counts: list[torch.Tensor], q: float) -> torch.Tensor:
    """One row block's percentile over its time shards: the passes of
    :class:`RadixSelect`, each one ``radix_digit_hist`` launch per shard
    under the block's prefixes, the shards' bins summed on the block's
    first device."""
    home = row_counts[0].device
    t_local = row_values[0].shape[1]
    plan = RadixSelect(row_counts[0], q, t_local * len(row_values))
    effs = [_shard_eff(plan.live.to(v.device), j, t_local) for j, v in enumerate(row_values)]

    def count_pass(prefix32: torch.Tensor, shift: int, bits: int) -> torch.Tensor:
        total = None
        for local_values, eff in zip(row_values, effs):
            bins = torch.zeros((local_values.shape[0], 1 << bits), dtype=torch.int32, device=local_values.device)
            bins = radix_digit_hist(local_values, eff, prefix32.to(local_values.device), bins, shift, bits)
            total = bins.to(home) if total is None else total + bins.to(home)
        return total

    return plan.run(count_pass)


def sharded_percentile_bisect(values: np.ndarray, counts: np.ndarray, q: float, mesh: Mesh) -> np.ndarray:
    """Exact per-row percentile over the mesh: the sample the 31-step
    bit-space bisection selects (`krr_tpu_torch.ops.selection`), NaN for
    empty rows. With one time shard, one ``bisect_select`` launch per row
    block; with more, the time-sharded radix select (the module's
    docstring)."""
    values_d, counts_d, real_rows = transfer_to_mesh(values, counts, mesh)
    out = []
    for row_values, row_counts in zip(values_d, counts_d):
        if len(row_values) == 1:
            out.append(masked_percentile_bisect_cuda(row_values[0], row_counts[0], q))
        else:
            out.append(_select_over_time(row_values, row_counts, q))
    return np.concatenate([p.cpu().numpy() for p in out])[:real_rows]
