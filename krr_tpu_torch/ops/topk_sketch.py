"""Exact streaming quantile sketch for high percentiles: per-row top-K values.

Port of `krr_tpu/ops/topk_sketch.py`. For q ≥ ~97 the rank-from-the-top of
the percentile is a small, a-priori bounded number ``K`` (1,211 for p99 over
7 d @ 5 s, 1,280 after rounding to 128), so keeping each row's top-K samples
is a fixed-size, **exact** sketch: chunks fold into the kept multiset, the
top-K of a union is inside the union of top-Ks (so merging is associative),
and the percentile at rank r from the top is the r-th largest kept value.

**State contract:** ``values[i]`` holds the top-``min(K, total_i)``
multiset in its first ``min(K, total_i)`` slots — in unspecified order —
and −inf in the rest. The slots hold ordered bits (negatives, −0.0 and
subnormals as +0.0), as the ``topk_select`` kernel places them
(`krr_tpu_torch.ops.cuda_sketch`); :func:`percentile` queries by masked
bisection, so slot order never matters.
"""

from __future__ import annotations

import math
from typing import TYPE_CHECKING, NamedTuple, Optional, Sequence

import numpy as np
import torch

from krr_tpu_torch.ops.chunked import (
    StreamStats,
    dispatch_prefix_kernel,
    scan_time_chunks,
    split_rows,
    stream_host_chunks,
)
from krr_tpu_torch.ops.cuda_sketch import topk_select
from krr_tpu_torch.ops.quantile import max_where
from krr_tpu_torch.ops.selection import as_ordered_bits, bisect_loop

if TYPE_CHECKING:
    from krr_tpu_torch.obs.device import DeviceObs


class TopKSketch(NamedTuple):
    """Per-row exact top-K state."""

    values: torch.Tensor  # [N, K] float32; top-min(K, total) multiset in the
    #                       first slots (order unspecified), -inf beyond
    total: torch.Tensor  # [N] float32 total (valid) sample count


def required_k(capacity: int, q: float) -> int:
    """Smallest K that answers percentile ``q`` for any row with up to
    ``capacity`` samples, with the reference's rank semantics
    (``index = floor((n - 1) * q / 100)`` into the ascending sort), rounded
    up to a multiple of 128."""
    if capacity <= 0:
        return 128
    n = capacity
    rank_from_top = (n - 1) - math.floor((n - 1) * q / 100.0)
    return ((rank_from_top + 1) + 127) // 128 * 128


def empty(num_rows: int, k: int, *, device: "torch.device | str") -> TopKSketch:
    return TopKSketch(
        values=torch.full((num_rows, k), float("-inf"), dtype=torch.float32, device=device),
        total=torch.zeros((num_rows,), dtype=torch.float32, device=device),
    )


def _valid_slots(sketch: TopKSketch) -> torch.Tensor:
    """Per-row count of populated slots: min(K, total), int32."""
    k = sketch.values.shape[1]
    return torch.clamp_max(sketch.total, float(k)).to(torch.int32)


def add_prefix_chunk(sketch: TopKSketch, values: torch.Tensor, eff: torch.Tensor) -> TopKSketch:
    """Fold one contiguous ``[N, Tc]`` chunk whose valid positions are the
    prefixes ``values[i, :eff[i]]`` into the sketch: one ``topk_select``
    call over the chunk and the running state — the kernel branch of
    :func:`add_chunk`, and the fold of the host-streamed build."""
    k = sketch.values.shape[1]
    new_values = topk_select(values, eff, k, state=sketch.values, state_counts=_valid_slots(sketch))
    return TopKSketch(values=new_values, total=sketch.total + eff.to(torch.float32))


def add_chunk(
    sketch: TopKSketch,
    values: torch.Tensor,
    valid: torch.Tensor,
    mask_is_prefix: bool = False,
) -> TopKSketch:
    """Fold one ``[N, Tc]`` time chunk (with validity mask) into the sketch.

    ``valid`` may be any boolean mask. The ``topk_select`` kernel reads it as
    a per-row prefix length and takes the state as a second part of the
    same row; unless the caller promises a prefix (``mask_is_prefix``) the
    mask is checked, and a mask that is not a prefix takes the JAX package's
    generic ``top_k(concat)`` path, which keeps raw values — the same
    multiset up to the clamp of negatives."""
    k = sketch.values.shape[1]
    eff = valid.sum(dim=1, dtype=torch.int32)

    def kernel(operands: "tuple[TopKSketch, torch.Tensor, torch.Tensor]") -> TopKSketch:
        sketch, values, _ = operands
        return add_prefix_chunk(sketch, values.contiguous(), eff)

    def generic(operands: "tuple[TopKSketch, torch.Tensor, torch.Tensor]") -> TopKSketch:
        sketch, values, valid = operands
        masked = torch.where(valid, values, torch.full_like(values, float("-inf")))
        top = torch.topk(torch.cat([sketch.values, masked], dim=1), k, dim=1).values
        return TopKSketch(values=top, total=sketch.total + eff.to(torch.float32))

    return dispatch_prefix_kernel("topk", kernel, generic, (sketch, values, valid), valid, eff, mask_is_prefix)


def merge(a: TopKSketch, b: TopKSketch) -> TopKSketch:
    """Associative, commutative merge: ``top_k`` of the concatenated slots —
    the top-K of a multiset union never depends on slot order."""
    k = a.values.shape[1]
    top = torch.topk(torch.cat([a.values, b.values], dim=1), k, dim=1).values
    return TopKSketch(values=top, total=a.total + b.total)


def percentile(sketch: TopKSketch, q: float) -> torch.Tensor:
    """Per-row q-th percentile with reference rank semantics. Exact whenever
    the rank-from-top fits in K (guaranteed by ``required_k``); NaN for
    empty rows — and NaN, not a clipped value, for rows whose rank falls
    outside the sketch.

    Slot order is unspecified, so the query runs the bit-space bisection of
    `krr_tpu_torch.ops.selection` over the populated prefix."""
    k = sketch.values.shape[1]
    total = sketch.total
    kv = _valid_slots(sketch)
    q32 = torch.tensor(q, dtype=torch.float32, device=total.device)
    above = torch.clamp_min(total - 1.0, 0.0)
    rank_bottom = torch.floor(above * q32 / torch.full_like(total, 100.0))
    rank_top = above - rank_bottom
    # Ascending rank of the wanted sample inside the populated prefix.
    upper = torch.clamp_min(kv - 1, 0)
    rank_in_state = torch.minimum(torch.clamp_min(kv - 1 - rank_top.to(torch.int32), 0), upper)
    mask = torch.arange(k, dtype=torch.int32, device=total.device)[None, :] < kv[:, None]
    out = bisect_loop(as_ordered_bits(sketch.values), mask, rank_in_state)
    answerable = (total > 0) & (rank_top < k)
    return torch.where(answerable, out, torch.full_like(out, float("nan")))


def peak(sketch: TopKSketch) -> torch.Tensor:
    """Exact per-row max — the top-1 sample is always in the sketch; NaN for
    empty rows."""
    values = sketch.values
    row_max = max_where(values, torch.ones_like(values, dtype=torch.bool), float("-inf"))
    return torch.where(sketch.total > 0, row_max, torch.full_like(row_max, float("nan")))


def build_from_packed(
    values: torch.Tensor,
    counts: torch.Tensor,
    k: int,
    chunk_size: Optional[int] = None,
    time_offset: int = 0,
) -> TopKSketch:
    """Build the sketch from a packed ``[N, T]`` array.

    By default one ``topk_select`` call with no state over the whole
    resident array. With ``chunk_size`` the build scans time chunks through
    :func:`add_chunk` — the same multiset, since the merge is exact."""
    n, t = values.shape
    if chunk_size is None:
        eff = torch.clamp(counts.to(torch.int32) - time_offset, 0, t).to(torch.int32)
        return TopKSketch(values=topk_select(values, eff, k), total=eff.to(torch.float32))
    return scan_time_chunks(
        values,
        counts,
        empty(n, k, device=values.device),
        lambda sketch, chunk, valid: add_chunk(sketch, chunk, valid, mask_is_prefix=True),
        chunk_size,
        time_offset,
    )


def build_from_host(
    values: np.ndarray,
    counts: np.ndarray,
    k: int,
    chunk_size: int = 8192,
    time_offset: int = 0,
    *,
    device: "torch.device | str" = "cuda",
    stats: Optional[StreamStats] = None,
    obs: Optional["DeviceObs"] = None,
    devices: Optional[Sequence["torch.device | str"]] = None,
) -> TopKSketch:
    """Build the sketch from a **host** ``[N, T]`` matrix, streaming time
    chunks to the device (`krr_tpu_torch.ops.chunked.HostChunkStreamer`):
    the same multiset as :func:`build_from_packed`, with device memory
    bounded by the ``[N, K]`` state plus two chunks. Every chunk is one
    ``topk_select`` call with the running state (:func:`add_prefix_chunk`).
    With ``devices`` the rows split over those devices, each block
    streaming on its own, and the sketch is gathered onto the first
    (`krr_tpu_torch.ops.chunked.split_rows`)."""

    def stream(values: np.ndarray, counts: np.ndarray, device: torch.device) -> TopKSketch:
        return stream_host_chunks(
            values,
            counts,
            empty(values.shape[0], k, device=device),
            add_prefix_chunk,
            chunk_size,
            time_offset,
            device=device,
            stats=stats,
            obs=obs,
        )

    return split_rows(values, counts, [device] if devices is None else devices, stream)
