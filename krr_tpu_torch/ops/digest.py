"""Mergeable quantile digest over log-spaced buckets (DDSketch-style).

Port of `krr_tpu/ops/digest.py`: the sketch behind the ``tdigest`` strategy.
Each row's samples fold into ``B`` bucket counts; merging adds counts, so
chunked builds, device merges and resumed state are all the same associative
operation, and every percentile carries a guaranteed relative value error of
``sqrt(gamma) − 1`` (0.5 % at the default ``gamma = 1.01``).

Bucket layout: bucket 0 is the underflow bucket (values ≤ ``min_value``,
idle-CPU zeros included, estimated as 0); bucket ``j ≥ 1`` covers
``[min_value·γ^(j−1), min_value·γ^j)`` and is estimated by its geometric
midpoint. The digest also keeps each row's exact max and total count.

On a CUDA tensor the histogram and the chunk peak come from the
``digest_hist`` kernel (`krr_tpu_torch.ops.cuda_sketch`); on a CPU tensor
from its plain version. Counts are exact integers on both, so chunked and
one-shot builds are bit-identical. The percentile query is plain PyTorch on
either device, as it is plain ``jnp`` in the JAX package; its per-bucket
estimates are computed once on the CPU, so the card and the CPU report the
same value for the same bucket. PyTorch's float32 ``exp`` and XLA's CPU
``exp`` differ by one or two ulps on some of those estimates (224 of the
2,560 at the default spec), far inside the digest's error bound.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
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
from krr_tpu_torch.ops.cuda_sketch import bucket_indices, digest_hist, row_histogram
from krr_tpu_torch.ops.quantile import max_where, peak_max

if TYPE_CHECKING:
    from krr_tpu_torch.obs.device import DeviceObs


@dataclass(frozen=True)
class DigestSpec:
    """Static configuration of the digest."""

    gamma: float = 1.01
    min_value: float = 1e-7
    num_buckets: int = 2560

    @property
    def log_gamma(self) -> float:
        return math.log(self.gamma)

    @property
    def max_value(self) -> float:
        """Largest value representable without clipping into the top bucket."""
        return self.min_value * self.gamma ** (self.num_buckets - 2)

    @property
    def relative_error(self) -> float:
        return math.sqrt(self.gamma) - 1.0


class Digest(NamedTuple):
    """Per-row digest state."""

    counts: torch.Tensor  # [N, B] float32 bucket counts (exact integers)
    total: torch.Tensor  # [N] float32 total sample count
    peak: torch.Tensor  # [N] float32 exact max (-inf when empty)


def empty(spec: DigestSpec, num_rows: int, *, device: "torch.device | str") -> Digest:
    return Digest(
        counts=torch.zeros((num_rows, spec.num_buckets), dtype=torch.float32, device=device),
        total=torch.zeros((num_rows,), dtype=torch.float32, device=device),
        peak=torch.full((num_rows,), float("-inf"), dtype=torch.float32, device=device),
    )


def bucketize(spec: DigestSpec, values: torch.Tensor) -> torch.Tensor:
    """Map values to bucket indices (int32). Values ≤ min_value → bucket 0."""
    return bucket_indices(values, spec.num_buckets, spec.min_value, spec.log_gamma)


def add_prefix_chunk(spec: DigestSpec, digest: Digest, values: torch.Tensor, eff: torch.Tensor) -> Digest:
    """Fold one contiguous ``[N, Tc]`` chunk whose valid positions are the
    prefixes ``values[i, :eff[i]]`` into the digest: one ``digest_hist``
    call — the kernel branch of :func:`add_chunk`, and the fold of the
    host-streamed build."""
    hist, chunk_peak = digest_hist(values, eff, spec.num_buckets, spec.min_value, spec.log_gamma)
    return Digest(
        counts=digest.counts + hist,
        total=digest.total + eff.to(torch.float32),
        peak=peak_max(digest.peak, chunk_peak),
    )


def add_chunk(
    spec: DigestSpec,
    digest: Digest,
    values: torch.Tensor,
    valid: torch.Tensor,
    mask_is_prefix: bool = False,
) -> Digest:
    """Fold one ``[N, Tc]`` time chunk (with validity mask) into the digest.

    ``valid`` may be any boolean mask. The kernel reads it as a per-row
    prefix length, so unless the caller promises a prefix
    (``mask_is_prefix``, as `krr_tpu_torch.ops.chunked` does by
    construction) the mask is checked, and a mask that is not a prefix takes
    the generic path — the same counts either way."""
    eff = valid.sum(dim=1, dtype=torch.int32)

    def kernel(operands: "tuple[Digest, torch.Tensor, torch.Tensor]") -> Digest:
        digest, values, _ = operands
        return add_prefix_chunk(spec, digest, values.contiguous(), eff)

    def generic(operands: "tuple[Digest, torch.Tensor, torch.Tensor]") -> Digest:
        digest, values, valid = operands
        return Digest(
            counts=digest.counts + row_histogram(bucketize(spec, values), valid, spec.num_buckets),
            total=digest.total + eff.to(torch.float32),
            peak=peak_max(digest.peak, max_where(values, valid, float("-inf"))),
        )

    return dispatch_prefix_kernel("digest", kernel, generic, (digest, values, valid), valid, eff, mask_is_prefix)


def merge(a: Digest, b: Digest) -> Digest:
    """Associative, commutative merge."""
    return Digest(counts=a.counts + b.counts, total=a.total + b.total, peak=peak_max(a.peak, b.peak))


def bucket_estimates(spec: DigestSpec) -> torch.Tensor:
    """Per-bucket estimate ``[B]`` float32 on the CPU: 0 for bucket 0, the
    geometric midpoint ``min_value·exp((k − 0.5)·log γ)`` for bucket k."""
    k = torch.arange(spec.num_buckets, dtype=torch.float32)
    estimate = spec.min_value * torch.exp((k - 0.5) * spec.log_gamma)
    return torch.where(k == 0, torch.zeros_like(estimate), estimate)


def percentile(spec: DigestSpec, digest: Digest, q: float) -> torch.Tensor:
    """Per-row q-th percentile estimate with reference rank semantics
    (``rank = floor((n − 1)·q / 100)``). NaN for empty rows."""
    total = digest.total
    q32 = torch.tensor(q, dtype=torch.float32, device=total.device)
    rank = torch.clamp_min(torch.floor((total - 1.0) * q32 / torch.full_like(total, 100.0)), 0.0)
    cum = torch.cumsum(digest.counts, dim=1)
    # First bucket whose running count passes the rank; none (an empty row) → 0.
    k = (cum <= rank[:, None]).sum(dim=1)
    k = torch.where(k >= spec.num_buckets, torch.zeros_like(k), k)
    estimate = bucket_estimates(spec).to(total.device)[k]
    # The digest never needs to report beyond the exactly-tracked max.
    estimate = torch.minimum(estimate, digest.peak)
    return torch.where(total > 0, estimate, torch.full_like(estimate, float("nan")))


def peak(digest: Digest) -> torch.Tensor:
    """Exact per-row max; NaN for empty rows."""
    return torch.where(digest.total > 0, digest.peak, torch.full_like(digest.peak, float("nan")))


def percentile_host(
    spec: DigestSpec, counts: np.ndarray, total: np.ndarray, peaks: np.ndarray, q: float
) -> np.ndarray:
    """Host-numpy :func:`percentile` — the same math (float64 ``exp``), for
    digests that live in host memory. Rows go in blocks of 4,096 so the
    cumsum temporary stays cache-sized; a block holding a row whose total
    reaches 2^24 sums in float64, where float32 would saturate."""
    n = counts.shape[0]
    total = np.asarray(total)
    out = np.empty(n, dtype=np.float32)
    for s in range(0, max(n, 1), 4096):
        e = min(s + 4096, n)
        t_blk = total[s:e].astype(np.float64)
        rank = np.maximum(np.floor((t_blk - 1.0) * q / 100.0), 0.0)
        cum_dtype = np.float64 if t_blk.size and t_blk.max() >= 2**24 else np.float32
        cum = np.cumsum(counts[s:e], axis=1, dtype=cum_dtype)
        k = np.argmax(cum > rank.astype(cum_dtype)[:, None], axis=1).astype(np.float64)
        estimate = np.where(k == 0, 0.0, spec.min_value * np.exp((k - 0.5) * spec.log_gamma))
        estimate = np.minimum(estimate, peaks[s:e])
        out[s:e] = np.where(t_blk > 0, estimate, np.nan).astype(np.float32)
    return out[:n]


def build_from_packed(
    spec: DigestSpec,
    values: torch.Tensor,
    counts: torch.Tensor,
    chunk_size: Optional[int] = None,
    time_offset: int = 0,
) -> Digest:
    """Build a digest from a packed ``[N, T]`` array.

    By default one ``digest_hist`` call over the whole resident array (the
    kernel walks each row itself). With ``chunk_size`` the build scans time
    chunks through :func:`add_chunk` — bit-identical, since the merge is
    exact integer addition. ``time_offset`` is the global position of
    ``values[:, 0]`` when this array is one time-shard of a larger matrix:
    validity is decided against the row's global count."""
    n, t = values.shape
    if chunk_size is None:
        eff = torch.clamp(counts.to(torch.int32) - time_offset, 0, t).to(torch.int32)
        hist, row_peak = digest_hist(values, eff, spec.num_buckets, spec.min_value, spec.log_gamma)
        return Digest(counts=hist, total=eff.to(torch.float32), peak=row_peak)
    return scan_time_chunks(
        values,
        counts,
        empty(spec, n, device=values.device),
        lambda digest, chunk, valid: add_chunk(spec, digest, chunk, valid, mask_is_prefix=True),
        chunk_size,
        time_offset,
    )


def build_from_host(
    spec: DigestSpec,
    values: np.ndarray,
    counts: np.ndarray,
    chunk_size: int = 8192,
    time_offset: int = 0,
    *,
    device: "torch.device | str" = "cuda",
    stats: Optional[StreamStats] = None,
    obs: Optional["DeviceObs"] = None,
    devices: Optional[Sequence["torch.device | str"]] = None,
) -> Digest:
    """Build a digest from a **host** ``[N, T]`` matrix, streaming time
    chunks to the device (`krr_tpu_torch.ops.chunked.HostChunkStreamer`):
    bit-identical to :func:`build_from_packed`, while device memory holds
    only the digest plus two chunks. Every chunk is one ``digest_hist`` call
    through :func:`add_prefix_chunk` — the streamer's validity is a prefix
    by construction, so no fold takes the generic path. With ``devices``
    the rows split over those devices, each block streaming on its own, and
    the digest is gathered onto the first
    (`krr_tpu_torch.ops.chunked.split_rows`)."""

    def stream(values: np.ndarray, counts: np.ndarray, device: torch.device) -> Digest:
        return stream_host_chunks(
            values,
            counts,
            empty(spec, values.shape[0], device=device),
            lambda digest, chunk, eff: add_prefix_chunk(spec, digest, chunk, eff),
            chunk_size,
            time_offset,
            device=device,
            stats=stats,
            obs=obs,
        )

    return split_rows(values, counts, [device] if devices is None else devices, stream)
