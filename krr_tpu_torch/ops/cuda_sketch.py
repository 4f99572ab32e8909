"""The `tdigest` strategy's sketch builds: CUDA kernels + their wrappers.

Replaces `krr_tpu/ops/pallas_sketch.py`. Two hand-written kernels
(`krr_tpu_torch/csrc/sketch.cu`, where each kernel's note says what it
replaces, what bounds it on the card and what its design does about it):

* ``digest_hist`` — per-row log-bucket histogram plus the running peak over
  the valid prefix (the JAX package's ``_digest_kernel``);
* ``topk_select`` — per-row top-min(K, n) multiset of the valid prefixes of a
  chunk and a state (``_topk_kernel``).

Each wrapper checks device, dtype, shape and contiguity and raises on
anything else. On a CPU tensor it runs the plain PyTorch version
(:func:`digest_hist_plain`, :func:`topk_select_plain`); on a CUDA tensor it
launches the kernel or raises — there is no fallback. :data:`LAUNCHES`
counts kernel launches per kernel, so a run can show that it went through
the kernels. The kernels take any ``N ≥ 0``, ``T ≥ 0``, bucket count
``B ≥ 2`` and ``K ≥ 1``: the TPU tiling and its "unsupported shape" paths do
not carry over.

Numerics the plain versions pin (and the kernels repeat):

* ``bucket_indices`` keeps the JAX package's float32 op order
  (``max(v, min)``, ``/ min``, ``log``, ``/ log γ``, ``floor``) with both
  divisors as tensors — PyTorch may turn division by a Python scalar into
  multiplication by its reciprocal, which rounds differently. The clip to
  ``[0, B − 2]`` happens in float before the int cast, so NaN → 0 and
  ``+inf`` → ``B − 2`` as XLA's saturating cast gives; PyTorch's own cast
  of ``+inf`` gives ``INT32_MIN``.
* ``log`` differs by an ulp between XLA's CPU backend, PyTorch's CPU kernel
  and the card's libdevice, so a value within an ulp of a bucket edge may
  land one bucket over — the digest's own contract
  (`krr_tpu/ops/pallas_sketch.py:46-51`).
* The top-K slots hold ordered bits (`krr_tpu_torch.ops.selection`), so a
  negative, −0.0 or subnormal sample is placed as +0.0, as the TPU kernel
  places it; slot order is unspecified and comparisons sort.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from krr_tpu_torch.ops import cuda_build
from krr_tpu_torch.ops.cuda_select import check_rows
from krr_tpu_torch.ops.quantile import max_where
from krr_tpu_torch.ops.selection import INT32_MIN, as_ordered_bits, valid_mask

#: Kernel launches per kernel since the last :func:`reset_launches`.
LAUNCHES: dict[str, int] = {"digest_hist": 0, "topk_select": 0}

#: float32 bits of −inf, the value of an empty top-K slot.
NEG_INF_BITS = int(np.array(-np.inf, dtype=np.float32).view(np.int32))

_SOURCE = "sketch"
_SIGNATURES = {
    "krr_digest_hist": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
    ],
    "krr_digest_table_ints": [ctypes.c_int, ctypes.c_float, ctypes.c_float],
    "krr_digest_tables": [ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_void_p],
    "krr_digest_table_check": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
    ],
    "krr_topk_select": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
    ],
    "krr_topk_cache_ints": [],
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _library() -> ctypes.CDLL:
    return cuda_build.load(_SOURCE, _SIGNATURES)


# ------------------------------------------------------------------ digest


def bucket_indices(values: torch.Tensor, num_buckets: int, min_value: float, log_gamma: float) -> torch.Tensor:
    """Log-bucket index per value (int32): bucket 0 for ``v ≤ min_value``,
    else ``1 + clip(floor(log(v / min) / log γ), 0, B − 2)`` in float32."""
    min32 = torch.full_like(values, float(np.float32(min_value)))
    safe = torch.where(values < min32, min32, values)  # jnp.maximum: NaN stays NaN
    raw = torch.floor(torch.log(safe / min32) / torch.full_like(values, float(np.float32(log_gamma))))
    clipped = torch.clamp_max(torch.where(raw >= 0, raw, torch.zeros_like(raw)), float(num_buckets - 2))
    idx = 1 + clipped.to(torch.int32)
    return torch.where(values <= min32, torch.zeros_like(idx), idx)


def row_histogram(idx: torch.Tensor, valid: torch.Tensor, num_buckets: int) -> torch.Tensor:
    """Per-row counts ``[N, B]`` (exact integers in float32) of the bucket
    indices at the positions ``valid`` selects (any boolean mask)."""
    hist = torch.zeros((idx.shape[0], num_buckets), dtype=torch.int32, device=idx.device)
    hist.scatter_add_(1, idx.to(torch.int64), valid.to(torch.int32))
    return hist.to(torch.float32)


def digest_hist_plain(
    values: torch.Tensor, eff_counts: torch.Tensor, num_buckets: int, min_value: float, log_gamma: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of :func:`digest_hist`, on any device."""
    valid = valid_mask(eff_counts, values.shape[1])
    hist = row_histogram(bucket_indices(values, num_buckets, min_value, log_gamma), valid, num_buckets)
    return hist, max_where(values, valid, float("-inf"))


def _check_spec(num_buckets: int, min_value: float, log_gamma: float, what: str) -> None:
    """Raise unless ``B ≥ 2`` and ``min_value`` and ``log γ`` are positive
    and finite in float32 — the specs the digest kernel's tables take."""
    if num_buckets < 2:
        raise ValueError(f"{what}: num_buckets must be at least 2, got {num_buckets}")
    for name, value in (("min_value", min_value), ("log_gamma", log_gamma)):
        value32 = np.float32(value)
        if not (np.isfinite(value32) and value32 > 0):
            raise ValueError(f"{what}: {name} must be positive and finite in float32, got {value}")


def _tables(lib: ctypes.CDLL, num_buckets: int, min_value: float, log_gamma: float, device) -> torch.Tensor:
    """Scratch for the kernel's bucket tables (the edge table, then the
    coarse table)."""
    ints = lib.krr_digest_table_ints(num_buckets, min_value, log_gamma)
    return torch.empty((ints,), dtype=torch.int32, device=device)


#: The digest kernel's bucket tables per (device, B, min_value, log γ in
#: float32), built on the card at the spec's first ``digest_hist`` call.
_TABLES: dict[tuple, torch.Tensor] = {}


def build_digest_tables(num_buckets: int, min_value: float, log_gamma: float, device) -> torch.Tensor:
    """The ``digest_hist`` kernel's bucket tables for a spec, built on the
    card on the current stream (``krr_digest_tables``)."""
    lib = _library()
    tables = _tables(lib, num_buckets, min_value, log_gamma, device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = lib.krr_digest_tables(tables.data_ptr(), num_buckets, min_value, log_gamma, stream)
    cuda_build.raise_on_error(lib, code, "digest_tables")
    return tables


def digest_tables(num_buckets: int, min_value: float, log_gamma: float, device: torch.device) -> torch.Tensor:
    """The spec's tables on ``device``, built once and kept: a build costs
    about a third of the fold of a streamed [10,000, 8,192] chunk, which
    would otherwise pay it once a chunk. The first build is waited for, so
    a launch on any stream may read the tables."""
    key = (str(device), num_buckets, float(np.float32(min_value)), float(np.float32(log_gamma)))
    if key not in _TABLES:
        tables = build_digest_tables(num_buckets, min_value, log_gamma, device)
        torch.cuda.current_stream(device).synchronize()
        _TABLES[key] = tables
    return _TABLES[key]


def digest_hist(
    values: torch.Tensor, eff_counts: torch.Tensor, num_buckets: int, min_value: float, log_gamma: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """(histogram ``[N, B]`` float32, peak ``[N]`` float32) over the valid
    prefix ``values[i, :eff_counts[i]]``: the ``digest_hist`` kernel on a
    CUDA tensor, :func:`digest_hist_plain` on a CPU tensor. The peak is −inf
    for an empty row and NaN for a row holding NaN."""
    check_rows(values, eff_counts, "digest_hist")
    _check_spec(num_buckets, min_value, log_gamma, "digest_hist")
    if values.device.type == "cpu":
        return digest_hist_plain(values, eff_counts, num_buckets, min_value, log_gamma)
    n, t = values.shape
    hist = torch.empty((n, num_buckets), dtype=torch.float32, device=values.device)
    peak = torch.empty((n,), dtype=torch.float32, device=values.device)
    if n == 0:
        return hist, peak
    tables = digest_tables(num_buckets, min_value, log_gamma, values.device)
    lib = _library()
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream(values.device).cuda_stream
        code = lib.krr_digest_hist(
            values.data_ptr(), eff_counts.data_ptr(), hist.data_ptr(), peak.data_ptr(), tables.data_ptr(), n, t,
            num_buckets, min_value, log_gamma, stream,
        )
    cuda_build.raise_on_error(lib, code, "digest_hist")
    LAUNCHES["digest_hist"] += 1
    return hist, peak


def digest_table_check(num_buckets: int, min_value: float, log_gamma: float, device="cuda") -> dict:
    """The proof behind the ``digest_hist`` kernel's tables, on the card:
    the kernel's own bucket formula and its table route over all 2^32
    float32 bit patterns. Returns the mismatch count, the smallest
    mismatching pattern (None when there is none), the number of edges (bit
    patterns where the bucket steps up), the most edges any 2^16-pattern
    range holds, and the coarse table's length."""
    _check_spec(num_buckets, min_value, log_gamma, "digest_table_check")
    lib = _library()
    tables = _tables(lib, num_buckets, min_value, log_gamma, device)
    result = torch.tensor([0, -1], dtype=torch.int64, device=device)  # -1: all ones as unsigned
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = lib.krr_digest_table_check(
            tables.data_ptr(), result.data_ptr(), num_buckets, min_value, log_gamma, stream
        )
    cuda_build.raise_on_error(lib, code, "digest_table_check")
    mismatches, first = (int(x) for x in result.cpu())
    edges = np.unique(tables[1:num_buckets].cpu().numpy())
    per_range = np.unique(edges >> 16, return_counts=True)[1]
    return {
        "mismatches": mismatches,
        "first_mismatch_bits": None if mismatches == 0 else first & 0xFFFFFFFF,
        "edges": int(edges.size),
        "max_edges_per_2^16_range": int(per_range.max()),
        "coarse_entries": int(tables.numel() - num_buckets),
    }


# ------------------------------------------------------------------- top-K


def topk_select_plain(
    values: torch.Tensor,
    eff_counts: torch.Tensor,
    k: int,
    state: Optional[torch.Tensor] = None,
    state_counts: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The plain PyTorch version of :func:`topk_select`, on any device:
    ``torch.topk`` over the ordered bits of state ∪ chunk (positions past
    each count set below every valid value), then the τ / −inf fill rule."""
    n, t = values.shape
    if state is None:
        state = values.new_zeros((n, 0))
        state_counts = torch.zeros_like(eff_counts)
    s = state.shape[1]
    total = eff_counts.clamp(0, t) + state_counts.clamp(0, s)
    kv = torch.clamp_max(total, k)
    slot = torch.arange(k, dtype=torch.int32, device=values.device)[None, :]
    neg_inf = torch.full((n, k), NEG_INF_BITS, dtype=torch.int32, device=values.device)
    if t + s == 0:
        return neg_inf.view(torch.float32)
    valid = torch.cat([valid_mask(eff_counts, t), valid_mask(state_counts, s)], dim=1)
    bits = torch.cat([as_ordered_bits(values), as_ordered_bits(state)], dim=1)
    bits = torch.where(valid, bits, torch.full_like(bits, INT32_MIN))
    top = torch.topk(bits, min(k, t + s), dim=1).values  # descending
    if top.shape[1] < k:
        top = torch.cat([top, neg_inf[:, top.shape[1]:]], dim=1)
    # τ, the kv-th largest, as the bisection over [0, INT32_MAX] pins it.
    kth = torch.gather(top, 1, torch.clamp_min(kv - 1, 0).to(torch.int64)[:, None])
    tau = torch.clamp_min(kth, 0)
    c_gt = (top > tau).sum(dim=1, keepdim=True, dtype=torch.int32)
    out = torch.where(slot < c_gt, top, torch.where(slot < kv[:, None], tau, neg_inf))
    return out.view(torch.float32)


def topk_cache_ints() -> int:
    """How many ordered bits of a row's head the ``topk_select`` kernel
    keeps in shared memory; builds the kernel's library on first use."""
    return _library().krr_topk_cache_ints()


def topk_select(
    values: torch.Tensor,
    eff_counts: torch.Tensor,
    k: int,
    state: Optional[torch.Tensor] = None,
    state_counts: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Top-min(K, n) multiset ``[N, K]`` float32 of the valid prefixes of
    ``values`` (and ``state`` when given): survivors, then τ copies, then
    −inf, in unspecified slot order — the ``topk_select`` kernel on a CUDA
    tensor, :func:`topk_select_plain` on a CPU tensor."""
    check_rows(values, eff_counts, "topk_select")
    if (state is None) != (state_counts is None):
        raise ValueError("topk_select: state and state_counts go together")
    if state is not None:
        check_rows(state, state_counts, "topk_select")
        if state.shape[0] != values.shape[0] or state.device != values.device:
            raise ValueError("topk_select: state and chunk must share rows and device")
    if k < 1:
        raise ValueError(f"topk_select: k must be at least 1, got {k}")
    s = 0 if state is None else state.shape[1]
    if values.shape[1] + s > 2**31 - 1:
        raise ValueError("topk_select: chunk plus state wider than 2^31 - 1 positions")
    if values.device.type == "cpu":
        return topk_select_plain(values, eff_counts, k, state, state_counts)
    n, t = values.shape
    out = torch.empty((n, k), dtype=torch.float32, device=values.device)
    if n == 0:
        return out
    lib = _library()
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream(values.device).cuda_stream
        code = lib.krr_topk_select(
            values.data_ptr(), eff_counts.data_ptr(),
            None if state is None else state.data_ptr(), None if state is None else state_counts.data_ptr(),
            out.data_ptr(), n, t, s, k, stream,
        )
    cuda_build.raise_on_error(lib, code, "topk_select")
    LAUNCHES["topk_select"] += 1
    return out
