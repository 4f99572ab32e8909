"""Exact order statistics without sorting: bit-space bisection, plain PyTorch.

For non-negative float32 values the IEEE-754 bit pattern, read as int32, is
monotone in the value. So the k-th smallest value of a row can be found by
binary search over the 31-bit pattern space: at each step count how many
valid samples have a bit pattern ≤ mid and move the bounds. 31 iterations pin
every bit of the answer, yielding exactly the sample a sort would select.

These are the plain versions of the selection: the CPU path of the port, and
what the hand-written kernel (`krr_tpu_torch.ops.cuda_select`) is held
against on the card. Every step is integer arithmetic on the ordered bits, so
the plain version and the kernel agree bit for bit on any input.

Parity with the JAX package (`krr_tpu/ops/selection.py`), which runs on XLA's
CPU backend in the reference tests:

* ``jnp.maximum(v, 0.0)`` there maps −0.0 to +0.0 and flushes subnormals to
  zero, but keeps NaN (payload included). :func:`as_ordered_bits` reproduces
  that on the bits — NaN keeps its bits, everything below the smallest normal
  (negatives, −0.0, subnormals) becomes 0 — with no float arithmetic, so the
  result does not depend on the FPU's flush-to-zero mode.
* :func:`selection_rank` keeps the reference's float32 op order (cast, −1,
  ×q, ÷100, floor, clip). The divisor is a tensor, never a Python scalar:
  PyTorch may turn division by a scalar into multiplication by its
  reciprocal, which rounds differently.
"""

from __future__ import annotations

import torch

INT32_MAX = 2**31 - 1
#: Smallest positive normal float32, as bits: patterns below it (as signed
#: int32) are negatives, ±0.0 and subnormals.
MIN_NORMAL_BITS = 0x00800000
INT32_MIN = -(2**31)
#: Bits above this (magnitude only) are NaN; this itself is +inf.
EXPONENT_BITS = 0x7F800000
MAGNITUDE_MASK = 0x7FFFFFFF


def as_ordered_bits(values: torch.Tensor) -> torch.Tensor:
    """float32 → int32 with value-monotone ordering over ``max(v, 0)``.

    NaN keeps its bits (a positive NaN sorts above every finite value);
    negatives, −0.0 and subnormals map to 0."""
    bits = values.contiguous().view(torch.int32)
    is_nan = (bits & MAGNITUDE_MASK) > EXPONENT_BITS
    return torch.where(is_nan | (bits >= MIN_NORMAL_BITS), bits, torch.zeros_like(bits))


def selection_rank(counts: torch.Tensor, q: "torch.Tensor | float") -> torch.Tensor:
    """0-based rank of the selected sample per row — reference semantics
    ``floor((n - 1) * q / 100)``, clamped into ``[0, n - 1]`` (without the
    upper clamp, float rounding at q=100 on huge rows — or q>100 — would never
    satisfy the bisection predicate and decay to NaN)."""
    q32 = torch.as_tensor(q, dtype=torch.float32, device=counts.device)
    n = counts.to(torch.float32)
    hundred = torch.full_like(n, 100.0)
    rank = torch.floor((n - 1.0) * q32 / hundred).to(torch.int32)
    upper = torch.clamp_min(counts.to(torch.int32) - 1, 0)
    return torch.minimum(torch.clamp_min(rank, 0), upper)


def bisect_bounds(n: int, device: "torch.device | str" = "cpu") -> tuple[torch.Tensor, torch.Tensor]:
    """Initial inclusive (lo, hi) over the 31-bit pattern space."""
    return (
        torch.zeros((n,), dtype=torch.int32, device=device),
        torch.full((n,), INT32_MAX, dtype=torch.int32, device=device),
    )


def bisect_mid(low: torch.Tensor, high: torch.Tensor) -> torch.Tensor:
    return low + torch.div(high - low, 2, rounding_mode="floor")


def bisect_update(
    low: torch.Tensor, high: torch.Tensor, mid: torch.Tensor, le: torch.Tensor, rank: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """One bound update from the ≤-mid counts. The tie rule ("if enough
    samples are ≤ mid, the answer is ≤ mid") lives ONLY here."""
    go_low = le >= rank + 1
    return torch.where(go_low, low, mid + 1), torch.where(go_low, mid, high)


def bisect_loop(bits: torch.Tensor, mask: torch.Tensor, rank: torch.Tensor, num_iters: int = 31) -> torch.Tensor:
    """The bisection core: binary search over the 31-bit pattern space,
    counting the valid samples whose bits are ≤ mid at each step."""
    low, high = bisect_bounds(bits.shape[0], bits.device)
    for _ in range(num_iters):
        mid = bisect_mid(low, high)
        le = (mask & (bits <= mid[:, None])).sum(dim=1, dtype=torch.int32)
        low, high = bisect_update(low, high, mid, le, rank)
    return low.view(torch.float32)


def valid_mask(counts: torch.Tensor, capacity: int) -> torch.Tensor:
    """[N, T] validity mask from per-row counts (left-justified packing)."""
    positions = torch.arange(capacity, dtype=torch.int32, device=counts.device)
    return positions[None, :] < counts[:, None]


def masked_percentile_bisect(
    values: torch.Tensor,
    counts: torch.Tensor,
    q: "torch.Tensor | float",
    num_iters: int = 31,
) -> torch.Tensor:
    """Per-row exact percentile (reference rank semantics: sorted index
    ``floor((n-1) * q / 100)``) of non-negative float32 data via bit
    bisection. NaN for empty rows."""
    mask = valid_mask(counts, values.shape[1])
    result = bisect_loop(as_ordered_bits(values), mask, selection_rank(counts, q), num_iters=num_iters)
    return torch.where(counts > 0, result, torch.full_like(result, float("nan")))
