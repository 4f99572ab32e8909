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

:func:`masked_percentile_bisect_from_host` selects the same sample from a
window that stays in host memory, by a radix select streamed over time
chunks: 3 passes of the host matrix (11-, 11- and 10-bit digits) where the
JAX package's streamed bisection makes 31. :class:`RadixSelect` holds that
select's pass loop, which the mesh's time-sharded select shares.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Optional, Sequence

import numpy as np
import torch

from krr_tpu_torch.ops.chunked import HostChunkStreamer, StreamStats, split_rows

if TYPE_CHECKING:
    from krr_tpu_torch.obs.device import DeviceObs

INT32_MAX = 2**31 - 1
#: Smallest positive normal float32, as bits: patterns below it (as signed
#: int32) are negatives, ±0.0 and subnormals.
MIN_NORMAL_BITS = 0x00800000
INT32_MIN = -(2**31)
#: Bits above this (magnitude only) are NaN; this itself is +inf.
EXPONENT_BITS = 0x7F800000
MAGNITUDE_MASK = 0x7FFFFFFF
#: K1's and K4's digit shifts (8-bit digits), most significant first.
RADIX_SHIFTS = (24, 16, 8, 0)
#: The streamed radix select's digits as (shift, bits), most significant
#: first: 2,048, 2,048 and 1,024 bins, so three passes over the host window.
STREAM_DIGITS = ((21, 11), (10, 11), (0, 10))
#: The widest digit ``radix_digit_hist`` takes (4,096 bins).
MAX_DIGIT_BITS = 12


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


def radix_pick(bins: torch.Tensor, residual: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One digit of the radix select from a pass's ``[N, B]`` histogram:
    the smallest digit whose inclusive count passes the residual rank, and
    the residual rank among the keys that carry it. A row whose keys do not
    reach past the residual (a row already decided) gets digit B − 1. The
    inclusive counts stay int32, as a row's count is, and a binary search
    finds the digit, so the pick holds one int32 copy of the bins beside
    them."""
    cum = torch.cumsum(bins, dim=1, dtype=torch.int32)
    passed = torch.searchsorted(cum, residual.to(torch.int32)[:, None], right=True)[:, 0]  # bins with cum <= rank
    digit = torch.clamp_max(passed, bins.shape[1] - 1)
    below = torch.gather(cum, 1, torch.clamp_min(digit - 1, 0)[:, None])[:, 0]
    return digit, residual - torch.where(digit > 0, below, torch.zeros_like(below))


def check_digits(digits: Sequence[tuple[int, int]]) -> None:
    """Raise unless ``digits`` are (shift, bits) pairs that tile the 32 key
    bits from the top down, each 1 to ``MAX_DIGIT_BITS`` bits wide."""
    top = 32
    for shift, bits in digits:
        if not 1 <= bits <= MAX_DIGIT_BITS or shift + bits != top:
            raise ValueError(f"digits {tuple(digits)} do not tile the 32 key bits from the top")
        top = shift
    if top != 0:
        raise ValueError(f"digits {tuple(digits)} do not reach bit 0")


class RadixSelect:
    """The radix select's plan and pass loop over a window the device never
    holds whole: what K1 (`krr_tpu_torch/csrc/common.cuh`
    ``radix_select_ordered``) does in one launch, as one counting pass per
    digit of ``u = ordered bits ^ 0x80000000`` from the top. Two callers
    share it: the host-streamed select (:func:`masked_percentile_bisect_from_host`,
    a pass streams the host chunks) and the mesh's time-sharded select
    (`krr_tpu_torch.parallel.fleet.sharded_percentile_bisect`, a pass runs
    every shard and sums their bins onto the row block's device).

    ``counts`` ([N] int32, on the device the loop runs on) and ``width``
    (the row's columns, padding included) decide, here and only here, the
    rows no pass serves: ``count == 0`` gives NaN, and a rank at or past
    the row's valid keys (a count past the width) gives the bits
    0x7fffffff, where the bisection climbs. Such rows fold nothing: the
    passes count each row's first :attr:`live` positions."""

    def __init__(self, counts: torch.Tensor, q: float, width: int):
        self.counts = counts.to(torch.int32)
        self.rank = selection_rank(self.counts, q).to(torch.int64)
        self.past = self.rank >= torch.clamp(self.counts, 0, width)
        #: Per row, the valid positions the passes count: 0 for a decided row.
        self.live = torch.where(self.past, torch.zeros_like(self.counts), self.counts)

    def run(self, count_pass, digits: Sequence[tuple[int, int]] = STREAM_DIGITS) -> torch.Tensor:
        """The selected samples, ``[N]`` float32 on the counts' device.
        ``count_pass(prefix32, shift, bits)`` returns the ``[N, 2^bits]``
        int32 histogram of digit ``(u >> shift) & (2^bits - 1)`` over each
        row's first ``live`` keys whose bits above ``shift + bits`` equal
        those of ``prefix32`` (as int32); between passes :func:`radix_pick`
        takes the digit where the count passes the residual rank. The
        answer does not depend on the schedule ``digits``. It is ``max(b,
        0)`` for ``b`` the selected key read as signed, so a row whose top
        bit of ``u`` is 0 (a negative key: a NaN with its sign bit set)
        gives 0."""
        check_digits(digits)
        prefix = torch.zeros_like(self.rank)  # the u digits found so far
        residual = self.rank
        for shift, bits in digits:
            prefix32 = torch.where(prefix >= 2**31, prefix - 2**32, prefix).to(torch.int32)
            digit, residual = radix_pick(count_pass(prefix32, shift, bits), residual)
            prefix = prefix | (digit << shift)
        answer = torch.clamp_min(prefix - 2**31, 0).to(torch.int32)  # max(b, 0), b = u ^ 0x80000000 as signed
        answer = torch.where(self.past, torch.full_like(answer, INT32_MAX), answer).view(torch.float32)
        return torch.where(self.counts > 0, answer, torch.full_like(answer, float("nan")))


def masked_percentile_bisect_from_host(
    values: np.ndarray,
    counts: np.ndarray,
    q: float,
    chunk_size: int = 8192,
    *,
    device: "torch.device | str" = "cuda",
    stats: Optional[StreamStats] = None,
    obs: Optional["DeviceObs"] = None,
    digits: Sequence[tuple[int, int]] = STREAM_DIGITS,
    devices: Optional[Sequence["torch.device | str"]] = None,
) -> np.ndarray:
    """Exact percentile of a **host** ``[N, T]`` matrix that does not fit
    on the device: the sample :func:`masked_percentile_bisect` selects (31
    bisection steps), for any ``q``. Returns a host float32 array; NaN for
    empty rows.

    The JAX package streams its 31 bisection steps, each a counting pass
    over the host chunks. This streams :class:`RadixSelect`'s passes
    instead, one over the host chunks per digit: ``digits`` (shift, bits),
    by default 11, 11 and 10 bits. Pass p adds each chunk's digit histogram
    into ``[N, 2^bits]`` int32 bins (``radix_digit_hist``, the K5 kernel on
    the card). The strategies take the default schedule; ``digits`` takes
    another (K1's four 8-bit digits, say) only so that the tests and the
    chip check can show that the answer does not depend on it. 3 passes
    move 3/31 of the host→device bytes of the streamed bisection. With
    ``devices`` the rows split over those devices, each block streaming on
    its own (`krr_tpu_torch.ops.chunked.split_rows`)."""
    from krr_tpu_torch.ops.cuda_select import radix_digit_hist  # cuda_select imports this module

    check_digits(digits)

    def select(values: np.ndarray, counts: np.ndarray, device: torch.device) -> np.ndarray:
        counts32 = np.ascontiguousarray(counts, dtype=np.int32)
        if values.shape[0] == 0:
            return np.zeros((0,), dtype=np.float32)
        plan = RadixSelect(torch.from_numpy(counts32).to(device), q, values.shape[1])
        streamer = HostChunkStreamer(values, plan.live.cpu().numpy(), chunk_size, device=device, stats=stats,
                                     obs=obs)

        def count_pass(prefix32: torch.Tensor, shift: int, bits: int) -> torch.Tensor:
            bins = torch.zeros((values.shape[0], 1 << bits), dtype=torch.int32, device=device)
            return streamer.run(bins, lambda b, chunk, eff: radix_digit_hist(chunk, eff, prefix32, b, shift, bits))

        return plan.run(count_pass, digits).cpu().numpy()

    return split_rows(values, counts, [device] if devices is None else devices, select)
