"""Exact batched reductions over packed usage history, plain PyTorch.

Percentile semantics follow the reference's *documented* intent — the value at
sorted index ``floor((n - 1) * q / 100)`` — not its literal unsorted-indexing
quirk (`simple.py:32-36`; divergence noted in SURVEY.md §7). Empty rows
(count == 0) return NaN, which the host edge converts to ``"?"``.

:func:`masked_max` is the plain version of the row-max kernel
(`krr_tpu_torch.ops.cuda_select`). It reproduces what ``jnp.max`` gives on
XLA's CPU backend, where the JAX package's tests run it: subnormals are read
as zero of the same sign, +0.0 ranks above −0.0, and NaN propagates. The max
is taken over an integer key that orders float32 totally, so the result does
not depend on the order of the reduction; a row holding NaN returns the
canonical NaN (the JAX package may return the NaN's own payload — NaN either
way, and ``"?"`` downstream). :func:`max_where` is the same max over any
mask; the digest's peak uses it with ``-inf`` for an empty row, and
:func:`peak_max` combines two such maxima.

:func:`masked_max_from_host` is the max of a window that stays in host
memory (`krr_tpu_torch.ops.chunked`), one ``row_max`` launch per time chunk.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Optional, Sequence

import numpy as np
import torch

from krr_tpu_torch.ops.chunked import StreamStats, split_rows, stream_host_chunks
from krr_tpu_torch.ops.selection import (
    EXPONENT_BITS,
    INT32_MAX,
    INT32_MIN,
    MAGNITUDE_MASK,
    MIN_NORMAL_BITS,
    selection_rank,
    valid_mask,
)

if TYPE_CHECKING:
    from krr_tpu_torch.obs.device import DeviceObs


def masked_percentile(values: torch.Tensor, counts: torch.Tensor, q: "torch.Tensor | float") -> torch.Tensor:
    """Per-row percentile of the first ``counts[i]`` entries of ``values[i]``
    by sorting — the oracle the bisection is tested against.

    Returns the element at sorted index ``floor((count - 1) * q / 100)`` —
    an actual sample, like the reference — or NaN for empty rows.
    """
    n, t = values.shape
    if t == 0:
        return torch.full((n,), float("nan"), dtype=torch.float32, device=values.device)
    # Padding sorts to the top and is never selected (index < count <= first pad).
    padded = torch.where(valid_mask(counts, t), values, torch.full_like(values, float("inf")))
    ordered = torch.sort(padded, dim=1).values
    idx = selection_rank(counts, q).to(torch.int64)
    picked = torch.gather(ordered, 1, idx[:, None])[:, 0]
    return torch.where(counts > 0, picked, torch.full_like(picked, float("nan")))


def peak_keys(peaks: torch.Tensor) -> torch.Tensor:
    """int32 keys that order float32 maxima as the row max does:
    subnormals read as zero of their sign, +0.0 above −0.0, every NaN
    above +inf. The integer max of keys, read back by :func:`key_peaks`,
    is the max of the values whatever the order — how a collective max
    across processes reduces peaks."""
    bits = peaks.contiguous().view(torch.int32)
    magnitude = bits & MAGNITUDE_MASK
    flushed = torch.where(magnitude < MIN_NORMAL_BITS, bits & INT32_MIN, bits)
    key = torch.where(flushed >= 0, flushed, flushed ^ MAGNITUDE_MASK)
    return torch.where(magnitude > EXPONENT_BITS, torch.full_like(key, INT32_MAX), key)


def key_peaks(keys: torch.Tensor) -> torch.Tensor:
    """The float32 values of :func:`peak_keys`' keys; the NaN key gives the
    canonical NaN."""
    peak = torch.where(keys >= 0, keys, keys ^ MAGNITUDE_MASK).view(torch.float32)
    return torch.where(keys == INT32_MAX, torch.full_like(peak, float("nan")), peak)


def max_where(values: torch.Tensor, mask: torch.Tensor, empty: float) -> torch.Tensor:
    """Per-row max over the positions ``mask`` selects (any boolean mask):
    the canonical NaN for a row that selects a NaN, ``empty`` for a row
    that selects nothing."""
    if values.shape[1] == 0:
        return torch.full((values.shape[0],), empty, dtype=torch.float32, device=values.device)
    # No value's key is INT32_MIN (that key would be a NaN's), so it marks the unselected.
    key = torch.where(mask, peak_keys(values), torch.full_like(mask, INT32_MIN, dtype=torch.int32))
    peak = key_peaks(key.amax(dim=1))
    return torch.where(mask.any(dim=1), peak, torch.full_like(peak, empty))


def masked_max(values: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """Per-row max of the valid prefix; NaN for empty rows."""
    return max_where(values, valid_mask(counts, values.shape[1]), float("nan"))


def peak_max(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise max of two ``[N]`` maxima with the row max's semantics
    (NaN propagates as the canonical NaN, +0.0 above −0.0, subnormals read
    as zero of their sign), whatever the argument order: the max of a row
    split in two parts equals the max of the whole row, bit for bit."""
    pair = torch.stack([a, b], dim=1)
    return max_where(pair, torch.ones_like(pair, dtype=torch.bool), float("-inf"))


def masked_max_from_host(
    values: np.ndarray,
    counts: np.ndarray,
    chunk_size: int = 8192,
    *,
    device: "torch.device | str" = "cuda",
    stats: Optional[StreamStats] = None,
    obs: Optional["DeviceObs"] = None,
    devices: Optional[Sequence["torch.device | str"]] = None,
) -> np.ndarray:
    """Per-row max of the valid prefix of a **host** ``[N, T]`` matrix,
    streamed to the device in time chunks so the whole matrix never lives
    there; NaN for empty rows. Bit-identical to :func:`masked_max` — and to
    one ``row_max`` launch — on the same float32 data. The strategies pass
    memory already in MB (`krr_tpu_torch.strategies.window.device_packed`).

    Each chunk's max comes from the ``row_max`` kernel on the card (its
    plain version on the CPU) with −inf for a row whose samples all lie in
    other chunks, and :func:`peak_max` folds it into the running max; NaN
    for ``count == 0`` only at the end. With ``devices`` the rows split
    over those devices, each block streaming on its own
    (`krr_tpu_torch.ops.chunked.split_rows`)."""
    from krr_tpu_torch.ops.cuda_select import row_max_chunk  # cuda_select imports this module

    def stream(values: np.ndarray, counts: np.ndarray, device: torch.device) -> np.ndarray:
        counts = np.asarray(counts)
        n = values.shape[0]
        if n == 0:
            return np.zeros((0,), dtype=np.float32)
        init = torch.full((n,), float("-inf"), dtype=torch.float32, device=device)
        peak = stream_host_chunks(
            values,
            counts,
            init,
            lambda state, chunk, eff: peak_max(state, row_max_chunk(chunk, eff)),
            chunk_size,
            device=device,
            stats=stats,
            obs=obs,
        )
        return np.where(counts > 0, peak.cpu().numpy(), np.float32(np.nan)).astype(np.float32)

    return split_rows(values, counts, [device] if devices is None else devices, stream)
