"""Ragged → rectangular packing of usage history.

The reference hands each strategy a ``dict[pod, list[Decimal]]`` per object and
flattens it in Python (`robusta_krr/strategies/simple.py:25,32`).
The device path instead packs the whole fleet into one
``[containers × timesteps]`` array + per-row sample counts, so a single batched
kernel right-sizes every container at once (SURVEY.md §7).

Packing is left-justified: row ``i`` holds the concatenation of all pod series
of object ``i`` in ``values[i, :counts[i]]``; the tail is padding. Downstream
kernels derive the mask as ``iota(T) < counts[:, None]``. The time dimension is
padded to a multiple of 128, as the JAX package pads it, so both packages hand
their kernels identical ``[N, T]`` arrays.
"""

from __future__ import annotations

from typing import Iterable, Mapping, Sequence

import numpy as np

LANE = 128


def pad_to_lane(n: int) -> int:
    """Round up to a multiple of 128 (min 128)."""
    return max(LANE, ((n + LANE - 1) // LANE) * LANE)


def pack_ragged(
    per_object_series: Sequence[Mapping[str, np.ndarray]] | Sequence[Iterable[np.ndarray]],
    dtype: np.dtype = np.float64,
    capacity: int | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Pack per-object, per-pod sample arrays into ``(values [N, T], counts [N])``.

    ``per_object_series[i]`` is either a mapping ``pod -> samples`` or an
    iterable of sample arrays; all samples of an object are concatenated in
    iteration order (same flatten order as the reference strategy).

    Values are stored in float64 on the host — byte counts stay exact; device
    kernels downcast (after scaling) as they see fit.
    """
    flats: list[np.ndarray] = []
    for entry in per_object_series:
        chunks = list(entry.values()) if isinstance(entry, Mapping) else list(entry)
        if chunks:
            flats.append(np.concatenate([np.asarray(c, dtype=dtype).ravel() for c in chunks]))
        else:
            flats.append(np.empty(0, dtype=dtype))

    n = len(flats)
    max_len = max((f.size for f in flats), default=0)
    t = pad_to_lane(max_len if capacity is None else max(capacity, max_len))

    values = np.zeros((max(n, 1), t), dtype=dtype)
    counts = np.zeros(max(n, 1), dtype=np.int32)
    for i, flat in enumerate(flats):
        values[i, : flat.size] = flat
        counts[i] = flat.size
    return values[:n] if n else values[:0], counts[:n] if n else counts[:0]
