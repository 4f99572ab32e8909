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

import os
from collections.abc import Iterable, Mapping, Sequence
from concurrent.futures import ThreadPoolExecutor
from functools import partial

import numpy as np

LANE = 128

#: The fill runs on threads only when the chunks average at least this many
#: samples and the destination holds at least ``THREAD_MIN_BYTES``; fewer
#: threads than ``MAX_WORKERS`` when the process may use fewer cores. The
#: copies are bound by memory: on an 8-core H100 host four threads filled a
#: 10,000 × 120,960 row pack faster than eight (PERF.md §6).
THREAD_MIN_CHUNK = 16384
THREAD_MIN_BYTES = 64 << 20
MAX_WORKERS = 4
#: Row blocks a worker takes, in turn, from the pool's queue.
BLOCKS_PER_WORKER = 4
#: A scaled fill packs rows into a float64 block of at most this many bytes,
#: which stays in cache, and divides a block at a time (one row a block when
#: a row is wider).
SCALE_BLOCK_BYTES = 1 << 20


def pad_to_lane(n: int) -> int:
    """Round up to a multiple of 128 (min 128)."""
    return max(LANE, ((n + LANE - 1) // LANE) * LANE)


def padding_stats(counts: np.ndarray, capacity: int) -> tuple[int, int]:
    """``(real, padded)`` element counts of a packed batch — the inputs of
    the ``krr_tpu_pad_waste_pct`` padding-efficiency gauge
    (`krr_tpu_torch.obs.device`). ``real`` is the genuine samples behind the
    mask; ``padded`` is the full rectangular ``[rows × capacity]`` the
    device reads, lane rounding included."""
    return int(np.sum(counts, dtype=np.int64)), int(len(counts)) * int(capacity)


def pack_workers(elements: int, chunks: int, nbytes: int) -> int:
    """Threads :func:`pack_ragged` fills its destination with, from the
    input's shape: ``elements`` samples in ``chunks`` pod series, packed into
    ``nbytes`` of destination. Serial (1) unless the destination is large and
    the chunks are long on average; numpy releases the interpreter lock while
    it copies a chunk, so long copies overlap on the host's cores, and short
    ones spend their time taking the lock back."""
    if not chunks or nbytes < THREAD_MIN_BYTES or elements < THREAD_MIN_CHUNK * chunks:
        return 1
    cores = len(os.sched_getaffinity(0)) if hasattr(os, "sched_getaffinity") else os.cpu_count() or 1
    return min(MAX_WORKERS, cores)


def _flat(chunk, dtype: np.dtype) -> np.ndarray:
    """A chunk that is not a 1-D ndarray, made one: an ndarray raveled, and
    lists and Decimals (the compatibility paths) cast here."""
    if isinstance(chunk, np.ndarray):
        return chunk.ravel()
    return np.asarray(chunk, dtype=dtype).ravel()


def _fill(values: np.ndarray, rows: list[list[np.ndarray]], start: int, stop: int) -> None:
    """Write rows ``[start, stop)``: each chunk straight into its slot (numpy
    casts in the assignment, rounding as ``astype`` does), then the tail's
    zeros, so every element of the destination is written once."""
    for row, chunks in zip(values[start:stop], rows[start:stop]):
        offset = 0
        for chunk in chunks:
            end = offset + len(chunk)
            row[offset:end] = chunk
            offset = end
        row[offset:] = 0


def _fill_blocks_divided(values: np.ndarray, rows: list[list[np.ndarray]], start: int, stop: int,
                         scale: float) -> None:
    """:func:`_fill` of ``samples / scale``: each block of rows filled by
    :func:`_fill` into a float64 block of at most ``SCALE_BLOCK_BYTES``, then
    divided into its rows of ``values`` in one call, in float64 and rounded
    once to ``values``' dtype (as ``astype`` rounds; the zeros divide to
    zeros)."""
    step = max(1, SCALE_BLOCK_BYTES // (8 * values.shape[1]))
    block = np.empty((min(step, stop - start), values.shape[1]), dtype=np.float64)
    for a in range(start, stop, step):
        b = min(a + step, stop)
        _fill(block, rows[a:b], 0, b - a)
        np.divide(block[: b - a], scale, out=values[a:b])


def pack_ragged_with_workers(
    per_object_series: Sequence[Mapping[str, np.ndarray]] | Sequence[Iterable[np.ndarray]],
    dtype: np.dtype = np.float64,
    capacity: int | None = None,
    scale: float = 1.0,
) -> tuple[np.ndarray, np.ndarray, int]:
    """:func:`pack_ragged`'s ``(values, counts)`` and the threads that filled
    ``values`` (:func:`pack_workers`; 1 on the serial path)."""
    # A scaled fill casts into its float64 block, so lists and Decimals do too.
    source = dtype if scale == 1.0 else np.float64
    rows: list[list[np.ndarray]] = []
    for entry in per_object_series:
        chunks = entry.values() if isinstance(entry, Mapping) else entry
        rows.append([c if isinstance(c, np.ndarray) and c.ndim == 1 else _flat(c, source) for c in chunks])

    n = len(rows)
    counts = np.zeros(max(n, 1), dtype=np.int32)
    counts[:n] = [sum(map(len, chunks)) for chunks in rows]
    max_len = int(counts.max())
    t = pad_to_lane(max_len if capacity is None else max(capacity, max_len))

    values = np.empty((max(n, 1), t), dtype=dtype)
    workers = pack_workers(int(np.sum(counts, dtype=np.int64)), sum(map(len, rows)), values.nbytes)
    fill = _fill if scale == 1.0 else partial(_fill_blocks_divided, scale=scale)
    if workers == 1:
        fill(values, rows, 0, n)
    else:
        # Disjoint row blocks, several a worker so ragged rows even out: the
        # result does not depend on the worker count or the order.
        bounds = np.linspace(0, n, workers * BLOCKS_PER_WORKER + 1).astype(int).tolist()
        with ThreadPoolExecutor(max_workers=workers) as pool:
            done = [pool.submit(fill, values, rows, a, b) for a, b in zip(bounds, bounds[1:]) if a < b]
            for future in done:
                future.result()
    return values[:n], counts[:n], workers


def pack_ragged(
    per_object_series: Sequence[Mapping[str, np.ndarray]] | Sequence[Iterable[np.ndarray]],
    dtype: np.dtype = np.float64,
    capacity: int | None = None,
    scale: float = 1.0,
) -> tuple[np.ndarray, np.ndarray]:
    """Pack per-object, per-pod sample arrays into ``(values [N, T], counts [N])``.

    ``per_object_series[i]`` is either a mapping ``pod -> samples`` or an
    iterable of sample arrays; all samples of an object are concatenated in
    iteration order (same flatten order as the reference strategy).

    Values are stored in float64 on the host by default — byte counts stay
    exact. A ``scale`` other than 1 stores ``samples / scale`` instead: the
    fill divides in float64 and rounds once to ``dtype``, so the bytes are
    ``(pack_ragged(...) / scale).astype(dtype)``'s with no float64 matrix in
    between (the strategies pack memory so, in MB and float32, for the
    device).

    One pass: the row lengths first, then one destination in which every
    element is written once, long rows by row blocks on the host's cores
    (:func:`pack_workers`). A scaled fill divides a cache-sized float64
    block of rows at a time.
    """
    values, counts, _workers = pack_ragged_with_workers(per_object_series, dtype, capacity, scale)
    return values, counts
