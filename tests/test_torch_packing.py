"""The port's one-pass ``pack_ragged`` held bit for bit to the JAX package's:
the same ``values`` dtype, shape and bytes (zero padding included) and the
same ``counts``, for every kind of input, on the serial fill and on the fill
by row blocks over threads, with shapes on either side of the cut that
chooses between them."""

from __future__ import annotations

import os
from decimal import Decimal

import numpy as np
import pytest

from krr_tpu.ops.packing import pack_ragged as jax_pack_ragged
from krr_tpu_torch.ops import packing
from krr_tpu_torch.ops.packing import pack_ragged, pack_ragged_with_workers, pack_workers

#: The cut the ``threaded`` path lowers the fill to, so small shapes cross it:
#: its shapes' chunks average at least this many samples, ``serial``'s fewer.
SMALL_CUT = 64


def _lengths(rng, long: bool, k: int) -> list[int]:
    low, high = (SMALL_CUT, 4 * SMALL_CUT) if long else (1, SMALL_CUT // 2)
    return rng.integers(low, high, size=k).tolist()


def mapping_entries(rng, long):
    return [{f"pod-{p}": rng.normal(size=n) for p, n in enumerate(_lengths(rng, long, pods))}
            for pods in (1, 3, 2, 4, 1)]


def many_rows(rng, long):
    # More rows than the threads' blocks, of lengths that differ row to row.
    return [[rng.normal(size=n) for n in _lengths(rng, long, 1 + i % 3)] for i in range(70)]


def iterable_entries(rng, long):
    rows = [[rng.random(n) * 1e3 for n in _lengths(rng, long, pods)] for pods in (2, 1, 3)]
    # A list, a tuple and a generator: any iterable of chunks.
    return [rows[0], tuple(rows[1]), (chunk for chunk in rows[2])]


def list_chunks(rng, long):
    return [[[float(x) for x in rng.random(n)] for n in _lengths(rng, long, pods)] for pods in (2, 3)]


def decimal_chunks(rng, long):
    lists = [[[Decimal(repr(float(x))) for x in rng.random(n) * 7] for n in _lengths(rng, long, pods)]
             for pods in (1, 2)]
    # Decimals in an object ndarray take the ndarray route: cast on write.
    return [*lists, [np.array(lists[1][0], dtype=object)]]


def two_d_chunks(rng, long):
    (a, b), (c,) = _lengths(rng, long, 2), _lengths(rng, long, 1)
    return [[rng.normal(size=(a, 2)), rng.normal(size=(2, b)).T], {"pod": rng.normal(size=(1, c))}]


def int_chunks(rng, long):
    # Past 2**24 (float32) and 2**53 (float64), so the casts round.
    big = np.array([2**24 + 1, 2**53 + 1, -(2**31), 2**62 + 12345], dtype=np.int64)
    return [[rng.integers(-1000, 1000, size=n, dtype=np.int32) for n in _lengths(rng, long, 2)],
            [np.concatenate([big, rng.integers(0, 2**40, size=_lengths(rng, long, 1)[0])])]]


def special_values(rng, long):
    special = np.array([np.nan, np.inf, -np.inf, -0.0, 5e-324, 1e-45, 3.4e38, 1e39, -1e39, 0.1])
    (n,) = _lengths(rng, long, 1)
    return [{"a": special, "b": rng.normal(size=n) * 1e30}, [rng.normal(size=n), special[::-1].copy()]]


def empty_containers(rng, long):
    (n, m) = _lengths(rng, long, 2)
    # Rows with no pods, with only empty pods, and between long rows.
    return [{}, {"a": np.empty(0)}, {"a": rng.normal(size=n), "b": np.empty(0), "c": rng.normal(size=m)}, [],
            [rng.normal(size=m), rng.normal(size=n)]]


def empty_fleet(rng, long):
    return []


CASES = {
    "mapping": mapping_entries,
    "many_rows": many_rows,
    "iterable": iterable_entries,
    "list_chunks": list_chunks,
    "decimal_chunks": decimal_chunks,
    "two_d_chunks": two_d_chunks,
    "int_chunks": int_chunks,
    "nan_inf": special_values,
    "empty_containers": empty_containers,
    "empty_fleet": empty_fleet,
}


def cores() -> int:
    return min(packing.MAX_WORKERS, len(os.sched_getaffinity(0)))


def assert_bitwise_equal(got: tuple, want: tuple) -> None:
    (values, counts), (want_values, want_counts) = got, want
    assert values.dtype == want_values.dtype and values.shape == want_values.shape
    assert values.tobytes() == want_values.tobytes()
    assert counts.dtype == want_counts.dtype and counts.tobytes() == want_counts.tobytes()
    for i, n in enumerate(counts):
        assert not values[i, n:].any()


@pytest.mark.filterwarnings("ignore:overflow encountered in cast:RuntimeWarning")
@pytest.mark.parametrize("capacity", [None, 1000], ids=["fit", "capacity"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["float32", "float64"])
@pytest.mark.parametrize("path", ["serial", "threaded"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_pack_ragged_equals_jax_bit_for_bit(monkeypatch, case, path, dtype, capacity):
    long = path == "threaded"
    make = lambda: CASES[case](np.random.default_rng(22), long)  # noqa: E731 - fresh generators each call
    serial = pack_ragged_with_workers(make(), dtype, capacity)
    if long:
        monkeypatch.setattr(packing, "THREAD_MIN_CHUNK", SMALL_CUT)
        monkeypatch.setattr(packing, "THREAD_MIN_BYTES", 0)
    values, counts, workers = pack_ragged_with_workers(make(), dtype, capacity)

    assert_bitwise_equal((values, counts), jax_pack_ragged(make(), dtype, capacity))
    assert_bitwise_equal((values, counts), pack_ragged(make(), dtype, capacity))
    assert serial[2] == 1
    assert workers == (cores() if long and case != "empty_fleet" else 1)
    # The threaded fill writes the serial fill's bytes.
    assert_bitwise_equal((values, counts), serial[:2])
    if capacity is not None:
        assert values.shape[1] == packing.pad_to_lane(capacity)


@pytest.mark.parametrize(
    "shape, threads",
    [
        # tdigest-28d-1m: 10,000 containers × 3 pods × 40,320 float32 samples.
        ((10_000 * 3 * 40_320, 10_000 * 3, 10_000 * 120_960 * 4), True),
        # The same rows in float64, the memory resource.
        ((10_000 * 3 * 40_320, 10_000 * 3, 10_000 * 120_960 * 8), True),
        # simple-14d-15m: 100,000 × 3 × 1,344 into [100,000, 4,096] float32.
        ((100_000 * 3 * 1_344, 100_000 * 3, 100_000 * 4_096 * 4), False),
        # Its memory through the stats route: one max a pod.
        ((100_000 * 3, 100_000 * 3, 100_000 * 128 * 8), False),
        # Long chunks into a small destination, and just either side of the cut.
        ((3 * 40_320, 3, 120_960 * 8), False),
        ((2 * 16_384, 2, 64 << 20), True),
        ((2 * 16_384 - 1, 2, 64 << 20), False),
        ((2 * 16_384, 2, (64 << 20) - 1), False),
        ((0, 0, 1 << 40), False),
    ],
    ids=["tdigest_cpu", "tdigest_memory", "simple_cpu", "simple_memory_stats", "small_destination",
         "at_the_cut", "below_the_chunk_cut", "below_the_byte_cut", "no_chunks"],
)
def test_the_shape_selects_the_workers(shape, threads):
    assert pack_workers(*shape) == (cores() if threads else 1)


def test_a_threaded_pack_at_the_real_cut_equals_the_serial_one(monkeypatch):
    """Rows of three pods of 16,000–20,000 samples, past 64 MiB of float64,
    take the threads under the shipped cut; the serial fill of the same
    input writes the same bytes."""
    rng = np.random.default_rng(7)
    flat = rng.normal(size=180 * 3 * 20_000)
    fleet = [[flat[(3 * i + p) * 20_000:(3 * i + p + 1) * 20_000][: 20_000 - (i % 5) * 1_000] for p in range(3)]
             for i in range(180)]
    values, counts, workers = pack_ragged_with_workers(fleet, np.float64)
    assert values.nbytes >= packing.THREAD_MIN_BYTES and workers == cores()
    monkeypatch.setattr(packing, "THREAD_MIN_CHUNK", 10**9)
    serial = pack_ragged_with_workers(fleet, np.float64)
    assert serial[2] == 1
    assert_bitwise_equal((values, counts), serial[:2])
    assert_bitwise_equal((values, counts), jax_pack_ragged(fleet, np.float64))
