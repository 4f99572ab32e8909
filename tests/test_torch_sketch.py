"""Parity of the port's sketch ops (digest, top-K) with the JAX package.

The same seeded numpy inputs go through the JAX package — its jnp ops and
its Pallas sketch kernels in interpret mode, as `tests/test_ops.py` runs
them on the CPU — and through `krr_tpu_torch`'s plain PyTorch versions on
the CPU, which is what the port's wrappers run for a CPU tensor and what
its CUDA kernels are held against on the card (`chip_smoke.py`).

Tolerances, each with its reason:

* Bucket indices: equal, except that a value whose log-quotient lies
  within a few float32 ulps of an integer may land one bucket over — ``log``
  differs by an ulp between XLA's CPU backend and PyTorch's, and that is the
  digest's own contract (`krr_tpu/ops/pallas_sketch.py:46-51`). Histogram
  comparisons therefore use values moved off the bucket edges.
* Histogram counts, totals, peaks and top-K rows (sorted, since slot order
  is unspecified): bit-exact, NaN positions equal.
* Digest estimates: two float32 ulps (PyTorch's ``exp`` against XLA's CPU
  ``exp``), and every estimate within ``relative_error`` of the exact
  percentile.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from krr_tpu.ops import digest as jax_digest
from krr_tpu.ops import pallas_sketch as jax_pallas
from krr_tpu.ops import topk_sketch as jax_topk
from krr_tpu_torch.models.interop import digest_from_arrays, topk_from_arrays
from krr_tpu_torch.ops import chunked, cuda_build, cuda_sketch
from krr_tpu_torch.ops import digest as port_digest
from krr_tpu_torch.ops import quantile as port_quantile
from krr_tpu_torch.ops import selection as port_selection
from krr_tpu_torch.ops import topk_sketch as port_topk
from tests.test_torch_select import SPECIAL, assert_same, port_tensors, radix_tau

#: Edge values the JAX top-K kernel places exactly: its three-piece bf16
#: split turns ±inf, NaN and magnitudes that round to inf in bf16 into NaN
#: across the row, so they stay out of comparisons with it (the card's
#: parity phase holds the port's kernel against the plain version on all of
#: them).
FINITE_SPECIAL = SPECIAL[np.isfinite(SPECIAL) & (np.abs(SPECIAL) < 1e38)]
#: Every edge pattern of the port's tests, as bits.
SPECIAL_BITS_ALL = np.unique(SPECIAL.view(np.uint32))


def fuzz(seed: int, n: int, t: int, special=SPECIAL, special_frac: float = 0.2, ties: bool = False):
    """Ragged gamma-like rows (an empty and a full row included) salted with
    edge values — in the padding too, which no kernel may read."""
    rng = np.random.default_rng(seed)
    values = rng.gamma(2.0, 0.05, size=(n, t)).astype(np.float32)
    if ties:
        values[:, : t // 2] = values[0, 0] if n and t else 0.0
    salted = rng.random((n, t)) < special_frac
    values[salted] = rng.choice(special, int(salted.sum()))
    counts = rng.integers(0, t + 1, size=n).astype(np.int32)
    if n > 1:
        counts[0], counts[1] = 0, t
    return values, counts


def quotient(spec, values: np.ndarray) -> np.ndarray:
    """The bucket quotient ``log(v / min) / log γ`` in float64."""
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.log(values.astype(np.float64) / np.float64(np.float32(spec.min_value))) / np.float64(
            np.float32(spec.log_gamma)
        )


def off_edges(spec, values: np.ndarray) -> np.ndarray:
    """Move every value whose quotient is within 1e-3 of a bucket edge to
    the middle of its bucket."""
    q = quotient(spec, values)
    with np.errstate(invalid="ignore"):
        near = np.isfinite(q) & (np.abs(q - np.round(q)) < 1e-3) & (values > spec.min_value)
    out = values.copy()
    out[near] = (values[near].astype(np.float64) * np.sqrt(spec.gamma)).astype(np.float32)
    return out


def specs(gamma: float, buckets: int):
    return jax_digest.DigestSpec(gamma=gamma, num_buckets=buckets), port_digest.DigestSpec(
        gamma=gamma, num_buckets=buckets
    )


def assert_digest_equal(port: port_digest.Digest, counts, total, peak) -> None:
    np.testing.assert_array_equal(port.counts.numpy(), np.asarray(counts))
    np.testing.assert_array_equal(port.total.numpy(), np.asarray(total))
    assert_same(port.peak.numpy(), np.asarray(peak))


def sorted_bits(rows) -> np.ndarray:
    return np.sort(np.asarray(rows, dtype=np.float32).view(np.int32), axis=1)


# --------------------------------------------------------------- bucketize


class TestBucketize:
    def test_edge_values(self):
        """NaN → bucket 1 and +inf / 1e30 → B − 1, as XLA's saturating cast
        gives; PyTorch's own float→int32 cast of +inf is INT32_MIN."""
        jax_spec, port_spec = specs(1.01, 2560)
        values = np.array([np.inf, np.nan, -0.0, 1e-45, -1.0, 1e30, 1e-7], dtype=np.float32)
        want = [2559, 1, 0, 0, 0, 2559, 0]
        np.testing.assert_array_equal(np.asarray(jax_digest.bucketize(jax_spec, values)), want)
        np.testing.assert_array_equal(port_digest.bucketize(port_spec, torch.from_numpy(values)).numpy(), want)
        np.testing.assert_array_equal(
            port_digest.bucketize(port_spec, torch.from_numpy(SPECIAL.copy())).numpy(),
            np.asarray(jax_digest.bucketize(jax_spec, SPECIAL)),
        )

    @pytest.mark.parametrize(
        "gamma, buckets, max_edge_misses", [(1.01, 2560, 16), (1.02, 512, 30), (1.01, 200, 13)]
    )
    def test_matches_jax_but_at_edges(self, gamma, buckets, max_edge_misses):
        """Seeded values agree everywhere; values placed on and one ulp
        around every bucket edge agree except at most ``max_edge_misses`` of
        them, each one bucket over and each within 4 float32 ulps of the
        edge.

        How many edge values land one bucket over depends on the host: it is
        the gap between PyTorch's CPU ``log`` and XLA's, and both pick a
        SIMD code path by the CPU they run on. The bound is the count of the
        host the test was first written on (16, 30, 13; its CPU was not
        recorded); an AMD EPYC with AVX-512 (torch 2.13.0+cpu, jax 0.9.0)
        gives 7, 20, 4. A bound still catches a change that moves many
        values; the per-value contract is exact."""
        jax_spec, port_spec = specs(gamma, buckets)
        rng = np.random.default_rng(5)
        seeded = np.concatenate([rng.gamma(2.0, 0.05, 100_000), 10 ** rng.uniform(-8, 4, 100_000)])
        seeded = seeded.astype(np.float32)
        np.testing.assert_array_equal(
            port_digest.bucketize(port_spec, torch.from_numpy(seeded)).numpy(),
            np.asarray(jax_digest.bucketize(jax_spec, seeded)),
        )
        j = np.arange(1, 2559, dtype=np.float64)  # the default spec's edges; clipped above B − 2
        edges = (jax_spec.min_value * jax_spec.gamma**j).astype(np.float32)
        values = np.concatenate([np.nextafter(edges, np.float32(0)), edges, np.nextafter(edges, np.float32(np.inf))])
        ref = np.asarray(jax_digest.bucketize(jax_spec, values))
        got = port_digest.bucketize(port_spec, torch.from_numpy(values)).numpy()
        miss = np.nonzero(got != ref)[0]
        assert miss.size <= max_edge_misses
        np.testing.assert_array_equal(np.abs(got[miss] - ref[miss]), 1)
        q = quotient(jax_spec, values[miss])
        ulp = np.spacing(np.abs(q).astype(np.float32)).astype(np.float64)
        assert np.all(np.abs(q - np.round(q)) <= 4 * ulp)


class DigestTables(NamedTuple):
    """numpy model of `csrc/sketch.cu`'s bucket tables for one spec."""

    edges: np.ndarray  # [B] int64: edges[b] the smallest pattern with bucket >= b (edges[0] unused)
    coarse: np.ndarray  # one entry per 2^16-pattern range, packed as digest_tables_kernel packs it
    base: int  # top 16 bits of the first pattern above min_value
    min_bits: int


def formula(bits: np.ndarray, spec) -> np.ndarray:
    """The plain bucket formula on float32 bit patterns."""
    values = torch.from_numpy(np.ascontiguousarray(bits, dtype=np.int64).astype(np.int32).view(np.float32))
    return cuda_sketch.bucket_indices(values, spec.num_buckets, spec.min_value, spec.log_gamma).numpy().astype(np.int64)


def first_above(spec, lo: np.ndarray, hi: np.ndarray, level: np.ndarray) -> np.ndarray:
    """Per element, the smallest pattern in [lo, hi] whose bucket is at
    least ``level`` (hi when none below it is), by bisection."""
    lo, hi = lo.astype(np.int64), hi.astype(np.int64)
    for _ in range(32):
        mid = lo + (hi - lo) // 2
        above = formula(mid, spec) >= level
        lo, hi = np.where(above, lo, mid + 1), np.where(above, mid, hi)
    return lo


def digest_tables(spec, coarse_len=None) -> DigestTables:
    """The tables as `digest_tables_kernel` builds them: each edge by
    bisection over the patterns above ``min_value``; one coarse entry per
    2^16-pattern range from the first pattern above ``min_value`` to the top
    edge (estimated in double with a margin, as ``table_shape`` does, unless
    ``coarse_len`` is given). A range whose bucket steps at most once, with
    B below 2^15, packs its lower bucket and the step's low 16 bits; the
    last range and the others hold ``~b0`` and walk up the edges."""
    buckets = spec.num_buckets
    min_bits = int(np.float32(spec.min_value).view(np.int32))
    wanted = np.arange(1, buckets)
    edges = np.concatenate([[port_selection.INT32_MIN], first_above(
        spec, np.full(wanted.shape, min_bits + 1), np.full(wanted.shape, 0x7F800000), wanted)])
    base = (min_bits + 1) >> 16
    if coarse_len is None:
        top = float(np.float32(spec.min_value)) * np.exp(float(np.float32(spec.log_gamma)) * (buckets - 2)) * 1.00001
        top_bits = 0x7F800000 if top >= np.finfo(np.float32).max else int(np.float32(top).view(np.int32))
        coarse_len = max((min(top_bits, 0x7F800000) >> 16) - base + 1, 1)
    start = (base + np.arange(coarse_len, dtype=np.int64)) << 16
    lo_end = np.maximum(start, min_bits + 1)
    hi_end = np.minimum(start + 0xFFFF, 0x7F800000)
    b0, b_end = formula(lo_end, spec), formula(hi_end, spec)
    step = first_above(spec, lo_end + 1, hi_end, b0 + 1)
    packed = np.where(b_end == b0, (b0 - 1) << 16, (b0 << 16) | (step - start))
    single = (np.arange(coarse_len) < coarse_len - 1) & (buckets <= 2**15 - 1) & (b_end <= b0 + 1)
    coarse = np.where(single, packed, ~b0)
    return DigestTables(edges, coarse, base, min_bits)


def table_route(bits: np.ndarray, spec, tables: DigestTables) -> np.ndarray:
    """numpy model of `csrc/sketch.cu` ``table_bucket``: NaN → 1, a value
    at or below ``min_value`` → 0, at or past the top edge → B − 1, else the
    coarse entry of the pattern's 2^16 range (the last entry past the
    table): a packed entry gives the bucket by one compare, ``~b0`` walks up
    the edges from b0."""
    bits = np.asarray(bits, dtype=np.int64).astype(np.int32).astype(np.int64)
    last_bucket = spec.num_buckets - 1
    out = np.zeros(bits.shape, dtype=np.int64)
    nan = (bits & 0x7FFFFFFF) > 0x7F800000
    top = ~nan & (bits >= tables.edges[-1])
    inside = ~nan & ~top & (bits > tables.min_bits)
    out[nan] = 1
    out[top] = last_bucket
    mine = bits[inside]
    entry = tables.coarse[np.minimum((mine >> 16) - tables.base, len(tables.coarse) - 1)]
    b = np.where(entry >= 0, (entry >> 16) + ((mine & 0xFFFF) >= (entry & 0xFFFF)), np.minimum(~entry, last_bucket - 1))
    walk = entry < 0
    while True:
        step = walk & (mine >= tables.edges[np.minimum(b + 1, last_bucket)])
        if not step.any():
            break
        b = b + step
    out[inside] = b
    return out


#: (γ, B): the default spec, the two other bucket counts the card's parity
#: checks at the default γ, and a small γ at which one 2^16-pattern range
#: holds many edges (the walk up the edges takes many steps).
TABLE_SPECS = [(1.01, 2560), (1.01, 16), (1.01, 200), (1.0001, 2560)]


class TestBucketTables:
    """The digest kernel's table route, modelled in numpy, equals the plain
    formula on the CPU around every edge and on random bit patterns."""

    @pytest.mark.parametrize("gamma, buckets", TABLE_SPECS)
    def test_table_route_equals_the_formula(self, gamma, buckets):
        spec = port_digest.DigestSpec(gamma=gamma, num_buckets=buckets)
        tables = digest_tables(spec)
        edges = np.unique(tables.edges[1:])
        near = (edges[:, None] + np.arange(-64, 65)[None, :]).ravel()
        rng = np.random.default_rng(buckets)
        random = rng.integers(0, 2**32, size=1_000_000, dtype=np.uint64).astype(np.int64)
        specials = SPECIAL_BITS_ALL.astype(np.int64)
        for bits in (near, random, specials):
            np.testing.assert_array_equal(table_route(bits, spec, tables), formula(bits, spec))
        assert np.all(np.diff(tables.edges[1:]) >= 0)  # the edges rise with the bucket
        per_range = np.unique(edges >> 16, return_counts=True)[1]
        if (gamma, buckets) == (1.01, 2560):
            assert edges.size == buckets - 1 and per_range.max() == 1
            assert np.all(tables.coarse[:-1] >= 0)  # one read gives the bucket in every range but the last
        if gamma == 1.0001:
            assert per_range.max() > 8  # many edges in one range: the walk takes many steps

    def test_an_underestimated_coarse_table_still_walks_to_the_answer(self):
        spec = port_digest.DigestSpec(gamma=1.01, num_buckets=2560)
        full = digest_tables(spec)
        short = digest_tables(spec, coarse_len=len(full.coarse) // 3)
        bits = (np.unique(full.edges[1:])[:, None] + np.arange(-3, 4)[None, :]).ravel()
        np.testing.assert_array_equal(table_route(bits, spec, short), formula(bits, spec))


# ------------------------------------------------------------- digest_hist


#: (rows, time extent): N = 0, T = 1, odd widths and a width past one
#: Pallas time block.
HIST_SHAPES = [(0, 64), (17, 1), (23, 257), (9, 700), (5, 8300)]


class TestDigestHist:
    @pytest.mark.parametrize(
        "shape, gamma, buckets",
        [(shape, 1.02, 512) for shape in HIST_SHAPES]
        + [((23, 257), 1.05, 128), ((5, 8300), 1.05, 128), ((17, 1), 1.01, 2560), ((9, 700), 1.01, 2560)],
    )
    def test_plain_matches_pallas_interpret(self, shape, gamma, buckets):
        jax_spec, _ = specs(gamma, buckets)
        values, counts = fuzz(61 + shape[1], *shape)
        values = off_edges(jax_spec, values)
        hist, peak = cuda_sketch.digest_hist(
            *port_tensors(values, counts), buckets, jax_spec.min_value, jax_spec.log_gamma
        )
        assert tuple(hist.shape) == (shape[0], buckets) and tuple(peak.shape) == (shape[0],)
        if shape[0] == 0:
            return  # the Pallas kernel cannot take N = 0; the shapes are the check
        ref_hist, ref_peak = jax_pallas.digest_hist(
            jnp.asarray(values), jnp.asarray(counts), buckets, jax_spec.min_value, jax_spec.log_gamma,
            interpret=True,
        )
        np.testing.assert_array_equal(hist.numpy(), np.asarray(ref_hist))
        assert_same(peak.numpy(), ref_peak)
        if shape[0]:
            assert np.isneginf(peak.numpy()[0])  # the empty row

    @pytest.mark.parametrize("shape", [(17, 1), (23, 257), (9, 700)])
    @pytest.mark.parametrize("buckets", [16, 200, 1000])
    def test_plain_matches_jnp_histogram(self, shape, buckets):
        """B off every multiple of 128 (no Pallas kernel takes it), against
        the JAX package's sort-based histogram and jnp peak."""
        jax_spec, port_spec = specs(1.03, buckets)
        values, counts = fuzz(71 + buckets, *shape)
        values = off_edges(jax_spec, values)
        port = port_digest.build_from_packed(port_spec, *port_tensors(values, counts))
        ref = jax_digest.add_chunk(
            jax_spec, jax_digest.empty(jax_spec, shape[0]), jnp.asarray(values),
            jnp.asarray(np.arange(shape[1])[None, :] < counts[:, None]), use_kernel=False,
        )
        assert_digest_equal(port, ref.counts, ref.total, ref.peak)

    def test_all_rows_empty_or_nan(self):
        values = np.array([[np.nan, 1.0], [1.0, 2.0], [-np.inf, -np.inf]], dtype=np.float32)
        counts = np.array([2, 0, 2], dtype=np.int32)
        hist, peak = cuda_sketch.digest_hist(*port_tensors(values, counts), 64, 1e-7, np.log(1.01))
        np.testing.assert_array_equal(hist.sum(dim=1).numpy(), [2, 0, 2])
        assert np.isnan(peak[0]) and np.isneginf(peak[1]) and np.isneginf(peak[2])
        assert peak[0].view(torch.int32) == 0x7FC00000  # the canonical NaN


# --------------------------------------------------------- the digest's ops


def assert_digests_bit_equal(one_shot: port_digest.Digest, scanned: port_digest.Digest, values: np.ndarray) -> None:
    """Bit equality of two digests; on failure the message says which of
    counts, total and peak differ, on which rows, with the differing
    entries and each such row's valid samples' bucket indices."""
    report = []
    for field, a, b in zip(port_digest.Digest._fields, one_shot, scanned):
        a_bits, b_bits = a.numpy().view(np.int32), b.numpy().view(np.int32)
        if a_bits.shape != b_bits.shape:
            report.append(f"{field}: shapes {a_bits.shape} != {b_bits.shape}")
            continue
        differ = np.argwhere(a_bits != b_bits)
        if differ.size:
            rows = sorted({int(i[0]) for i in differ})
            entries = [(tuple(int(x) for x in i), a.numpy()[tuple(i)], b.numpy()[tuple(i)]) for i in differ[:20]]
            report.append(f"{field}: {len(differ)} entries differ on rows {rows}: (index, one-shot, chunked) {entries}")
    if report:
        spec = port_digest.DigestSpec()
        buckets = port_digest.bucketize(spec, torch.from_numpy(values)).numpy()
        report.append(f"torch threads {torch.get_num_threads()}, first row's buckets {buckets[0][:40].tolist()}")
        raise AssertionError("chunked digest != one-shot digest:\n" + "\n".join(report))


#: Process state another test file may leave in a pytest-xdist worker:
#: thread counts, the FPU's flush-to-zero mode, and a JAX computation run
#: in the same process first.
WORKER_STATES = ["threads-1", "threads-3", "flush-denormal", "after-jax"]


@pytest.fixture
def worker_state(request):
    threads = torch.get_num_threads()
    state = request.param
    if state.startswith("threads-"):
        torch.set_num_threads(int(state.split("-")[1]))
    elif state == "flush-denormal":
        torch.set_flush_denormal(True)
    else:
        jax_digest.build_from_packed(jax_digest.DigestSpec(), *fuzz(82, 7, 300), chunk_size=128)
    try:
        yield state
    finally:
        torch.set_num_threads(threads)
        torch.set_flush_denormal(False)


class TestDigestOps:
    @pytest.mark.parametrize("chunk_size", [1, 7, 128, 1000])
    @pytest.mark.parametrize("time_offset", [0, 300])
    def test_chunked_equals_one_shot(self, chunk_size, time_offset):
        _, spec = specs(1.01, 2560)
        values, counts = fuzz(81, 19, 700)
        v, c = port_tensors(values, counts)
        one_shot = port_digest.build_from_packed(spec, v, c, time_offset=time_offset)
        scanned = port_digest.build_from_packed(spec, v, c, chunk_size=chunk_size, time_offset=time_offset)
        assert_digests_bit_equal(one_shot, scanned, values)

    @pytest.mark.parametrize("worker_state", WORKER_STATES, indirect=True)
    def test_chunked_equals_one_shot_whatever_ran_before(self, worker_state):
        """Chunked == one-shot in 128-column chunks with the suspected
        worker state set up first, on the same inputs, on values within an
        ulp of every bucket edge and through the host-streamed build."""
        chunk_size = 128
        _, spec = specs(1.01, 2560)
        values, counts = fuzz(81, 19, 700)
        j = np.arange(1, 2559, dtype=np.float64)
        edges = (spec.min_value * spec.gamma**j).astype(np.float32)
        near = np.concatenate([np.nextafter(edges, np.float32(0)), edges, np.nextafter(edges, np.float32(np.inf))])
        for vals, cnts in ((values, counts), (near[: 12 * 639].reshape(12, 639), np.full(12, 639, np.int32))):
            v, c = port_tensors(vals, cnts)
            one_shot = port_digest.build_from_packed(spec, v, c)
            assert_digests_bit_equal(one_shot, port_digest.build_from_packed(spec, v, c, chunk_size=chunk_size), vals)
            assert_digests_bit_equal(
                one_shot, port_digest.build_from_host(spec, vals, cnts, chunk_size, device="cpu"), vals
            )

    def test_merge_is_associative_and_commutative(self):
        _, spec = specs(1.01, 2560)
        a, b, c = (port_digest.build_from_packed(spec, *port_tensors(*fuzz(s, 11, 300))) for s in (91, 92, 93))
        left = port_digest.merge(port_digest.merge(a, b), c)
        for other in (port_digest.merge(a, port_digest.merge(b, c)), port_digest.merge(c, port_digest.merge(b, a))):
            for x, y in zip(left, other):
                np.testing.assert_array_equal(x.numpy().view(np.int32), y.numpy().view(np.int32))

    def test_non_prefix_mask_takes_the_generic_path(self):
        jax_spec, port_spec = specs(1.01, 2560)
        values, _ = fuzz(95, 16, 384)
        values = off_edges(jax_spec, values)
        scattered = np.random.default_rng(96).random((16, 384)) < 0.5
        chunked.reset_generic_folds()
        port = port_digest.add_chunk(
            port_spec, port_digest.empty(port_spec, 16, device="cpu"), torch.from_numpy(values),
            torch.from_numpy(scattered),
        )
        ref = jax_digest.add_chunk(
            jax_spec, jax_digest.empty(jax_spec, 16), jnp.asarray(values), jnp.asarray(scattered), use_kernel=False
        )
        assert_digest_equal(port, ref.counts, ref.total, ref.peak)
        assert chunked.GENERIC_FOLDS == {"digest": 0, "topk": 0}  # counted on the card only

    def test_jax_half_merges_with_port_half(self):
        """A JAX-built digest of the first half of a window, carried over as
        numpy, merges with a port-built digest of the second half into the
        JAX one-shot digest."""
        jax_spec, port_spec = specs(1.01, 2560)
        values, counts = fuzz(97, 21, 800)
        values = off_edges(jax_spec, values)
        half = 400
        first = jax_digest.build_from_packed(
            jax_spec, values[:, :half], np.minimum(counts, half).astype(np.int32), chunk_size=128
        )
        carried = digest_from_arrays(
            np.asarray(first.counts), np.asarray(first.total), np.asarray(first.peak), device="cpu"
        )
        second = port_digest.build_from_packed(
            port_spec, *port_tensors(values[:, half:], counts), time_offset=half
        )
        whole = jax_digest.build_from_packed(jax_spec, values, counts, chunk_size=256)
        assert_digest_equal(port_digest.merge(carried, second), whole.counts, whole.total, whole.peak)

    @pytest.mark.parametrize("q", [0.0, 50.0, 95.0, 99.0, 100.0])
    def test_percentile_within_relative_error(self, q):
        jax_spec, port_spec = specs(1.01, 2560)
        values, counts = fuzz(98, 31, 600, special_frac=0.0)
        digest = port_digest.build_from_packed(port_spec, *port_tensors(values, counts))
        port = port_digest.percentile(port_spec, digest, q).numpy()
        exact = port_quantile.masked_percentile(*port_tensors(values, counts), q).numpy()
        ref = np.asarray(jax_digest.percentile(jax_spec, jax_digest.build_from_packed(jax_spec, values, counts), q))
        np.testing.assert_array_equal(np.isnan(port), np.isnan(ref))
        np.testing.assert_array_equal(np.isnan(port), counts == 0)
        known = ~np.isnan(exact)
        error = np.abs(port[known].astype(np.float64) - exact[known])
        assert np.all(error <= port_spec.relative_error * exact[known] + port_spec.min_value)
        apart = np.abs(port[known].view(np.int32).astype(np.int64) - ref[known].view(np.int32))
        assert apart.max() <= 2

    @pytest.mark.parametrize(
        "gamma, buckets, max_one_ulp, max_two_ulps", [(1.01, 2560, 205, 19), (1.02, 512, 41, 1)]
    )
    def test_every_bucket_estimate_within_two_ulps(self, gamma, buckets, max_one_ulp, max_two_ulps):
        """Row k holds one sample in bucket k: the port's estimate for every
        bucket equals the JAX package's, or lies one or two float32 ulps
        away (PyTorch's ``exp`` against XLA's CPU ``exp``) — on at most
        ``max_one_ulp`` and ``max_two_ulps`` buckets; the rest are equal.

        The counts depend on the host (both libraries pick a SIMD ``exp``
        by the CPU): the bounds are the first host's counts (2,336 / 205 /
        19 and 470 / 41 / 1 at 0 / 1 / 2 ulps); an AMD EPYC with AVX-512
        (torch 2.13.0+cpu, jax 0.9.0) gives 2,345 / 200 / 15 and
        471 / 41 / 0."""
        jax_spec, port_spec = specs(gamma, buckets)
        counts = np.eye(buckets, dtype=np.float32)
        total = np.ones(buckets, dtype=np.float32)
        peak = np.full(buckets, np.inf, dtype=np.float32)
        ref = np.asarray(jax_digest.percentile(jax_spec, jax_digest.Digest(counts, total, peak), 50.0))
        port = port_digest.percentile(port_spec, digest_from_arrays(counts, total, peak, device="cpu"), 50.0).numpy()
        apart = np.abs(port.view(np.int32).astype(np.int64) - ref.view(np.int32))
        assert apart.max() <= 2
        equal, one_ulp, two_ulps = np.bincount(apart, minlength=3)
        assert one_ulp <= max_one_ulp and two_ulps <= max_two_ulps
        assert equal == buckets - one_ulp - two_ulps
        assert port[0] == 0.0
        np.testing.assert_array_equal(port, port_digest.bucket_estimates(port_spec).numpy())

    def test_percentile_host_is_the_jax_copy(self):
        jax_spec, port_spec = specs(1.01, 2560)
        values, counts = fuzz(99, 23, 700, special_frac=0.0)
        d = jax_digest.build_from_packed(jax_spec, values, counts, chunk_size=256)
        arrays = (np.asarray(d.counts), np.asarray(d.total), np.asarray(d.peak))
        for q in (50.0, 95.0, 99.0):
            np.testing.assert_array_equal(
                port_digest.percentile_host(port_spec, *arrays, q), jax_digest.percentile_host(jax_spec, *arrays, q)
            )

    def test_peak(self):
        values, counts = fuzz(100, 13, 90)
        spec = port_digest.DigestSpec()
        digest = port_digest.build_from_packed(spec, *port_tensors(values, counts))
        assert_same(port_digest.peak(digest).numpy(), port_quantile.masked_max(*port_tensors(values, counts)).numpy())


# ------------------------------------------------------------------- top-K


def topk_plain(values, counts, k, state=None, state_counts=None):
    args = port_tensors(values, counts)
    if state is not None:
        return cuda_sketch.topk_select(*args, k, *port_tensors(state, state_counts)).numpy()
    return cuda_sketch.topk_select(*args, k).numpy()


class TestTopK:
    @pytest.mark.parametrize("q", [0.0, 50.0, 95.0, 97.5, 99.0, 99.9, 100.0])
    def test_required_k_matches_jax(self, q):
        for capacity in (0, 1, 2, 127, 128, 129, 1000, 40_320, 120_960, 10**6):
            assert port_topk.required_k(capacity, q) == jax_topk.required_k(capacity, q)

    @pytest.mark.parametrize("k", [128, 256, 1280])
    @pytest.mark.parametrize("with_state", [False, True])
    def test_plain_matches_pallas_interpret(self, k, with_state):
        """Sorted rows bit-equal, K above and below the row counts (0 to
        1,500), ties across τ, negatives, −0.0 and subnormals (placed as
        +0.0)."""
        t = 1500
        values, counts = fuzz(110 + t, 12, t, special=FINITE_SPECIAL, ties=True)
        kwargs = {}
        if with_state:
            state, state_counts = fuzz(111 + t, 12, 384, special=FINITE_SPECIAL)
            kwargs = {"state": state, "state_counts": np.minimum(state_counts, 384 - 7).astype(np.int32)}
        port = topk_plain(values, counts, k, kwargs.get("state"), kwargs.get("state_counts"))
        ref = jax_pallas.topk_select(
            jnp.asarray(values), jnp.asarray(counts), k,
            **{name: jnp.asarray(a) for name, a in kwargs.items()}, interpret=True,
        )
        assert port.shape == (12, k)
        np.testing.assert_array_equal(sorted_bits(port), sorted_bits(ref))

    def test_invalid_sentinel_divergence(self):
        """A valid sample whose bits are 0x7fffffff (a NaN payload): the JAX
        kernel premasks padding to INT32_MAX and drops survivors with those
        bits, so the sample is lost and τ fills its slot; the port skips
        positions past the count and keeps it (ROADMAP Queue 3)."""
        values = np.arange(1, 201, dtype=np.float32)[None, :] / 100
        values[0, 50] = np.array(0x7FFFFFFF, dtype=np.uint32).view(np.float32)
        counts = np.array([200], dtype=np.int32)
        port = topk_plain(values, counts, 128)
        ref = np.asarray(jax_pallas.topk_select(jnp.asarray(values), jnp.asarray(counts), 128, interpret=True))
        port_bits, ref_bits = sorted_bits(port)[0], sorted_bits(ref)[0]
        tau = values[0, 73].view(np.int32)  # 0.74: the 128th largest, NaN counted
        assert port_bits[-1] == 0x7FFFFFFF and 0x7FFFFFFF not in ref_bits
        assert (port_bits == tau).sum() == 1 and (ref_bits == tau).sum() == 2
        np.testing.assert_array_equal(port_bits[1:-1], ref_bits[2:])  # the 126 other survivors

    @pytest.mark.parametrize("q", [95.0, 99.0, 99.9, 100.0])
    def test_percentile_equals_bisection(self, q):
        """The top-K percentile is the sample the bisection selects, bit for
        bit, edge values included."""
        values, counts = fuzz(120, 25, 900)
        v, c = port_tensors(values, counts)
        sketch = port_topk.build_from_packed(v, c, port_topk.required_k(900, q))
        assert_same(port_topk.percentile(sketch, q).numpy(), port_selection.masked_percentile_bisect(v, c, q).numpy())

    @pytest.mark.parametrize("q", [99.0, 99.9])
    def test_percentile_matches_jax(self, q):
        values, counts = fuzz(121, 17, 700, special=FINITE_SPECIAL)
        k = port_topk.required_k(700, q)
        port = port_topk.percentile(port_topk.build_from_packed(*port_tensors(values, counts), k), q).numpy()
        ref = jax_topk.percentile(jax_topk.build_from_packed(values, counts, k=k, interpret=True), q)
        assert_same(port, ref)

    @pytest.mark.parametrize("chunk_size", [7, 128, 300])
    def test_chunked_equals_one_shot(self, chunk_size):
        v, c = port_tensors(*fuzz(122, 14, 700))
        one_shot = port_topk.build_from_packed(v, c, 128)
        scanned = port_topk.build_from_packed(v, c, 128, chunk_size=chunk_size)
        np.testing.assert_array_equal(sorted_bits(one_shot.values), sorted_bits(scanned.values))
        np.testing.assert_array_equal(one_shot.total.numpy(), scanned.total.numpy())

    def test_fold_with_state_matches_jax_kernel(self):
        values, counts = fuzz(123, 16, 512, special=FINITE_SPECIAL)
        chunk, chunk_counts = fuzz(124, 16, 384, special=FINITE_SPECIAL)
        mask = np.arange(384)[None, :] < chunk_counts[:, None]
        port = port_topk.add_chunk(
            port_topk.build_from_packed(*port_tensors(values, counts), 128), torch.from_numpy(chunk),
            torch.from_numpy(mask),
        )
        ref = jax_topk.add_chunk(
            jax_topk.build_from_packed(values, counts, k=128, interpret=True), jnp.asarray(chunk),
            jnp.asarray(mask), interpret=True,
        )
        np.testing.assert_array_equal(sorted_bits(port.values), sorted_bits(ref.values))
        np.testing.assert_array_equal(port.total.numpy(), np.asarray(ref.total))

    def test_non_prefix_mask_takes_the_generic_path(self):
        values, _ = fuzz(125, 16, 384, special_frac=0.0)
        scattered = np.random.default_rng(126).random((16, 384)) < 0.5
        chunked.reset_generic_folds()
        port = port_topk.add_chunk(
            port_topk.empty(16, 128, device="cpu"), torch.from_numpy(values), torch.from_numpy(scattered)
        )
        ref = jax_topk.add_chunk(jax_topk.empty(16, 128), jnp.asarray(values), jnp.asarray(scattered), use_kernel=False)
        np.testing.assert_array_equal(sorted_bits(port.values), sorted_bits(ref.values))
        np.testing.assert_array_equal(port.total.numpy(), np.asarray(ref.total))
        assert chunked.GENERIC_FOLDS == {"digest": 0, "topk": 0}

    def test_jax_half_merges_with_port_half(self):
        values, counts = fuzz(127, 19, 1000, special=FINITE_SPECIAL)
        half, k = 500, 256
        first = jax_topk.build_from_packed(values[:, :half], np.minimum(counts, half).astype(np.int32), k=k, interpret=True)
        carried = topk_from_arrays(np.asarray(first.values), np.asarray(first.total), device="cpu")
        second = port_topk.build_from_packed(*port_tensors(values[:, half:], counts), k, time_offset=half)
        merged = port_topk.merge(carried, second)
        whole = jax_topk.build_from_packed(values, counts, k=k, interpret=True)
        np.testing.assert_array_equal(sorted_bits(merged.values), sorted_bits(whole.values))
        for q in (99.0, 99.9):
            assert_same(port_topk.percentile(merged, q).numpy(), jax_topk.percentile(whole, q))

    def test_peak_and_unanswerable_rank(self):
        values, counts = fuzz(128, 9, 400, special_frac=0.0)
        v, c = port_tensors(values, counts)
        sketch = port_topk.build_from_packed(v, c, 128)
        assert_same(port_topk.peak(sketch).numpy(), port_quantile.masked_max(v, c).numpy())
        # p50 of a 400-sample row needs K ≥ 200: not answerable from 128 slots.
        out = port_topk.percentile(sketch, 50.0).numpy()
        assert np.all(np.isnan(out[counts > 256]))


# ----------------------------------------------------- the kernel's τ search


def edge_row_bits(seed: int, n: int, t: int) -> np.ndarray:
    """Rows for the τ search: negative NaN payloads (negative keys), the
    all-ones NaN 0x7fffffff, ±0.0, subnormals, negatives, digit edges and
    all-equal rows, mixed into gamma samples at fractions up to 1."""
    pool = np.array(
        [0xFFC00000, 0xFFFFFFFF, 0xFF800001, 0x7FFFFFFF, 0x00000000, 0x80000000, 0x00000001, 0x807FFFFF,
         0xBF800000, 0x7F800000, 0x7F7FFFFF, 0x3F800000, 0x3F7FFFFF, 0x00800000],
        dtype=np.uint32,
    ).view(np.float32)
    rng = np.random.default_rng(seed)
    values = rng.gamma(2.0, 0.05, size=(n, t)).astype(np.float32)
    for r in range(n):
        frac = (0.0, 0.3, 0.9, 1.0)[r % 4]
        salted = rng.random(t) < frac
        subset = pool[rng.permutation(len(pool))[: 1 + r % len(pool)]]
        values[r, salted] = rng.choice(subset, int(salted.sum()))
    values[n - 2] = 0.25  # all equal
    values[n - 3] = pool[1]  # all negative keys
    return values


class TestRadixSelectModel:
    """The kernel's radix select, modelled in numpy, returns the τ that
    :func:`topk_select_plain` implies — what the bisection pins."""

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_equals_the_sorted_rank(self, seed):
        rng = np.random.default_rng(seed)
        for size in (1, 2, 7, 300):
            keys = rng.integers(-(2**31), 2**31, size=size, dtype=np.int64).astype(np.int32)
            if seed == 1:
                keys = keys[rng.integers(0, size, size)]  # ties
            for rank in {0, size // 2, size - 1}:
                assert radix_tau(keys, rank) == max(int(np.sort(keys)[rank]), 0)

    @pytest.mark.parametrize("k", [1, 128, 1280])
    @pytest.mark.parametrize("with_state", [False, True])
    def test_matches_topk_select_plain(self, k, with_state):
        """Rows with kv < total, kv == total (rank 0: counts at and below
        K), an empty chunk (state-only when a state is given) and an empty
        row; τ is the kv-th largest of the plain version's sorted slots."""
        n, t, s = 24, 1500, 384
        values = edge_row_bits(140 + k, n, t)
        counts = np.full(n, t, dtype=np.int32)
        counts[:4] = [min(k, t), max(min(k, t) - 1, 0), 1, 0]
        args = port_tensors(values, counts)
        state_keys = [np.zeros(0, dtype=np.int32)] * n
        if with_state:
            state = edge_row_bits(141 + k, n, s)
            state_counts = np.random.default_rng(142).integers(0, s + 1, size=n).astype(np.int32)
            state_counts[3] = s  # the empty-chunk row is state-only
            args += port_tensors(state, state_counts)
            state_bits = port_selection.as_ordered_bits(args[2]).numpy()
            state_keys = [state_bits[r, : state_counts[r]] for r in range(n)]
        plain = cuda_sketch.topk_select_plain(args[0], args[1], k, *args[2:]).numpy().view(np.int32)
        chunk_bits = port_selection.as_ordered_bits(args[0]).numpy()
        checked = 0
        for r in range(n):
            keys = np.concatenate([chunk_bits[r, : counts[r]], state_keys[r]])
            if keys.size == 0:
                continue
            kv = min(keys.size, k)
            tau = radix_tau(keys, keys.size - kv)
            assert tau == np.sort(plain[r])[::-1][kv - 1], f"row {r}"
            assert tau == max(int(np.sort(keys)[keys.size - kv]), 0)
            checked += 1
        assert checked >= n - 2  # at most rows 1 and 3 are empty


# ---------------------------------------------------------------- wrappers


class TestWrappers:
    def test_cpu_tensors_run_the_plain_versions(self):
        values, counts = fuzz(130, 11, 200)
        v, c = port_tensors(values, counts)
        cuda_sketch.reset_launches()
        for got, want in zip(
            cuda_sketch.digest_hist(v, c, 300, 1e-7, 0.01), cuda_sketch.digest_hist_plain(v, c, 300, 1e-7, 0.01)
        ):
            np.testing.assert_array_equal(got.numpy(), want.numpy())
        np.testing.assert_array_equal(
            cuda_sketch.topk_select(v, c, 128, v, c).numpy(), cuda_sketch.topk_select_plain(v, c, 128, v, c).numpy()
        )
        assert cuda_sketch.LAUNCHES == {"digest_hist": 0, "topk_select": 0}

    @pytest.mark.parametrize(
        "bad",
        [
            lambda v, c: (v.double(), c),
            lambda v, c: (v, c.long()),
            lambda v, c: (v[:, ::2], c),
            lambda v, c: (v, c[:-1]),
            lambda v, c: (v[0], c),
            lambda v, c: (v.to("meta"), c.to("meta")),
        ],
        ids=["float64", "int64-counts", "non-contiguous", "row-mismatch", "1-d", "meta-device"],
    )
    def test_rejects_what_the_kernels_do_not_take(self, bad):
        v, c = bad(*port_tensors(*fuzz(131, 6, 40)))
        with pytest.raises((TypeError, ValueError)):
            cuda_sketch.digest_hist(v, c, 128, 1e-7, 0.01)
        with pytest.raises((TypeError, ValueError)):
            cuda_sketch.topk_select(v, c, 128)

    def test_rejects_bad_sizes_and_a_lone_state(self):
        v, c = port_tensors(*fuzz(132, 4, 16))
        with pytest.raises(ValueError):
            cuda_sketch.digest_hist(v, c, 1, 1e-7, 0.01)
        with pytest.raises(ValueError):
            cuda_sketch.topk_select(v, c, 0)
        with pytest.raises(ValueError):
            cuda_sketch.topk_select(v, c, 128, state=v)

    @pytest.mark.parametrize(
        "min_value, log_gamma", [(0.0, 0.01), (-1e-7, 0.01), (float("inf"), 0.01), (1e-7, 0.0), (1e-7, float("nan")),
                                 (1e-50, 0.01)],
    )
    def test_rejects_specs_the_tables_do_not_take(self, min_value, log_gamma):
        """The kernel's tables need min_value and log γ positive and finite
        in float32 (1e-50 rounds to 0.0); both devices refuse the rest."""
        v, c = port_tensors(*fuzz(135, 4, 16))
        with pytest.raises(ValueError):
            cuda_sketch.digest_hist(v, c, 64, min_value, log_gamma)

    @pytest.mark.parametrize("n, t, s", [(0, 8, 0), (4, 0, 0), (4, 0, 5), (3, 6, 0)])
    def test_degenerate_shapes(self, n, t, s):
        values, counts = fuzz(133, n, t)
        state, state_counts = fuzz(134, n, s)
        port = topk_plain(values, counts, 128, state if s else None, state_counts if s else None)
        assert port.shape == (n, 128)
        valid = np.minimum(counts, t) + (np.minimum(state_counts, s) if s else 0)
        np.testing.assert_array_equal((~np.isneginf(port)).sum(axis=1), valid)  # placed values are never -inf
        hist, peak = cuda_sketch.digest_hist(*port_tensors(values, counts), 64, 1e-7, 0.01)
        assert tuple(hist.shape) == (n, 64) and tuple(peak.shape) == (n,)
        np.testing.assert_array_equal(hist.sum(dim=1).numpy(), np.minimum(counts, t))
        if t == 0:
            assert bool(torch.isneginf(peak).all())


class TestBuild:
    def test_sketch_source_is_built_with_the_others(self):
        assert {"select", "sketch"} <= set(cuda_build.sources())
        assert cuda_build.library_path("sketch").name.startswith("libsketch-")

    def test_editing_a_shared_header_changes_every_library_path(self, monkeypatch, tmp_path):
        for source in cuda_build.SOURCE_DIR.iterdir():
            if source.suffix in (".cu", ".cuh"):
                (tmp_path / source.name).write_bytes(source.read_bytes())
        monkeypatch.setattr(cuda_build, "SOURCE_DIR", tmp_path)
        before = {name: cuda_build.library_path(name) for name in ("select", "sketch")}
        with open(tmp_path / "common.cuh", "a") as header:
            header.write("// edited\n")
        after = {name: cuda_build.library_path(name) for name in ("select", "sketch")}
        assert all(before[name] != after[name] for name in before)
