"""The port's host-streamed builds held against its resident builds and the
JAX package's ``*_from_host`` builds.

A window that stays in host memory streams to the device in time chunks
(`krr_tpu_torch.ops.chunked.HostChunkStreamer`); on the CPU the port runs
the same folds in the same order with its plain PyTorch versions. The same
seeded numpy inputs go through the JAX package's host-streamed builds on
its CPU backend. Chunk sizes 1, 7, one that does not divide the width, and
one past the width; ``time_offset`` 0 and past some counts; ``scale`` 1 on
float32 and ``MEMORY_SCALE`` on float64 input. The port's stream takes no
``scale``: it streams a memory window as the pack's scaled fill makes it
(MB, float32), the route the strategies take, against the JAX package's
streamer dividing the raw float64 window.

Tolerances: against the port's resident builds everything is bit-exact.
Against the JAX package: counts, totals, selected samples and sorted top-K
rows bit-exact; peaks and maxima with NaN positions equal and equal bits
elsewhere (the JAX package may keep a NaN's own payload); digest inputs are
moved off the bucket edges, where ``log`` differs by an ulp between XLA's
CPU backend and PyTorch's (see `tests/test_torch_sketch.py`).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from krr_tpu.ops import chunked as jax_chunked
from krr_tpu.ops import digest as jax_digest
from krr_tpu.ops import quantile as jax_quantile
from krr_tpu.ops import selection as jax_selection
from krr_tpu.ops import topk_sketch as jax_topk
from krr_tpu_torch.ops import chunked, cuda_select
from krr_tpu_torch.ops import digest as port_digest
from krr_tpu_torch.ops import quantile as port_quantile
from krr_tpu_torch.ops import selection as port_selection
from krr_tpu_torch.ops import topk_sketch as port_topk
from krr_tpu_torch.ops.packing import pack_ragged
from krr_tpu_torch.strategies.window import MEMORY_SCALE
from tests.test_torch_select import QS, SPECIAL, assert_same, port_tensors, radix_route, radix_route_rows
from tests.test_torch_sketch import FINITE_SPECIAL, fuzz, off_edges, sorted_bits, specs

N, T = 11, 120
#: 1, 7, a width that does not divide T, and one past T.
CHUNKS = [1, 7, 50, T + 1]
#: 0, and an offset past some rows' counts (those rows fold nothing).
OFFSETS = [0, 70]


def memory_window(seed: int, n: int = N, t: int = T):
    """float64 byte counts (a memory window) with ragged counts, an empty
    and a full row, and edge values salted in."""
    rng = np.random.default_rng(seed)
    values = np.round(rng.uniform(2e7, 4e9, size=(n, t)))
    salted = rng.random((n, t)) < 0.1
    values[salted] = rng.choice(SPECIAL.astype(np.float64), int(salted.sum()))
    counts = rng.integers(0, t + 1, size=n).astype(np.int32)
    counts[0], counts[1] = 0, t
    return values, counts


def window(seed: int, scale: float):
    """A float32 CPU-like window for ``scale`` 1, a float64 memory window
    otherwise."""
    if scale == 1.0:
        return fuzz(seed, N, T)
    return memory_window(seed)


def resident(values: np.ndarray, scale: float) -> np.ndarray:
    """What the resident pack puts on the device: divide, then numpy's
    float32 cast."""
    return np.ascontiguousarray(values / scale if scale != 1.0 else values, dtype=np.float32)


def streamed(values: np.ndarray, scale: float) -> np.ndarray:
    """What the port streams for ``values``: a float32 window as it is; a
    memory window as the pack's scaled fill makes it from the same rows
    (each byte count divided in float64 and rounded once to float32), cut
    to the window's width."""
    if scale == 1.0:
        return values
    t = values.shape[1]
    packed, _counts = pack_ragged([[row] for row in values], dtype=np.float32, capacity=t, scale=scale)
    return packed[:, :t]


#: Bit patterns on the digit edges of the streamed 11/11/10 schedule (the
#: low 21 or 10 bits all zeros or all ones) in positive values, positive
#: NaN and negative NaN (a negative key).
STREAM_EDGES = (0x3F800000, 0x3F9FFFFF, 0x3FA00000, 0x3F8003FF, 0x3F800400, 0x3F7FFC00, 0x3F7FFBFF, 0x00800000,
                0x00BFFFFF, 0x7F7FFFFF, 0x7F600000, 0x7FFFFC00, 0x7F800400, 0xFFE00000, 0xFFDFFFFF, 0xFFC003FF)


def stream_edge_rows(seed: int, t: int):
    """Rows on the streamed schedule's digit edges: edge patterns alone and
    salted into gamma-like values, patterns that share their top 21 bits
    and straddle the 10-bit edge (the last pass decides among them), ones
    that straddle the 21-bit edge, and a count of 1."""
    rng = np.random.default_rng(seed)
    pool = np.array(STREAM_EDGES, dtype=np.uint32).view(np.float32)
    rows = []
    for frac in (1.0, 0.5, 0.1):
        row = rng.gamma(2.0, 0.05, size=t).astype(np.float32)
        salted = rng.random(t) < frac
        row[salted] = rng.choice(pool, int(salted.sum()))
        rows.append(row)
    for base in (0x3F800000, 0x3F9FFC00):
        rows.append((base + rng.integers(0, 2048, t)).astype(np.uint32).view(np.float32))
    values = np.stack(rows + [rows[0]])
    counts = np.array([t] * len(rows) + [1], dtype=np.int32)
    return values, counts


# ------------------------------------------------------------ the streamer


class TestHostChunkStreamer:
    @pytest.mark.parametrize("chunk_size", CHUNKS)
    @pytest.mark.parametrize("time_offset", OFFSETS)
    @pytest.mark.parametrize("scale", [1.0, MEMORY_SCALE])
    def test_chunks_and_validity_equal_the_jax_streamer(self, chunk_size, time_offset, scale):
        """Every chunk the fold gets holds the bytes of the JAX package's
        ``_host_chunk`` (its pad columns aside), and its prefix lengths give
        the JAX validity mask."""
        values, counts = window(201, scale)
        seen = []
        state = chunked.stream_host_chunks(
            streamed(values, scale), counts, 0,
            lambda s, chunk, eff: (seen.append((chunk.clone(), eff.clone())), s + 1)[1],
            chunk_size, time_offset, device="cpu",
        )
        ref = jax_chunked.HostChunkStreamer(values, counts, chunk_size, time_offset=time_offset, scale=scale)
        assert state == len(seen) == -(-T // chunk_size)
        for i, (chunk, eff) in enumerate(seen):
            want = ref._host_chunk(i)
            assert chunk.dtype == torch.float32 and chunk.is_contiguous()
            np.testing.assert_array_equal(chunk.numpy().view(np.int32), want.view(np.int32))
            local = i * chunk_size + np.arange(want.shape[1])
            valid = (local[None, :] < T) & (local[None, :] + time_offset < counts[:, None])
            prefix = np.arange(want.shape[1])[None, :] < eff.numpy()[:, None]
            np.testing.assert_array_equal(prefix, valid)
        np.testing.assert_array_equal(
            np.concatenate([c.numpy() for c, _ in seen], axis=1).view(np.int32),
            resident(values, scale).view(np.int32),
        )

    def test_run_twice_and_stats(self):
        values, counts = fuzz(202, N, T)
        stats = chunked.StreamStats()
        streamer = chunked.HostChunkStreamer(values, counts, 50, device="cpu", stats=stats)
        fold = lambda s, chunk, eff: s + torch.where(  # noqa: E731
            torch.arange(chunk.shape[1])[None, :] < eff[:, None], chunk.double(), 0.0
        ).sum(dim=1)
        first = streamer.run(torch.zeros(N, dtype=torch.float64), fold)
        second = streamer.run(torch.zeros(N, dtype=torch.float64), fold)
        np.testing.assert_array_equal(first.numpy(), second.numpy())
        assert (stats.passes, stats.chunks, stats.host_bytes) == (2, 6, 2 * values.nbytes)
        assert stats.pinned_bytes == stats.copy_seconds == 0  # no pinned buffer and no copy on the CPU

    @pytest.mark.parametrize("shape", [(0, 40), (6, 0)])
    def test_empty_shapes_return_init(self, shape):
        values = np.zeros(shape, dtype=np.float32)
        counts = np.full(shape[0], 5, dtype=np.int32)

        def fold(*_):
            raise AssertionError("no chunk to fold")

        streamer = chunked.HostChunkStreamer(values, counts, 7, device="cpu")
        assert streamer.run("init", fold) == "init"

    def test_rejects_bad_arguments(self):
        values, counts = fuzz(203, 4, 16)
        with pytest.raises(ValueError):
            chunked.HostChunkStreamer(values, counts, 0, device="cpu")
        with pytest.raises(ValueError):
            chunked.HostChunkStreamer(values, counts[:-1], 8, device="cpu")
        with pytest.raises(ValueError):
            chunked.HostChunkStreamer(values[0], counts, 8, device="cpu")


# --------------------------------------------------------- the streamed ops


class TestStreamedMax:
    @pytest.mark.parametrize("chunk_size", CHUNKS)
    @pytest.mark.parametrize("scale", [1.0, MEMORY_SCALE])
    def test_equals_resident_and_jax(self, chunk_size, scale):
        values, counts = window(211, scale)
        port = port_quantile.masked_max_from_host(streamed(values, scale), counts, chunk_size, device="cpu")
        assert port.dtype == np.float32 and port.shape == (N,)
        want = port_quantile.masked_max(*port_tensors(resident(values, scale), counts)).numpy()
        np.testing.assert_array_equal(port.view(np.int32), want.view(np.int32))
        assert_same(port, jax_quantile.masked_max_from_host(values, counts, chunk_size, scale=scale))
        assert np.isnan(port[0])  # the empty row

    def test_a_row_ending_in_an_earlier_chunk_keeps_its_max(self):
        """Rows whose samples all lie in the first chunk: the later chunks
        give −inf, never NaN, and the running max keeps the first chunk's."""
        values = np.array([[3.0, 1.0, 2.0, 9.0], [-0.0, 0.0, 5.0, 5.0], [np.nan, 1.0, 1.0, 1.0]], np.float32)
        counts = np.array([2, 2, 1], dtype=np.int32)
        port = port_quantile.masked_max_from_host(values, counts, 2, device="cpu")
        np.testing.assert_array_equal(port.view(np.uint32), [np.float32(3.0).view(np.uint32), 0, 0x7FC00000])

    def test_row_max_chunk_gives_minus_inf_for_an_empty_prefix(self):
        values, counts = fuzz(212, 9, 33)
        got = cuda_select.row_max_chunk(*port_tensors(values, counts)).numpy()
        want = port_quantile.masked_max(*port_tensors(values, counts)).numpy()
        np.testing.assert_array_equal(np.isneginf(got), counts == 0)
        np.testing.assert_array_equal(got[counts > 0].view(np.int32), want[counts > 0].view(np.int32))

    def test_no_rows(self):
        values = np.zeros((0, 9), dtype=np.float64)
        assert port_quantile.masked_max_from_host(values, np.zeros(0, np.int32), 4, device="cpu").shape == (0,)


class TestStreamedDigest:
    @pytest.mark.parametrize("chunk_size", CHUNKS)
    @pytest.mark.parametrize("time_offset", OFFSETS)
    def test_equals_resident_and_jax(self, chunk_size, time_offset):
        jax_spec, port_spec = specs(1.01, 2560)
        values, counts = fuzz(221, N, T)
        values = off_edges(jax_spec, values)
        port = port_digest.build_from_host(port_spec, values, counts, chunk_size, time_offset, device="cpu")
        one_shot = port_digest.build_from_packed(port_spec, *port_tensors(values, counts), time_offset=time_offset)
        for got, want in zip(port, one_shot):
            np.testing.assert_array_equal(got.numpy().view(np.int32), want.numpy().view(np.int32))
        ref = jax_digest.build_from_host(jax_spec, values, counts, chunk_size, time_offset)
        np.testing.assert_array_equal(port.counts.numpy(), np.asarray(ref.counts))
        np.testing.assert_array_equal(port.total.numpy(), np.asarray(ref.total))
        assert_same(port.peak.numpy(), np.asarray(ref.peak))

    def test_no_rows(self):
        _, spec = specs(1.01, 64)
        digest = port_digest.build_from_host(spec, np.zeros((0, 9), np.float32), np.zeros(0, np.int32), device="cpu")
        assert tuple(digest.counts.shape) == (0, 64)


class TestStreamedTopK:
    @pytest.mark.parametrize("chunk_size", CHUNKS)
    @pytest.mark.parametrize("time_offset", OFFSETS)
    def test_equals_resident(self, chunk_size, time_offset):
        values, counts = fuzz(231, N, T, ties=True)
        port = port_topk.build_from_host(values, counts, 128, chunk_size, time_offset, device="cpu")
        one_shot = port_topk.build_from_packed(*port_tensors(values, counts), 128, time_offset=time_offset)
        np.testing.assert_array_equal(sorted_bits(port.values), sorted_bits(one_shot.values))
        np.testing.assert_array_equal(port.total.numpy(), one_shot.total.numpy())

    @pytest.mark.parametrize("chunk_size", CHUNKS)
    def test_equals_jax(self, chunk_size):
        """Non-negative normal samples (the JAX package's jnp fold keeps raw
        values, the port's slots hold ordered bits): the same multiset; with
        edge values salted in, the same percentiles."""
        rng = np.random.default_rng(232)
        values = rng.gamma(2.0, 0.05, size=(N, T)).astype(np.float32)
        counts = fuzz(233, N, T)[1]
        port = port_topk.build_from_host(values, counts, 128, chunk_size, device="cpu")
        ref = jax_topk.build_from_host(values, counts, 128, chunk_size)
        np.testing.assert_array_equal(sorted_bits(port.values), sorted_bits(ref.values))
        np.testing.assert_array_equal(port.total.numpy(), np.asarray(ref.total))
        salted, counts = fuzz(234, N, T, special=FINITE_SPECIAL)
        k = port_topk.required_k(T, 95.0)
        port = port_topk.build_from_host(salted, counts, k, chunk_size, device="cpu")
        ref = jax_topk.build_from_host(salted, counts, k, chunk_size)
        for q in (95.0, 99.0, 100.0):
            assert_same(port_topk.percentile(port, q).numpy(), jax_topk.percentile(ref, q))


class TestStreamedSelect:
    @pytest.mark.parametrize("chunk_size", CHUNKS)
    @pytest.mark.parametrize("q", [0.0, 50.0, 99.0, 120.0])
    def test_equals_resident_bisection(self, chunk_size, q):
        values, counts = fuzz(241, N, T)
        counts[-2:] = [T + 5, 3 * T]  # counts past the width: the rank may pass the keys
        port = port_selection.masked_percentile_bisect_from_host(values, counts, q, chunk_size, device="cpu")
        want = port_selection.masked_percentile_bisect(*port_tensors(values, counts), q).numpy()
        assert port.dtype == np.float32 and port.shape == (N,)
        np.testing.assert_array_equal(port.view(np.int32), want.view(np.int32))

    @pytest.mark.parametrize("chunk_size", CHUNKS)
    @pytest.mark.parametrize("q", [50.0, 99.0, 0.0, 90.0, 100.0])
    def test_equals_jax_streamed_bisection(self, chunk_size, q):
        """The 3-pass schedule against the JAX package's 31-pass streamed
        bisection, bit for bit (NaN payloads included)."""
        values, counts = fuzz(242, N, T)
        counts[-1] = T + 9
        port = port_selection.masked_percentile_bisect_from_host(values, counts, q, chunk_size, device="cpu")
        ref = np.asarray(jax_selection.masked_percentile_bisect_from_host(values, counts, q, chunk_size), np.float32)
        assert_same(port, ref)
        np.testing.assert_array_equal(port.view(np.int32), ref.view(np.int32))

    @pytest.mark.parametrize("q", QS)
    def test_schedule_does_not_change_the_answer(self, q):
        """K1's hard rows and rows on the 11- and 10-bit digit edges: the
        default 11/11/10 schedule, 12/12/8 and the 8-bit schedule give the
        same sample, which is K1's (the numpy model)."""
        hard, edges = radix_route_rows(751, 300), stream_edge_rows(752, 300)
        values, counts = (np.concatenate([a, b]) for a, b in zip(hard, edges))
        want = radix_route(values, counts, q).view(np.int32)
        for digits in (port_selection.STREAM_DIGITS, ((20, 12), (8, 12), (0, 8)),
                       tuple((shift, 8) for shift in port_selection.RADIX_SHIFTS)):
            port = port_selection.masked_percentile_bisect_from_host(values, counts, q, 37, device="cpu",
                                                                     digits=digits)
            np.testing.assert_array_equal(port.view(np.int32), want, err_msg=f"digits {digits}")

    def test_three_passes_on_the_cpu(self):
        values, counts = fuzz(243, N, T)
        stats = chunked.StreamStats()
        port_selection.masked_percentile_bisect_from_host(values, counts, 50.0, 50, device="cpu", stats=stats)
        assert (stats.passes, stats.chunks) == (3, 3 * -(-T // 50))

    @pytest.mark.parametrize(
        "digits",
        [((21, 11), (10, 11)), ((21, 11), (10, 11), (0, 11)), ((20, 13), (0, 20)), ((24, 8), (8, 16), (0, 8))],
        ids=["short", "past-32", "too-wide", "16-bit-digit"],
    )
    def test_rejects_a_schedule_that_does_not_tile_the_key(self, digits):
        values, counts = fuzz(244, 4, 16)
        with pytest.raises(ValueError):
            port_selection.masked_percentile_bisect_from_host(values, counts, 50.0, 8, device="cpu", digits=digits)

    @pytest.mark.parametrize("q", QS)
    def test_radix_route_rows(self, q):
        """K1's hard rows — negative NaN payloads, keys that read as 0,
        digits 0x00/0xff, all-equal rows, count 1, counts past the width —
        streamed in odd chunks: the numpy model of K1's 31-step route."""
        values, counts = radix_route_rows(750, 300)
        port = port_selection.masked_percentile_bisect_from_host(values, counts, q, 37, device="cpu")
        np.testing.assert_array_equal(port.view(np.int32), radix_route(values, counts, q).view(np.int32))

    @pytest.mark.parametrize("shape", [(0, 16), (5, 0)])
    def test_degenerate_shapes(self, shape):
        values = np.zeros(shape, dtype=np.float32)
        counts = np.arange(shape[0], dtype=np.int32)
        port = port_selection.masked_percentile_bisect_from_host(values, counts, 50.0, 8, device="cpu")
        ref = jax_selection.masked_percentile_bisect_from_host(values, counts, 50.0, 8)
        assert port.shape == (shape[0],)
        assert_same(port, ref)  # T = 0: NaN for count 0, the bisection's climb to 0x7fffffff past it


# ---------------------------------------------------------------- the K5 fold


def digit_hist_numpy(values, eff, prefixes, shift, bins, bits=8):
    """numpy model of ``radix_digit_hist``: per row, the ``bits``-wide digit
    at ``shift`` of every valid key whose bits above ``shift + bits`` equal
    the prefix's, counted."""
    out = bins.copy()
    u = port_selection.as_ordered_bits(torch.from_numpy(values)).numpy().view(np.uint32) ^ np.uint32(0x80000000)
    mask = np.uint32((0xFFFFFFFF << (shift + bits)) & 0xFFFFFFFF)
    for r in range(values.shape[0]):
        keys = u[r, : max(min(int(eff[r]), values.shape[1]), 0)]
        keys = keys[(keys & mask) == (np.uint32(prefixes[r]) & mask)]
        np.add.at(out[r], ((keys >> np.uint32(shift)) & np.uint32((1 << bits) - 1)).astype(np.int64), 1)
    return out


def digit_case(seed: int, n: int, t: int, bits: int):
    """A fuzzed chunk, prefixes taken from the rows' own keys (so some
    match) and one at random, and bins that already hold counts."""
    values, eff = fuzz(seed, n, t)
    rng = np.random.default_rng(seed + bits)
    prefixes = values.view(np.int32)[np.arange(n), rng.integers(0, t, n)] ^ np.int32(-(2**31))
    prefixes[-1] = rng.integers(-(2**31), 2**31)
    bins = rng.integers(0, 5, size=(n, 1 << bits)).astype(np.int32)
    return values, eff, prefixes.astype(np.int32), bins


class TestDigitHist:
    @pytest.mark.parametrize("shift", port_selection.RADIX_SHIFTS)
    @pytest.mark.parametrize("shape", [(13, 1), (9, 257), (4, 1000)])
    def test_plain_matches_numpy(self, shift, shape):
        """8-bit digits, K1's schedule."""
        n, t = shape
        values, eff, prefixes, bins = digit_case(250 + t + shift, n, t, 8)
        want = digit_hist_numpy(values, eff, prefixes.view(np.uint32), shift, bins)
        got = cuda_select.radix_digit_hist(*port_tensors(values, eff, prefixes, bins), shift, 8)
        np.testing.assert_array_equal(got.numpy(), want)

    @pytest.mark.parametrize("digit", port_selection.STREAM_DIGITS + ((20, 12), (31, 1), (0, 1), (5, 12)),
                             ids=lambda d: f"{d[0]}-{d[1]}")
    @pytest.mark.parametrize("shape", [(13, 1), (9, 257), (4, 1000)])
    def test_schedule_matches_numpy(self, digit, shape):
        """Each digit of the streamed 11/11/10 schedule, and the narrowest
        and widest digits the kernel takes."""
        (shift, bits), (n, t) = digit, shape
        values, eff, prefixes, bins = digit_case(270 + t + shift, n, t, bits)
        want = digit_hist_numpy(values, eff, prefixes.view(np.uint32), shift, bins, bits)
        got = cuda_select.radix_digit_hist(*port_tensors(values, eff, prefixes, bins), shift, bits)
        np.testing.assert_array_equal(got.numpy(), want)

    def test_wrapper_adds_in_place_and_counts_no_launch_on_the_cpu(self):
        values, eff = fuzz(260, 6, 40)
        v, e = port_tensors(values, eff)
        bins = torch.zeros((6, 2048), dtype=torch.int32)
        cuda_select.reset_launches()
        out = cuda_select.radix_digit_hist(v, e, torch.zeros(6, dtype=torch.int32), bins, 21, 11)
        assert out is bins and int(bins.sum()) == int(np.minimum(eff, 40).sum())
        assert cuda_select.LAUNCHES["radix_digit_hist"] == 0

    @pytest.mark.parametrize(
        "bad",
        [
            lambda v, e, p, b: (v, e, p.long(), b, 24, 8),
            lambda v, e, p, b: (v, e, p, b.float(), 24, 8),
            lambda v, e, p, b: (v, e, p, b[:, :128], 24, 8),
            lambda v, e, p, b: (v, e, p[:-1], b, 24, 8),
            lambda v, e, p, b: (v, e, p, b, 25, 8),
            lambda v, e, p, b: (v[:, ::2], e, p, b, 24, 8),
            lambda v, e, p, b: (v, e, p, b, 24, 0),
            lambda v, e, p, b: (v, e, p, torch.zeros((6, 8192), dtype=torch.int32), 19, 13),
            lambda v, e, p, b: (v, e, p, b, -1, 8),
            lambda v, e, p, b: (v, e, p, b, 21, 11),
            lambda v, e, p, b: (v, e, p, torch.zeros((6, 2048), dtype=torch.int32), 22, 11),
        ],
        ids=["int64-prefixes", "float-bins", "narrow-bins", "prefix-rows", "shift", "non-contiguous", "bits-0",
             "bits-13", "negative-shift", "bins-width", "shift-plus-bits"],
    )
    def test_rejects_what_the_kernel_does_not_take(self, bad):
        values, eff = fuzz(261, 6, 40)
        v, e = port_tensors(values, eff)
        with pytest.raises((TypeError, ValueError)):
            cuda_select.radix_digit_hist(*bad(v, e, torch.zeros(6, dtype=torch.int32),
                                              torch.zeros((6, 256), dtype=torch.int32)))

    @pytest.mark.parametrize("shape", [(0, 8), (5, 0)])
    def test_degenerate_shapes(self, shape):
        values = np.zeros(shape, dtype=np.float32)
        bins = torch.ones((shape[0], 1024), dtype=torch.int32)
        out = cuda_select.radix_digit_hist(torch.from_numpy(values), torch.full((shape[0],), 3, dtype=torch.int32),
                                           torch.zeros(shape[0], dtype=torch.int32), bins, 0, 10)
        assert bool((out == 1).all())


def test_radix_pick_matches_the_model():
    """The digit pick between passes, on histograms with the residual
    before, at and past a bin's edge."""
    bins = torch.tensor([[0, 3, 0, 2] + [0] * 252, [5] + [0] * 254 + [1], [0] * 256], dtype=torch.int32)
    for residual, want in (([0, 4, 0], [(1, 0), (0, 4), (255, 0)]), ([2, 5, 3], [(1, 2), (255, 0), (255, 3)]),
                           ([3, 0, 0], [(3, 0), (0, 0), (255, 0)])):
        digit, rest = port_selection.radix_pick(bins, torch.tensor(residual, dtype=torch.int64))
        assert list(zip(digit.tolist(), rest.tolist())) == want


@pytest.mark.parametrize("width", [2, 1024, 2048, 4096])
def test_radix_pick_takes_any_width(width):
    """[N, B] bins of any width: the last digit on a row whose count ends
    in its last bin, and on a row already decided (clamped to B − 1)."""
    bins = torch.zeros((3, width), dtype=torch.int32)
    bins[0, -1], bins[1, 0], bins[2, 1] = 4, 2, 3
    digit, rest = port_selection.radix_pick(bins, torch.tensor([3, 5, 1], dtype=torch.int64))
    assert digit.tolist() == [width - 1, width - 1, 1] and rest.tolist() == [3, 3, 1]
