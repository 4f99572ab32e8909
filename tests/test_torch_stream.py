"""The port's host-streamed builds held against its resident builds and the
JAX package's ``*_from_host`` builds.

A window that stays in host memory streams to the device in time chunks
(`krr_tpu_torch.ops.chunked.HostChunkStreamer`); on the CPU the port runs
the same folds in the same order with its plain PyTorch versions. The same
seeded numpy inputs go through the JAX package's host-streamed builds on
its CPU backend. Chunk sizes 1, 7, one that does not divide the width, and
one past the width; ``time_offset`` 0 and past some counts; ``scale`` 1 on
float32 and ``MEMORY_SCALE`` on float64 input.

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
from krr_tpu_torch.strategies.simple import MEMORY_SCALE
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
            values, counts, 0, lambda s, chunk, eff: (seen.append((chunk.clone(), eff.clone())), s + 1)[1],
            chunk_size, time_offset, scale, device="cpu",
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
        port = port_quantile.masked_max_from_host(values, counts, chunk_size, scale=scale, device="cpu")
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
    @pytest.mark.parametrize("q", [50.0, 99.0])
    def test_equals_jax_streamed_bisection(self, chunk_size, q):
        values, counts = fuzz(242, N, T)
        counts[-1] = T + 9
        port = port_selection.masked_percentile_bisect_from_host(values, counts, q, chunk_size, device="cpu")
        assert_same(port, jax_selection.masked_percentile_bisect_from_host(values, counts, q, chunk_size))

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


def digit_hist_numpy(values, eff, prefixes, shift, bins):
    """numpy model of ``radix_digit_hist``: per row, the digit of every
    valid key whose digits above ``shift`` equal the prefix's, counted."""
    out = bins.copy()
    u = port_selection.as_ordered_bits(torch.from_numpy(values)).numpy().view(np.uint32) ^ np.uint32(0x80000000)
    mask = np.uint32(0 if shift == 24 else (0xFFFFFFFF << (shift + 8)) & 0xFFFFFFFF)
    for r in range(values.shape[0]):
        keys = u[r, : max(min(int(eff[r]), values.shape[1]), 0)]
        keys = keys[(keys & mask) == (np.uint32(prefixes[r]) & mask)]
        np.add.at(out[r], ((keys >> np.uint32(shift)) & np.uint32(0xFF)).astype(np.int64), 1)
    return out


class TestDigitHist:
    @pytest.mark.parametrize("shift", port_selection.RADIX_SHIFTS)
    @pytest.mark.parametrize("shape", [(13, 1), (9, 257), (4, 1000)])
    def test_plain_matches_numpy(self, shift, shape):
        n, t = shape
        values, eff = fuzz(250 + t, n, t)
        rng = np.random.default_rng(shift + t)
        bits = values.view(np.int32)
        # Prefixes taken from the rows' own keys (so some match), and one random.
        prefixes = bits[np.arange(n), rng.integers(0, t, n)] ^ np.int32(-(2**31))
        prefixes[-1] = rng.integers(-(2**31), 2**31)
        bins = rng.integers(0, 5, size=(n, port_selection.RADIX_BINS)).astype(np.int32)
        want = digit_hist_numpy(values, eff, prefixes.view(np.uint32), shift, bins)
        got = cuda_select.radix_digit_hist(*port_tensors(values, eff, prefixes.astype(np.int32), bins), shift)
        np.testing.assert_array_equal(got.numpy(), want)

    def test_wrapper_adds_in_place_and_counts_no_launch_on_the_cpu(self):
        values, eff = fuzz(260, 6, 40)
        v, e = port_tensors(values, eff)
        bins = torch.zeros((6, 256), dtype=torch.int32)
        cuda_select.reset_launches()
        out = cuda_select.radix_digit_hist(v, e, torch.zeros(6, dtype=torch.int32), bins, 24)
        assert out is bins and int(bins.sum()) == int(np.minimum(eff, 40).sum())
        assert cuda_select.LAUNCHES["radix_digit_hist"] == 0

    @pytest.mark.parametrize(
        "bad",
        [
            lambda v, e, p, b: (v, e, p.long(), b, 24),
            lambda v, e, p, b: (v, e, p, b.float(), 24),
            lambda v, e, p, b: (v, e, p, b[:, :128], 24),
            lambda v, e, p, b: (v, e, p[:-1], b, 24),
            lambda v, e, p, b: (v, e, p, b, 4),
            lambda v, e, p, b: (v[:, ::2], e, p, b, 24),
        ],
        ids=["int64-prefixes", "float-bins", "narrow-bins", "prefix-rows", "shift", "non-contiguous"],
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
        bins = torch.ones((shape[0], 256), dtype=torch.int32)
        out = cuda_select.radix_digit_hist(torch.from_numpy(values), torch.full((shape[0],), 3, dtype=torch.int32),
                                           torch.zeros(shape[0], dtype=torch.int32), bins, 0)
        assert bool((out == 1).all())


def test_radix_pick_matches_the_model():
    """The digit pick between passes, on histograms with the residual
    before, at and past a bin's edge."""
    bins = torch.tensor([[0, 3, 0, 2] + [0] * 252, [5] + [0] * 254 + [1], [0] * 256], dtype=torch.int32)
    for residual, want in (([0, 4, 0], [(1, 0), (0, 4), (255, 0)]), ([2, 5, 3], [(1, 2), (255, 0), (255, 3)]),
                           ([3, 0, 0], [(3, 0), (0, 0), (255, 0)])):
        digit, rest = port_selection.radix_pick(bins, torch.tensor(residual, dtype=torch.int64))
        assert list(zip(digit.tolist(), rest.tolist())) == want
