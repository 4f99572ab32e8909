"""Parity of the port's selection kernels' plain versions with the JAX package.

The same numpy inputs (seeded) go through the JAX package — its jnp ops and
its Pallas kernels in interpret mode, as `tests/test_ops.py` runs them on the
CPU — and through `krr_tpu_torch`'s plain PyTorch versions on the CPU, which
is what the port's wrappers run for a CPU tensor and what its CUDA kernels
are held against on the card (`chip_smoke.py`). The tolerance is exact:
``assert_array_equal`` with NaN positions equal, plus equal bit patterns
wherever the result is not NaN (so −0.0 and +0.0 count as different).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from krr_tpu.ops import pallas_select as jax_pallas
from krr_tpu.ops import quantile as jax_quantile
from krr_tpu.ops import selection as jax_selection
from krr_tpu_torch.ops import cuda_build, cuda_select
from krr_tpu_torch.ops import quantile as port_quantile
from krr_tpu_torch.ops import selection as port_selection

#: Edge values, as float32 bit patterns: ±0.0, negatives, the largest finite
#: magnitudes, ±inf, quiet NaN, the all-ones-payload NaN (bits 0x7fffffff,
#: equal to the TPU kernel's premask sentinel), a negative NaN, subnormals of
#: both signs and the smallest normal.
SPECIAL_BITS = np.array(
    [
        0x00000000, 0x80000000, 0xBFC00000, 0xFF7FFFFF, 0x7F7FFFFF, 0x7F800000,
        0xFF800000, 0x7FC00000, 0x7FFFFFFF, 0xFFC00000, 0x00000001, 0x000F0000,
        0x800F0000, 0x807FFFFF, 0x00800000,
    ],
    dtype=np.uint32,
)
SPECIAL = SPECIAL_BITS.view(np.float32)

QS = [0.0, 50.0, 95.0, 99.0, 100.0, 120.0]
#: (rows, time extent): a single column, widths off every power of two, a
#: wider row, and the degenerate N = 0 / T = 0 shapes.
SHAPES = [(17, 1), (23, 257), (9, 1024), (0, 64), (5, 0)]


def fuzz(seed: int, n: int, t: int, special_frac: float = 0.2, ties: bool = False):
    """Ragged rows (an empty row and a full row included) over gamma-like
    samples salted with edge values — in the padding too, which no kernel
    may read."""
    rng = np.random.default_rng(seed)
    if ties:
        values = (rng.integers(0, 6, size=(n, t)) / 4).astype(np.float32)
    else:
        values = rng.gamma(2.0, 0.05, size=(n, t)).astype(np.float32)
    salted = rng.random((n, t)) < special_frac
    values[salted] = rng.choice(SPECIAL, int(salted.sum()))
    counts = rng.integers(0, t + 1, size=n).astype(np.int32)
    if n > 1:
        counts[0], counts[1] = 0, t
    return values, counts


def assert_same(port, ref) -> None:
    port = np.asarray(port, dtype=np.float32)
    ref = np.asarray(ref, dtype=np.float32)
    np.testing.assert_array_equal(port, ref)
    finite = ~np.isnan(ref)
    np.testing.assert_array_equal(port[finite].view(np.uint32), ref[finite].view(np.uint32))


def port_tensors(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


class TestOrderedBits:
    def test_edge_values(self):
        ref = np.asarray(jax_selection.as_ordered_bits(SPECIAL))
        port = port_selection.as_ordered_bits(torch.from_numpy(SPECIAL.copy())).numpy()
        np.testing.assert_array_equal(port, ref)

    def test_subnormals_and_negative_zero_map_to_zero(self):
        """The JAX package (XLA's CPU backend) flushes subnormals and −0.0 to
        bits 0 in ``jnp.maximum(v, 0.0)``; ``torch.clamp_min`` would keep
        them (bits 1 and INT32_MIN). The port reproduces the JAX bits."""
        values = np.array([1e-45, -0.0, -1e-40, 1e-39], dtype=np.float32)
        port = port_selection.as_ordered_bits(torch.from_numpy(values)).numpy()
        np.testing.assert_array_equal(port, [0, 0, 0, 0])
        np.testing.assert_array_equal(port, np.asarray(jax_selection.as_ordered_bits(values)))

    @pytest.mark.parametrize("seed", [0, 1])
    def test_random_bit_patterns(self, seed):
        rng = np.random.default_rng(seed)
        values = rng.integers(0, 2**32, size=4096, dtype=np.uint64).astype(np.uint32).view(np.float32)
        ref = np.asarray(jax_selection.as_ordered_bits(values))
        port = port_selection.as_ordered_bits(torch.from_numpy(values.copy())).numpy()
        np.testing.assert_array_equal(port, ref)


class TestSelectionRank:
    @pytest.mark.parametrize("q", QS + [33.3, 99.9, 1e-3])
    def test_matches_jax_in_float32(self, q):
        counts = np.array(
            [0, 1, 2, 3, 99, 100, 101, 1000, 40_320, 120_960, 2**24 - 1, 2**24 + 1, 16_777_259, 2**30],
            dtype=np.int32,
        )
        ref = np.asarray(jax_selection.selection_rank(counts, q))
        port = port_selection.selection_rank(torch.from_numpy(counts), q).numpy()
        np.testing.assert_array_equal(port, ref)


class TestBisectParity:
    @pytest.mark.parametrize("shape", SHAPES)
    @pytest.mark.parametrize("q", QS)
    def test_plain_matches_jnp_and_pallas_interpret(self, shape, q):
        values, counts = fuzz(11, *shape)
        port = port_selection.masked_percentile_bisect(*port_tensors(values, counts), q).numpy()
        assert port.shape == (shape[0],)
        assert_same(port, jax_selection.masked_percentile_bisect(values, counts, q))
        assert_same(port, jax_pallas.masked_percentile_bisect_pallas(values, counts, q, interpret=True))

    @pytest.mark.parametrize("q", QS)
    def test_ties(self, q):
        values, counts = fuzz(5, 19, 300, special_frac=0.05, ties=True)
        port = port_selection.masked_percentile_bisect(*port_tensors(values, counts), q).numpy()
        assert_same(port, jax_selection.masked_percentile_bisect(values, counts, q))

    @pytest.mark.parametrize("q", [0.0, 50.0, 95.0, 99.0, 100.0])
    @pytest.mark.parametrize("ties", [False, True])
    def test_plain_matches_sort_oracle(self, q, ties):
        """On non-negative normal data (where max(v, 0) is the identity) the
        bisection selects exactly the sorted sample."""
        values, counts = fuzz(23, 29, 513, special_frac=0.0, ties=ties)
        bisect = port_selection.masked_percentile_bisect(*port_tensors(values, counts), q).numpy()
        oracle = port_quantile.masked_percentile(*port_tensors(values, counts), q).numpy()
        assert_same(bisect, oracle)
        assert_same(oracle, jax_quantile.masked_percentile(values, counts, q))


class TestMaxParity:
    @pytest.mark.parametrize("shape", SHAPES)
    @pytest.mark.parametrize("seed", [3, 4])
    def test_plain_matches_jnp_and_pallas_interpret(self, shape, seed):
        values, counts = fuzz(seed, *shape, special_frac=0.3)
        port = port_quantile.masked_max(*port_tensors(values, counts)).numpy()
        assert port.shape == (shape[0],)
        # The Pallas wrapper answers T = 0 with NaN rows; jnp's max raises there.
        assert_same(port, jax_pallas.masked_max_pallas(values, counts, interpret=True))
        if shape[1] == 0:
            return
        jnp_ref = np.asarray(jax_quantile.masked_max(values, counts))
        if shape[1] == 1:
            # XLA folds a one-element reduce away, so its flush of subnormals
            # never applies there: the jnp path keeps a lone subnormal that
            # the JAX Pallas kernel (T padded to 128) and the port flush.
            lone = (jnp_ref != 0) & (np.abs(jnp_ref) < np.finfo(np.float32).tiny)
            jnp_ref = np.where(lone, np.copysign(np.float32(0), jnp_ref), jnp_ref)
        assert_same(port, jnp_ref)

    def test_signed_zero_and_subnormal_rows(self):
        """XLA's CPU max reads subnormals as zero of their sign and ranks
        +0.0 above −0.0, whatever the order; the port's max does the same."""
        rows = np.array(
            [[1e-45, 0.0], [-0.0, 0.0], [0.0, -0.0], [1e-40, -1.0], [-1e-40, -1.0], [-0.0, -0.0]],
            dtype=np.float32,
        )
        counts = np.full(len(rows), 2, dtype=np.int32)
        port = port_quantile.masked_max(*port_tensors(rows, counts)).numpy()
        np.testing.assert_array_equal(
            port.view(np.uint32), [0, 0, 0, 0, 0x80000000, 0x80000000]
        )
        assert_same(port, jax_quantile.masked_max(rows, counts))


def nan_high_row_max(values: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """numpy model of the row-max kernel's one reduction: every NaN takes
    the key INT32_MAX, every other value its total-order key (subnormal →
    zero of its sign, negatives mirrored below +0.0); the row's answer is
    the canonical NaN when the max key is INT32_MAX or the row is empty."""
    bits = values.view(np.int32)
    magnitude = bits & port_selection.MAGNITUDE_MASK
    flushed = np.where(magnitude < port_selection.MIN_NORMAL_BITS, bits & np.int32(port_selection.INT32_MIN), bits)
    key = np.where(flushed >= 0, flushed, flushed ^ port_selection.MAGNITUDE_MASK)
    key = np.where(magnitude > port_selection.EXPONENT_BITS, port_selection.INT32_MAX, key)
    valid = np.arange(values.shape[1])[None, :] < counts[:, None]
    best = np.where(valid, key, port_selection.INT32_MIN).max(axis=1)
    peak = np.where(best >= 0, best, best ^ port_selection.MAGNITUDE_MASK).astype(np.int32)
    peak = np.where((best == port_selection.INT32_MAX) | (counts <= 0), 0x7FC00000, peak).astype(np.int32)
    return peak.view(np.float32)


class TestNanHighMaxKey:
    @pytest.mark.parametrize("width", [1, 2, 3])
    def test_orders_every_special_pattern_as_masked_max(self, width):
        """Every row of ``width`` values drawn with repetition from the
        edge patterns (those of ``chip_smoke.fuzz`` among them) and a few
        normal values, one more position of padding holding NaN: the model
        equals ``masked_max`` bit for bit, canonical NaN included."""
        pool = np.concatenate([SPECIAL, np.array([0.25, 1e30, -1e30, -0.5], dtype=np.float32)])
        grid = np.stack(np.meshgrid(*[np.arange(len(pool))] * width, indexing="ij"), axis=-1).reshape(-1, width)
        values = np.concatenate([pool[grid], np.full((len(grid), 1), np.nan, dtype=np.float32)], axis=1)
        counts = np.full(len(grid), width, dtype=np.int32)
        counts[::7] = 0
        port = port_quantile.masked_max(*port_tensors(values, counts)).numpy()
        np.testing.assert_array_equal(port.view(np.int32), nan_high_row_max(values, counts).view(np.int32))


def radix_tau(keys: np.ndarray, rank: int) -> int:
    """numpy model of `csrc/common.cuh` ``radix_select_ordered``: flip the
    sign bit (signed order → unsigned), then four 8-bit digits from the top,
    each the smallest digit whose running count over the keys matching the
    prefix passes the residual rank; the counts below it leave the residual.
    A negative top digit ends the search at 0. Returns ``max(b, 0)`` for
    ``b`` the rank-th smallest key."""
    u = keys.astype(np.int32).view(np.uint32) ^ np.uint32(0x80000000)
    prefix, mask, residual = 0, 0, rank
    for shift in (24, 16, 8, 0):
        candidates = u[(u & np.uint32(mask)) == np.uint32(prefix)]
        hist = np.bincount((candidates >> np.uint32(shift)) & np.uint32(0xFF), minlength=256)
        inclusive = np.cumsum(hist)
        digit = int(np.argmax(inclusive > residual))
        residual -= int(inclusive[digit] - hist[digit])
        prefix |= digit << shift
        mask |= 0xFF << shift
        if shift == 24 and digit < 0x80:
            return 0
    return max(int(np.array(prefix ^ 0x80000000, dtype=np.uint32).view(np.int32)), 0)


#: Bit patterns for K1's radix route: negative NaN payloads (negative keys,
#: which count toward the rank; a rank landing on one gives +0.0), keys
#: that read as 0 (negatives, ±0.0, subnormals, −inf), the all-ones NaN and
#: digit edges 0x00 / 0xff (+inf, the largest finite, 1.0 and its
#: neighbours, the smallest normal).
NEGATIVE_KEYS = (0xFFC00000, 0xFFFFFFFF, 0xFF800001)
ZERO_KEYS = (0xBF800000, 0x80000000, 0x00000000, 0x00000001, 0x807FFFFF, 0x800F0000, 0xFF800000)
DIGIT_EDGES = (0x7F7FFFFF, 0x7FFFFFFF, 0x7F800000, 0x3F800000, 0x3F7FFFFF, 0x3F800001, 0x3F7FFF00, 0x00800000,
               0x00FFFFFF)


def radix_route_rows(seed: int, t: int):
    """Rows aimed at K1's radix route at width ``t``: all-equal rows, rows
    whose rank lands on negative NaN payloads or on keys that read as 0,
    rows of ±0.0 and subnormals, digit-edge rows, counts of 1, and counts
    past the width (the rank from the count may pass the row's keys)."""
    rng = np.random.default_rng(seed)

    def mixed(pool, frac):
        row = rng.gamma(2.0, 0.05, size=t).astype(np.float32)
        salted = rng.random(t) < frac
        row[salted] = np.array(pool, dtype=np.uint32).view(np.float32)[rng.integers(0, len(pool), int(salted.sum()))]
        return row

    rows = [(np.full(t, 0.25, dtype=np.float32), t), (np.full(t, -0.0, dtype=np.float32), t)]
    for frac in (0.5, 0.9, 0.99, 1.0):
        rows += [(mixed(NEGATIVE_KEYS, frac), t), (mixed(ZERO_KEYS, frac), t)]
    rows += [(mixed(NEGATIVE_KEYS + ZERO_KEYS, 1.0), t), (mixed(DIGIT_EDGES, 1.0), t), (mixed(DIGIT_EDGES, 0.5), t)]
    rows += [(mixed(DIGIT_EDGES + NEGATIVE_KEYS, 0.3), 1), (mixed(NEGATIVE_KEYS, 1.0), 1), (mixed(ZERO_KEYS, 0.5), 0)]
    for count in (t + 1, t + 7, 2 * t, 100 * t):
        rows.append((mixed(DIGIT_EDGES + NEGATIVE_KEYS, 0.2), count))
    values = np.stack([row for row, _ in rows])
    counts = np.array([count for _, count in rows], dtype=np.int32)
    return values, counts


def radix_route(values: np.ndarray, counts: np.ndarray, q: float) -> np.ndarray:
    """numpy model of `csrc/select.cu` ``bisect_select_kernel`` at 31 steps:
    canonical NaN for an empty row; INT32_MAX (the NaN 0x7fffffff) when the
    rank, taken from the count, is at or past the row's keys (a count past
    the width), which is where 31 bisection steps climb; else
    :func:`radix_tau` over the row's ordered bits."""
    t = values.shape[1]
    bits = port_selection.as_ordered_bits(torch.from_numpy(values)).numpy()
    rank = port_selection.selection_rank(torch.from_numpy(counts), q).numpy()
    out = np.full(len(counts), 0x7FC00000, dtype=np.int32)
    for r, count in enumerate(counts):
        if count > 0:
            valid = min(int(count), t)
            out[r] = port_selection.INT32_MAX if rank[r] >= valid else radix_tau(bits[r, :valid], int(rank[r]))
    return out.view(np.float32)


class TestRadixRouteModel:
    """K1's 31-step route, modelled in numpy, gives what the bisection pins."""

    @pytest.mark.parametrize("t", [1, 3, 300])
    @pytest.mark.parametrize("q", QS)
    def test_matches_plain_and_jnp_bisection(self, t, q):
        """Bit for bit against the plain version and the JAX package's jnp
        bisection, on every row. The JAX Pallas path pads T to 128 with
        zeros that a row with a count past the width counts as samples, so
        it is held to the rows whose count is within the width only."""
        values, counts = radix_route_rows(700 + t, t)
        model = radix_route(values, counts, q)
        plain = port_selection.masked_percentile_bisect(*port_tensors(values, counts), q).numpy()
        np.testing.assert_array_equal(model.view(np.int32), plain.view(np.int32))
        assert_same(model, jax_selection.masked_percentile_bisect(values, counts, q))
        inside = counts <= t
        assert_same(
            model[inside],
            jax_pallas.masked_percentile_bisect_pallas(values[inside], counts[inside], q, interpret=True),
        )

    @pytest.mark.parametrize("q", [95.0, 99.0, 100.0, 120.0])
    def test_counts_past_the_width_give_int32_max(self, q):
        """A rank past the row's keys: the answer is the NaN 0x7fffffff."""
        values, counts = radix_route_rows(710, 50)
        past = counts >= 2 * 50
        model = radix_route(values, counts, q).view(np.int32)
        assert np.all(model[past] == port_selection.INT32_MAX)
        plain = port_selection.masked_percentile_bisect(*port_tensors(values, counts), q).numpy().view(np.int32)
        np.testing.assert_array_equal(plain[past], model[past])

    @pytest.mark.parametrize("seed", [0, 1])
    def test_fuzzed_rows(self, seed):
        values, counts = fuzz(720 + seed, 40, 257, special_frac=0.3, ties=bool(seed))
        counts[-5:] = [300, 514, 1000, 258, 257]  # past the width
        for q in QS:
            model = radix_route(values, counts, q)
            plain = port_selection.masked_percentile_bisect(*port_tensors(values, counts), q).numpy()
            np.testing.assert_array_equal(model.view(np.int32), plain.view(np.int32))


class TestFleetExactParity:
    @pytest.mark.parametrize(
        "n, tc, tm", [(21, 700, 130), (13, 1, 450), (7, 0, 64), (7, 64, 0), (0, 32, 32)]
    )
    @pytest.mark.parametrize("q", [50.0, 99.0, 100.0])
    def test_plain_matches_pallas_interpret(self, n, tc, tm, q):
        """Different CPU and memory time extents, N = 0 and T = 0 included."""
        cpu, cpu_counts = fuzz(31, n, tc)
        mem, mem_counts = fuzz(32, n, tm)
        port = cuda_select.fleet_exact(*port_tensors(cpu, cpu_counts, mem, mem_counts), q).numpy()
        ref = np.asarray(jax_pallas.fleet_exact(cpu, cpu_counts, mem, mem_counts, q, interpret=True))
        assert port.shape == ref.shape == (2, n)
        assert_same(port, ref)


class TestWrappers:
    def test_cpu_tensors_run_the_plain_versions(self):
        values, counts = fuzz(41, 11, 200)
        v, c = port_tensors(values, counts)
        cuda_select.reset_launches()
        np.testing.assert_array_equal(
            cuda_select.masked_percentile_bisect_cuda(v, c, 99.0).numpy(),
            port_selection.masked_percentile_bisect(v, c, 99.0).numpy(),
        )
        np.testing.assert_array_equal(
            cuda_select.masked_max_cuda(v, c).numpy(), port_quantile.masked_max(v, c).numpy()
        )
        np.testing.assert_array_equal(
            cuda_select.fleet_exact(v, c, v, c, 99.0).numpy(),
            cuda_select.fleet_exact_plain(v, c, v, c, 99.0).numpy(),
        )
        assert cuda_select.LAUNCHES == {"bisect_select": 0, "row_max": 0, "radix_digit_hist": 0}

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
        values, counts = fuzz(42, 6, 40)
        v, c = bad(*port_tensors(values, counts))
        with pytest.raises((TypeError, ValueError)):
            cuda_select.masked_percentile_bisect_cuda(v, c, 99.0)
        with pytest.raises((TypeError, ValueError)):
            cuda_select.masked_max_cuda(v, c)

    def test_rejects_iteration_counts_past_the_bit_width(self):
        v, c = port_tensors(*fuzz(43, 4, 16))
        with pytest.raises(ValueError):
            cuda_select.masked_percentile_bisect_cuda(v, c, 99.0, num_iters=32)

    def test_empty_fleet_shape(self):
        v, c = port_tensors(np.zeros((0, 8), np.float32), np.zeros(0, np.int32))
        assert tuple(cuda_select.fleet_exact(v, c, v, c, 99.0).shape) == (2, 0)


class TestBuild:
    def test_sources_and_keyed_library_path(self):
        assert "select" in cuda_build.sources()
        path = cuda_build.library_path("select")
        assert path.parent == cuda_build.BUILD_DIR
        assert path.name.startswith("libselect-") and path.suffix == ".so"
        assert path == cuda_build.library_path("select")
        assert any("sm_90a" in flag for flag in cuda_build.NVCC_FLAGS)

    def test_missing_nvcc_raises(self, monkeypatch, tmp_path):
        monkeypatch.setenv("CUDA_HOME", str(tmp_path))
        monkeypatch.delenv("CUDA_PATH", raising=False)
        monkeypatch.setattr(cuda_build.shutil, "which", lambda name: None)
        monkeypatch.setattr(cuda_build.os.path, "isfile", lambda path: False)
        with pytest.raises(RuntimeError, match="nvcc"):
            cuda_build.nvcc_path()
