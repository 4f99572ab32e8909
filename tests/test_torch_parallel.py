"""The port's device mesh (`krr_tpu_torch.parallel`) against the JAX package's.

The JAX package runs its mesh on the 8 virtual CPU devices of
``tests/conftest.py`` (``make_mesh(data, time, devices=jax.devices()[:k])``);
the port runs the same mesh shapes over ``[cpu] * k`` — a device may stand in
a port mesh more than once — with its plain PyTorch versions. The same seeded
numpy inputs (ragged rows, N and T off the mesh so both axes pad, counts of
0 and past the width, the edge values of ``TestOrderedBits``) go through
both. Tolerances, each with its reason:

* Percentile (bisection), row max: bit-exact, NaN positions equal (ROADMAP
  Queue 3 items 1–4: the port's NaN is canonical where XLA keeps a payload).
* Top-K: the sorted multiset of ordered bits and the totals, bit-exact
  (the JAX package's CPU top-K keeps negatives, −0.0 and subnormals raw; the
  port places them as +0.0, Queue 3 item 1). The JAX comparison uses finite
  edge values, as ``tests/test_torch_sketch.py`` does; the port's sharded
  sketch equals its resident one on every edge value.
* Digest: bit-exact against the port's resident digest on the padded
  matrix; against the JAX package's, totals exact and each sample that
  moved one bucket, on a bucket edge, the ``log`` ulp of the digest's own
  contract (`krr_tpu/ops/pallas_sketch.py:46-51`).
* ``Runner`` renders and state files: byte for byte.
"""

from __future__ import annotations

import os
import zipfile

import jax
import numpy as np
import pytest
import torch

import krr_tpu.parallel as jax_parallel
import krr_tpu.strategies.simple as jax_simple
import krr_tpu_torch.parallel as port_parallel
import krr_tpu_torch.parallel.fleet as port_fleet
import krr_tpu_torch.strategies.simple as port_simple
import krr_tpu_torch.strategies.tdigest as port_tdigest
from krr_tpu.ops import digest as jax_digest
from krr_tpu.ops import topk_sketch as jax_topk
from krr_tpu_torch.ops import digest as port_digest
from krr_tpu_torch.ops import quantile as port_quantile
from krr_tpu_torch.ops import selection as port_selection
from krr_tpu_torch.ops import topk_sketch as port_topk

from .test_torch_select import SPECIAL, assert_same, port_tensors
from .test_torch_simple import long_histories
from .test_torch_simple import run_jax as run_jax_simple
from .test_torch_simple import run_port as run_port_simple
from .test_torch_simple import scan_stages
from .test_torch_sketch import FINITE_SPECIAL, assert_digests_bit_equal, quotient
from .test_torch_store import PINNED_CLOCK, assert_same_files
from .test_torch_tdigest import fleet  # noqa: F401  (module-scoped fixture)
from .test_torch_tdigest import run_jax, run_port

#: (data, time) mesh shapes of the JAX tests' virtual devices.
MESHES = [(8, 1), (4, 2), (2, 4), (1, 2)]
QS = [0.0, 50.0, 99.0, 100.0]
#: Rows and columns off every mesh axis, so both axes pad.
N, T = 29, 37


def ragged(seed: int, n: int, t: int, special=SPECIAL, special_frac: float = 0.15):
    """Gamma-like rows salted with edge values; counts from 0 to past the
    width (a row with none, one full and one past it included)."""
    rng = np.random.default_rng(seed)
    values = rng.gamma(2.0, 0.05, size=(n, t)).astype(np.float32)
    salted = rng.random((n, t)) < special_frac
    values[salted] = rng.choice(special, int(salted.sum()))
    counts = rng.integers(0, t + t // 4 + 2, size=n).astype(np.int32)
    counts[:3] = [0, t, t + 3][:n]
    return values, counts


def meshes(shape):
    data, time = shape
    k = data * time
    return (
        jax_parallel.make_mesh(data=data, time=time, devices=jax.devices()[:k]),
        port_parallel.make_mesh(data=data, time=time, devices=["cpu"] * k),
    )


def ordered_sorted(rows) -> np.ndarray:
    """Each row's slots as ordered bits (negatives, −0.0 and subnormals as
    +0.0), sorted: the top-K multiset, whatever the slot order."""
    bits = port_selection.as_ordered_bits(torch.from_numpy(np.array(rows, dtype=np.float32)))
    return np.sort(bits.numpy(), axis=1)


def padded(values, counts, mesh):
    """The matrix the mesh holds: rows and time padded as ``pad_for_mesh`` pads."""
    v, c, _ = port_fleet.pad_for_mesh(values, counts, mesh)
    return port_tensors(v.astype(np.float32), c.astype(np.int32))


def holds_nan(values: torch.Tensor, counts: torch.Tensor) -> np.ndarray:
    """Per real row, whether its valid prefix (padding included) holds a NaN."""
    valid = port_selection.valid_mask(counts, values.shape[1])
    return (valid & torch.isnan(values)).any(dim=1).numpy()[:N]


def assert_moves_at_edges(spec, a: np.ndarray, b: np.ndarray, values: np.ndarray, counts: np.ndarray) -> int:
    """Two digests' counts of the same samples differ only by samples one
    bucket over, each on a bucket edge: per row, the running count differs
    at boundary j (between buckets j and j + 1, the quotient j) by at most
    the valid samples within 4 float32 ulps of that quotient, and the moves
    sum to half the absolute count difference. Returns the samples moved;
    on failure the message names the rows, boundaries and samples."""
    diff = a.astype(np.int64) - b.astype(np.int64)
    cum = np.cumsum(diff, axis=1)
    moved = int(np.abs(diff).sum() // 2)
    report = []
    if int(np.abs(cum).sum()) != moved:
        report.append(f"a move wider than one bucket: sum |cumsum| {int(np.abs(cum).sum())} != moved {moved}")
    for row, j in np.argwhere(cum != 0):
        samples = values[row, : min(int(counts[row]), values.shape[1])]
        q = quotient(spec, samples)
        with np.errstate(invalid="ignore"):
            at_edge = np.abs(q - j) <= 4 * np.spacing(np.float32(j)).astype(np.float64)
        if at_edge.sum() < abs(int(cum[row, j])):
            report.append(f"row {row}: {int(cum[row, j])} samples moved across boundary {j}, "
                          f"{int(at_edge.sum())} on it; samples near it {samples[np.abs(q - j) < 1e-3].tolist()}")
    assert not report, "\n".join(report)
    return moved


def port_digests_host(digests, real_rows) -> port_digest.Digest:
    return port_digest.Digest(*(
        torch.from_numpy(port_parallel.gather_rows(digests, lambda d, i=i: d[i], real_rows)) for i in range(3)
    ))


# ------------------------------------------------------------------- mesh
class TestMesh:
    def test_every_public_name_has_a_counterpart(self):
        assert set(jax_parallel.__all__) <= set(port_parallel.__all__)
        for name in port_parallel.__all__:
            assert hasattr(port_parallel, name), name
        assert (port_parallel.DATA_AXIS, port_parallel.TIME_AXIS) == (jax_parallel.DATA_AXIS, jax_parallel.TIME_AXIS)

    @pytest.mark.parametrize("data, time, k", [(None, 3, 8), (3, 2, 8), (None, 1, 8), (2, 4, 8), (None, 2, 1)])
    def test_make_mesh_shapes_and_errors_match_jax(self, data, time, k):
        try:
            ref = jax_parallel.make_mesh(data=data, time=time, devices=jax.devices()[:k])
        except ValueError as error:
            with pytest.raises(ValueError) as port_error:
                port_parallel.make_mesh(data=data, time=time, devices=["cpu"] * k)
            assert str(port_error.value) == str(error)
            return
        mesh = port_parallel.make_mesh(data=data, time=time, devices=["cpu"] * k)
        assert dict(mesh.shape) == dict(ref.shape) and mesh.size == ref.devices.size
        assert mesh.flat() == [torch.device("cpu")] * k

    def test_resolve_mesh_matches_jax(self, monkeypatch):
        eight = [torch.device("cpu")] * 8
        monkeypatch.setattr(port_simple, "mesh_devices", lambda device: eight)
        for args in ({}, {"mesh_time_axis": 2}, {"mesh_time_axis": 8}, {"use_mesh": False}):
            ref = jax_simple.resolve_mesh(jax_simple.SimpleStrategySettings(**args))
            mesh = port_simple.resolve_mesh(port_simple.SimpleStrategySettings(device="cpu", **args), "cpu")
            assert (mesh is None) == (ref is None)
            if ref is not None:
                assert dict(mesh.shape) == dict(ref.shape)
        with pytest.raises(ValueError) as ref_error:
            jax_simple.resolve_mesh(jax_simple.SimpleStrategySettings(mesh_time_axis=3))
        with pytest.raises(ValueError) as port_error:
            port_simple.resolve_mesh(port_simple.SimpleStrategySettings(device="cpu", mesh_time_axis=3), "cpu")
        assert str(port_error.value) == str(ref_error.value)

    def test_one_device_takes_the_single_device_path(self):
        """The CPU, or one card, is no mesh: whatever ``mesh_time_axis`` says."""
        settings = port_simple.SimpleStrategySettings(device="cpu", mesh_time_axis=3)
        assert port_simple.resolve_mesh(settings, "cpu") is None
        assert port_parallel.mesh_devices("cpu") == [torch.device("cpu")]
        assert port_parallel.mesh_devices("cuda:1") == [torch.device("cuda", 1)]
        assert len(port_parallel.mesh_devices("cuda")) == torch.cuda.device_count()

    def test_initialize_distributed_cuda_without_a_card_raises(self):
        """A ``cuda`` process group on a host without a card raises before
        any rendezvous, and starts nothing (the group is process-wide: the
        two-rank runs are `tests/test_torch_distributed.py`'s children)."""
        if torch.cuda.is_available():
            pytest.skip("this host has a card: the request would rendezvous")
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            port_parallel.initialize_distributed("127.0.0.1:1", num_processes=2, process_id=0)
        assert not torch.distributed.is_initialized() and port_parallel.mesh.world() is None

    def test_placement_needs_divisible_extents(self):
        mesh = port_parallel.make_mesh(2, 2, devices=["cpu"] * 4)
        blocks = port_parallel.fleet_sharding(mesh).place(np.arange(24, dtype=np.float32).reshape(4, 6))
        assert [[tuple(b.shape) for b in row] for row in blocks] == [[(2, 3), (2, 3)]] * 2
        np.testing.assert_array_equal(blocks[1][1].numpy(), [[15, 16, 17], [21, 22, 23]])
        rows = port_parallel.rows_sharding(mesh).place(np.arange(4, dtype=np.int32))
        assert [[b.tolist() for b in row] for row in rows] == [[[0, 1], [0, 1]], [[2, 3], [2, 3]]]
        with pytest.raises(ValueError, match="does not divide"):
            port_parallel.fleet_sharding(mesh).place(np.zeros((4, 5), dtype=np.float32))

    @pytest.mark.parametrize("shape", MESHES)
    def test_pad_for_mesh_is_the_jax_padding(self, shape):
        values, counts = ragged(1, N, T)
        jax_mesh, port_mesh = meshes(shape)
        for ref, got in zip(jax_parallel.fleet.pad_for_mesh(values, counts, jax_mesh),
                            port_fleet.pad_for_mesh(values, counts, port_mesh)):
            np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


# ------------------------------------------------------ the sharded functions
class TestShardedFunctions:
    @pytest.mark.parametrize("shape", MESHES)
    @pytest.mark.parametrize("q", QS)
    def test_bisect_matches_jax(self, shape, q):
        values, counts = ragged(2, N, T)
        jax_mesh, port_mesh = meshes(shape)
        ref = jax_parallel.sharded_percentile_bisect(values, counts, q, jax_mesh)
        got = port_parallel.sharded_percentile_bisect(values, counts, q, port_mesh)
        assert got.shape == (N,)
        assert_same(got, ref)

    @pytest.mark.parametrize("shape", MESHES)
    def test_max_matches_jax(self, shape):
        """Bit-exact on every row but those holding a NaN sample, where the
        JAX package's ``pmax`` drops the NaN (ROADMAP Queue 3 item 9) and the
        port keeps it, as both packages' resident max does."""
        values, counts = ragged(3, N, T)
        jax_mesh, port_mesh = meshes(shape)
        got = port_parallel.sharded_masked_max(values, counts, port_mesh)
        assert got.shape == (N,)
        v, c = padded(values, counts, port_mesh)
        assert_same(got, port_quantile.masked_max(v, c).numpy()[:N])
        nan_rows = holds_nan(v, c)
        assert nan_rows.any() and (~nan_rows).any()
        ref = jax_parallel.sharded_masked_max(values, counts, jax_mesh)
        assert_same(got[~nan_rows], ref[~nan_rows])
        assert np.isnan(got[nan_rows]).all()

    @pytest.mark.parametrize("shape, jax_answer", [((2, 1), -np.inf), ((1, 2), 1.0)])
    def test_nan_sample_divergence(self, shape, jax_answer):
        """The smallest input: one row ``[NaN, 1.0]``, count 2. On a mesh of
        two or more devices XLA's CPU ``pmax`` drops the NaN — −inf on
        (2, 1), 1.0 on (1, 2) — where the JAX package's resident max gives
        NaN. The port gives NaN on every mesh (ROADMAP Queue 3 item 9)."""
        values, counts = np.array([[np.nan, 1.0]], dtype=np.float32), np.array([2], dtype=np.int32)
        jax_mesh, port_mesh = meshes(shape)
        np.testing.assert_array_equal(jax_parallel.sharded_masked_max(values, counts, jax_mesh), [jax_answer])
        assert np.isnan(port_parallel.sharded_masked_max(values, counts, port_mesh)).all()

    @pytest.mark.parametrize("shape", MESHES)
    def test_topk_matches_jax_and_the_resident_sketch(self, shape):
        t, k = 301, 128
        jax_mesh, port_mesh = meshes(shape)
        values, counts = ragged(4, N, t, special=FINITE_SPECIAL)
        ref, ref_rows = jax_parallel.sharded_fleet_topk(values, counts, k, jax_mesh, chunk_size=64)
        sketches, real_rows = port_parallel.sharded_fleet_topk(values, counts, k, port_mesh)
        assert real_rows == ref_rows == N
        got_values = port_parallel.gather_rows(sketches, lambda s: s.values, real_rows)
        got_total = port_parallel.gather_rows(sketches, lambda s: s.total, real_rows)
        np.testing.assert_array_equal(ordered_sorted(got_values), ordered_sorted(np.asarray(ref.values)[:N]))
        np.testing.assert_array_equal(got_total, np.asarray(ref.total)[:N])
        for q in (99.0, 99.9):
            assert_same(
                port_parallel.gather_rows(sketches, lambda s: port_topk.percentile(s, q), real_rows),
                np.asarray(jax_topk.percentile(ref, q))[:N],
            )
        # Every edge value, against the port's own resident sketch.
        values, counts = ragged(5, N, t)
        sketches, real_rows = port_parallel.sharded_fleet_topk(values, counts, k, port_mesh)
        resident = port_topk.build_from_packed(*padded(values, counts, port_mesh), k)
        got = port_parallel.gather_rows(sketches, lambda s: s.values, real_rows)
        np.testing.assert_array_equal(
            np.sort(got.view(np.int32), axis=1), np.sort(resident.values.numpy()[:N].view(np.int32), axis=1)
        )
        np.testing.assert_array_equal(
            port_parallel.gather_rows(sketches, lambda s: s.total, real_rows), resident.total.numpy()[:N]
        )

    @pytest.mark.parametrize("shape", MESHES)
    def test_digest_equals_the_resident_digest_and_jax_but_at_edges(self, shape):
        t = 301
        jax_mesh, port_mesh = meshes(shape)
        spec = port_digest.DigestSpec()
        values, counts = ragged(6, N, t)
        digests, real_rows = port_parallel.sharded_fleet_digest(spec, values, counts, port_mesh)
        got = port_digests_host(digests, real_rows)
        v, c = padded(values, counts, port_mesh)
        resident = port_digest.build_from_packed(spec, v, c)
        assert_digests_bit_equal(port_digest.Digest(*(f[:N] for f in resident)), got, values)

        ref, ref_rows = jax_parallel.sharded_fleet_digest(jax_digest.DigestSpec(), values, counts, jax_mesh,
                                                          chunk_size=64)
        assert ref_rows == N
        np.testing.assert_array_equal(got.total.numpy(), np.asarray(ref.total)[:N])
        nan_rows = holds_nan(v, c)  # the JAX pmax drops a NaN peak (Queue 3 item 9)
        assert_same(got.peak.numpy()[~nan_rows], np.asarray(ref.peak)[:N][~nan_rows])
        assert np.isnan(got.peak.numpy()[nan_rows]).all()
        moved = assert_moves_at_edges(spec, got.counts.numpy(), np.asarray(ref.counts)[:N], v.numpy()[:N], c.numpy()[:N])
        assert moved <= 0.001 * float(got.total.sum())
        for q in (50.0, 99.0):
            estimate = port_parallel.sharded_percentile(spec, digests, q, real_rows)
            assert_same(estimate, port_digest.percentile(spec, port_digest.Digest(*(f[:N] for f in resident)), q))

    @pytest.mark.parametrize("width", [1, 7, 128, 1000])
    @pytest.mark.parametrize("time", [2, 3])
    def test_digest_per_time_shard_at_many_widths(self, width, time):
        """A digest built per time shard at many widths equals the one-shot
        build bit for bit; on failure the message names the fields and rows
        that differ (ROADMAP Queue 3 item 7's suspect path)."""
        spec = port_digest.DigestSpec()
        values, counts = ragged(7 + width, 11, width * time)
        mesh = port_parallel.make_mesh(1, time, devices=["cpu"] * time)
        digests, real_rows = port_parallel.sharded_fleet_digest(spec, values, counts, mesh)
        v, c = port_tensors(values, counts)
        assert_digests_bit_equal(port_digest.build_from_packed(spec, v, c), port_digests_host(digests, real_rows), values)


# -------------------------------------------------- the time-sharded select
def select_rows(seed: int, n: int, t: int):
    """Rows aimed at the radix select: negative NaN keys, ties, a count of
    one, counts past the width, and edge values."""
    values, counts = ragged(seed, n, t, special_frac=0.3)
    values[3, :] = np.array(0xFFC00000, dtype=np.uint32).view(np.float32)  # negative NaN: ranks below 0
    values[4, : t // 2] = 0.25  # ties across the rank
    counts[5] = 1
    counts[6] = t + 40
    return values, counts


class TestTimeShardedSelect:
    @pytest.mark.parametrize("width", [1, 7, 8192])
    @pytest.mark.parametrize("shape", [(1, 2), (2, 2), (1, 3)])
    @pytest.mark.parametrize("q", QS)
    def test_radix_route_equals_the_31_step_bisection(self, width, shape, q):
        """The ``time > 1`` route (K5 per shard and digit, bins summed)
        gives the bits of the 31-step bisection over the padded matrix,
        NaN bits included: 0x7fffffff for a rank past the row's keys."""
        data, time = shape
        t = width * time - (1 if width > 1 else 0)
        values, counts = select_rows(9 + width, 8 if width < 8192 else 7, t)
        mesh = port_parallel.make_mesh(data, time, devices=["cpu"] * (data * time))
        got = port_parallel.sharded_percentile_bisect(values, counts, q, mesh)
        v, c = padded(values, counts, mesh)
        want = port_selection.masked_percentile_bisect(v, c, q).numpy()[: values.shape[0]]
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))

    @pytest.mark.parametrize("shape, k1, k5", [((2, 1), 2, 0), ((2, 2), 0, 3 * 4), ((1, 4), 0, 3 * 4)])
    def test_route_by_time_axis(self, monkeypatch, shape, k1, k5):
        """``time == 1``: one ``bisect_select`` call a row block; ``time >
        1``: one ``radix_digit_hist`` call per shard and digit."""
        calls = {"k1": 0, "k5": 0}

        def counted(name, fn):
            def wrapper(*args, **kwargs):
                calls[name] += 1
                return fn(*args, **kwargs)
            return wrapper

        monkeypatch.setattr(port_fleet, "masked_percentile_bisect_cuda",
                            counted("k1", port_fleet.masked_percentile_bisect_cuda))
        monkeypatch.setattr(port_fleet, "radix_digit_hist", counted("k5", port_fleet.radix_digit_hist))
        values, counts = ragged(10, N, T)
        mesh = port_parallel.make_mesh(*shape, devices=["cpu"] * (shape[0] * shape[1]))
        port_parallel.sharded_percentile_bisect(values, counts, 50.0, mesh)
        assert calls == {"k1": k1, "k5": k5}

    def test_dryrun_multichip_scaled_down(self):
        """`__graft_entry__.py:55` ``dryrun_multichip`` on a (4, 2) port
        mesh, scaled down: digest percentile, memory peak, top-K and
        bisection p99 (bit-equal to each other and to a numpy sort oracle),
        the digest within its error, and the host-streamed digest with the
        rows split over every mesh device equal to the sharded one."""
        mesh = port_parallel.make_mesh(data=4, time=2, devices=["cpu"] * 8)
        spec = port_digest.DigestSpec(gamma=1.08, min_value=1e-7, num_buckets=256)
        rng = np.random.default_rng(1)
        n, t = 32 * 8 + 3, 640 * 2 + 128
        cpu = rng.gamma(2.0, 0.05, size=(n, t))
        mem = rng.uniform(10.0, 4000.0, size=(n, t))
        counts = rng.integers(0, t + 1, size=n).astype(np.int32)
        digests, real_rows = port_parallel.sharded_fleet_digest(spec, cpu, counts, mesh)
        cpu_p99 = port_parallel.sharded_percentile(spec, digests, 99.0, real_rows)
        mem_peak = port_parallel.sharded_masked_max(mem, counts, mesh)
        valid = counts > 0
        assert cpu_p99.shape == mem_peak.shape == (n,)
        assert np.isfinite(cpu_p99[valid]).all() and np.isnan(cpu_p99[~valid]).all()
        k = port_topk.required_k(t, 99.0)
        sketches, real_rows = port_parallel.sharded_fleet_topk(cpu, counts, k, mesh)
        topk_p99 = port_parallel.gather_rows(sketches, lambda s: port_topk.percentile(s, 99.0), real_rows)
        bisect_p99 = port_parallel.sharded_percentile_bisect(cpu, counts, 99.0, mesh)
        assert np.isnan(bisect_p99[~valid]).all() and np.isnan(topk_p99[~valid]).all()
        np.testing.assert_array_equal(bisect_p99[valid], topk_p99[valid])
        cpu32, mem32 = cpu.astype(np.float32), mem.astype(np.float32)
        for i in rng.choice(np.flatnonzero(valid), size=64, replace=False):
            c = int(counts[i])
            want = np.sort(cpu32[i, :c])[int(np.floor((c - 1) * 99.0 / 100.0))]
            assert bisect_p99[i] == want and mem_peak[i] == np.max(mem32[i, :c])
            assert abs(float(cpu_p99[i]) - float(want)) / max(float(want), spec.min_value) <= spec.relative_error * 1.05
        streamed = port_digest.build_from_host(spec, cpu, counts, 512, device="cpu", devices=mesh.flat())
        assert_digests_bit_equal(port_digests_host(digests, real_rows), streamed, cpu32)


# ------------------------------------------------ the streamed row split
class TestStreamedRowSplit:
    @pytest.mark.parametrize("n, parts", [(29, 8), (5, 8), (8, 4), (0, 3)])
    def test_split_equals_one_device(self, n, parts):
        """Streamed builds with the rows split over ``parts`` devices (blocks
        of ceil(n / parts), some empty) equal the one-device builds bit for
        bit."""
        values, counts = ragged(11, max(n, 1), 300)
        values, counts = values[:n], counts[:n]
        devices = ["cpu"] * parts
        spec = port_digest.DigestSpec()
        one = port_digest.build_from_host(spec, values, counts, 64, device="cpu")
        split = port_digest.build_from_host(spec, values, counts, 64, device="cpu", devices=devices)
        assert_digests_bit_equal(one, split, values)
        one = port_topk.build_from_host(values, counts, 128, 64, device="cpu")
        split = port_topk.build_from_host(values, counts, 128, 64, device="cpu", devices=devices)
        np.testing.assert_array_equal(np.sort(one.values.numpy().view(np.int32), axis=1),
                                      np.sort(split.values.numpy().view(np.int32), axis=1))
        np.testing.assert_array_equal(one.total.numpy(), split.total.numpy())
        assert_same(port_quantile.masked_max_from_host(values, counts, 64, device="cpu", devices=devices),
                    port_quantile.masked_max_from_host(values, counts, 64, device="cpu"))
        got = port_selection.masked_percentile_bisect_from_host(values, counts, 50.0, 64, device="cpu", devices=devices)
        want = port_selection.masked_percentile_bisect_from_host(values, counts, 50.0, 64, device="cpu")
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


# --------------------------------------------------------- Runner renders
@pytest.fixture
def port_mesh_of_eight(monkeypatch):
    """The port's strategies see eight devices (the CPU eight times), as the
    JAX package sees its eight virtual CPU devices; the mesh entry points
    they call are counted."""
    monkeypatch.setattr(port_simple, "mesh_devices", lambda device: [torch.device("cpu")] * 8)
    calls: dict = {}
    for module in (port_simple, port_tdigest):
        for name in ("sharded_percentile_bisect", "sharded_masked_max", "sharded_fleet_digest", "sharded_fleet_topk"):
            if hasattr(module, name):
                def wrapper(*args, _fn=getattr(module, name), _name=name, **kwargs):
                    calls[_name] = calls.get(_name, 0) + 1
                    return _fn(*args, **kwargs)
                monkeypatch.setattr(module, name, wrapper)
    return calls


#: The mesh scans: (port strategy, settings, sharded calls expected).
MESH_SCANS = {
    "simple": ("simple", {}, {"sharded_percentile_bisect": 1, "sharded_masked_max": 1}),
    "simple_time2": ("simple", {"mesh_time_axis": 2, "cpu_percentile": 50},
                     {"sharded_percentile_bisect": 1, "sharded_masked_max": 1}),
    "tdigest": ("tdigest", {}, {"sharded_fleet_digest": 1, "sharded_masked_max": 1}),
    "exact_upgrade": ("tdigest", {"exact_upgrade": True, "mesh_time_axis": 4},
                      {"sharded_fleet_topk": 1, "sharded_masked_max": 1}),
}


class TestRunnerRenders:
    @pytest.mark.parametrize("path", sorted(MESH_SCANS))
    def test_mesh_scan_renders_jax_bytes(self, fleet, port_mesh_of_eight, path):  # noqa: F811
        strategy, args, expected = MESH_SCANS[path]
        if strategy == "simple":
            jax = run_jax_simple(fleet, args, format="json")
            port, runner = run_port_simple(fleet, args, format="json")
        else:
            jax = run_jax(fleet, args, format="json")
            port, runner = run_port(fleet, args, format="json")
        assert port.format("json") == jax.format("json")
        assert port.format("yaml") == jax.format("yaml")
        assert port_mesh_of_eight == expected
        assert "h2d" not in dict(scan_stages(runner)) and ("quantile", "mesh") in scan_stages(runner)

    def test_state_path_renders_and_files(self, fleet, port_mesh_of_eight, tmp_path, monkeypatch):  # noqa: F811
        """``tdigest --state_path`` on the mesh, two runs: each render is
        the JAX ``Runner``'s, and the state directory is byte for byte the
        JAX package's and the port's single-device one."""
        monkeypatch.setattr(zipfile, "time", PINNED_CLOCK)
        paths = {name: str(tmp_path / name) for name in ("jax", "mesh", "single")}
        for run in range(2):
            jax = run_jax(fleet, {"state_path": paths["jax"]}, format="json")
            port, _runner = run_port(fleet, {"state_path": paths["mesh"]}, format="json")
            single, _ = run_port(fleet, {"state_path": paths["single"], "use_mesh": False}, format="json")
            assert port.format("json") == jax.format("json") == single.format("json"), f"run {run}"
        assert port_mesh_of_eight == {"sharded_fleet_digest": 2, "sharded_masked_max": 2}
        assert sorted(os.listdir(paths["mesh"]))
        assert_same_files(paths["mesh"], paths["single"])
        assert_same_files(paths["mesh"], paths["jax"])

    @pytest.mark.parametrize("strategy, args", [("simple", {}), ("simple", {"cpu_percentile": 50}),
                                                ("tdigest", {}), ("tdigest", {"exact_upgrade": True})])
    def test_host_streamed_with_a_mesh_renders_jax_bytes(self, fleet, port_mesh_of_eight, strategy, args):  # noqa: F811
        """A window past ``host_stream_mb`` per device streams with its rows
        split over the eight devices, in both packages."""
        jax_objs, dumps, histories = fleet
        long = (jax_objs, dumps, long_histories(histories, length=30_000))
        args = {**args, "host_stream_mb": 1}
        if strategy == "simple":
            jax = run_jax_simple(long, args, format="json")
            port, runner = run_port_simple(long, args, format="json")
        else:
            jax = run_jax(long, args, format="json")
            port, runner = run_port(long, args, format="json")
        assert port.format("json") == jax.format("json")
        assert runner.session.strategy.stream_stats is not None
        assert port_mesh_of_eight == {}
