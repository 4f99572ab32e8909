"""The general generator: sizes from the mix, values from the seed."""

import json
import shutil

import numpy as np
import pytest

from benchmark import generate, spec
from benchmark.scan import Fleet

CELLS = ["simple-14d-15m.uniform", "tdigest-28d-1m.uniform", "simple-14d-15m.ragged"]
BIG_SEED = 2**31 + 12345


def padded(rows: np.ndarray) -> int:
    return int(-(-int(rows.max()) // 128) * 128)


@pytest.mark.parametrize("name", CELLS)
def test_every_seed_gets_the_same_sizes_in_another_order(name):
    cell = spec.load_cell(name)
    a = generate.shape(cell.config, cell.mix_name, cell.mix, 0)
    b = generate.shape(cell.config, cell.mix_name, cell.mix, BIG_SEED)
    assert sorted(a.row_samples.tolist()) == sorted(b.row_samples.tolist())
    assert a.pod_samples.sum() == b.pod_samples.sum() and len(a.pod_samples) == len(b.pod_samples)
    again = generate.shape(cell.config, cell.mix_name, cell.mix, BIG_SEED)
    assert np.array_equal(again.pod_samples, b.pod_samples) and np.array_equal(again.replicas, b.replicas)


@pytest.mark.parametrize("name, rows, width, waste", [
    ("simple-14d-15m.uniform", 100_000, 4_096, 1.5625),
    ("tdigest-28d-1m.uniform", 10_000, 120_960, 0.0),
])
def test_uniform_cells_hold_full_pods(name, rows, width, waste):
    cell = spec.load_cell(name)
    shape = generate.shape(cell.config, cell.mix_name, cell.mix, 7)
    assert shape.containers == rows
    assert set(shape.replicas.tolist()) == {3} and set(shape.pod_samples.tolist()) == {shape.window}
    real = shape.row_samples
    assert padded(real) == width
    assert 100 * (1 - real.sum() / (width * rows)) == pytest.approx(waste)


def test_ragged_cell_is_two_thirds_padding():
    cell = spec.load_cell("simple-14d-15m.ragged")
    shape = generate.shape(cell.config, cell.mix_name, cell.mix, 0)
    real = shape.row_samples
    assert shape.window == 1_344 and padded(real) == 8_064
    assert 100 * (1 - real.sum() / (8_064 * len(real))) == pytest.approx(67.34365277777779)
    assert real.mean() == pytest.approx(2_633.40784)
    counts = np.bincount(shape.replicas, minlength=7)[1:]
    assert counts.sum() == 100_000
    expected = 100_000 * (1 / np.arange(1, 7)) / (1 / np.arange(1, 7)).sum()
    assert np.all(np.abs(counts - expected) < 0.05 * expected)
    assert np.mean(shape.pod_samples == 1_344) == pytest.approx(0.6 + 0.4 / 1_344, abs=0.01)


def test_samples_repeat_for_a_seed_and_differ_across_seeds():
    cell = spec.load_cell("simple-14d-15m.ragged")
    shape = generate.shape(cell.config, cell.mix_name, cell.mix, BIG_SEED, containers=12)
    a = generate.samples(cell.config, shape, BIG_SEED, "cpu", 2)
    b = generate.samples(cell.config, shape, BIG_SEED, "cpu", 2)
    c = generate.samples(cell.config, shape, BIG_SEED + 1, "cpu", 2)
    assert all(np.array_equal(x.cpu, y.cpu) and np.array_equal(x.memory, y.memory) for x, y in zip(a, b))
    assert not np.array_equal(a[0].cpu, c[0].cpu) and not np.array_equal(a[0].cpu, a[1].cpu)
    turn = shape.window  # the second set: the draw turned by one pod window, sharing its memory
    assert np.shares_memory(a[0].cpu, a[1].cpu) and np.array_equal(a[1].memory[:-turn], a[0].memory[turn:])
    assert np.array_equal(a[1].cpu[-turn:], a[0].cpu[:turn])
    assert a[0].cpu.dtype == np.float64 and len(a[0].cpu) == shape.pod_samples.sum()
    assert 0.05 * 0.001 * 0.999 <= a[0].cpu.min() and a[0].cpu.max() <= 8 * 1.001 * 1.001
    assert 3.2e7 * 0.999 <= a[0].memory.min() and a[0].memory.max() <= 1.6e10 * 1.001
    per_container = np.maximum.reduceat(a[0].memory, np.concatenate([[0], np.cumsum(shape.row_samples)[:-1]]))
    assert per_container.max() > 4 * per_container.min()


def test_fleet_serves_the_stats_route_one_max_a_pod():
    cell = spec.load_cell("simple-14d-15m.ragged")
    fleet = Fleet(cell, 3, "cpu", containers=10)
    from krr_tpu_torch.models import ResourceType

    source = fleet.sources[1]
    import asyncio

    window = source.window
    served = asyncio.run(source.gather_fleet(fleet.objects[::-1], *window, stats_resources=frozenset({ResourceType.Memory})))
    first_pod = fleet.objects[-1].pods[0]
    raw = served[ResourceType.CPU][0][first_pod]
    assert raw.dtype == np.float64 and len(raw) == fleet.shape.pod_samples[int(fleet.shape.replicas[:-1].sum())]
    memory = served[ResourceType.Memory][0][first_pod]
    start = int(fleet.shape.pod_samples[: int(fleet.shape.replicas[:-1].sum())].sum())
    assert memory.tolist() == [fleet.samples[1].memory[start : start + len(raw)].max()]
    with pytest.raises(ValueError):
        asyncio.run(source.gather_fleet(fleet.objects, window[0] / 2, window[1]))


def test_a_mix_with_code_of_its_own_is_found_by_name(tmp_path):
    (tmp_path / "benchmark").mkdir()
    shutil.copytree(spec.ROOT / "benchmark" / "mixes", tmp_path / "benchmark" / "mixes")
    (tmp_path / "benchmark" / "mixes" / "pairs.json").write_text(json.dumps({"shape_seed": 1, "pods": 2}))
    (tmp_path / "benchmark" / "mixes" / "pairs.py").write_text(
        "import numpy as np\n"
        "def pod_samples(mix, containers, window, rng):\n"
        "    replicas = np.full(containers, mix['pods'])\n"
        "    return replicas, np.full(int(replicas.sum()), window // 2)\n"
    )
    config = spec.load_cell("simple-14d-15m.uniform").config
    mix = json.loads((tmp_path / "benchmark" / "mixes" / "pairs.json").read_text())
    shape = generate.shape(config, "pairs", mix, 5, root=tmp_path, containers=8)
    assert shape.replicas.tolist() == [2] * 8 and set(shape.pod_samples.tolist()) == {672}
