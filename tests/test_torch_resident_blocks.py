"""The resident window by row blocks on the CPU: the rows-per-block rule,
and scans whose window takes several uneven blocks through the one reused
buffer (``RESIDENT_BLOCK_BYTES`` cut to a few rows) rendering the bytes of
the one-block scan and of the JAX package's resident scan — ``simple``,
``tdigest``, ``tdigest`` with ``exact_upgrade`` and with ``state_path`` (its
store too) — with the H2D counters and the ``h2d`` spans adding up to the
one-block copy."""

from __future__ import annotations

import asyncio

import numpy as np
import pytest

import krr_tpu.core.config as jax_config
import krr_tpu.core.runner as jax_runner
import krr_tpu.models as jax_models
import krr_tpu_torch.core.config as port_config
import krr_tpu_torch.core.runner as port_runner
import krr_tpu_torch.models as port_models
import krr_tpu_torch.strategies.window as port_window
from krr_tpu_torch.core import streaming as port_streaming
from krr_tpu_torch.models.interop import fleet_batch_from_dicts, objects_from_dicts
from krr_tpu_torch.obs.trace import NULL_TRACER, Tracer
from krr_tpu_torch.ops import digest as port_digest
from krr_tpu_torch.strategies.window import rows_per_block

from .test_torch_simple import MemoryInventory, history_factory, jax_objects, make_fleet

MIB = 2**20


# ------------------------------------------------------------ the rule
@pytest.mark.parametrize("row_bytes, rows, wave, want", [
    (483_840, 10_000, 1_056, 1_056),  # one wave of 120,960-sample rows: 487 MiB
    (16_384, 100_000, 1_056, 32_736),  # 31 waves of 4,096-sample rows
    (32_256, 100_000, 1_056, 15_840),  # 15 waves of 8,064-sample rows
    (512, 100_000, 1_056, 100_000),  # 48.8 MiB: the window is one block
    (16_384, 32_768, 1_056, 32_768),  # exactly the budget: one block
    (16_384, 32_769, 1_056, 32_736),  # a row past it: whole waves
    (600 * MIB, 50, 1, 1),  # a row past the budget: one wave, at least
    (2 * MIB, 10_000, 1_056, 1_056),  # 2 GiB a wave: still one wave
    (2 * MIB, 700, 1_056, 700),  # a wave past the rows: never more than them
    (0, 10_000, 1_056, 10_000),  # empty rows: one block
    (4_096, 0, 1, 1),  # no rows: no block
])
def test_rows_per_block_takes_whole_waves_within_the_budget(row_bytes, rows, wave, want):
    assert port_window.RESIDENT_BLOCK_BYTES == 512 * MIB
    assert rows_per_block(row_bytes, rows, wave) == want


@pytest.mark.parametrize("row_bytes", [4, 16_384, 483_840, 3 * MIB])
@pytest.mark.parametrize("rows", [1, 1_056, 10_000, 250_000])
@pytest.mark.parametrize("wave", [1, 1_056])
def test_the_blocks_tile_the_rows_in_whole_waves_with_a_short_last(row_bytes, rows, wave):
    step = rows_per_block(row_bytes, rows, wave)
    blocks = [(r0, min(r0 + step, rows)) for r0 in range(0, rows, step)]
    assert blocks[0][0] == 0 and blocks[-1][1] == rows
    assert all(a[1] == b[0] for a, b in zip(blocks, blocks[1:]))
    assert all(r1 - r0 == step for r0, r1 in blocks[:-1]) and 0 < blocks[-1][1] - blocks[-1][0] <= step
    if rows * row_bytes <= port_window.RESIDENT_BLOCK_BYTES:
        assert blocks == [(0, rows)]
    else:
        assert step == rows or step % wave == 0
        assert step == min(rows, wave) or step * row_bytes <= port_window.RESIDENT_BLOCK_BYTES
        # The largest such number of waves: one more passes the budget.
        assert step == rows or (step + wave) * row_bytes > port_window.RESIDENT_BLOCK_BYTES


def test_the_wave_is_one_row_on_the_cpu():
    import torch

    assert port_window.device_wave(torch.device("cpu")) == 1


# ------------------------------------------------------------ the scans
#: The paths: (strategy, settings).
PATHS = {
    "simple": ("simple", {}),
    "tdigest": ("tdigest", {}),
    "exact_upgrade": ("tdigest", {"exact_upgrade": True}),
    "state_path": ("tdigest", {}),
}
#: Rows a CPU block takes in the blocked scans: the fleet's 30 rows go in
#: four blocks of 7 and a last of 2.
BLOCK_ROWS = 7


@pytest.fixture(scope="module")
def fleet():
    dicts, histories = make_fleet(seed=11)
    jax_objs = jax_objects(dicts)
    return jax_objs, [o.model_dump(mode="json") for o in jax_objs], histories


def _args(path: str, tmp_path, name: str) -> dict:
    args = PATHS[path][1]
    return {**args, "state_path": str(tmp_path / name)} if path == "state_path" else dict(args)


def run_port(fleet, path: str, args: dict, tracer=NULL_TRACER):
    _jax_objs, dumps, histories = fleet
    objects = objects_from_dicts(dumps)
    runner = port_runner.Runner(
        port_config.Config(quiet=True, format="json", device="cpu", strategy=PATHS[path][0], other_args=args),
        inventory=MemoryInventory(objects),
        history_factory=history_factory(port_models.ResourceType, objects, histories),
        tracer=tracer,
    )
    return asyncio.run(runner.run()), runner


def run_jax(fleet, path: str, args: dict):
    jax_objs, _dumps, histories = fleet
    runner = jax_runner.Runner(
        jax_config.Config(quiet=True, format="json", jax_compilation_cache_dir="", strategy=PATHS[path][0],
                          other_args={**args, "use_mesh": False}),
        inventory=MemoryInventory(jax_objs),
        history_factory=history_factory(jax_models.ResourceType, jax_objs, histories),
    )
    return asyncio.run(runner.run())


def _spy_blocks(monkeypatch) -> dict:
    """Every resident block as the strategies are handed it, by resource:
    (first row, end row, width)."""
    seen: dict = {}
    original = port_window.ResidentWindow.blocks

    def blocks(self, resource):
        for r0, r1, values, counts in original(self, resource):
            assert values.shape[0] == counts.shape[0] == r1 - r0
            seen.setdefault(resource.value, []).append((r0, r1, values.shape[1]))
            yield r0, r1, values, counts

    monkeypatch.setattr(port_window.ResidentWindow, "blocks", blocks)
    return seen


def _store(path: str) -> dict:
    store = port_streaming.DigestStore.open_or_create(path, port_digest.DigestSpec())
    fields = ("cpu_counts", "cpu_total", "cpu_peak", "mem_total", "mem_peak")
    return {"keys": list(store.keys), **{f: np.asarray(getattr(store, f)).tobytes() for f in fields}}


@pytest.fixture(scope="module")
def block_budget(fleet) -> int:
    """A ``RESIDENT_BLOCK_BYTES`` that cuts the fleet's CPU window into
    blocks of :data:`BLOCK_ROWS` rows."""
    _jax_objs, dumps, histories = fleet
    batch = fleet_batch_from_dicts(dumps, histories)
    return BLOCK_ROWS * 4 * port_window.device_packed(batch, port_models.ResourceType.CPU).capacity


@pytest.mark.parametrize("path", sorted(PATHS))
def test_a_window_of_uneven_blocks_renders_the_one_block_and_jax_bytes(fleet, tmp_path, monkeypatch, path,
                                                                       block_budget):
    whole, whole_runner = run_port(fleet, path, _args(path, tmp_path, "whole"))
    seen = _spy_blocks(monkeypatch)
    monkeypatch.setattr(port_window, "RESIDENT_BLOCK_BYTES", block_budget)
    tracer = Tracer()
    blocked, runner = run_port(fleet, path, _args(path, tmp_path, "blocked"), tracer)
    jax = run_jax(fleet, path, _args(path, tmp_path, "jax"))
    for fmt in ("json", "yaml"):
        assert blocked.format(fmt) == whole.format(fmt) == jax.format(fmt)
    if path == "state_path":
        assert _store(str(tmp_path / "blocked")) == _store(str(tmp_path / "whole"))

    rows = len(fleet[1])
    cpu = seen["cpu"]
    assert len(cpu) >= 3 and cpu[-1][1] - cpu[-1][0] < cpu[0][1] - cpu[0][0] == BLOCK_ROWS
    (spans,) = tracer.traces()
    for resource, blocks in seen.items():
        # The blocks tile the rows in order, as the rule cuts them.
        assert [r0 for r0, _r1, _w in blocks] == [r1 for _r0, r1, _w in [(0, 0, 0), *blocks[:-1]]]
        assert blocks[-1][1] == rows
        width = blocks[0][2]
        assert len(blocks) == -(-rows // rows_per_block(4 * width, rows, 1))
        # The same bytes as one block, in pieces, and one h2d span a block.
        assert (runner.metrics.value("krr_tpu_h2d_bytes_total", resource=resource)
                == whole_runner.metrics.value("krr_tpu_h2d_bytes_total", resource=resource)
                == rows * (4 * width + 4))
        assert runner.metrics.value("krr_tpu_h2d_blocks_total", resource=resource) == len(blocks)
        assert whole_runner.metrics.value("krr_tpu_h2d_blocks_total", resource=resource) == 1
        h2d = [s for s in spans if s.name == "h2d" and s.attributes["resource"] == resource]
        assert [s.attributes["block"] for s in h2d] == list(range(len(blocks)))
        assert sum(s.attributes["rows"] for s in h2d) == rows
        assert sum(s.attributes["bytes"] for s in h2d) == rows * (4 * width + 4)
    if path != "state_path":
        (quantile,) = [s for s in spans if s.name == "quantile"]
        assert quantile.attributes["blocks"] == len(seen["cpu"]) + len(seen["memory"])
