"""The streamed cell ``simple-30d-1m.streamed``: its configuration reaches
the strategy, a small fleet of it streams from host memory through
``Runner.run`` and agrees with the reference, and a stream that skips its
last, narrower chunk, or the reference in bfloat16, is not correct."""

import dataclasses

import pytest

from benchmark import check, harness, scan, spec

CELL = "simple-30d-1m.streamed"
SEED = 2**31 + 23
CONTAINERS = 24
STREAM_METRICS = {"stream_ms", "stream_fill_ms", "stream_copy_wait_ms", "stream_h2d_gbps", "stream_kernels_roofline"}
#: The runner-wide metrics the cell reports besides its stream's.
RUNNER_METRICS = {"scan_containers_per_s.host", "discover_ms", "post_compute_ms", "pack_ms", "finalize_ms",
                  "assemble_ms", "render_ms", "device_idle_pct", "pad_waste_pct", "pack_minor_faults"}


def small_cell():
    """The cell with ``host_stream_mb`` lowered to 1, so that a fleet of
    ``CONTAINERS`` streams too (the file states 4,000)."""
    cell = spec.load_cell(CELL)
    settings = {**cell.config["settings"], "host_stream_mb": 1}
    return dataclasses.replace(cell, config={**cell.config, "settings": settings})


def test_the_cell_loads_and_its_settings_reach_the_strategy():
    from krr_tpu_torch.strategies.simple import SimpleStrategySettings

    cell = spec.load_cell(CELL)
    assert (cell.chips, cell.mix_name, cell.config["name"], cell.config["strategy"]) == (
        1, "uniform", "simple-30d-1m", "simple")
    assert spec.samples_per_pod(cell.config) == 43_200
    settings = SimpleStrategySettings(**cell.config["settings"])
    assert settings.host_stream_mb == 4_000 and settings.cpu_percentile == 99
    assert settings.memory_buffer_percentage == 5
    assert (settings.history_duration, settings.timeframe_duration) == (720, 1)
    assert cell.config["guarantee"] == spec.load_cell("simple-14d-15m.uniform").config["guarantee"]
    assert {entry["name"] for entry in cell.per_layer} == STREAM_METRICS | RUNNER_METRICS
    assert {entry["name"] for entry in cell.end_to_end} == {"setup_s", "peak_device_mib"}


def test_the_full_window_passes_the_stated_share_and_k4_serves_p99():
    from krr_tpu_torch.ops.packing import pad_to_lane
    from krr_tpu_torch.strategies.simple import HOST_STREAM_CHUNK, SimpleStrategySettings, exact_topk_k

    cell = spec.load_cell(CELL)
    settings = SimpleStrategySettings(**cell.config["settings"])
    columns = pad_to_lane(3 * spec.samples_per_pod(cell.config))
    assert 4 * cell.config["containers"] * columns > settings.host_stream_mb * 1_000_000
    assert -(-columns // HOST_STREAM_CHUNK) == 16
    # Rank 1,296 from the top rounds up to a sketch of 1,408, within the budget.
    assert exact_topk_k(columns, float(settings.cpu_percentile), settings.exact_sketch_budget) == 1_408


def _scan(cell, fleet, tracer=None):
    answers = harness.reference_answers(cell, fleet, sets=[0])
    record = scan.scan(cell, fleet, 0, "cpu", tracer)
    return harness.judge(cell, fleet, [record], answers)


def test_a_small_fleet_streams_and_agrees_with_the_reference():
    from krr_tpu_torch.obs.trace import Tracer

    cell = small_cell()
    fleet = scan.Fleet(cell, SEED, "cpu", containers=CONTAINERS)
    tracer = Tracer()
    readings = _scan(cell, fleet, tracer)
    assert {r.name: r.value for r in readings} == {"cpu_mismatches": 0.0, "memory_mismatches": 0.0}
    (spans,) = tracer.traces()
    (quantile,) = [s for s in spans if s.name == "quantile"]
    assert quantile.attributes["path"] == "host_stream"
    assert quantile.attributes["chunks"] == 16 + 1  # the CPU window's, then memory's one
    assert not [s for s in spans if s.name in ("cast", "h2d")]


def test_a_traced_small_run_reads_the_stream_spans_and_names_the_device_metrics():
    outcome = harness.run_cell(small_cell(), SEED, 0.0, True, "cpu", 0.0, containers=CONTAINERS)
    assert outcome.correct, outcome.line()
    assert set(outcome.metrics) == {"stream_ms", "stream_fill_ms"} | RUNNER_METRICS - {"device_idle_pct"}
    # No pinned copy waits on the CPU, and no profiler trace of the card.
    assert set(outcome.missing) == {"stream_copy_wait_ms", "stream_h2d_gbps", "stream_kernels_roofline",
                                    "device_idle_pct"}
    assert 0 < outcome.metrics["stream_fill_ms"]["value"] < outcome.metrics["stream_ms"]["value"]


def test_a_stream_that_skips_its_last_narrower_chunk_is_not_correct(monkeypatch):
    from krr_tpu_torch.ops.chunked import HostChunkStreamer

    original = HostChunkStreamer.__init__

    def skip_the_narrow_tail(self, *args, **kwargs):
        original(self, *args, **kwargs)
        start, end = self._bounds(self.num_chunks - 1)
        if self.num_chunks > 1 and end - start < self.chunk_size:
            self.num_chunks -= 1

    monkeypatch.setattr(HostChunkStreamer, "__init__", skip_the_narrow_tail)
    cell = small_cell()
    readings = _scan(cell, scan.Fleet(cell, SEED, "cpu", containers=CONTAINERS))
    values = {r.name: r.value for r in readings}
    # A p99 a millicore apart renders alike, so small containers hide it.
    assert values["cpu_mismatches"] > 0 and values["memory_mismatches"] == 0
    assert not all(r.holds for r in readings)


def test_the_bfloat16_control_of_the_cell_is_not_correct():
    cell = spec.load_cell(CELL)
    fleet = scan.Fleet(cell, SEED, "cpu", containers=200)
    exact = harness.reference_answers(cell, fleet, sets=[0])[0]
    low = harness.reference_answers(cell, fleet, precision="bfloat16", sets=[0])[0]
    readings = check.compare(check.as_rendered(low), exact, cell.config["guarantee"], harness.cpu_floor(cell))
    values = {r.name: r.value for r in readings}
    assert values["cpu_mismatches"] > 20 and values["memory_mismatches"] > 20


@pytest.mark.card
def test_a_tiny_streamed_cell_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    outcome = harness.run_cell(small_cell(), 17, 0.5, True, "cuda", 0.0, containers=64)
    assert outcome.correct, outcome.line()
    assert set(outcome.metrics) == STREAM_METRICS | RUNNER_METRICS, outcome.missing
    assert 0 < outcome.metrics["stream_kernels_roofline"]["value"] < 105
    assert {name for name, _ in outcome.breakdown["device_ops"]} >= {"topk_select_kernel"}
