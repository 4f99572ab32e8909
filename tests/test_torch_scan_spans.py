"""The one-shot scan's trace on the CPU: the runner's ``assemble``, ``gc``
and ``render`` spans under the scan's root, the resident paths' ``cast``
stages and their row blocks' ``h2d`` stages (inside ``digest`` or
``quantile``) with their byte counts, memory packed once in MB as float32
(the ``cast`` stage copies nothing) and rendered as the old divide-then-cast
rendered it, the ``pack`` stage's threads and bytes, the stages' page-fault
counts, the
spans' ``torch.profiler`` ranges, and what a scan without a recording
tracer leaves alone; and the ``--profile`` report held to ``analyze``'s
reading of the exported trace at the export's rounding edges."""

from __future__ import annotations

import asyncio
import json
import os
import resource

import numpy as np
import pytest
import torch

import krr_tpu_torch.core.config as port_config
import krr_tpu_torch.core.runner as port_runner
import krr_tpu_torch.models as port_models
import krr_tpu_torch.strategies.simple as port_simple
import krr_tpu_torch.strategies.tdigest as port_tdigest
import krr_tpu_torch.strategies.window as port_window
from krr_tpu_torch.models.interop import fleet_batch_from_dicts, objects_from_dicts
from krr_tpu_torch.models.series import PackedSeries
from krr_tpu_torch.obs import profile as port_profile
from krr_tpu_torch.obs.trace import NULL_TRACER, Span, Tracer
from krr_tpu_torch.ops import packing

from .test_torch_simple import MemoryInventory, fleet, history_factory  # noqa: F401  (fixture)

#: (strategy, settings) of the two resident paths.
RESIDENT = {"simple": ("simple", {}), "tdigest": ("tdigest", {})}


def scan(fleet, strategy, args, tracer):  # noqa: F811
    """One ``Runner.run`` of the fleet on the CPU: (result, runner)."""
    _jax_objs, dumps, histories = fleet
    objects = objects_from_dicts(dumps)
    runner = port_runner.Runner(
        port_config.Config(quiet=True, format="json", device="cpu", strategy=strategy, other_args=args),
        inventory=MemoryInventory(objects),
        history_factory=history_factory(port_models.ResourceType, objects, histories),
        tracer=tracer,
    )
    return asyncio.run(runner.run()), runner


def children(spans, parent) -> list:
    return sorted((s for s in spans if s.parent_id == parent.span_id), key=lambda s: s.start)


@pytest.mark.parametrize("path", sorted(RESIDENT))
def test_one_trace_a_scan_with_assemble_and_render_under_its_root(fleet, path):  # noqa: F811
    tracer = Tracer()
    for _ in range(2):
        scan(fleet, *RESIDENT[path], tracer)
    traces = tracer.traces()
    assert len(traces) == 2
    for spans in traces:
        (root,) = [s for s in spans if s.parent_id is None]
        assert root.name == "scan"
        names = [s.name for s in children(spans, root)]
        assert names[-4:] == ["compute", "assemble", "gc", "render"]
        assert all(root.start <= s.start and s.end <= root.end for s in spans)


def test_the_collection_the_scan_deferred_runs_in_the_gc_span(fleet, monkeypatch):  # noqa: F811
    import gc

    collections = []

    def spy(generation=2):
        collections.append((generation, gc.isenabled()))
        return 0

    monkeypatch.setattr(gc, "collect", spy)
    tracer = Tracer()
    scan(fleet, "simple", {}, tracer)
    assert gc.isenabled() and collections == [(0, True)]
    (spans,) = tracer.traces()
    (assemble,) = [s for s in spans if s.name == "assemble"]
    (collect,) = [s for s in spans if s.name == "gc"]
    (render,) = [s for s in spans if s.name == "render"]
    assert assemble.end <= collect.start and collect.end <= render.start
    gc.disable()
    try:  # a caller that runs with the collector off keeps it off: no pass
        scan(fleet, "simple", {}, tracer)
    finally:
        gc.enable()
    assert collections == [(0, True)] and not [s for s in tracer.traces()[-1] if s.name == "gc"]


def descendants(spans, parent) -> list:
    """Every span under ``parent``, in the order they start."""
    below = {parent.span_id}
    for span in sorted(spans, key=lambda s: s.start):
        if span.parent_id in below:
            below.add(span.span_id)
    return sorted((s for s in spans if s.span_id in below - {parent.span_id}), key=lambda s: s.start)


@pytest.mark.parametrize("blocks", ["one", "several"])
@pytest.mark.parametrize("path", sorted(RESIDENT))
def test_the_resident_stages_run_in_order_with_cast_and_h2d_per_resource(
    fleet, monkeypatch, path, blocks  # noqa: F811
):
    if blocks == "several":  # three CPU rows a block
        monkeypatch.setattr(port_window, "RESIDENT_BLOCK_BYTES", 3 * 4 * _cpu_width(fleet))
    tracer = Tracer()
    scan(fleet, *RESIDENT[path], tracer)
    (spans,) = tracer.traces()
    (compute,) = [s for s in spans if s.name == "compute"]
    stages = [(s.name, s.attributes.get("resource")) for s in children(spans, compute)]
    digest = [("digest", None)] if path == "tdigest" else []
    assert stages == [("pack", None), ("cast", "cpu"), ("cast", "memory"), *digest,
                      ("quantile", None), ("round", None)]
    (quantile,) = [s for s in spans if s.name == "quantile"]
    assert quantile.attributes["path"] == "resident"
    # Each block's copy inside the stage that reduces it: CPU's blocks, then
    # memory's; tdigest builds CPU's in ``digest``.
    cpu_stage = [s for s in spans if s.name == "digest"][0] if path == "tdigest" else quantile
    copies = {stage.name: [(s.attributes["resource"], s.attributes["block"]) for s in children(spans, stage)]
              for stage in (cpu_stage, quantile)}
    cpu = [block for resource, block in copies[cpu_stage.name] if resource == "cpu"]
    memory = [block for resource, block in copies["quantile"] if resource == "memory"]
    assert cpu == list(range(len(cpu))) and memory == list(range(len(memory)))
    order = [copy for stage in copies.values() for copy in stage]
    assert order == [*(("cpu", b) for b in cpu), *(("memory", b) for b in memory)]
    assert quantile.attributes["blocks"] == len(cpu) + len(memory)
    assert len(cpu) == (1 if blocks == "one" else -(-len(fleet[1]) // 3))


def _cpu_width(fleet) -> int:  # noqa: F811
    """The packed width of the fleet's CPU window."""
    _jax_objs, dumps, histories = fleet
    return port_window.device_packed(fleet_batch_from_dicts(dumps, histories), port_models.ResourceType.CPU).capacity


@pytest.mark.parametrize("blocks", ["one", "several"])
@pytest.mark.parametrize("path", sorted(RESIDENT))
@pytest.mark.parametrize("recording", [True, False], ids=["recording", "null"])
def test_h2d_bytes_are_the_copied_tensors_bytes(fleet, monkeypatch, path, recording, blocks):  # noqa: F811
    if blocks == "several":  # three CPU rows a block
        monkeypatch.setattr(port_window, "RESIDENT_BLOCK_BYTES", 3 * 4 * _cpu_width(fleet))
    copied: dict = {}
    original = port_window.ResidentWindow.blocks

    def spy(self, resource_type):
        for r0, r1, values, counts in original(self, resource_type):
            # The block's values, and its rows of the counts copied whole.
            copied[resource_type.value] = copied.get(resource_type.value, 0) + values.nbytes + counts.nbytes
            assert values.dtype == torch.float32 and counts.dtype == torch.int32
            yield r0, r1, values, counts

    monkeypatch.setattr(port_window.ResidentWindow, "blocks", spy)
    tracer = Tracer() if recording else NULL_TRACER
    _result, runner = scan(fleet, *RESIDENT[path], tracer)
    assert set(copied) == {"cpu", "memory"} and all(size > 0 for size in copied.values())
    for name, size in copied.items():
        assert runner.metrics.value("krr_tpu_h2d_bytes_total", resource=name) == size
    if recording:
        (spans,) = tracer.traces()
        h2d: dict = {}
        for s in spans:
            if s.name == "h2d":
                h2d[s.attributes["resource"]] = h2d.get(s.attributes["resource"], 0) + s.attributes["bytes"]
        assert h2d == copied


def _batches(monkeypatch) -> list:
    """The batches every strategy's ``run_batch`` is handed, as they come."""
    seen: list = []
    for cls in (port_simple.SimpleStrategy, port_tdigest.TDigestStrategy):
        def run_batch(self, batch, _original=cls.run_batch):
            seen.append(batch)
            return _original(self, batch)

        monkeypatch.setattr(cls, "run_batch", run_batch)
    return seen


def _divided_after_the_pack(batch, resource):
    """The device view as it was built before the pack divided: memory
    packed raw in float64, then divided and cast to float32."""
    packed = batch.packed(resource)
    if resource is not port_models.ResourceType.Memory:
        return packed
    values = np.ascontiguousarray(packed.values / port_window.MEMORY_SCALE, dtype=np.float32)
    return PackedSeries(values=values, counts=packed.counts, workers=packed.workers)


@pytest.mark.parametrize("block", ["shipped", "one_row"])
@pytest.mark.parametrize("path", sorted(RESIDENT))
def test_a_resident_scan_packs_memory_once_in_mb_and_casts_nothing(fleet, monkeypatch, path, block):  # noqa: F811
    if block == "one_row":  # the fill divides a row at a time
        monkeypatch.setattr(packing, "SCALE_BLOCK_BYTES", 1)
    batches = _batches(monkeypatch)
    tracer = Tracer()
    got, _runner = scan(fleet, *RESIDENT[path], tracer)
    (batch,) = batches
    memory, cpu = port_models.ResourceType.Memory, port_models.ResourceType.CPU
    # No float64 memory pack: the cache holds the scaled float32 view alone.
    assert set(batch._packed) == {(cpu, 1.0), (memory, port_window.MEMORY_SCALE)}
    assert batch._packed[(memory, port_window.MEMORY_SCALE)].values.dtype == np.float32
    (spans,) = tracer.traces()
    casts = {s.attributes["resource"]: s.attributes["copied_bytes"] for s in spans if s.name == "cast"}
    assert casts == {"cpu": 0, "memory": 0}
    # The same bytes as the raw pack divided and cast, and the same render.
    assert (batch.packed_scaled(memory, port_window.MEMORY_SCALE).values.tobytes()
            == _divided_after_the_pack(batch, memory).values.tobytes())
    monkeypatch.setattr(port_window, "device_packed", _divided_after_the_pack)
    want, _runner = scan(fleet, *RESIDENT[path], NULL_TRACER)
    assert got.format("json") == want.format("json")


@pytest.mark.parametrize("rows", ["whole", "slice"])
def test_the_device_view_is_float32_c_contiguous_with_int32_counts(fleet, rows):  # noqa: F811
    """What the ``cast`` stage takes without a copy: both resources' device
    views, of the whole batch and of a row slice packed to the fleet's
    width, are C-contiguous float32 matrices beside int32 counts."""
    _jax_objs, dumps, histories = fleet
    batch = fleet_batch_from_dicts(dumps, histories)
    if rows == "slice":
        batch = batch.row_slice(3, 9)
    for resource in port_models.ResourceType:
        view = port_window.device_packed(batch, resource)
        assert view.values.dtype == np.float32 and view.values.flags.c_contiguous
        assert view.counts.dtype == np.int32 and view.counts.flags.c_contiguous
        assert view.values.shape[0] == len(view.counts) == len(batch)


def test_h2d_bytes_add_up_over_scans_and_row_chunks(fleet):  # noqa: F811
    _result, runner = scan(fleet, "simple", {}, NULL_TRACER)
    once = runner.metrics.value("krr_tpu_h2d_bytes_total", resource="cpu")
    _jax_objs, dumps, histories = fleet
    objects = objects_from_dicts(dumps)
    tracer = Tracer()
    chunked = port_runner.Runner(
        port_config.Config(quiet=True, format="json", device="cpu", max_fleet_rows_per_device=7),
        inventory=MemoryInventory(objects),
        history_factory=history_factory(port_models.ResourceType, objects, histories),
        tracer=tracer,
    )
    asyncio.run(chunked.run())
    (spans,) = tracer.traces()
    sizes = [s.attributes["bytes"] for s in spans if s.name == "h2d" and s.attributes["resource"] == "cpu"]
    assert len(sizes) == -(-len(objects) // 7)
    assert chunked.metrics.value("krr_tpu_h2d_bytes_total", resource="cpu") == sum(sizes)
    # Chunks pin the fleet's capacity: the chunked copies are the whole one's.
    assert sum(sizes) == once


@pytest.mark.parametrize("threaded", [False, True], ids=["serial", "threaded"])
@pytest.mark.parametrize("path", sorted(RESIDENT))
def test_the_pack_stage_carries_its_workers_and_bytes(fleet, monkeypatch, path, threaded):  # noqa: F811
    want, _runner = scan(fleet, *RESIDENT[path], NULL_TRACER)
    if threaded:
        # A cut every chunk passes: the tiny fleet fills by row blocks.
        monkeypatch.setattr(packing, "THREAD_MIN_CHUNK", 1)
        monkeypatch.setattr(packing, "THREAD_MIN_BYTES", 0)
    workers = min(packing.MAX_WORKERS, len(os.sched_getaffinity(0))) if threaded else 1
    tracer = Tracer()
    got, runner = scan(fleet, *RESIDENT[path], tracer)
    assert got.format("json") == want.format("json")
    (spans,) = tracer.traces()
    (pack,) = [s for s in spans if s.name == "pack"]
    assert pack.attributes["workers_cpu"] == pack.attributes["workers_memory"] == workers
    for name in ("cpu", "memory"):
        assert runner.metrics.value("krr_tpu_pack_workers", resource=name) == workers
    # The destinations' bytes: float32 CPU rows and float32 memory rows (in
    # MB, divided by the fill), each copied to the device as it is beside
    # int32 counts.
    rows = pack.attributes["rows"]
    h2d = {s.attributes["resource"]: s.attributes["bytes"] - 4 * rows for s in spans if s.name == "h2d"}
    assert pack.attributes["bytes"] == h2d["cpu"] + h2d["memory"] > 0


@pytest.mark.parametrize("path", sorted(RESIDENT))
def test_every_recording_stage_counts_its_minor_faults(fleet, path):  # noqa: F811
    tracer = Tracer()
    scan(fleet, *RESIDENT[path], tracer)
    (spans,) = tracer.traces()
    (compute,) = [s for s in spans if s.name == "compute"]
    stages = descendants(spans, compute)
    assert len(stages) >= 7
    for stage in stages:
        faults = stage.attributes["minor_faults"]
        assert isinstance(faults, int) and faults >= 0
    assert all("minor_faults" not in s.attributes for s in spans if s.parent_id is None or s is compute)


def test_a_stage_counts_the_faults_of_fresh_pages():
    from krr_tpu_torch.obs.device import DeviceObs

    tracer = Tracer()
    obs = DeviceObs(tracer)
    with obs.stage("pack") as span:
        # 64 MiB, past glibc's largest mmap threshold: fresh pages, faulted
        # in as they are written (2 MiB at a time where huge pages serve).
        block = np.ones(64 * 2**20 // 8)
    assert block.sum() == block.size
    assert span.attributes["minor_faults"] >= 16


def _raise(*_args, **_kwargs):
    raise AssertionError("called on a scan without a recording tracer")


@pytest.mark.parametrize("path", sorted(RESIDENT))
def test_a_null_tracer_scan_reads_no_rusage_and_opens_no_range(fleet, monkeypatch, path):  # noqa: F811
    want, _runner = scan(fleet, *RESIDENT[path], NULL_TRACER)
    monkeypatch.setattr(resource, "getrusage", _raise)
    monkeypatch.setattr(torch.profiler, "record_function", _raise)
    got, runner = scan(fleet, *RESIDENT[path], NULL_TRACER)
    assert got.format("json") == want.format("json")
    assert runner.session.strategy.obs.tracer is NULL_TRACER


#: The spans a scan opens on the event loop's thread, and its stages, which
#: run in the compute worker thread.
LOOP_RANGES = {"krr.scan", "krr.discover", "krr.compute", "krr.assemble", "krr.gc", "krr.render"}
STAGE_RANGES = {"krr.pack", "krr.cast", "krr.h2d", "krr.quantile", "krr.round"}


def _ranges(prof) -> set:
    return {event.key for event in prof.key_averages() if event.key.startswith("krr.")}


@pytest.mark.parametrize("path", sorted(RESIDENT))
def test_a_recording_scan_puts_its_spans_on_the_profilers_clock(fleet, path):  # noqa: F811
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    stages = STAGE_RANGES | ({"krr.digest"} if path == "tdigest" else set())
    # A profiler of every thread holds the stages, opened in the worker.
    with profile(activities=[ProfilerActivity.CPU],
                 experimental_config=_ExperimentalConfig(profile_all_threads=True)) as prof:
        scan(fleet, *RESIDENT[path], Tracer())
    assert LOOP_RANGES | stages <= _ranges(prof)
    # One of its own thread alone holds the spans opened there.
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        scan(fleet, *RESIDENT[path], Tracer())
    assert LOOP_RANGES <= _ranges(prof)
    with profile(activities=[ProfilerActivity.CPU],
                 experimental_config=_ExperimentalConfig(profile_all_threads=True)) as prof:
        scan(fleet, *RESIDENT[path], NULL_TRACER)
    assert not _ranges(prof)


def test_a_strategys_profile_dir_trace_holds_its_stages(fleet, tmp_path):  # noqa: F811
    scan(fleet, "simple", {"profile_dir": str(tmp_path)}, Tracer())
    (path,) = tmp_path.iterdir()
    names = {event.get("name") for event in json.loads(path.read_text())["traceEvents"]}
    assert {"krr.pack", "krr.cast", "krr.h2d", "krr.quantile"} <= names


# ------------------------------------------------- the --profile report's input
#: A scan's spans: (name, parent's index, start and end in microseconds
#: after the scan's first instant).
EDGE_SPANS = [("scan", None, 0, 2_000_000), ("fetch", 0, 100_000, 1_000_000), ("prom_query", 1, 100_001, 900_000),
              ("compute", 0, 1_000_003, 1_900_000), ("pack", 3, 1_000_004, 1_400_000),
              ("round", 3, 1_400_001, 1_800_000), ("assemble", 0, 1_900_001, 1_950_000),
              ("render", 0, 1_950_001, 1_999_999)]


def _edge_tracer(scans: int) -> Tracer:
    """A tracer of ``scans`` scans whose spans start within half a
    nanosecond of a whole microsecond and end within half a nanosecond of
    a half one: every duration lies at an edge of the reports' six decimal
    places, which the export's separate nanosecond rounding of ``ts`` and
    ``dur`` can tip."""
    tracer = Tracer(ring_scans=scans)
    tracer.epoch_perf = 1000.0
    nudge = iter([0.3e-9, -0.3e-9, 0.1e-9, -0.4e-9, 0.2e-9] * len(EDGE_SPANS) * 2 * scans)
    for k in range(scans):
        first = 10_000_000 * (k + 1)
        spans = []
        for name, parent, start, end in EDGE_SPANS:
            attributes = {"kind": "cli"} if parent is None else {}
            if name == "prom_query":
                attributes.update(phase_ttfb=0.2, phase_body_read=0.3)
            span = Span(name, f"scan-{k}", None if parent is None else spans[parent].span_id, attributes)
            span.start = tracer.epoch_perf + (first + start) * 1e-6 + next(nudge)
            span.end = tracer.epoch_perf + (first + end + 0.5) * 1e-6 + next(nudge)
            spans.append(span)
        for span in spans[1:] + spans[:1]:  # the root closes last
            tracer._record(span)
    return tracer


def test_the_profile_report_is_analyzes_reading_of_the_export(tmp_path):
    tracer = _edge_tracer(6)
    path = tmp_path / "trace.json"
    path.write_text(json.dumps(tracer.export_chrome()))
    reread = port_profile.profile_chrome_payload(json.loads(path.read_text()))
    live = port_profile.profile_traces(tracer.traces())
    # The hazard is real: profiled live, every scan rounds apart from the file.
    assert all(a != b for a, b in zip(live["scans"], reread["scans"]))
    port_profile.write_profile_report(tracer, str(tmp_path / "profile.json"))
    assert json.loads((tmp_path / "profile.json").read_text()) == reread
    assert reread["aggregate"]["scan_count"] == 6
    for report in reread["scans"]:
        assert sum(report["categories"].values()) == pytest.approx(report["wall_seconds"], abs=1e-5)
