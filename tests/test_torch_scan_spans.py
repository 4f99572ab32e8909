"""The one-shot scan's trace on the CPU: the runner's ``assemble``, ``gc``
and ``render`` spans under the scan's root, the resident paths' ``cast`` and
``h2d`` stages with their byte counts, the ``pack`` stage's threads and
bytes, the stages' page-fault counts, the
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
from krr_tpu_torch.models.interop import objects_from_dicts
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


@pytest.mark.parametrize("path", sorted(RESIDENT))
def test_the_resident_stages_run_in_order_with_cast_and_h2d_per_resource(fleet, path):  # noqa: F811
    tracer = Tracer()
    scan(fleet, *RESIDENT[path], tracer)
    (spans,) = tracer.traces()
    (compute,) = [s for s in spans if s.name == "compute"]
    stages = [(s.name, s.attributes.get("resource")) for s in children(spans, compute)]
    digest = [("digest", None)] if path == "tdigest" else []
    assert stages == [("pack", None), ("cast", "cpu"), ("h2d", "cpu"), ("cast", "memory"), ("h2d", "memory"),
                      *digest, ("quantile", None), ("round", None)]
    (quantile,) = [s for s in spans if s.name == "quantile"]
    assert quantile.attributes["path"] == "resident"


@pytest.mark.parametrize("path", sorted(RESIDENT))
@pytest.mark.parametrize("recording", [True, False], ids=["recording", "null"])
def test_h2d_bytes_are_the_copied_tensors_bytes(fleet, monkeypatch, path, recording):  # noqa: F811
    copied: dict = {}
    original = port_simple.fleet_device_arrays

    def spy(batch, resource_type, *args, **kwargs):
        values, counts = original(batch, resource_type, *args, **kwargs)
        copied[resource_type.value] = copied.get(resource_type.value, 0) + values.nbytes + counts.nbytes
        assert values.dtype == torch.float32 and counts.dtype == torch.int32
        return values, counts

    monkeypatch.setattr(port_simple, "fleet_device_arrays", spy)
    monkeypatch.setattr(port_tdigest, "fleet_device_arrays", spy)
    tracer = Tracer() if recording else NULL_TRACER
    _result, runner = scan(fleet, *RESIDENT[path], tracer)
    assert set(copied) == {"cpu", "memory"} and all(size > 0 for size in copied.values())
    for name, size in copied.items():
        assert runner.metrics.value("krr_tpu_h2d_bytes_total", resource=name) == size
    if recording:
        (spans,) = tracer.traces()
        h2d = {s.attributes["resource"]: s.attributes["bytes"] for s in spans if s.name == "h2d"}
        assert h2d == copied


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
    # The destinations' bytes: float32 CPU and float64 memory rows, each
    # copied to the device as float32 values beside int32 counts.
    rows = pack.attributes["rows"]
    h2d = {s.attributes["resource"]: s.attributes["bytes"] - 4 * rows for s in spans if s.name == "h2d"}
    assert pack.attributes["bytes"] == h2d["cpu"] + 2 * h2d["memory"] > 0


@pytest.mark.parametrize("path", sorted(RESIDENT))
def test_every_recording_stage_counts_its_minor_faults(fleet, path):  # noqa: F811
    tracer = Tracer()
    scan(fleet, *RESIDENT[path], tracer)
    (spans,) = tracer.traces()
    (compute,) = [s for s in spans if s.name == "compute"]
    stages = children(spans, compute)
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
