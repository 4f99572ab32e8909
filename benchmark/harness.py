"""One run of a cell: set-up, the measured window, the comparison with
the reference, and the result line's contents.

Set-up makes the fleet and its two sample sets from the seed, starts the
fake Prometheus where the configuration fetches its histories from one
(:func:`benchmark.scan.histories`; it ends with the window, before the
reference runs), and runs one warm-up scan at the cell's shapes, of the
sample set the window does not start with (it builds and loads the
kernels: the build's own seconds are recorded apart). The window then runs whole scans back to back
(:func:`benchmark.scan.window`); ``--trace 1`` runs it under the port's
recording tracer and ``torch.profiler``. After the window every scan's JSON
is held to the plain reference of its sample set (:mod:`benchmark.check`).

The device's peak is what the program holds: it is reset once the fleet is
made, so the generator's buffers never count, and read over the warm-up
and the window.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
import tempfile
import time
from dataclasses import dataclass, field
from decimal import Decimal
from typing import Optional

from benchmark import check, roofline, scan, spec, traced
from benchmark.reference.recommend import MILLICORE, recommend

#: Modules no run may load, by their whole top-level name: JAX and the JAX
#: package the port was made from.
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "krr_tpu"})


def forbidden_modules(names) -> list[str]:
    """The names among ``names`` whose top-level part (before the first
    dot) is, whole, a forbidden one: ``krr_tpu_torch.x`` passes,
    ``krr_tpu.x`` and ``jax.numpy`` do not."""
    return sorted(name for name in names if name.split(".", 1)[0] in FORBIDDEN)


@dataclass
class Outcome:
    """What a run prints: the result line's parts and the readings."""

    correct: bool
    attempted: int
    failed: int
    metrics: dict
    device: dict
    readings: list
    breakdown: Optional[dict] = None
    missing: dict = field(default_factory=dict)
    setup_parts: dict = field(default_factory=dict)

    def line(self) -> dict:
        out = {"correct": self.correct, "attempted": self.attempted, "failed": self.failed,
               "metrics": self.metrics, "device": self.device}
        if self.breakdown is not None:
            out["breakdown"] = self.breakdown
        out["setup_parts"] = self.setup_parts
        out["checks"] = {r.name: {"value": r.value, "limit": r.limit} for r in self.readings}
        return out


def _reader(cell: spec.Cell, name: str):
    path = spec.metric_path(cell.root, name)
    module_spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(module_spec)
    module_spec.loader.exec_module(module)
    return module.read


def reference_answers(cell: spec.Cell, fleet: scan.Fleet, precision: str = "float32", sets=None) -> dict:
    """The plain reference's answers for the fleet's sample sets ``sets``
    (default: all), by sample set."""
    settings = cell.config["settings"]
    sets = range(len(fleet.samples)) if sets is None else sorted(set(sets))
    return {
        index: recommend(fleet.samples[index].cpu, fleet.samples[index].memory, fleet.shape.replicas,
                         fleet.shape.pod_samples, cpu_percentile=settings["cpu_percentile"],
                         memory_buffer_percentage=settings["memory_buffer_percentage"],
                         cpu_min_millicores=cell.config["cpu_min_millicores"],
                         memory_min_mb=cell.config["memory_min_mb"], precision=precision)
        for index in sets
    }


def cpu_floor(cell: spec.Cell) -> Decimal:
    return Decimal(cell.config["cpu_min_millicores"]) * MILLICORE


def judge(cell: spec.Cell, fleet: scan.Fleet, records: list, answers: dict) -> list:
    """The worst reading of every number over the scans: each distinct JSON
    of a sample set is parsed and held to that set's reference; a scan
    that rendered no single JSON document fails every number."""
    guarantee = cell.config["guarantee"]
    if any(record.rendered is None for record in records):
        return check.failing(guarantee)
    groups, compared = [], {}
    for record in records:
        seen = compared.setdefault(record.sample_set, [])
        if any(record.rendered == text for text in seen):
            continue
        seen.append(record.rendered)
        rendered = check.parse(record.rendered, fleet.keys)
        groups.append(check.compare(rendered, answers[record.sample_set], guarantee, cpu_floor(cell)))
    return check.worst(groups)


def _spent(before: Optional[float], after: Optional[float]) -> str:
    """CPU seconds between two readings of a process's clock."""
    return "not read" if before is None or after is None else f"{after - before:.3f} CPU s"


def _device_report(device: str, chips: int) -> dict:
    import torch

    if device != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips}


def _traced_window(cell, fleet, device, seconds):
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from krr_tpu_torch.obs.trace import Tracer

    tracer = Tracer(ring_scans=1_000_000)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device == "cuda" else [])
    with tempfile.TemporaryDirectory(prefix="benchmark-trace-") as folder:
        with profile(activities=activities, record_shapes=False, with_stack=False) as prof:
            if device == "cuda":  # the profiler keeps only records inside its window
                torch.cuda.synchronize()
                time.sleep(0.1)
            records, start, end, marks = scan.window(
                cell, fleet, device, seconds, tracer=tracer, annotate=lambda: record_function(traced.SCAN_MARK))
            if device == "cuda":
                torch.cuda.synchronize()
                time.sleep(0.1)
        path = os.path.join(folder, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return records, start, end, marks, tracer.traces(), events


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool, device: str, started: float,
             containers: Optional[int] = None) -> Outcome:
    """One run of ``cell``: ``started`` is the process's start on the host
    clock; ``containers`` shrinks the fleet (tests on the CPU)."""
    import torch

    from krr_tpu_torch.ops import cuda_build

    made = time.perf_counter()
    fleet = scan.Fleet(cell, seed, device, containers)
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()  # the generator's buffers are not the program's
    fleet_made = time.perf_counter()
    with scan.histories(cell, fleet) as served:  # the fake Prometheus, on that route, ends with the block
        warm = time.perf_counter()
        builds: list = []
        hook = lambda event, seconds: builds.append(seconds) if event == "compile" else None
        cuda_build.BUILD_HOOKS.append(hook)
        fake_cpu = served.cpu_seconds() if served is not None else None
        try:  # the warm-up: a scan of the set the window does not start with, at the cell's shapes
            record = scan.scan(cell, fleet, scan.SAMPLE_SETS - 1, device)
        finally:
            cuda_build.BUILD_HOOKS.remove(hook)
        if device == "cuda":
            torch.cuda.synchronize()
            setup_peak = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        setup_seconds = time.perf_counter() - started
        parts = {"import_s": made - started, "fleet_s": fleet_made - made}
        if served is not None:
            parts["fake_s"] = warm - fleet_made
        parts.update({"warmup_scan_s": record.end - record.start, "build_s": sum(builds)})
        print("setup: " + ", ".join(f"{key} {value:.3f}" for key, value in parts.items())
              + f"; setup_s {setup_seconds:.3f}", file=sys.stderr)
        if served is not None:
            legs = ("discover_seconds", "fetch_seconds", "fetch_cpu_seconds", "compute_seconds")
            print("warm-up scan: " + ", ".join(f"{key} {record.stats[key]:.3f}" for key in legs)
                  + f"; the fake {_spent(fake_cpu, served.cpu_seconds())}", file=sys.stderr)

        fake_cpu = served.cpu_seconds() if served is not None else None
        if trace:
            records, start, end, marks, traces, events = _traced_window(cell, fleet, device, seconds)
        else:
            records, start, end, marks = scan.window(cell, fleet, device, seconds)
        if served is not None:
            phases = ", ".join(f"{name} {seconds:.3f} s" for name, seconds in served.phases.items())
            print(f"fake Prometheus: set-up {phases}; {_spent(fake_cpu, served.cpu_seconds())} over the window",
                  file=sys.stderr)

    report = _device_report(device, cell.chips)
    metrics: dict = {}
    if device == "cuda":
        window_peak = torch.cuda.max_memory_allocated()
        report["memory_peak_bytes"] = max(setup_peak, window_peak)
    containers_done = fleet.shape.containers * len(records)
    outcome = Outcome(correct=False, attempted=containers_done,
                      failed=int(sum(record.stats.get("failed_rows", 0) for record in records)),
                      metrics=metrics, device=report, readings=[], setup_parts=parts)

    if trace:
        from krr_tpu_torch.models import ResourceType

        asked = records[0].stats_resources  # resources served one max a pod
        held = {r: len(fleet.shape.pod_samples) if r in asked else int(fleet.shape.pod_samples.sum())
                for r in ResourceType}
        try:
            ops = traced.device_ops(events, marks) if device == "cuda" else []
        except traced.Missing as missing:
            print(f"benchmark: the profiler's trace is not read: {missing}", file=sys.stderr)
            ops = []
        run = traced.TracedRun(
            scans=records, spans=traces, ops=[op for op in ops if start <= op.start < end],
            window=(start, end), containers=fleet.shape.containers,
            work_bytes=roofline.work_bytes(held[ResourceType.CPU], held[ResourceType.Memory],
                                           fleet.shape.containers),
            # Every resource's samples cross the wire: the stats route folds them as they arrive.
            fetched_samples=len(ResourceType) * int(fleet.shape.pod_samples.sum()) if served is not None else None,
        )
        for entry in cell.per_layer:
            try:
                if len(traces) != len(records):
                    raise traced.Missing(f"{len(traces)} traces for {len(records)} scans")
                metrics[entry["name"]] = {"value": _reader(cell, entry["name"])(run), "unit": entry["unit"]}
            except traced.Missing as missing:
                outcome.missing[entry["name"]] = str(missing)
        if device == "cuda":
            report["busy_s"] = run.busy_seconds
            report["window_s"] = run.window_seconds
            outcome.breakdown = run.breakdown()
    else:
        values = {"setup_s": setup_seconds}
        if device == "cuda":
            values["peak_device_mib"] = window_peak / 2**20
        for entry in cell.end_to_end:
            if entry["name"] in values:
                metrics[entry["name"]] = {"value": values[entry["name"]], "unit": entry["unit"]}

    print("scans: " + " ".join(f"{record.end - record.start:.4f}" for record in records)
          + f"; {containers_done / (end - start):.4f} containers/s over the window", file=sys.stderr)
    checked = time.perf_counter()
    answers = reference_answers(cell, fleet, sets=[record.sample_set for record in records])
    outcome.readings = judge(cell, fleet, records, answers)
    print(f"reference and comparison: {time.perf_counter() - checked:.3f} s", file=sys.stderr)
    outcome.correct = outcome.failed == 0 and all(reading.holds for reading in outcome.readings)
    return outcome
