"""``krr_tpu_torch``'s one-shot scan, driven as a user's cron job drives it:
one ``Runner.run`` a scan over an injected inventory.

A configuration's ``history_source`` says how the histories arrive:

* ``"injected"`` (the default): a source handed to the runner gives each
  scan the histories the fetch layer would: per container a dict of pod →
  float64 samples (views of the generated flat arrays), or, for the
  resources the strategy asks through the stats route, one exact max per
  pod, as ``integrations/prometheus.py`` serves them;
* ``"prometheus"``: the runner's own ``PrometheusLoader`` fetches them, at
  its default settings, from the benchmark's fake Prometheus
  (:mod:`benchmark.prometheus`), which :func:`histories` starts.

Two sample sets of the same fleet alternate, so consecutive scans have
different answers: a program that hands back an earlier scan's answers
fails the comparison.
"""

from __future__ import annotations

import asyncio
import contextlib
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np

from benchmark import generate, prometheus, spec

#: Sample sets a fleet alternates between, scan by scan.
SAMPLE_SETS = 2
#: The end of every scan's window on the Prometheus route (a whole number
#: of 15-minute and 1-minute steps since the epoch, in October 2025).
PROMETHEUS_END = 1_760_000_400.0
HISTORY_SOURCES = ("injected", "prometheus")


def history_source(cell: spec.Cell) -> str:
    """The configuration's ``history_source``: ``"injected"`` where absent."""
    source = cell.config.get("history_source", "injected")
    if source not in HISTORY_SOURCES:
        raise ValueError(f"{cell.config['name']}: history_source {source!r} is none of {HISTORY_SOURCES}")
    return source


class Inventory:
    """The cluster inventory: the fleet's objects, listed once a scan."""

    def __init__(self, objects: list) -> None:
        self.objects = objects

    async def list_clusters(self):
        return None

    async def list_scannable_objects(self, clusters):
        return list(self.objects)


class History:
    """One sample set's histories, prebuilt; ``stats_asked`` records which
    resources a scan took through the stats route."""

    def __init__(self, index: dict, raw: dict, stats: dict, window: tuple) -> None:
        self.index = index
        self.raw = raw
        self.stats = stats
        self.window = window
        self.stats_asked: frozenset = frozenset()

    async def gather_fleet(self, objects, history_seconds, step_seconds, stats_resources=frozenset()):
        if (history_seconds, step_seconds) != self.window:
            raise ValueError(f"asked for {(history_seconds, step_seconds)}, the fleet holds {self.window}")
        self.stats_asked = frozenset(stats_resources)
        rows = [self.index[id(obj)] for obj in objects]
        return {
            resource: [(self.stats if resource in stats_resources else self.raw)[resource][i] for i in rows]
            for resource in self.raw
        }


class Fleet:
    """The cell's objects and its sample sets, made from the seed."""

    def __init__(self, cell: spec.Cell, seed: int, device: str, containers: Optional[int] = None) -> None:
        from krr_tpu_torch.models import K8sObjectData, ResourceAllocations, ResourceType

        config = cell.config
        self.shape = generate.shape(config, cell.mix_name, cell.mix, seed, root=cell.root, containers=containers)
        self.samples = generate.samples(config, self.shape, seed, device, SAMPLE_SETS)
        allocations = ResourceAllocations(
            requests={ResourceType.CPU: config["allocations"]["requests"]["cpu"],
                      ResourceType.Memory: config["allocations"]["requests"]["memory"]},
            limits={ResourceType.CPU: config["allocations"]["limits"]["cpu"],
                    ResourceType.Memory: config["allocations"]["limits"]["memory"]},
        )
        namespaces = int(config["namespaces"])
        replicas = self.shape.replicas.tolist()
        self.prometheus: Optional[prometheus.Served] = None
        self.objects = [
            K8sObjectData(
                name=f"workload-{i}", container="main", namespace=f"ns-{i % namespaces}", kind="Deployment",
                pods=[f"workload-{i}-pod-{p}" for p in range(r)], allocations=allocations,
            )
            for i, r in enumerate(replicas)
        ]
        self.keys = [(obj.namespace, obj.name, obj.container) for obj in self.objects]
        self.sources: list = []
        if history_source(cell) != "injected":
            return
        index = {id(obj): i for i, obj in enumerate(self.objects)}
        settings = config["settings"]
        window = (settings["history_duration"] * 3600.0, settings["timeframe_duration"] * 60.0)
        lengths = self.shape.pod_samples
        starts = np.concatenate([[0], np.cumsum(lengths)[:-1]]).astype(np.int64)
        samples = list(zip(starts.tolist(), (starts + lengths).tolist()))  # each pod's samples
        maxima = [(j, j + 1) for j in range(len(lengths))]  # each pod's one max
        first = np.concatenate([[0], np.cumsum(self.shape.replicas)[:-1]]).astype(np.int64).tolist()
        groups = [range(f, f + r) for f, r in zip(first, replicas)]

        def per_pod(flat: np.ndarray, spans: list) -> list:
            return [{obj.pods[p]: flat[spans[j][0]:spans[j][1]] for p, j in enumerate(pods)}
                    for obj, pods in zip(self.objects, groups)]

        for drawn in self.samples:
            raw = {ResourceType.CPU: drawn.cpu, ResourceType.Memory: drawn.memory}
            self.sources.append(History(
                index,
                raw={resource: per_pod(flat, samples) for resource, flat in raw.items()},
                stats={resource: per_pod(np.maximum.reduceat(flat, starts), maxima) for resource, flat in raw.items()},
                window=window,
            ))


@contextlib.contextmanager
def histories(cell: spec.Cell, fleet: Fleet, **fault):
    """While the block runs, the fleet's histories are served as its
    configuration says: for ``"prometheus"``, by a fake Prometheus holding
    every sample set (``fault``: a planted fault of the benchmark's tests);
    yields the running fake, or None where the histories are injected."""
    if history_source(cell) != "prometheus":
        yield None
        return
    shape, total = fleet.shape, int(fleet.shape.pod_samples.sum())
    extra = generate.set_shift(shape) * (len(fleet.samples) - 1)

    def turned(first, last):  # set 0's samples and the later sets' wrap
        return np.concatenate([first, last[total - extra:]])

    settings = cell.config["settings"]
    with prometheus.served(
        [(obj.namespace, pod, obj.container) for obj in fleet.objects for pod in obj.pods], shape.pod_samples,
        {"cpu": turned(fleet.samples[0].cpu, fleet.samples[-1].cpu),
         "memory": turned(fleet.samples[0].memory, fleet.samples[-1].memory)},
        shift=generate.set_shift(shape), sets=len(fleet.samples), end=PROMETHEUS_END,
        step=settings["timeframe_duration"] * 60.0, window=shape.window, **fault,
    ) as served:
        fleet.prometheus = served
        try:
            yield served
        finally:
            fleet.prometheus = None


class _Capture:
    """Standard output during a scan: keeps what the runner writes."""

    def __init__(self) -> None:
        self.parts: list = []

    def write(self, text: str) -> int:
        self.parts.append(text)
        return len(text)

    def flush(self) -> None:
        pass


@dataclass
class ScanRecord:
    """One scan: its ``Runner.run`` span on the host clock, the runner's
    stats, CPU pad-waste gauge and Prometheus wire bytes (None where no
    query read any), the resources the strategy took through the stats
    route, and the JSON it rendered."""

    sample_set: int
    start: float
    end: float
    stats: dict
    pad_waste_cpu: Optional[float]
    rendered: Optional[str]
    wire_bytes: Optional[float] = None
    stats_resources: frozenset = frozenset()


def scan(cell: spec.Cell, fleet: Fleet, sample_set: int, device: str, tracer=None) -> ScanRecord:
    """One whole scan of ``fleet``'s sample set ``sample_set``."""
    from krr_tpu_torch.core.config import Config
    from krr_tpu_torch.core.runner import Runner

    options = dict(quiet=True, format="json", device=device, strategy=cell.config["strategy"],
                   cpu_min_value=cell.config["cpu_min_millicores"], memory_min_value=cell.config["memory_min_mb"],
                   other_args=dict(cell.config["settings"]))
    if fleet.prometheus is not None:
        config = Config(**options, prometheus_url=fleet.prometheus.url(sample_set),
                        scan_end_timestamp=fleet.prometheus.end)
        runner = Runner(config, inventory=Inventory(fleet.objects), tracer=tracer)
    else:
        source = fleet.sources[sample_set]
        runner = Runner(Config(**options), inventory=Inventory(fleet.objects),
                        history_factory=lambda cluster: source, tracer=tracer)
    sink = _Capture()

    async def timed() -> tuple:
        start = time.perf_counter()
        await runner.run()
        return start, time.perf_counter()

    with contextlib.redirect_stdout(sink):
        start, end = asyncio.run(timed())
    rendered = [part for part in sink.parts if part.startswith("{")]
    wire = runner.metrics.series("krr_tpu_prom_wire_bytes_total")
    return ScanRecord(
        sample_set=sample_set, start=start, end=end, stats=dict(runner.stats),
        pad_waste_cpu=runner.metrics.value("krr_tpu_pad_waste_pct", resource="cpu"),
        rendered=rendered[0] if len(rendered) == 1 else None,
        wire_bytes=float(sum(wire.values())) if wire else None,
        stats_resources=frozenset(runner.session.strategy.stats_only_resources),
    )


def window(cell: spec.Cell, fleet: Fleet, device: str, seconds: float, tracer=None, annotate=None):
    """Whole scans back to back, the sample sets in turn from the first,
    until ``seconds`` have passed; the last scan finishes, and there is at
    least one. The warm-up scanned the last set, so no scan reads the set
    the one before it read. Returns
    the records, the window's start and end on the host clock, and where
    each scan's ``annotate`` context (the profiler's mark) was entered."""
    records, marks = [], []
    start = time.perf_counter()
    while True:
        with annotate() if annotate is not None else contextlib.nullcontext():
            marks.append(time.perf_counter())
            records.append(scan(cell, fleet, len(records) % SAMPLE_SETS, device, tracer))
        if time.perf_counter() - start >= seconds:
            return records, start, time.perf_counter(), marks
