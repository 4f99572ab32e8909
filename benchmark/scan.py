"""``krr_tpu_torch``'s one-shot scan, driven as a user's cron job drives it:
one ``Runner.run`` a scan over an injected inventory and history source.

The source hands each scan the histories the fetch layer would: per
container a dict of pod → float64 samples (views of the generated flat
arrays), or, for the resources the strategy asks through the stats route,
one exact max per pod, as ``integrations/prometheus.py`` serves them. Two
sample sets of the same fleet alternate, so consecutive scans have
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

from benchmark import generate, spec

#: Sample sets a fleet alternates between, scan by scan.
SAMPLE_SETS = 2


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
        self.objects = [
            K8sObjectData(
                name=f"workload-{i}", container="main", namespace=f"ns-{i % namespaces}", kind="Deployment",
                pods=[f"workload-{i}-pod-{p}" for p in range(r)], allocations=allocations,
            )
            for i, r in enumerate(replicas)
        ]
        self.keys = [(obj.namespace, obj.name, obj.container) for obj in self.objects]
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

        self.sources = []
        for drawn in self.samples:
            raw = {ResourceType.CPU: drawn.cpu, ResourceType.Memory: drawn.memory}
            self.sources.append(History(
                index,
                raw={resource: per_pod(flat, samples) for resource, flat in raw.items()},
                stats={resource: per_pod(np.maximum.reduceat(flat, starts), maxima) for resource, flat in raw.items()},
                window=window,
            ))


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
    stats and CPU pad-waste gauge, and the JSON it rendered."""

    sample_set: int
    start: float
    end: float
    stats: dict
    pad_waste_cpu: Optional[float]
    rendered: Optional[str]


def scan(cell: spec.Cell, fleet: Fleet, sample_set: int, device: str, tracer=None) -> ScanRecord:
    """One whole scan of ``fleet``'s sample set ``sample_set``."""
    from krr_tpu_torch.core.config import Config
    from krr_tpu_torch.core.runner import Runner

    config = Config(quiet=True, format="json", device=device, strategy=cell.config["strategy"],
                    cpu_min_value=cell.config["cpu_min_millicores"], memory_min_value=cell.config["memory_min_mb"],
                    other_args=dict(cell.config["settings"]))
    source = fleet.sources[sample_set]
    runner = Runner(config, inventory=Inventory(fleet.objects), history_factory=lambda cluster: source,
                    tracer=tracer)
    sink = _Capture()

    async def timed() -> tuple:
        start = time.perf_counter()
        await runner.run()
        return start, time.perf_counter()

    with contextlib.redirect_stdout(sink):
        start, end = asyncio.run(timed())
    rendered = [part for part in sink.parts if part.startswith("{")]
    return ScanRecord(
        sample_set=sample_set, start=start, end=end, stats=dict(runner.stats),
        pad_waste_cpu=runner.metrics.value("krr_tpu_pad_waste_pct", resource="cpu"),
        rendered=rendered[0] if len(rendered) == 1 else None,
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
