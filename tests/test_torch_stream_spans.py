"""The host-streamed scan's trace and counters on the CPU: a window past
``host_stream_mb=1`` streamed in more than one chunk, through ``Runner.run``.

The streamed ``quantile`` stage carries the stream's totals (the strategy's
``stream_stats``), each chunk's host fill is a ``stream_fill`` stage with
its bytes, the ``krr_tpu_stream_*`` counters count every scan with the
tracer recording or not, and a scan renders the same with the tracer on
and off; without a recording tracer no span, page-fault read or profiler
range runs."""

from __future__ import annotations

import asyncio
import resource

import numpy as np
import pytest
import torch

import krr_tpu_torch.core.config as port_config
import krr_tpu_torch.core.runner as port_runner
from krr_tpu_torch.models import K8sObjectData, ResourceAllocations, ResourceType
from krr_tpu_torch.obs.trace import NULL_TRACER, Tracer
from krr_tpu_torch.ops.chunked import StreamStats
from krr_tpu_torch.ops.packing import pad_to_lane
from krr_tpu_torch.strategies.simple import HOST_STREAM_CHUNK

CONTAINERS, PODS, SAMPLES = 64, 3, 4_320
#: (strategy, settings) of the streamed paths: the top-K sketch at p99, the
#: radix select's three passes (no top-K budget), the digest, the digest's
#: top-K upgrade.
STREAMED = {
    "simple-p99": ("simple", {"host_stream_mb": 1}),
    "simple-radix": ("simple", {"host_stream_mb": 1, "exact_sketch_budget": 0}),
    "tdigest": ("tdigest", {"host_stream_mb": 1}),
    "tdigest-exact": ("tdigest", {"host_stream_mb": 1, "exact_upgrade": True}),
}
#: Passes over the CPU window of each path (the memory window takes one).
CPU_PASSES = {"simple-p99": 1, "simple-radix": 3, "tdigest": 1, "tdigest-exact": 1}
#: Columns of the packed windows: ``simple`` takes memory through the stats
#: route, one max a pod.
CPU_COLUMNS = pad_to_lane(PODS * SAMPLES)
MEMORY_COLUMNS = {"simple": pad_to_lane(PODS), "tdigest": CPU_COLUMNS}


class Inventory:
    def __init__(self, objects):
        self.objects = objects

    async def list_clusters(self):
        return None

    async def list_scannable_objects(self, clusters):
        return list(self.objects)


class History:
    """Per container a dict of pod → float64 samples; one max a pod for the
    resources the strategy asks through the stats route."""

    def __init__(self, rows):
        self.rows = rows

    async def gather_fleet(self, objects, history_seconds, step_seconds, stats_resources=frozenset(), failed_rows=None):
        index = {id(obj): i for i, obj in enumerate(self.objects)}
        out = {}
        for resource_type, rows in self.rows.items():
            picked = [rows[index[id(obj)]] for obj in objects]
            if resource_type in stats_resources:
                picked = [{pod: np.asarray([s.max()]) for pod, s in row.items()} for row in picked]
            out[resource_type] = picked
        return out


@pytest.fixture(scope="module")
def streamed_fleet():
    """64 containers × 3 pods × 4,320 samples: a CPU window of 3.3 MB, two
    chunks of 8,192 columns a row."""
    rng = np.random.default_rng(23)
    allocations = ResourceAllocations(requests={ResourceType.CPU: "500m", ResourceType.Memory: "1Gi"},
                                      limits={ResourceType.CPU: None, ResourceType.Memory: "2Gi"})
    objects = [K8sObjectData(name=f"workload-{i}", container="main", namespace=f"ns-{i % 4}", kind="Deployment",
                             pods=[f"workload-{i}-pod-{p}" for p in range(PODS)], allocations=allocations)
               for i in range(CONTAINERS)]
    rows = {
        ResourceType.CPU: [{pod: rng.gamma(2.0, 0.1, SAMPLES) for pod in obj.pods} for obj in objects],
        ResourceType.Memory: [{pod: np.round(rng.uniform(20e6, 3e9, SAMPLES)) for pod in obj.pods}
                              for obj in objects],
    }
    return objects, rows


def runner_for(fleet, path, tracer):
    objects, rows = fleet
    strategy, args = STREAMED[path]
    history = History(rows)
    history.objects = objects
    return port_runner.Runner(
        port_config.Config(quiet=True, format="json", device="cpu", strategy=strategy,
                           other_args={"history_duration": 72, "timeframe_duration": 1, **args}),
        inventory=Inventory(objects), history_factory=lambda cluster: history, tracer=tracer,
    )


def chunks(path) -> dict:
    """Chunks each resource's stream folds in a scan: every pass's."""
    memory = MEMORY_COLUMNS[STREAMED[path][0]]
    return {"cpu": CPU_PASSES[path] * -(-CPU_COLUMNS // HOST_STREAM_CHUNK), "memory": -(-memory // HOST_STREAM_CHUNK)}


def quantile_span(spans):
    (span,) = [s for s in spans if s.name == "quantile"]
    return span


def under(spans, ancestor) -> list:
    """The spans below ``ancestor``, at any depth."""
    by_id = {s.span_id: s for s in spans}

    def below(span) -> bool:
        parent = by_id.get(span.parent_id)
        return parent is not None and (parent is ancestor or below(parent))

    return [s for s in spans if below(s)]


@pytest.mark.parametrize("path", sorted(STREAMED))
def test_the_streamed_quantile_stage_carries_the_stream_stats(streamed_fleet, path):
    tracer = Tracer()
    runner = runner_for(streamed_fleet, path, tracer)
    asyncio.run(runner.run())
    stats = runner.session.strategy.stream_stats
    (spans,) = tracer.traces()
    attributes = quantile_span(spans).attributes
    assert attributes["path"] == "host_stream"
    renamed = {"fill_seconds": "host_fill_seconds"}
    names = ["passes", "chunks", "host_bytes", "pinned_bytes", "fill_seconds", "copy_wait_seconds",
             "copy_seconds", "fold_seconds"]
    assert {name: attributes[name] for name in names} == {name: stats[renamed.get(name, name)] for name in names}
    assert stats["passes"] == CPU_PASSES[path] + 1
    assert stats["chunks"] == sum(chunks(path).values())
    assert stats["host_bytes"] > 0 and stats["host_fill_seconds"] > 0 and stats["fold_seconds"] > 0
    assert stats["pinned_bytes"] == 0 and stats["copy_seconds"] == 0.0  # no pinned copy on the CPU


@pytest.mark.parametrize("path", sorted(STREAMED))
def test_the_fill_spans_number_the_chunks_and_sum_to_the_host_bytes(streamed_fleet, path):
    tracer = Tracer()
    runner = runner_for(streamed_fleet, path, tracer)
    asyncio.run(runner.run())
    stats = runner.session.strategy.stream_stats
    (spans,) = tracer.traces()
    fills = [s for s in spans if s.name == "stream_fill"]
    # ``chunks`` sums every pass's chunks, so it already counts the passes.
    assert len(fills) == stats["chunks"]
    assert sum(s.attributes["bytes"] for s in fills) == stats["host_bytes"]
    assert fills == [s for s in under(spans, quantile_span(spans)) if s.name == "stream_fill"]
    assert all("minor_faults" in s.attributes for s in fills)
    assert sum(s.duration for s in fills) >= stats["host_fill_seconds"]
    assert not [s for s in spans if s.name == "stream_wait"]  # the CPU waits for no copy


@pytest.mark.parametrize("path", sorted(STREAMED))
@pytest.mark.parametrize("recording", [True, False], ids=["recording", "null"])
def test_the_stream_counters_grow_by_each_scans_bytes_and_chunks(streamed_fleet, path, recording):
    runner = runner_for(streamed_fleet, path, Tracer() if recording else NULL_TRACER)
    counted = []
    for _ in range(3):
        asyncio.run(runner.run())
        counted.append({(name, r.value): runner.metrics.value(f"krr_tpu_stream_{name}_total", resource=r.value)
                        for name in ("bytes", "chunks") for r in ResourceType})
    stats = runner.session.strategy.stream_stats
    first = counted[0]
    assert first[("bytes", "cpu")] + first[("bytes", "memory")] == stats["host_bytes"]
    assert first[("chunks", "cpu")] + first[("chunks", "memory")] == stats["chunks"]
    assert {r: first[("chunks", r)] for r in ("cpu", "memory")} == chunks(path)
    # Each pass reads the packed window once: float32 CPU, float32 memory
    # (in MB, divided by the pack's fill).
    assert first[("bytes", "cpu")] == CPU_PASSES[path] * CONTAINERS * CPU_COLUMNS * 4
    assert first[("bytes", "memory")] == CONTAINERS * MEMORY_COLUMNS[STREAMED[path][0]] * 4
    assert counted[1] == {key: 2 * value for key, value in first.items()}
    assert counted[2] == {key: 3 * value for key, value in first.items()}


def test_stream_stats_total_sums_each_field():
    a = StreamStats(passes=1, chunks=2, host_bytes=10, host_fill_seconds=0.5, pinned_bytes=8)
    b = StreamStats(passes=3, chunks=4, host_bytes=5, copy_seconds=0.25, fold_seconds=1.0)
    total = StreamStats.total([a, b])
    assert total.as_dict() == {"passes": 4, "chunks": 6, "host_bytes": 15, "host_fill_seconds": 0.5,
                               "copy_wait_seconds": 0.0, "copy_seconds": 0.25, "fold_seconds": 1.0,
                               "wall_seconds": 0.0, "pinned_bytes": 8}
    assert total.span_attributes()["fill_seconds"] == 0.5 and "wall_seconds" not in total.span_attributes()
    assert StreamStats.total([]).as_dict() == StreamStats().as_dict()


def _raise(*_args, **_kwargs):
    raise AssertionError("called on a scan without a recording tracer")


@pytest.mark.parametrize("path", sorted(STREAMED))
def test_a_streamed_scan_renders_alike_traced_or_not_and_untraced_opens_nothing(streamed_fleet, path, monkeypatch):
    tracer = Tracer()
    traced = runner_for(streamed_fleet, path, tracer)
    want = asyncio.run(traced.run()).format("json")
    assert quantile_span(tracer.traces()[0]).attributes["path"] == "host_stream"
    monkeypatch.setattr(resource, "getrusage", _raise)
    monkeypatch.setattr(torch.profiler, "record_function", _raise)
    untraced = runner_for(streamed_fleet, path, NULL_TRACER)
    got = asyncio.run(untraced.run()).format("json")
    assert got == want
    assert untraced.session.strategy.stream_stats["chunks"] == traced.session.strategy.stream_stats["chunks"]
