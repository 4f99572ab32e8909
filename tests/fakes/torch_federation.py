"""Deterministic multi-cluster fakes on `krr_tpu_torch`, for the port's bench.

A copy of `tests/fakes/federation.py` over the port's models: the same
fleet, series and comparisons from the same seed, built from
`krr_tpu_torch.models`, so nothing here imports the JAX package.

A :class:`MultiClusterFleet` is N fake clusters with disjoint namespaces and
seeded per-pod series anchored on the evaluation grid, exposed two ways:

* :class:`FleetInventory` — an injectable ``InventorySource`` scoped to a
  cluster subset (the whole fleet for the single-process control, one
  cluster for each shard);
* :class:`WindowedHistory` — an injectable ``HistorySource`` that slices
  each series to the REQUESTED window on the grid (inclusive endpoints,
  like a Prometheus range query), so delta-window semantics are real:
  consecutive delta fetches partition the grid exactly and the federated
  vs single-process bit-exactness comparison is meaningful.

Everything is derived from one seed, so a control scan and a federated scan
over the same clusters see byte-identical ground truth.
"""

from __future__ import annotations

import math

import numpy as np

from krr_tpu_torch.models.allocations import ResourceAllocations, ResourceType
from krr_tpu_torch.models.objects import K8sObjectData

#: Series anchor on the 60 s evaluation grid (divisible by 900 and 60, like
#: the HTTP fakes' SERIES_ORIGIN).
ORIGIN = 1_699_999_200.0
STEP = 60.0


def _allocations(i: int) -> ResourceAllocations:
    return ResourceAllocations(
        requests={ResourceType.CPU: 0.1 * (1 + i % 3), ResourceType.Memory: 128 + 64 * (i % 2)},
        limits={ResourceType.CPU: 0.5, ResourceType.Memory: 512},
    )


class MultiClusterFleet:
    """N clusters × M namespaces × W workloads, with seeded series."""

    def __init__(
        self,
        clusters: int = 3,
        namespaces_per_cluster: int = 2,
        workloads_per_namespace: int = 2,
        pods: int = 2,
        samples: int = 240,
        seed: int = 7,
    ) -> None:
        self.samples = int(samples)
        self.clusters = [f"c{i}" for i in range(clusters)]
        self.objects: dict[str, list[K8sObjectData]] = {}
        self.series: dict[tuple[str, str], tuple[np.ndarray, np.ndarray]] = {}
        rng = np.random.default_rng(seed)
        counter = 0
        for cluster in self.clusters:
            objs: list[K8sObjectData] = []
            for n in range(namespaces_per_cluster):
                namespace = f"{cluster}-ns{n}"
                for w in range(workloads_per_namespace):
                    name = f"app-{w}"
                    pod_names = [f"{name}-pod-{p}" for p in range(pods)]
                    objs.append(
                        K8sObjectData(
                            cluster=cluster,
                            namespace=namespace,
                            name=name,
                            kind="Deployment",
                            container="main",
                            pods=pod_names,
                            allocations=_allocations(counter),
                        )
                    )
                    for pod in pod_names:
                        cpu = np.clip(
                            rng.gamma(2.0, 0.05 * (1 + counter % 4), self.samples), 1e-4, None
                        ).astype(np.float64)
                        mem = rng.uniform(5e7, 4e8, self.samples).astype(np.float64)
                        self.series[(namespace, pod)] = (cpu, mem)
                    counter += 1
            self.objects[cluster] = objs

    def all_objects(self, clusters: "list[str] | None" = None) -> list[K8sObjectData]:
        return [
            obj
            for cluster in (clusters if clusters is not None else self.clusters)
            for obj in self.objects.get(cluster, [])
        ]


class FleetInventory:
    """InventorySource over a cluster subset of one fleet."""

    def __init__(self, fleet: MultiClusterFleet, clusters: "list[str] | None" = None):
        self.fleet = fleet
        self.clusters = list(clusters) if clusters is not None else list(fleet.clusters)
        #: Test knob: clusters whose listing "fails" (fail-soft empty).
        self.failing: set[str] = set()
        self.last_failed_clusters: dict[str, str] = {}

    async def list_clusters(self):
        return list(self.clusters)

    async def list_scannable_objects(self, clusters):
        self.last_failed_clusters = {
            c: "injected discovery failure" for c in (clusters or []) if c in self.failing
        }
        return [
            obj
            for c in (clusters or [])
            if c not in self.failing
            for obj in self.fleet.objects.get(c, [])
        ]


class WindowedHistory:
    """HistorySource for one cluster: grid-sliced deterministic series."""

    def __init__(self, fleet: MultiClusterFleet, cluster: "str | None"):
        self.fleet = fleet
        self.cluster = cluster

    def _slice(self, namespace: str, pod: str, is_cpu: bool, start: float, end: float) -> np.ndarray:
        series = self.fleet.series.get((namespace, pod))
        if series is None:
            return np.empty(0, np.float64)
        values = series[0] if is_cpu else series[1]
        # Inclusive grid endpoints, like a Prometheus range query: samples
        # at ORIGIN + k*STEP with start <= t <= end.
        k0 = max(0, math.ceil((start - ORIGIN) / STEP))
        k1 = min(len(values) - 1, math.floor((end - ORIGIN) / STEP))
        if k1 < k0:
            return np.empty(0, np.float64)
        return values[k0 : k1 + 1]

    async def gather_fleet(self, objects, history_seconds, step_seconds, end_time=None):
        assert end_time is not None, "federation fakes need a pinned window"
        start = float(end_time) - float(history_seconds)
        out = {resource: [] for resource in ResourceType}
        for obj in objects:
            cpu: dict[str, np.ndarray] = {}
            mem: dict[str, np.ndarray] = {}
            for pod in obj.pods:
                cpu_samples = self._slice(obj.namespace, pod, True, start, float(end_time))
                if cpu_samples.size:
                    cpu[pod] = cpu_samples
                mem_samples = self._slice(obj.namespace, pod, False, start, float(end_time))
                if mem_samples.size:
                    mem[pod] = mem_samples
            out[ResourceType.CPU].append(cpu)
            out[ResourceType.Memory].append(mem)
        return out


def history_factory(fleet: MultiClusterFleet):
    return lambda cluster: WindowedHistory(fleet, cluster)


def stores_bitexact_by_key(a, b) -> "tuple[bool, str]":
    """Per-KEY bit-exactness across two stores whose row ORDERS differ (the
    aggregator grows rows in shard-arrival order; a single-process scan in
    discovery order): align rows by key, then compare every digest array
    bit-for-bit."""
    if sorted(a.keys) != sorted(b.keys):
        only_a = set(a.keys) - set(b.keys)
        only_b = set(b.keys) - set(a.keys)
        return False, f"key sets differ (only_a={sorted(only_a)[:3]}, only_b={sorted(only_b)[:3]})"
    index_b = {key: i for i, key in enumerate(b.keys)}
    order = np.asarray([index_b[key] for key in a.keys], dtype=np.int64)
    for attr in ("cpu_counts", "cpu_total", "cpu_peak", "mem_total", "mem_peak"):
        left = getattr(a, attr)
        right = getattr(b, attr)[order]
        if not np.array_equal(left, right):
            bad = int(np.argwhere(~np.isclose(left, right, equal_nan=True))[0][0]) if left.size else -1
            return False, f"{attr} differs (first at row {bad}, key {a.keys[bad] if bad >= 0 else '?'})"
    return True, ""
