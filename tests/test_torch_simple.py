"""The port's one-shot `simple` scan held against the JAX package's.

One fleet — ~30 objects of 1–3 pods over three clusters, ragged histories,
some empty, per-row fetch failures on one cluster and a whole cluster whose
source fails — is made with numpy from a seed and handed to both packages:
the JAX objects are dumped with ``model_dump(mode="json")`` and rebuilt in
the port through `krr_tpu_torch.models.interop`, and one in-memory history
source class serves the same arrays to both runners. The port runs with
``device="cpu"`` (its plain PyTorch versions). Every comparison is exact:
rendered bytes, scores, and the strategy's raw Decimals.
"""

from __future__ import annotations

import asyncio
import io
import json
import os
import subprocess
import sys
from decimal import Decimal
from pathlib import Path

import numpy as np
import pytest
import torch
from rich.console import Console

import krr_tpu.core.config as jax_config
import krr_tpu.core.runner as jax_runner
import krr_tpu.models as jax_models
import krr_tpu.strategies.simple as jax_simple
import krr_tpu_torch.core.config as port_config
import krr_tpu_torch.core.runner as port_runner
import krr_tpu_torch.models as port_models
import krr_tpu_torch.strategies.simple as port_simple
from krr_tpu_torch.core import rounding as port_rounding
from krr_tpu_torch.models.interop import fleet_batch_from_dicts, objects_from_dicts
from krr_tpu_torch.obs.device import DeviceObs
from krr_tpu_torch.obs.trace import Tracer as PortTracer
from krr_tpu_torch.utils import resource_units as port_units

REPO = Path(__file__).resolve().parent.parent
CLUSTERS = ["alpha", "beta", "gamma"]
#: Cluster whose source reports some rows as terminally failed.
PARTIAL_CLUSTER = "beta"
#: Cluster whose history source cannot be built at all.
BROKEN_CLUSTER = "gamma"
QUANTITIES = {
    "cpu": [None, "100m", "250m", "1", "1500m", "2", "5m"],
    "memory": [None, "64Mi", "128Mi", "1Gi", "300M", "2Gi", "10Mi"],
}


def make_fleet(seed: int = 7, n_objects: int = 30):
    """(object dicts, ``{"cpu"|"memory": [{pod: samples}]}``) — plain data."""
    rng = np.random.default_rng(seed)
    objects, cpu, memory = [], [], []
    for i in range(n_objects):
        pods = [f"w{i}-pod-{p}" for p in range(int(rng.integers(1, 4)))]

        def quantity(resource: str):
            options = QUANTITIES[resource]
            return options[int(rng.integers(0, len(options)))]

        objects.append(
            {
                "cluster": CLUSTERS[i % 3] if i % 7 else None,
                "name": f"workload-{i // 2}",
                "container": f"c{i % 2}",
                "pods": pods,
                "namespace": ["default", "payments", "batch"][i % 3],
                "kind": ["Deployment", "StatefulSet", "Job"][i % 3],
                "allocations": {
                    "requests": {"cpu": quantity("cpu"), "memory": quantity("memory")},
                    "limits": {"cpu": quantity("cpu"), "memory": quantity("memory")},
                },
            }
        )
        empty = i % 11 == 5
        cpu.append(
            {} if empty else {
                pod: rng.gamma(2.0, 0.08, size=int(rng.integers(0, 400))).astype(np.float64)
                for pod in pods
            }
        )
        memory.append(
            {} if empty else {
                pod: np.round(rng.uniform(20e6, 3e9, size=int(rng.integers(0, 300))))
                for pod in pods
            }
        )
    return objects, {"cpu": cpu, "memory": memory}


def long_histories(histories, length: int = 9_000):
    """The fleet's histories with every non-empty pod series repeated out
    to ``length`` samples: a packed window past 1 MB (``host_stream_mb=1``)
    that still holds empty rows."""
    return {
        resource: [{pod: np.resize(s, length) if s.size else s for pod, s in row.items()} for row in rows]
        for resource, rows in histories.items()
    }


def object_key(obj) -> tuple:
    return (obj.cluster, obj.namespace, obj.name, obj.container)


class MemoryInventory:
    def __init__(self, objects):
        self.objects = objects

    async def list_clusters(self):
        return sorted({o.cluster for o in self.objects if o.cluster})

    async def list_scannable_objects(self, clusters):
        return list(self.objects)


class MemoryHistory:
    """In-memory history source: serves the shared numpy arrays keyed by
    object identity, honours the stats route (one max-sample per pod) and
    reports every third row of ``PARTIAL_CLUSTER`` as failed."""

    def __init__(self, resource_type, objects, histories, cluster):
        self.resource_type = resource_type
        self.cluster = cluster
        self.lookup = {
            resource: {object_key(obj): histories[resource][i] for i, obj in enumerate(objects)}
            for resource in histories
        }

    async def gather_fleet(
        self, objects, history_seconds, step_seconds, stats_resources=frozenset(), failed_rows=None
    ):
        out = {resource: [] for resource in self.resource_type}
        for i, obj in enumerate(objects):
            failed = self.cluster == PARTIAL_CLUSTER and i % 3 == 0
            if failed and failed_rows is not None:
                failed_rows.add(i)
            for resource in self.resource_type:
                per_pod = {} if failed else self.lookup[resource.value][object_key(obj)]
                if resource in stats_resources:
                    per_pod = {pod: np.asarray([s.max()]) for pod, s in per_pod.items() if s.size}
                out[resource].append(per_pod)
        return out


def history_factory(resource_type, objects, histories):
    def build(cluster):
        if cluster == BROKEN_CLUSTER:
            raise ConnectionError("metrics backend unreachable")
        return MemoryHistory(resource_type, objects, histories, cluster)

    return build


def jax_objects(dicts):
    return [jax_models.K8sObjectData.model_validate(d) for d in dicts]


@pytest.fixture(scope="module")
def fleet():
    dicts, histories = make_fleet()
    # The JAX objects are the source of truth; the port gets their JSON dump.
    jax_objs = jax_objects(dicts)
    return jax_objs, [o.model_dump(mode="json") for o in jax_objs], histories


def run_jax(fleet, other_args=None, **config):
    jax_objs, _dumps, histories = fleet
    cfg = jax_config.Config(quiet=True, jax_compilation_cache_dir="", other_args=other_args or {}, **config)
    runner = jax_runner.Runner(
        cfg,
        inventory=MemoryInventory(jax_objs),
        history_factory=history_factory(jax_models.ResourceType, jax_objs, histories),
    )
    return asyncio.run(runner.run())


def run_port(fleet, other_args=None, **config):
    _jax_objs, dumps, histories = fleet
    port_objs = objects_from_dicts(dumps)
    cfg = port_config.Config(quiet=True, device="cpu", other_args=other_args or {}, **config)
    runner = port_runner.Runner(
        cfg,
        inventory=MemoryInventory(port_objs),
        history_factory=history_factory(port_models.ResourceType, port_objs, histories),
        tracer=PortTracer(),
    )
    return asyncio.run(runner.run()), runner


def stages(spans) -> list:
    """The stages of one scan's trace as (name, path) in order: the
    children of its ``compute`` span."""
    (compute,) = [span for span in spans if span.name == "compute"]
    children = sorted((span for span in spans if span.parent_id == compute.span_id), key=lambda span: span.start)
    return [(span.name, span.attributes.get("path")) for span in children]


def scan_stages(runner) -> list:
    """:func:`stages` of the runner's last scan (its tracer records)."""
    return stages(runner.tracer.traces()[-1])


def render_table(result) -> str:
    console = Console(width=240, record=True, file=io.StringIO(), color_system=None)
    console.print(result.format("table"))
    return console.export_text()


#: JAX reference paths: the default (8 virtual CPU devices → the sharded
#: mesh path) and the resident single-device `fleet_exact` path.
JAX_PATHS = {"mesh": {}, "resident": {"use_mesh": False}}


@pytest.fixture(scope="module")
def scans(fleet):
    port, runner = run_port(fleet, format="json")
    return {name: run_jax(fleet, args, format="json") for name, args in JAX_PATHS.items()}, port, runner


class TestRunnerParity:
    @pytest.mark.parametrize("path", list(JAX_PATHS))
    @pytest.mark.parametrize("fmt", ["json", "yaml"])
    def test_machine_renders_byte_identical(self, scans, path, fmt):
        jax_results, port, _ = scans
        assert port.format(fmt) == jax_results[path].format(fmt)

    @pytest.mark.parametrize("path", list(JAX_PATHS))
    def test_table_render_identical(self, scans, path):
        jax_results, port, _ = scans
        assert render_table(port) == render_table(jax_results[path])

    @pytest.mark.parametrize("path", list(JAX_PATHS))
    def test_score_equal(self, scans, path):
        jax_results, port, _ = scans
        assert port.score == jax_results[path].score

    def test_fleet_scale_yaml_and_table_paths_identical(self, scans, monkeypatch):
        """Above 1,000 scans yaml and table switch to hand-rolled emitters;
        forced on at this size they render what the JAX package's render."""
        import krr_tpu.formatters.machine as jax_machine
        import krr_tpu.formatters.table as jax_table
        import krr_tpu_torch.formatters.machine as port_machine
        import krr_tpu_torch.formatters.table as port_table

        jax_results, port, _ = scans
        ref = jax_results["resident"]
        port_yaml = port_machine.fast_yaml(json.loads(port.model_dump_json()))
        assert port_yaml is not None
        assert port_yaml == jax_machine.fast_yaml(json.loads(ref.model_dump_json())) == port.format("yaml")
        monkeypatch.setattr(port_table.TableFormatter, "FAST_PATH_THRESHOLD", 0)
        monkeypatch.setattr(jax_table.TableFormatter, "FAST_PATH_THRESHOLD", 0)
        assert port.format("table") == ref.format("table")

    def test_fleet_scale_pprint_path_matches_library(self, scans):
        from pprint import pformat

        from krr_tpu_torch.formatters.machine import fast_pformat

        _jax, port, _ = scans
        data = port.model_dump()
        assert fast_pformat(data) == pformat(data) == port.format("pprint")

    def test_fleet_exercises_unknowns_and_failures(self, scans):
        _jax, port, runner = scans
        data = json.loads(port.format("json"))
        assert len(data["scans"]) == 30
        unknown = [s for s in data["scans"] if s["recommended"]["requests"]["cpu"]["value"] == "?"]
        known = [s for s in data["scans"] if s["recommended"]["requests"]["cpu"]["value"] != "?"]
        assert unknown and known
        failed = {s["object"]["cluster"] for s in unknown}
        assert {PARTIAL_CLUSTER, BROKEN_CLUSTER} <= failed
        assert runner.stats["failed_rows"] >= 10

    def test_row_chunked_scan_identical(self, fleet, scans):
        _jax, port, _ = scans
        chunked, _runner = run_port(fleet, format="json", max_fleet_rows_per_device=7)
        assert chunked.format("json") == port.format("json")

    def test_pinned_end_time_and_stdout(self, fleet, capsys):
        """The runner prints the rendered result raw on stdout."""
        result, _runner = run_port(fleet, format="yaml", scan_end_timestamp=1_700_000_000.0)
        assert capsys.readouterr().out.rstrip("\n") == result.format("yaml").rstrip("\n")


SETTINGS = [
    {"cpu_percentile": Decimal(99), "memory_buffer_percentage": Decimal(5)},
    {"cpu_percentile": Decimal(50), "memory_buffer_percentage": Decimal(15)},
    {"cpu_percentile": Decimal(100), "memory_buffer_percentage": Decimal("0.5")},
    {"cpu_percentile": Decimal("95.5"), "memory_buffer_percentage": Decimal(30)},
]


class TestRunBatchParity:
    @pytest.mark.parametrize(
        "settings", SETTINGS, ids=lambda s: f"p{s['cpu_percentile']}-b{s['memory_buffer_percentage']}"
    )
    def test_raw_decimals_identical(self, fleet, settings):
        jax_objs, dumps, histories = fleet
        jax_batch = jax_models.FleetBatch.build(
            jax_objs, {jax_models.ResourceType(k): v for k, v in histories.items()}
        )
        port_batch = fleet_batch_from_dicts(dumps, histories)
        ref = jax_simple.SimpleStrategy(
            jax_simple.SimpleStrategySettings(use_mesh=False, **settings)
        ).run_batch(jax_batch)
        port = port_simple.SimpleStrategy(
            port_simple.SimpleStrategySettings(device="cpu", **settings)
        ).run_batch(port_batch)
        assert len(port) == len(ref) == len(jax_objs)
        for p, r in zip(port, ref):
            for resource in port_models.ResourceType:
                jax_resource = jax_models.ResourceType(resource.value)
                assert str(p[resource].request) == str(r[jax_resource].request)
                assert str(p[resource].limit) == str(r[jax_resource].limit)

    def test_interop_packs_identically(self, fleet):
        jax_objs, dumps, histories = fleet
        jax_batch = jax_models.FleetBatch.build(
            jax_objs, {jax_models.ResourceType(k): v for k, v in histories.items()}
        )
        port_batch = fleet_batch_from_dicts(dumps, histories)
        for resource in port_models.ResourceType:
            ref = jax_batch.packed(jax_models.ResourceType(resource.value))
            got = port_batch.packed(resource)
            assert got.values.dtype == ref.values.dtype
            np.testing.assert_array_equal(got.values, ref.values)
            np.testing.assert_array_equal(got.counts, ref.counts)
        assert [o.model_dump(mode="json") for o in port_batch.objects] == dumps

    def test_interop_requires_every_resource(self, fleet):
        _jax_objs, dumps, histories = fleet
        with pytest.raises(ValueError, match="memory"):
            fleet_batch_from_dicts(dumps, {"cpu": histories["cpu"]})

    @pytest.mark.parametrize("q", [Decimal(99), Decimal(50)], ids=["p99-topk", "p50-radix"])
    def test_window_past_stream_threshold_streams(self, fleet, q):
        """A window past ``host_stream_mb`` streams from host memory — the
        top-K sketch at p99, the streamed radix select at p50, the streamed
        max for memory — and gives the JAX package's streamed Decimals and
        the port's resident ones."""
        jax_objs, dumps, histories = fleet
        long = long_histories(histories)
        settings = {"cpu_percentile": q, "host_stream_mb": 1}
        jax_batch = jax_models.FleetBatch.build(jax_objs, {jax_models.ResourceType(k): v for k, v in long.items()})
        ref = jax_simple.SimpleStrategy(jax_simple.SimpleStrategySettings(use_mesh=False, **settings)).run_batch(
            jax_batch
        )
        streamed = port_simple.SimpleStrategy(port_simple.SimpleStrategySettings(device="cpu", **settings))
        tracer = PortTracer()
        streamed.obs = DeviceObs(tracer)
        with tracer.span("compute"):
            port = streamed.run_batch(fleet_batch_from_dicts(dumps, long))
        resident = port_simple.SimpleStrategy(
            port_simple.SimpleStrategySettings(device="cpu", cpu_percentile=q, host_stream_mb=-1)
        ).run_batch(fleet_batch_from_dicts(dumps, long))
        assert streamed.stream_stats["chunks"] >= 8 and streamed.stream_stats["passes"] == (2 if q == 99 else 4)
        assert stages(tracer.traces()[-1]) == [("pack", None), ("quantile", "host_stream"), ("round", None)]
        assert {"host_fill_seconds", "copy_wait_seconds", "fold_seconds"} <= set(streamed.stream_stats)
        assert len(port) == len(ref) == len(resident) == len(jax_objs)
        for p, r, s in zip(port, ref, resident):
            for resource in port_models.ResourceType:
                jax_resource = jax_models.ResourceType(resource.value)
                assert str(p[resource].request) == str(r[jax_resource].request) == str(s[resource].request)
                assert str(p[resource].limit) == str(r[jax_resource].limit) == str(s[resource].limit)

    def test_per_object_run_matches_batch(self, fleet):
        _jax_objs, dumps, histories = fleet
        batch = fleet_batch_from_dicts(dumps, histories)
        strategy = port_simple.SimpleStrategy(port_simple.SimpleStrategySettings(device="cpu"))
        batched = strategy.run_batch(batch)
        for i in (0, 3, 5):
            single = strategy.run(batch.history_for(i), batch.objects[i])
            assert {k: str(v.request) for k, v in single.items()} == {
                k: str(v.request) for k, v in batched[i].items()
            }


class TestHostEdgeParity:
    @pytest.mark.parametrize(
        "value", ["0.0001", "0.1050000041723251", "2.5", "123456789", "NaN", "0", "1e-9", None]
    )
    @pytest.mark.parametrize("resource", ["cpu", "memory"])
    def test_round_value(self, value, resource):
        from krr_tpu.core.rounding import round_value as jax_round

        number = None if value is None else Decimal(value)
        got = port_rounding.round_value(number, port_models.ResourceType(resource), cpu_min_value=3, memory_min_value=7)
        ref = jax_round(number, jax_models.ResourceType(resource), cpu_min_value=3, memory_min_value=7)
        assert str(got) == str(ref)

    @pytest.mark.parametrize("quantity", ["100m", "128Mi", "2", "1.5Gi", "300M", "7k", "1e3"])
    @pytest.mark.parametrize("precision", [None, 2, 4])
    def test_resource_units(self, quantity, precision):
        from krr_tpu.utils import resource_units as jax_units

        assert port_units.parse(quantity) == jax_units.parse(quantity)
        value = port_units.parse(quantity) * 3
        assert port_units.format(value, precision) == jax_units.format(value, precision)


class TestHygiene:
    def test_port_imports_neither_jax_nor_the_jax_package(self):
        """Every module of the port, found by walking the package, and the
        port's bench scripts import no ``jax*`` and no ``krr_tpu.*`` module
        (`tests/test_torch_bench.py` runs the bench under an import blocker)."""
        code = (
            "import importlib, pkgutil, sys\n"
            "before = set(sys.modules)\n"
            "import krr_tpu_torch\n"
            "names = [m.name for m in pkgutil.walk_packages(krr_tpu_torch.__path__, 'krr_tpu_torch.')]\n"
            "for name in names + ['bench_torch', 'bench_e2e_torch']:\n"
            "    importlib.import_module(name)\n"
            "bad = sorted(m for m in set(sys.modules) - before if m.split('.')[0] in ('jax', 'jaxlib', 'krr_tpu'))\n"
            "print(len(names), bad)\n"
            "missing = {'krr_tpu_torch.federation.shard', 'krr_tpu_torch.federation.replica',"
            " 'krr_tpu_torch.ingest.plane', 'krr_tpu_torch.ingest.listener', 'krr_tpu_torch.parallel.mesh',"
            " 'krr_tpu_torch.parallel.collectives', 'krr_tpu_torch.parallel.fleet'} - set(names)\n"
            "sys.exit(1 if bad or missing or len(names) < 30 else 0)\n"
        )
        env = {**os.environ, "PYTHONPATH": str(REPO)}
        proc = subprocess.run(
            [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=120
        )
        assert proc.returncode == 0, proc.stdout + proc.stderr

    def test_registries_stay_separate(self):
        import krr_tpu.formatters.base as jax_formatters
        import krr_tpu.strategies.base as jax_strategies
        import krr_tpu_torch.formatters.base as port_formatters
        import krr_tpu_torch.strategies.base as port_strategies

        assert port_strategies.BaseStrategy.get_all()["simple"] is port_simple.SimpleStrategy
        assert jax_strategies.BaseStrategy.get_all()["simple"] is jax_simple.SimpleStrategy
        import krr_tpu.strategies.tdigest as jax_tdigest
        import krr_tpu_torch.strategies.tdigest as port_tdigest

        assert port_strategies.BaseStrategy.get_all()["tdigest"] is port_tdigest.TDigestStrategy
        assert jax_strategies.BaseStrategy.get_all()["tdigest"] is jax_tdigest.TDigestStrategy
        assert jax_formatters.BaseFormatter.find("json").__module__.startswith("krr_tpu.")
        assert port_formatters.BaseFormatter.find("json").__module__.startswith("krr_tpu_torch.")

    def test_default_device_raises_without_a_card(self, monkeypatch, fleet):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="cuda"):
            port_simple.SimpleStrategy(port_simple.SimpleStrategySettings())
        _jax_objs, dumps, histories = fleet
        objects = objects_from_dicts(dumps)
        with pytest.raises(RuntimeError, match="cuda"):
            port_runner.Runner(
                port_config.Config(quiet=True),
                inventory=MemoryInventory(objects),
                history_factory=history_factory(port_models.ResourceType, objects, histories),
            )
        assert port_simple.SimpleStrategySettings().device == "cuda"
        assert port_config.Config().device == "cuda"

    def test_other_args_device_wins(self):
        strategy = port_config.Config(device="cuda", other_args={"device": "cpu"}).create_strategy()
        assert strategy.device == torch.device("cpu")
