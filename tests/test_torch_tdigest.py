"""The port's one-shot `tdigest` scan held against the JAX package's.

The fleet, the sources and the JAX↔port plumbing are those of
`tests/test_torch_simple.py` (~30 objects of 1–3 pods over three clusters,
ragged, some empty, per-row fetch failures and a broken cluster). The
`tdigest` strategy asks for no stats route, so both runners fold the full
raw memory window. The port runs with ``device="cpu"`` (its plain PyTorch
versions). Rendered bytes are compared exactly; raw CPU Decimals of the
digest path are compared to within two float32 ulps (see
``test_raw_decimals``), everything else exactly.
"""

from __future__ import annotations

import asyncio
from decimal import Decimal

import numpy as np
import pytest
import torch

import krr_tpu.core.config as jax_config
import krr_tpu.core.runner as jax_runner
import krr_tpu.models as jax_models
import krr_tpu.models.series as jax_series
import krr_tpu.strategies.tdigest as jax_tdigest
import krr_tpu_torch.core.config as port_config
import krr_tpu_torch.core.runner as port_runner
import krr_tpu_torch.models as port_models
import krr_tpu_torch.models.series as port_series
import krr_tpu_torch.strategies.tdigest as port_tdigest
from krr_tpu_torch.models.interop import fleet_batch_from_dicts, objects_from_dicts
from krr_tpu_torch.obs.trace import Tracer as PortTracer
from krr_tpu_torch.ops import digest as port_digest
from krr_tpu_torch.ops import topk_sketch as port_topk
from tests.test_torch_simple import (
    JAX_PATHS,
    MemoryInventory,
    history_factory,
    jax_objects,
    long_histories,
    make_fleet,
    render_table,
    scan_stages,
)

#: The two one-shot sketch paths: the default log-bucket digest and the
#: exact top-K sketch.
SKETCHES = {"digest": {}, "exact_upgrade": {"exact_upgrade": True}}


@pytest.fixture(scope="module")
def fleet():
    dicts, histories = make_fleet(seed=11)
    jax_objs = jax_objects(dicts)
    return jax_objs, [o.model_dump(mode="json") for o in jax_objs], histories


def run_jax(fleet, other_args, **config):
    jax_objs, _dumps, histories = fleet
    cfg = jax_config.Config(
        quiet=True, strategy="tdigest", jax_compilation_cache_dir="", other_args=other_args, **config
    )
    runner = jax_runner.Runner(
        cfg,
        inventory=MemoryInventory(jax_objs),
        history_factory=history_factory(jax_models.ResourceType, jax_objs, histories),
    )
    return asyncio.run(runner.run())


def run_port(fleet, other_args, strategy="tdigest", **config):
    _jax_objs, dumps, histories = fleet
    port_objs = objects_from_dicts(dumps)
    cfg = port_config.Config(quiet=True, device="cpu", strategy=strategy, other_args=other_args, **config)
    runner = port_runner.Runner(
        cfg,
        inventory=MemoryInventory(port_objs),
        history_factory=history_factory(port_models.ResourceType, port_objs, histories),
        tracer=PortTracer(),
    )
    return asyncio.run(runner.run()), runner


@pytest.fixture(scope="module")
def scans(fleet):
    out = {}
    for sketch, args in SKETCHES.items():
        port, runner = run_port(fleet, args, format="json")
        jax = {path: run_jax(fleet, {**args, **extra}, format="json") for path, extra in JAX_PATHS.items()}
        out[sketch] = (jax, port, runner)
    return out


class TestRunnerParity:
    @pytest.mark.parametrize("path", list(JAX_PATHS))
    @pytest.mark.parametrize("sketch", list(SKETCHES))
    @pytest.mark.parametrize("fmt", ["json", "yaml"])
    def test_machine_renders_byte_identical(self, scans, sketch, path, fmt):
        jax_results, port, _ = scans[sketch]
        assert port.format(fmt) == jax_results[path].format(fmt)

    @pytest.mark.parametrize("path", list(JAX_PATHS))
    @pytest.mark.parametrize("sketch", list(SKETCHES))
    def test_table_render_identical(self, scans, sketch, path):
        jax_results, port, _ = scans[sketch]
        assert render_table(port) == render_table(jax_results[path])

    @pytest.mark.parametrize("sketch", list(SKETCHES))
    def test_score_equal(self, scans, sketch):
        jax_results, port, _ = scans[sketch]
        assert port.score == jax_results["resident"].score

    @pytest.mark.parametrize("sketch", list(SKETCHES))
    def test_fleet_has_known_and_unknown_rows(self, scans, sketch):
        _jax, port, runner = scans[sketch]
        values = [s.recommended.requests[port_models.ResourceType.CPU].value for s in port.scans]
        assert any(v == "?" for v in values) and any(v != "?" for v in values)
        assert runner.stats["failed_rows"] >= 10
        assert scan_stages(runner) == [("pack", None), ("cast", None), ("cast", None),
                                       ("digest", None), ("quantile", "resident"), ("round", None)]

    @pytest.mark.parametrize("sketch", list(SKETCHES))
    def test_row_chunked_scan_identical(self, fleet, scans, sketch):
        _jax, port, _ = scans[sketch]
        chunked, _runner = run_port(fleet, SKETCHES[sketch], format="json", max_fleet_rows_per_device=7)
        assert chunked.format("json") == port.format("json")


class TestAgainstSimple:
    def test_exact_upgrade_equals_simple(self, fleet, scans):
        """The exact top-K sketch answers the same sample as the bisection:
        the renders equal the port's `simple` scan's (whose memory comes
        through the stats route, one max per pod — the same max)."""
        _jax, exact, _ = scans["exact_upgrade"]
        simple, _runner = run_port(fleet, {}, strategy="simple", format="json")
        assert exact.format("json") == simple.format("json")

    def test_digest_memory_equals_simple(self, fleet, scans):
        _jax, digest, _ = scans["digest"]
        simple, _runner = run_port(fleet, {}, strategy="simple", format="json")
        memory = port_models.ResourceType.Memory
        for d, s in zip(digest.scans, simple.scans):
            assert d.recommended.requests[memory] == s.recommended.requests[memory]
            assert d.recommended.limits[memory] == s.recommended.limits[memory]


SETTINGS = [
    {"cpu_percentile": Decimal(99), "memory_buffer_percentage": Decimal(5)},
    {"cpu_percentile": Decimal(50), "memory_buffer_percentage": Decimal(15)},
    {"cpu_percentile": Decimal("95.5"), "memory_buffer_percentage": Decimal(30), "digest_buckets": 1000},
]


def ulps_apart(a: str, b: str) -> int:
    if a == b:
        return 0
    x, y = np.float32(float(a)), np.float32(float(b))
    return abs(int(x.view(np.int32)) - int(y.view(np.int32)))


class TestRunBatchParity:
    @pytest.mark.parametrize("sketch", list(SKETCHES))
    @pytest.mark.parametrize(
        "settings", SETTINGS, ids=lambda s: f"p{s['cpu_percentile']}-b{s['memory_buffer_percentage']}"
    )
    def test_raw_decimals(self, fleet, settings, sketch):
        """Memory and the exact sketch's CPU are identical. The digest's CPU
        estimate is ``min_value·exp((k − 0.5)·log γ)`` in float32, and
        PyTorch's ``exp`` and XLA's CPU ``exp`` differ by one or two ulps on
        some buckets (224 of 2,560 at the default spec): the tolerance there
        is two float32 ulps, which also pins the bucket (neighbouring
        estimates lie a factor γ apart). On this fleet 3 of 30 rows at p99 and 4 at
        p50 differ by that ulp; none changes a rendered byte."""
        jax_objs, dumps, histories = fleet
        jax_batch = jax_models.FleetBatch.build(
            jax_objs, {jax_models.ResourceType(k): v for k, v in histories.items()}
        )
        args = {**settings, **SKETCHES[sketch]}
        ref = jax_tdigest.TDigestStrategy(
            jax_tdigest.TDigestStrategySettings(use_mesh=False, **args)
        ).run_batch(jax_batch)
        port = port_tdigest.TDigestStrategy(
            port_tdigest.TDigestStrategySettings(device="cpu", **args)
        ).run_batch(fleet_batch_from_dicts(dumps, histories))
        assert len(port) == len(ref) == len(jax_objs)
        cpu_apart = []
        for p, r in zip(port, ref):
            for resource in port_models.ResourceType:
                jax_resource = jax_models.ResourceType(resource.value)
                got, want = p[resource], r[jax_resource]
                assert str(got.limit) == str(want.limit)
                if resource == port_models.ResourceType.CPU and sketch == "digest":
                    cpu_apart.append(ulps_apart(str(got.request), str(want.request)))
                else:
                    assert str(got.request) == str(want.request)
        assert max(cpu_apart, default=0) <= 2

    def test_default_never_builds_the_topk_sketch(self, fleet, monkeypatch):
        def forbidden(*args, **kwargs):
            raise AssertionError("the default tdigest path built the top-K sketch")

        monkeypatch.setattr(port_topk, "build_from_packed", forbidden)
        _jax_objs, dumps, histories = fleet
        strategy = port_tdigest.TDigestStrategy(port_tdigest.TDigestStrategySettings(device="cpu"))
        assert len(strategy.run_batch(fleet_batch_from_dicts(dumps, histories))) == len(dumps)

    def test_exact_upgrade_never_builds_the_digest(self, fleet, monkeypatch):
        def forbidden(*args, **kwargs):
            raise AssertionError("exact_upgrade built the histogram digest")

        monkeypatch.setattr(port_digest, "build_from_packed", forbidden)
        _jax_objs, dumps, histories = fleet
        strategy = port_tdigest.TDigestStrategy(
            port_tdigest.TDigestStrategySettings(device="cpu", exact_upgrade=True)
        )
        assert len(strategy.run_batch(fleet_batch_from_dicts(dumps, histories))) == len(dumps)

    def test_budget_too_small_takes_the_digest(self, fleet, monkeypatch):
        """exact_upgrade past exact_sketch_budget keeps the digest (the
        shared cut-over, as in the JAX package)."""
        def forbidden(*args, **kwargs):
            raise AssertionError("the top-K sketch was built past its budget")

        monkeypatch.setattr(port_topk, "build_from_packed", forbidden)
        _jax_objs, dumps, histories = fleet
        strategy = port_tdigest.TDigestStrategy(
            port_tdigest.TDigestStrategySettings(device="cpu", exact_upgrade=True, exact_sketch_budget=0)
        )
        strategy.run_batch(fleet_batch_from_dicts(dumps, histories))


class TestNotPortedYet:
    """The two settings that raised ``NotImplementedError`` until the
    incremental tdigest path was ported (the test keeps its name): each now
    builds a strategy whose run gives the JAX package's raw Decimals —
    ``state_path`` through ``run_batch`` into a fresh store, ``digest_ingest``
    through ``run_digested`` on the fleet digested by each package's own
    ``fold_histories``."""

    @pytest.mark.parametrize(
        "args, item",
        [({"state_path": "state"}, "state_path"), ({"digest_ingest": True}, "digest_ingest")],
        ids=["state_path", "digest_ingest"],
    )
    def test_settings_raise(self, fleet, tmp_path, args, item):
        jax_objs, dumps, histories = fleet
        if item == "state_path":
            args = {"state_path": str(tmp_path / "state")}
        port = port_tdigest.TDigestStrategy(port_tdigest.TDigestStrategySettings(device="cpu", **args))
        jax = jax_tdigest.TDigestStrategy(
            jax_tdigest.TDigestStrategySettings(use_mesh=False, **{**args, "state_path": args.get("state_path")
                                                                   and str(tmp_path / "jax-state")})
        )
        jax_fetched = {jax_models.ResourceType(k): v for k, v in histories.items()}
        if item == "state_path":
            ref = jax.run_batch(jax_models.FleetBatch.build(jax_objs, jax_fetched))
            got = port.run_batch(fleet_batch_from_dicts(dumps, histories))
            assert port.store_stats["epoch"] == 1 and port.store_stats["rows"] == len(dumps)
        else:
            spec = port.settings.cpu_spec()
            port_objs = objects_from_dicts(dumps)
            fleets = []
            for runner, series, objects, fetched in (
                (jax_runner, jax_series, jax_objs, jax_fetched),
                (port_runner, port_series, port_objs, {port_models.ResourceType(k): v for k, v in histories.items()}),
            ):
                digested = series.DigestedFleet.empty(objects, spec.gamma, spec.min_value, spec.num_buckets)
                runner.fold_histories(digested, range(len(objects)), fetched, spec)
                fleets.append(digested)
            ref, got = jax.run_digested(fleets[0]), port.run_digested(fleets[1])
        assert len(got) == len(ref) == len(dumps)
        for p, r in zip(got, ref):
            for resource in port_models.ResourceType:
                want = r[jax_models.ResourceType(resource.value)]
                assert (str(p[resource].request), str(p[resource].limit)) == (str(want.request), str(want.limit))


class TestHostStream:
    @pytest.mark.parametrize("sketch", list(SKETCHES))
    def test_window_past_stream_threshold_streams(self, fleet, sketch):
        """A window past ``host_stream_mb`` streams from host memory in
        ``chunk_size`` chunks (the digest or the top-K sketch, and the
        streamed memory max): the port's resident Decimals exactly, and the
        JAX package's streamed ones — memory and the exact sketch exactly,
        the digest's CPU within two float32 ulps (``test_raw_decimals``)."""
        jax_objs, dumps, histories = fleet
        long = long_histories(histories)
        args = {**SKETCHES[sketch], "host_stream_mb": 1, "chunk_size": 4096}
        jax_batch = jax_models.FleetBatch.build(jax_objs, {jax_models.ResourceType(k): v for k, v in long.items()})
        ref = jax_tdigest.TDigestStrategy(jax_tdigest.TDigestStrategySettings(use_mesh=False, **args)).run_batch(
            jax_batch
        )
        streamed = port_tdigest.TDigestStrategy(port_tdigest.TDigestStrategySettings(device="cpu", **args))
        port = streamed.run_batch(fleet_batch_from_dicts(dumps, long))
        resident = port_tdigest.TDigestStrategy(
            port_tdigest.TDigestStrategySettings(device="cpu", **{**args, "host_stream_mb": -1})
        ).run_batch(fleet_batch_from_dicts(dumps, long))
        assert streamed.stream_stats["passes"] == 2 and streamed.stream_stats["chunks"] >= 14
        assert len(port) == len(ref) == len(resident) == len(jax_objs)
        cpu_apart = []
        for p, r, s in zip(port, ref, resident):
            for resource in port_models.ResourceType:
                jax_resource = jax_models.ResourceType(resource.value)
                assert str(p[resource].request) == str(s[resource].request)
                assert str(p[resource].limit) == str(s[resource].limit) == str(r[jax_resource].limit)
                if resource == port_models.ResourceType.CPU and sketch == "digest":
                    cpu_apart.append(ulps_apart(str(p[resource].request), str(r[jax_resource].request)))
                else:
                    assert str(p[resource].request) == str(r[jax_resource].request)
        assert max(cpu_apart, default=0) <= 2


class TestSettings:
    def test_fields_and_defaults_match_the_jax_package(self):
        jax_fields = jax_tdigest.TDigestStrategySettings.model_fields
        port_fields = port_tdigest.TDigestStrategySettings.model_fields
        own = ["digest_gamma", "digest_buckets", "chunk_size", "digest_ingest", "exact_upgrade",
               "state_path", "store_format", "exact_sketch_budget", "cpu_percentile",
               "memory_buffer_percentage", "host_stream_mb", "history_duration", "timeframe_duration"]
        for name in own:
            assert port_fields[name].default == jax_fields[name].default, name
        assert port_tdigest.TDigestStrategySettings().cpu_spec() == port_digest.DigestSpec()

    def test_device_defaults_to_cuda_and_raises_without_a_card(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        assert port_tdigest.TDigestStrategySettings().device == "cuda"
        with pytest.raises(RuntimeError, match="cuda"):
            port_tdigest.TDigestStrategy(port_tdigest.TDigestStrategySettings())
        with pytest.raises(RuntimeError, match="cuda"):
            port_config.Config(quiet=True, strategy="tdigest").create_strategy()
