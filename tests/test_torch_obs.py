"""The port's observability core held against the JAX package's.

The SLO engine is fed the same event sequence under one injected clock in
both packages; the padding gauges come from the same fleet packed by each;
the compile family is fed one build in each (the JAX listener a
``backend_compile`` duration and cache events, the port's nvcc build
hook a build, a miss and a hit) and rendered. Stage spans are read from a
recording tracer around each strategy's ``Runner`` scan on the CPU, beside
the JAX package's resident path. The debug dump and the JSON log channel
are checked on the port alone, and the log lines' keys against the JAX
CLI's; the log lines' ``ts`` and the timings inside a message are the only
values not compared.
"""

from __future__ import annotations

import asyncio
import json
import os
import signal
import types

import numpy as np
import pytest
import torch
from click.testing import CliRunner

import krr_tpu.core.config as jax_config
import krr_tpu.core.runner as jax_runner
import krr_tpu.models as jax_models
import krr_tpu.obs.device as jax_device
import krr_tpu_torch.core.config as port_config
import krr_tpu_torch.core.runner as port_runner
import krr_tpu_torch.models as port_models
import krr_tpu_torch.obs.device as port_device
from krr_tpu import main as jax_main
from krr_tpu.obs.health import default_objectives as jax_default_objectives
from krr_tpu.obs.health import engine_from_config as jax_engine_from_config
from krr_tpu.obs.health import SloEngine as JaxSloEngine
from krr_tpu.obs.metrics import MetricsRegistry as JaxRegistry
from krr_tpu.obs.trace import Tracer as JaxTracer
from krr_tpu_torch import main as port_main
from krr_tpu_torch.models.interop import fleet_batch_from_dicts, objects_from_dicts
from krr_tpu_torch.obs import dump as port_dump
from krr_tpu_torch.obs.health import SloEngine as PortSloEngine
from krr_tpu_torch.obs.health import default_objectives as port_default_objectives
from krr_tpu_torch.obs.health import engine_from_config as port_engine_from_config
from krr_tpu_torch.obs.metrics import MetricsRegistry as PortRegistry
from krr_tpu_torch.obs.trace import NULL_TRACER
from krr_tpu_torch.obs.trace import Tracer as PortTracer
from krr_tpu_torch.ops import cuda_build

from .test_integrations import fake_env  # noqa: F401  (module-scoped fixture)
from .test_torch_simple import MemoryInventory, fleet, history_factory  # noqa: F401


def samples(render: str, prefix: str) -> list[str]:
    """The exposition's sample and TYPE lines of the families under
    ``prefix`` (HELP text may say what the port measures)."""
    return [
        line for line in render.splitlines()
        if line.startswith(prefix) or (line.startswith("# TYPE " + prefix))
    ]


# ---------------------------------------------------------------- SLO engine
#: (seconds after the start, counter increments) — scans, failures and
#: fetches over an hour and a half: an outage that fires the scan-failure
#: and fetch objectives, then recovery.
EVENTS = [
    (60, {"krr_tpu_scans_total": 1, "krr_tpu_fetch_rows_total": 100}),
    (120, {"krr_tpu_scans_total": 1, "krr_tpu_fetch_rows_total": 100, "krr_tpu_fetch_failed_rows_total": 3}),
    (180, {"krr_tpu_scan_failures_total": 1}),
    (240, {"krr_tpu_scan_failures_total": 1, "krr_tpu_fetch_rows_total": 100,
           "krr_tpu_fetch_failed_rows_total": 100}),
    (300, {"krr_tpu_scan_failures_total": 1, "krr_tpu_fetch_rows_total": 100,
           "krr_tpu_fetch_failed_rows_total": 100}),
    (900, {"krr_tpu_scans_total": 1, "krr_tpu_fetch_rows_total": 100}),
    (1500, {"krr_tpu_scans_total": 1, "krr_tpu_fetch_rows_total": 100}),
    (4000, {"krr_tpu_scans_total": 1, "krr_tpu_fetch_rows_total": 100}),
    (5600, {"krr_tpu_scans_total": 1, "krr_tpu_fetch_rows_total": 100}),
]
T0 = 1_700_000_000.0


def _engines():
    now = [T0]
    engines = []
    for registry_type, objectives, engine_type in (
        (JaxRegistry, jax_default_objectives, JaxSloEngine),
        (PortRegistry, port_default_objectives, PortSloEngine),
    ):
        registry = registry_type()
        engine = engine_type(
            objectives(
                registry, scan_failure_budget=0.05, fetch_failure_budget=0.05,
                scan_latency_seconds=30.0, freshness_seconds=600.0, read_p99_seconds=0.5,
                clock=lambda: now[0],
            ),
            registry,
            clock=lambda: now[0],
        )
        engines.append((registry, engine))
    return now, engines


def test_slo_engine_status_and_text_equal_jax():
    now, engines = _engines()
    walls = iter([12.0, 45.0, 8.0, 50.0, 9.0, 20.0])
    for offset, increments in EVENTS:
        now[0] = T0 + offset
        wall = next(walls, 5.0) if "krr_tpu_scans_total" in increments else None
        transitions = []
        for registry, engine in engines:
            for name, amount in increments.items():
                registry.inc(name, amount, **({"kind": "cli"} if name == "krr_tpu_scans_total" else {}))
            if wall is not None:
                registry.set("krr_tpu_scan_duration_seconds", wall, phase="fetch")
                registry.set("krr_tpu_last_scan_timestamp_seconds", now[0] - 30.0)
            transitions.append(engine.evaluate())
        assert transitions[0] == transitions[1]
        (_, jax_engine), (_, port_engine) = engines
        assert port_engine.status(now[0]) == jax_engine.status(now[0])
        assert port_engine.render_text(now[0]) == jax_engine.render_text(now[0])
        assert port_engine.firing() == jax_engine.firing()
    (jax_registry, _), (port_registry, _) = engines
    assert samples(port_registry.render(), "krr_tpu_slo_") == samples(jax_registry.render(), "krr_tpu_slo_")
    fired = [name for name, _ in engines[1][1]._state.items() if engines[1][1]._state[name].since is not None]
    assert {"scan_failures", "fetch_failed_rows"} <= set(fired)


@pytest.mark.parametrize("pinned", [False, True])
@pytest.mark.parametrize("one_shot", [False, True])
def test_engine_from_config_equals_jax(one_shot, pinned):
    knobs = dict(
        slo_scan_failure_budget=0.1, slo_fetch_failure_budget=0.02, slo_scan_latency_seconds=0.0,
        slo_freshness_seconds=120.0, slo_fast_window_seconds=60.0, slo_slow_window_seconds=600.0,
        slo_fast_burn=8.0, slo_slow_burn=3.0, slo_read_p99_seconds=0.25,
        scan_end_timestamp=T0 if pinned else None,
    )
    clock = lambda: T0 + 42.0  # noqa: E731
    jax_registry, port_registry = JaxRegistry(), PortRegistry()
    jax_engine = jax_engine_from_config(
        jax_registry, jax_config.Config(quiet=True, **knobs), one_shot=one_shot, clock=clock
    )
    port_engine = port_engine_from_config(
        port_registry, port_config.Config(quiet=True, **knobs), one_shot=one_shot, clock=clock
    )
    fields = ("fast_window_seconds", "slow_window_seconds", "fast_burn_threshold", "slow_burn_threshold",
              "min_slow_bad_events")
    assert [getattr(port_engine, f) for f in fields] == [getattr(jax_engine, f) for f in fields]
    shape = lambda engine: [(o.name, o.description, o.budget, o.limit) for o in engine.objectives]  # noqa: E731
    assert shape(port_engine) == shape(jax_engine)
    for registry in (jax_registry, port_registry):
        registry.inc("krr_tpu_scans_total", kind="cli")
        registry.inc("krr_tpu_fetch_rows_total", 10)
        registry.inc("krr_tpu_fetch_failed_rows_total", 10)
        registry.set("krr_tpu_scan_duration_seconds", 2000.0, phase="fetch")
        registry.set("krr_tpu_last_scan_timestamp_seconds", T0 - 500.0)
    assert port_engine.evaluate(T0 + 42.0) == jax_engine.evaluate(T0 + 42.0)
    assert port_engine.status() == jax_engine.status()
    assert port_engine.render_text() == jax_engine.render_text()


# ----------------------------------------------------------- device gauges
def test_record_padding_gauges_equal_jax(fleet):  # noqa: F811
    jax_objs, dumps, histories = fleet
    jax_batch = jax_models.FleetBatch.build(jax_objs, {jax_models.ResourceType(k): v for k, v in histories.items()})
    port_batch = fleet_batch_from_dicts(dumps, histories)
    jax_registry, port_registry = JaxRegistry(), PortRegistry()
    jax_obs = jax_device.DeviceObs(metrics=jax_registry)
    port_obs = port_device.DeviceObs(metrics=port_registry)
    for resource in ("cpu", "memory"):
        jax_obs.record_padding(resource, jax_batch.packed(jax_models.ResourceType(resource)))
        port_obs.record_padding(resource, port_batch.packed(port_models.ResourceType(resource)))
    for family in ("krr_tpu_pad_waste_pct", "krr_tpu_packed_elements"):
        want = samples(jax_registry.render(), family)
        assert len(want) > 2 and samples(port_registry.render(), family) == want


def test_null_tracer_fence_is_identity_and_stage_is_the_shared_noop():
    obs = port_device.DeviceObs(NULL_TRACER, PortRegistry())
    value = (torch.arange(4.0), np.zeros(3))
    assert obs.fence(value) is value
    assert obs.stage("pack", rows=3) is NULL_TRACER.span("anything")
    assert port_device.NULL_DEVICE_OBS.stage("round") is NULL_TRACER.span("x")
    # Recording, the fence still hands back its argument (host tensors need
    # no wait) and a stage is a real span.
    recording = port_device.DeviceObs(PortTracer(), PortRegistry())
    assert recording.fence(value) is value
    assert recording.stage("pack") is not NULL_TRACER.span("x")
    # A strategy on the CPU records no device memory.
    recording.record_device_memory(torch.device("cpu"))
    assert "krr_tpu_device_memory_bytes{" not in recording.metrics.render()


def test_build_hook_gives_the_jax_compile_lines(monkeypatch, tmp_path):
    """One nvcc build (through ``build_all``, with the compiler stubbed),
    then a ``load`` that finds the library built, give the exposition lines
    the JAX listener gives for a ``backend_compile`` duration, one cache
    miss and one cache hit."""
    jax_registry, port_registry = JaxRegistry(), PortRegistry()
    port_device.install_compile_hooks(port_registry)

    class Compiler:
        """``nvcc`` stand-in: writes the library it was asked for."""

        def __init__(self, cmd, **_kwargs):
            self.out = cmd[cmd.index("-o") + 1]
            self.returncode = 0

        def communicate(self):
            with open(self.out, "wb") as f:
                f.write(b"\0")
            return "", None

    library = tmp_path / "libselect-test.so"
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(cuda_build, "library_path", lambda name: library)
    monkeypatch.setattr(cuda_build, "nvcc_path", lambda: "nvcc")
    monkeypatch.setattr(cuda_build.subprocess, "Popen", Compiler)
    clock = iter([100.0])  # the build starts at 100 s and ends 1.5 s later
    monkeypatch.setattr(cuda_build, "time", types.SimpleNamespace(perf_counter=lambda: next(clock, 101.5)))
    before = port_device.compile_seconds_total()
    cuda_build.build_all(["select"])
    assert library.exists()
    assert port_device.compile_seconds_total() - before == pytest.approx(1.5)
    monkeypatch.setattr(cuda_build, "_LOADED", {})
    monkeypatch.setattr(cuda_build.ctypes, "CDLL", lambda path: types.SimpleNamespace(
        krr_error_string=types.SimpleNamespace()))
    cuda_build.load("select", {})

    jax_device.install_compile_hooks(jax_registry)
    try:
        jax_device._on_duration("/jax/core/compile/backend_compile_duration", 1.5)
        jax_device._on_event("/jax/compilation_cache/cache_misses")
        jax_device._on_event("/jax/compilation_cache/cache_hits")
    finally:
        jax_device._target = None
    want = samples(jax_registry.render(), "krr_tpu_compile_")
    assert any("phase=\"backend_compile\"" in line for line in want)
    assert samples(port_registry.render(), "krr_tpu_compile_") == want


# --------------------------------------------------------------- stage spans
def _compute_children(tracer) -> tuple:
    (spans,) = tracer.traces()
    by_name = {}
    for span in spans:
        by_name.setdefault(span.name, []).append(span)
    (compute,) = by_name["compute"]
    children = sorted((s for s in spans if s.parent_id == compute.span_id), key=lambda s: s.start)
    return compute, [
        (s.name, {k: s.attributes[k] for k in ("rows", "path", "sketch") if k in s.attributes}) for s in children
    ]


@pytest.mark.parametrize("strategy, args", [
    ("simple", {}), ("tdigest", {}), ("tdigest", {"exact_upgrade": True}),
], ids=["simple", "tdigest", "exact_upgrade"])
def test_stage_spans_are_children_of_compute(fleet, strategy, args):  # noqa: F811
    jax_objs, dumps, histories = fleet
    port_objs = objects_from_dicts(dumps)
    port_tracer = PortTracer()
    runner = port_runner.Runner(
        port_config.Config(quiet=True, device="cpu", strategy=strategy, other_args=args),
        inventory=MemoryInventory(port_objs),
        history_factory=history_factory(port_models.ResourceType, port_objs, histories),
        tracer=port_tracer,
    )
    asyncio.run(runner.run())
    jax_tracer = JaxTracer()
    asyncio.run(jax_runner.Runner(
        jax_config.Config(quiet=True, jax_compilation_cache_dir="", strategy=strategy,
                          other_args={"use_mesh": False, **args}),
        inventory=MemoryInventory(jax_objs),
        history_factory=history_factory(jax_models.ResourceType, jax_objs, histories),
        tracer=jax_tracer,
    ).run())
    compute, stages = _compute_children(port_tracer)
    _, jax_stages = _compute_children(jax_tracer)
    # ``cast``, once per resource, and ``h2d``, once per row block inside
    # ``digest`` or ``quantile``, are the port's own: the JAX package's
    # transfer lies in no stage.
    assert [stage for stage in stages if stage[0] not in ("cast", "h2d")] == jax_stages
    names = [name for name, _ in stages]
    digest = ["digest"] if strategy == "tdigest" else []
    assert names == ["pack", "cast", "cast", *digest, "quantile", "round"]
    assert dict(stages)["quantile"]["path"] == "resident"


def test_stage_spans_on_the_host_stream_and_store_paths(fleet, tmp_path):  # noqa: F811
    _jax_objs, dumps, histories = fleet
    port_objs = objects_from_dicts(dumps)
    long = {r: [{p: np.resize(s, 9_000) if s.size else s for p, s in row.items()} for row in rows]
            for r, rows in histories.items()}
    for args, want in (
        ({"host_stream_mb": 1}, [("pack", None), ("quantile", "host_stream"), ("round", None)]),
        ({"state_path": str(tmp_path / "state")},
         [("pack", None), ("digest", None), ("fold", None), ("quantile", "store"), ("persist", None),
          ("round", None)]),
    ):
        tracer = PortTracer()
        runner = port_runner.Runner(
            port_config.Config(quiet=True, device="cpu", strategy="tdigest", other_args=args),
            inventory=MemoryInventory(port_objs),
            history_factory=history_factory(port_models.ResourceType, port_objs, long),
            tracer=tracer,
        )
        asyncio.run(runner.run())
        _compute, stages = _compute_children(tracer)
        assert [(name, attrs.get("path")) for name, attrs in stages] == want


# ------------------------------------------------------------------- dumps
def test_debug_dump_writes_three_files_and_counts(tmp_path, monkeypatch):
    tracer, registry = PortTracer(), PortRegistry()
    with tracer.span("scan", kind="cli"):
        with tracer.span("compute"):
            pass
    paths = port_dump.debug_dump(
        tracer, registry, device="cpu", trace_target=str(tmp_path / "t.json"),
        metrics_target=str(tmp_path / "m.prom"),
    )
    assert len(paths) == 3 and all(os.path.dirname(p) == str(tmp_path) for p in paths)
    trace_path, metrics_path, profile_path = paths
    assert os.path.basename(trace_path).startswith("t.json.") and trace_path.endswith(".json")
    assert os.path.basename(metrics_path).startswith("m.prom.") and metrics_path.endswith(".prom")
    assert profile_path.endswith(".profile.json")
    assert {e["name"] for e in json.load(open(trace_path))["traceEvents"] if e["ph"] == "X"} == {"scan", "compute"}
    assert json.load(open(profile_path))["aggregate"]["scan_count"] == 1
    assert "krr_tpu_debug_dumps_total 1" in open(metrics_path).read().splitlines()
    # The one-shot flavour: SIGUSR2 writes the same three files in the
    # working directory.
    monkeypatch.chdir(tmp_path)
    previous = signal.getsignal(signal.SIGUSR2)
    try:
        assert port_dump.install_signal_dump(tracer, registry, device="cpu")
        os.kill(os.getpid(), signal.SIGUSR2)
    finally:
        signal.signal(signal.SIGUSR2, previous)
    assert registry.value("krr_tpu_debug_dumps_total") == 2
    written = sorted(os.listdir(tmp_path))
    for stem in ("krr-tpu-trace.", "krr-tpu-metrics.", "krr-tpu-profile."):
        assert sum(name.startswith(stem) for name in written) == 1


# ------------------------------------------------------------- JSON log lines
def _stderr_lines(app, args) -> list[dict]:
    result = CliRunner().invoke(app, args, catch_exceptions=False)
    assert result.exit_code == 0, result.output
    return [json.loads(line) for line in result.stderr.splitlines()]


def test_log_format_json_lines_carry_the_trace_scan_id(fake_env, tmp_path):  # noqa: F811
    jax_main.load_commands()
    port_main.load_commands()
    common = ["simple", "--kubeconfig", fake_env["kubeconfig"], "-p", fake_env["server"].url, "-f", "json",
              "--logtostderr", "--log-format", "json"]
    trace = tmp_path / "trace.json"
    port = _stderr_lines(port_main.app, [*common, "--device", "cpu", "--trace", str(trace)])
    jax = _stderr_lines(jax_main.app, [*common, "--trace", str(tmp_path / "jax.json")])
    events = [e for e in json.loads(trace.read_text())["traceEvents"] if e["ph"] == "X"]
    (root,) = [e for e in events if e["name"] == "scan"]
    scan_id = root["args"]["trace_id"]
    span_ids = {e["args"]["span_id"] for e in events}
    keys = lambda lines: {frozenset(line) for line in lines}  # noqa: E731
    assert keys(port) == keys(jax) == {
        frozenset({"ts", "level", "message"}), frozenset({"ts", "level", "message", "scan_id", "span_id"}),
    }
    # The greeting precedes the scan span in both packages; every line
    # after it carries the trace's scan id and one of its spans.
    greeting = [line for line in port if "scan_id" not in line]
    assert [line["message"].split(" ")[0] for line in greeting] == ["Running", "Using", "Using"]
    scanned = [line for line in port if "scan_id" in line]
    assert scanned and {line["scan_id"] for line in scanned} == {scan_id}
    assert {line["span_id"] for line in scanned} <= span_ids
    assert [line["level"] for line in port] == [line["level"] for line in jax]
    # Messages but their timings: "Found N scannable objects", "Scanned …".
    head = lambda lines: [line["message"].split(":")[0] for line in lines if "scan_id" in line]  # noqa: E731
    assert head(scanned) == head(jax)
