"""The port's CLI against the JAX package's, on the same fake cluster.

Both ``app``s run in-process through click's ``CliRunner`` against the fake
apiserver + fake Prometheus of ``tests/test_integrations.py`` (the port with
``--device cpu``: its plain PyTorch versions). Machine formats and the table
are compared byte for byte on stdout with ``-q`` (the greetings differ), for
every strategy path and fetch option; flag names and boolean defaults are
held to the JAX command's. ``serve`` and ``diff`` are held to the JAX
commands' flags and defaults; ``diff`` and ``analyze --trend`` print the JAX
commands' stdout. The last tests prove that without ``--device cpu`` the
port asks for the card and refuses to scan or serve here.
"""

from __future__ import annotations

import asyncio
import json
import os
import subprocess
import sys

import click
import numpy as np
import pytest
import torch
import yaml
from click.testing import CliRunner

from krr_tpu import main as jax_main
from krr_tpu.strategies.base import BaseStrategy as JaxBaseStrategy
from krr_tpu_torch import main as port_main
from krr_tpu_torch.core.config import Config as PortConfig
from krr_tpu_torch.obs.trace import Tracer as PortTracer
from krr_tpu_torch.obs.trace import current_ids
from krr_tpu_torch.strategies.base import BaseStrategy as PortBaseStrategy

from .fakes.servers import FakeBackend, FakeCluster, FakeMetrics, ServerThread
from .test_integrations import fake_env  # noqa: F401  (module-scoped fixture)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: The three device paths of the slice: simple (K1 + K2), tdigest (K3 + K2),
#: tdigest with the exact upgrade (K4 + K2).
STRATEGY_PATHS = {
    "simple": ["simple"],
    "tdigest": ["tdigest"],
    "exact_upgrade": ["tdigest", "--exact_upgrade", "true"],
}

#: JAX flags with no counterpart in the port: the XLA compilation cache (the
#: port's kernels are nvcc builds) and the JAX strategies' Pallas switch (the
#: port always runs its CUDA kernels on the card).
JAX_ONLY_FLAGS = {
    "--jax-compilation-cache-dir",
    "--use_pallas",
}
#: Port flags the JAX command lacks: the compute device.
PORT_ONLY_FLAGS = {"--device"}

#: SERIES_ORIGIN on the minute grid (1.7e9 % 60 == 20): the alignment that
#: server-side downsampling requires.
ALIGNED_ORIGIN = 1_699_999_980.0


@pytest.fixture(scope="module")
def apps():
    jax_main.load_commands()
    port_main.load_commands()
    return jax_main.app, port_main.app


def _invoke(app, args):
    return CliRunner().invoke(app, args, catch_exceptions=False)


def _both(apps, env, args):
    """Run the same scan through both CLIs; returns (jax, port) results."""
    common = [*args, "--kubeconfig", env["kubeconfig"], "-p", env["server"].url, "-q"]
    jax_app, port_app = apps
    return _invoke(jax_app, common), _invoke(port_app, [*common, "--device", "cpu"])


@pytest.mark.parametrize("fmt", ["json", "yaml", "pprint", "table"])
@pytest.mark.parametrize("path", sorted(STRATEGY_PATHS))
def test_stdout_bytes_equal_jax(apps, fake_env, path, fmt):  # noqa: F811
    jax_result, port_result = _both(apps, fake_env, [*STRATEGY_PATHS[path], "-f", fmt])
    assert jax_result.exit_code == 0, jax_result.output
    assert port_result.exit_code == 0, port_result.output
    assert port_result.output == jax_result.output
    if fmt == "json":
        scans = json.loads(port_result.output)["scans"]
        assert len(scans) == 4  # web main + sidecar, db, migrate


FETCH_OPTIONS = {
    "plan_fixed": ["--fetch-plan", "fixed"],
    "plan_adaptive": ["--fetch-plan", "adaptive", "--fetch-plan-target-series", "2"],
    "per_workload": ["--batched-fleet-queries", "false"],
    "compression_off": ["--fetch-compression", "off"],
    "per_workload_pods": ["--bulk-pod-discovery", "false"],
}


@pytest.mark.parametrize("option", sorted(FETCH_OPTIONS))
@pytest.mark.parametrize("path", sorted(STRATEGY_PATHS))
def test_fetch_options_equal_jax(apps, fake_env, path, option):  # noqa: F811
    jax_result, port_result = _both(
        apps, fake_env, [*STRATEGY_PATHS[path], "-f", "json", *FETCH_OPTIONS[option]]
    )
    assert jax_result.exit_code == 0, jax_result.output
    assert port_result.exit_code == 0, port_result.output
    assert port_result.output == jax_result.output


@pytest.fixture(scope="module")
def aligned_env(tmp_path_factory):
    """A fake whose series sit on the absolute minute grid with ranged
    slicing on, so ``--fetch-downsample auto`` engages at an aligned
    ``--scan-end-timestamp``."""
    cluster = FakeCluster()
    metrics = FakeMetrics()
    metrics.enforce_range = True
    rng = np.random.default_rng(77)
    for ns, workloads, pods in (("alpha", 2, 2), ("beta", 1, 3)):
        for w in range(workloads):
            for pod in cluster.add_workload_with_pods("Deployment", f"{ns}-wl{w}", ns, pod_count=pods):
                metrics.set_series(
                    ns, "main", pod,
                    cpu=rng.gamma(2.0, 0.05, 96), memory=rng.uniform(5e7, 4e8, 96),
                )
    backend = FakeBackend(cluster, metrics)
    backend.SERIES_ORIGIN = ALIGNED_ORIGIN
    server = ServerThread(backend).start()
    kubeconfig = tmp_path_factory.mktemp("aligned") / "kubeconfig"
    kubeconfig.write_text(yaml.dump({
        "current-context": "fake",
        "contexts": [{"name": "fake", "context": {"cluster": "fake", "user": "u"}}],
        "clusters": [{"name": "fake", "cluster": {"server": server.url}}],
        "users": [{"name": "u", "user": {"token": "t"}}],
    }))
    yield {"server": server, "kubeconfig": str(kubeconfig)}
    server.stop()


@pytest.mark.parametrize("path", sorted(STRATEGY_PATHS))
def test_downsample_auto_equal_jax(apps, aligned_env, path, tmp_path):
    window = [
        "--history_duration", "1", "--timeframe_duration", "1",
        "--scan-end-timestamp", str(ALIGNED_ORIGIN + 3600.0),
    ]
    dump = tmp_path / "port.prom"
    jax_result, port_result = _both(
        apps, aligned_env,
        [*STRATEGY_PATHS[path], "-f", "json", *window, "--fetch-downsample", "auto",
         "--metrics-dump", str(dump)],
    )
    assert jax_result.exit_code == 0, jax_result.output
    assert port_result.exit_code == 0, port_result.output
    assert port_result.output == jax_result.output
    scans = json.loads(port_result.output)["scans"]
    assert len(scans) == 3 and all(
        s["recommended"]["requests"]["cpu"]["value"] != "?" for s in scans
    )
    downsampled = [
        line for line in dump.read_text().splitlines()
        if line.startswith("krr_tpu_fetch_downsampled_total{")
    ]
    if path == "simple":  # memory rides the stats route, which downsamples
        assert downsampled and float(downsampled[0].rsplit(" ", 1)[1]) >= 1
    else:  # tdigest fetches raw memory: nothing is eligible
        assert not downsampled
    # Downsampling is bit-exact: the raw fetch renders the same bytes.
    _, raw_result = _both(apps, aligned_env, [*STRATEGY_PATHS[path], "-f", "json", *window])
    assert raw_result.output == port_result.output


#: The JAX strategies' host-streamed methods.
JAX_STREAMED = {"simple": "_streamed_exact", "tdigest": "_streamed_sketch"}
#: The long-window fake: 2 Deployments of 3 pods, 45,000 samples a pod at 1
#: minute, so the packed CPU window alone (2 × 135,000 float32) passes
#: ``--host_stream_mb 1``.
LONG_SAMPLES = 45_000


@pytest.fixture(scope="module")
def long_env(tmp_path_factory):
    cluster = FakeCluster()
    metrics = FakeMetrics()
    metrics.enforce_range = True
    rng = np.random.default_rng(78)
    for w in range(2):
        for pod in cluster.add_workload_with_pods("Deployment", f"long-wl{w}", "default", pod_count=3):
            metrics.set_series(
                "default", "main", pod,
                cpu=np.round(rng.gamma(2.0, 0.05, LONG_SAMPLES), 4),
                memory=np.floor(rng.uniform(5e7, 4e8, LONG_SAMPLES) / 4096) * 4096,
            )
    backend = FakeBackend(cluster, metrics)
    server = ServerThread(backend).start()
    kubeconfig = tmp_path_factory.mktemp("long") / "kubeconfig"
    kubeconfig.write_text(yaml.dump({
        "current-context": "fake",
        "contexts": [{"name": "fake", "context": {"cluster": "fake", "user": "u"}}],
        "clusters": [{"name": "fake", "cluster": {"server": server.url}}],
        "users": [{"name": "u", "user": {"token": "t"}}],
    }))
    end = backend.SERIES_ORIGIN + (LONG_SAMPLES - 1) * 60.0
    yield {"server": server, "kubeconfig": str(kubeconfig), "end": end}
    server.stop()


@pytest.mark.parametrize("path", ["simple", "tdigest"])
def test_host_stream_equal_jax(apps, long_env, path, monkeypatch):
    """``--host_stream_mb 1`` on a window past 1 MB: the port streams the
    window from host memory (its streamed path runs once) and prints the
    JAX CLI's bytes. The JAX command runs with ``--use_mesh false``: on its
    eight virtual CPU devices the threshold is per device, and a mesh would
    keep this window resident."""
    window = [
        "--history_duration", str(LONG_SAMPLES // 60), "--timeframe_duration", "1",
        "--scan-end-timestamp", repr(long_env["end"]), "--host_stream_mb", "1",
    ]
    common = [path, "-f", "json", *window, "--kubeconfig", long_env["kubeconfig"], "-p", long_env["server"].url, "-q"]
    calls = []
    for strategy, method in ((PortBaseStrategy.find(path), "_run_streamed"),
                             (JaxBaseStrategy.find(path), JAX_STREAMED[path])):
        def spy(self, *args, _strategy=strategy, _streamed=getattr(strategy, method)):
            calls.append(_strategy.__module__.split(".")[0])
            return _streamed(self, *args)

        monkeypatch.setattr(strategy, method, spy)
    jax_app, port_app = apps
    jax_result = _invoke(jax_app, [*common, "--use_mesh", "false"])
    port_result = _invoke(port_app, [*common, "--device", "cpu"])
    assert jax_result.exit_code == 0, jax_result.output
    assert port_result.exit_code == 0, port_result.output
    assert port_result.output == jax_result.output
    assert calls == ["krr_tpu", "krr_tpu_torch"]  # both CLIs took their streamed path
    scans = json.loads(port_result.output)["scans"]
    assert len(scans) == 2 and all(s["recommended"]["requests"]["cpu"]["value"] != "?" for s in scans)


@pytest.mark.parametrize("path", sorted(STRATEGY_PATHS))
def test_mesh_flags_equal_jax(apps, fake_env, path, monkeypatch):  # noqa: F811
    """``--use_mesh true --mesh_time_axis 2`` on both CLIs: the JAX command
    meshes its eight virtual CPU devices as (4, 2), the port the CPU eight
    times (its device seam patched); the port's scan took its mesh path and
    printed the JAX CLI's bytes."""
    import krr_tpu_torch.strategies.simple as port_simple

    monkeypatch.setattr(port_simple, "mesh_devices", lambda device: [torch.device("cpu")] * 8)
    meshed = []
    strategy = PortBaseStrategy.find(STRATEGY_PATHS[path][0])

    def spy(self, *args, _run_mesh=strategy._run_mesh):
        meshed.append(args[-1].shape)
        return _run_mesh(self, *args)

    monkeypatch.setattr(strategy, "_run_mesh", spy)
    jax_result, port_result = _both(
        apps, fake_env, [*STRATEGY_PATHS[path], "-f", "json", "--use_mesh", "true", "--mesh_time_axis", "2"]
    )
    assert jax_result.exit_code == 0, jax_result.output
    assert port_result.exit_code == 0, port_result.output
    assert port_result.output == jax_result.output
    assert meshed == [{"data": 4, "time": 2}]


@pytest.mark.parametrize("depth", ["4", "0"])
@pytest.mark.parametrize("fmt", ["json", "yaml", "pprint", "table"])
def test_digest_ingest_equal_jax(apps, fake_env, fmt, depth):  # noqa: F811
    """``tdigest --digest_ingest true``, streamed (``--pipeline-depth 4``)
    and staged (``0``): the port's stdout is the JAX CLI's."""
    jax_result, port_result = _both(
        apps, fake_env, ["tdigest", "--digest_ingest", "true", "--pipeline-depth", depth, "-f", fmt]
    )
    assert jax_result.exit_code == 0, jax_result.output
    assert port_result.exit_code == 0, port_result.output
    assert port_result.output == jax_result.output
    if fmt == "json":
        assert len(json.loads(port_result.output)["scans"]) == 4


def _state_runs(apps, env, state: "dict[str, str]", args, runs: int = 2):
    """``runs`` consecutive ``tdigest --state_path`` scans per CLI, each
    into its own state; yields (jax, port) results per run."""
    jax_app, port_app = apps
    common = ["tdigest", *args, "--kubeconfig", env["kubeconfig"], "-p", env["server"].url, "-q"]
    for _ in range(runs):
        yield (
            _invoke(jax_app, [*common, "--state_path", state["jax"]]),
            _invoke(port_app, [*common, "--state_path", state["port"], "--device", "cpu"]),
        )


@pytest.mark.parametrize("store_format", ["sharded", "legacy"])
@pytest.mark.parametrize("fmt", ["json", "yaml", "pprint", "table"])
def test_state_path_two_runs_equal_jax(apps, fake_env, tmp_path, fmt, store_format):  # noqa: F811
    """Two consecutive ``tdigest --state_path`` runs into one state: each
    run's stdout is the JAX CLI's, and the state has the JAX shape (a
    directory with a manifest and a two-record WAL, or one ``.npz``)."""
    state = {name: str(tmp_path / name) for name in ("jax", "port")}
    for jax_result, port_result in _state_runs(
        apps, fake_env, state, ["-f", fmt, "--store_format", store_format]
    ):
        assert jax_result.exit_code == 0, jax_result.output
        assert port_result.exit_code == 0, port_result.output
        assert port_result.output == jax_result.output
    if store_format == "legacy":
        assert os.path.isfile(state["port"]) and not os.path.exists(state["port"] + ".lock")
    else:
        names = sorted(os.listdir(state["port"]))
        assert names == sorted(os.listdir(state["jax"])) == ["MANIFEST.json", "wal-00000000.log"]
        manifest = json.loads(open(os.path.join(state["port"], "MANIFEST.json")).read())
        assert manifest["format"] == 1


@pytest.mark.parametrize("first", ["jax", "port"])
def test_state_begun_by_one_cli_continued_by_the_other(apps, fake_env, tmp_path, first):  # noqa: F811
    """A state begun by one package's CLI and continued by the other's
    prints what a state driven by the JAX CLI alone prints."""
    jax_app, port_app = apps
    common = ["tdigest", "-f", "json", "--kubeconfig", fake_env["kubeconfig"], "-p", fake_env["server"].url, "-q"]
    mixed, control = str(tmp_path / "mixed"), str(tmp_path / "control")
    clis = {"jax": (jax_app, []), "port": (port_app, ["--device", "cpu"])}
    second = "port" if first == "jax" else "jax"
    for who in (first, second, first):
        app, extra = clis[who]
        got = _invoke(app, [*common, "--state_path", mixed, *extra])
        want = _invoke(jax_app, [*common, "--state_path", control])
        assert got.exit_code == want.exit_code == 0, got.output
        assert got.output == want.output


@pytest.mark.parametrize("strict", [False, True])
def test_failing_namespace_renders_unknown_and_strict_exits_3(apps, fake_env, strict):  # noqa: F811
    args = [
        "simple", "-f", "json", "--backoff-cap-seconds", "0.01",
        "--retry-deadline-seconds", "0.05", *(["--strict"] if strict else []),
    ]
    fake_env["metrics"].fail_namespaces = frozenset({"prod"})
    try:
        jax_result, port_result = _both(apps, fake_env, args)
    finally:
        fake_env["metrics"].fail_namespaces = frozenset()
    assert jax_result.exit_code == port_result.exit_code == (3 if strict else 0)
    if strict:
        return
    assert port_result.output == jax_result.output
    cpu = {
        (s["object"]["namespace"], s["object"]["name"]): s["recommended"]["requests"]["cpu"]["value"]
        for s in json.loads(port_result.output)["scans"]
    }
    assert cpu[("prod", "db")] == "?"
    assert cpu[("default", "web")] != "?"


def test_trace_spans_carry_the_scan_id_current_ids_reads(apps, fake_env, tmp_path):  # noqa: F811
    """``--trace`` keeps stdout byte-equal to the JAX CLI's and writes the
    scan's spans under one scan id; inside a span ``current_ids`` (the hook
    the structured log channel of ROADMAP M8 reads) gives that span's ids,
    outside any span nothing."""
    jax_app, port_app = apps
    args = ["simple", "--kubeconfig", fake_env["kubeconfig"], "-p", fake_env["server"].url,
            "-q", "-f", "json"]
    trace = tmp_path / "trace.json"
    port_result = _invoke(port_app, [*args, "--device", "cpu", "--trace", str(trace)])
    jax_result = _invoke(jax_app, args)
    assert port_result.exit_code == jax_result.exit_code == 0
    assert port_result.stdout == jax_result.stdout
    events = [e for e in json.loads(trace.read_text())["traceEvents"] if e["ph"] == "X"]
    assert {"scan", "discover", "fetch", "compute", "prom_query"} <= {e["name"] for e in events}
    (root,) = [e for e in events if e["name"] == "scan"]
    assert {e["args"]["trace_id"] for e in events} == {root["args"]["trace_id"]}

    tracer = PortTracer()
    assert current_ids() == (None, None)
    with tracer.span("scan") as scan:
        with tracer.span("fetch") as fetch:
            assert current_ids() == (scan.trace_id, f"{fetch.span_id:x}")
        assert current_ids() == (scan.trace_id, f"{scan.span_id:x}")
    assert current_ids() == (None, None)


def _flag_names(command: click.Command) -> "set[str]":
    return {
        opt for param in command.params if isinstance(param, click.Option)
        for opt in param.opts if opt.startswith("--")
    }


@pytest.mark.parametrize("name", ["simple", "tdigest"])
def test_help_lists_the_jax_flags(apps, name):
    jax_app, port_app = apps
    jax_flags = _flag_names(jax_app.commands[name])
    port_flags = _flag_names(port_app.commands[name])
    assert port_flags - jax_flags == PORT_ONLY_FLAGS
    assert jax_flags - port_flags == JAX_ONLY_FLAGS
    help_text = _invoke(port_app, [name, "--help"]).output
    for flag in port_flags:
        assert flag in help_text


#: ``analyze`` flags of the JAX command the port lacks: none since the
#: flight recorder's trend view (``--trend``, ``--timeline``) was ported.
ANALYZE_JAX_ONLY_FLAGS: "set[str]" = set()


def test_analyze_lists_the_jax_flags(apps):
    jax_app, port_app = apps
    jax_flags = _flag_names(jax_app.commands["analyze"])
    port_flags = _flag_names(port_app.commands["analyze"])
    assert port_flags <= jax_flags
    assert jax_flags - port_flags == ANALYZE_JAX_ONLY_FLAGS
    help_text = _invoke(port_app, ["analyze", "--help"]).output
    for flag in port_flags:
        assert flag in help_text


def _boolean_options(command: click.Command) -> "list[click.Option]":
    return [
        p for p in command.params
        if isinstance(p, click.Option)
        and (p.is_flag or getattr(p, "is_bool_flag", False) or p.type is click.BOOL)
    ]


@pytest.mark.parametrize("name", ["simple", "tdigest"])
def test_boolean_defaults_match_jax_and_fields(apps, name):
    """The real parser with no flags lands every boolean on the JAX
    command's default and on the Config / settings field it feeds (the
    click single-name inverted-flag trap)."""
    jax_app, port_app = apps
    port_command = port_app.commands[name]
    jax_defaults = {
        opt.name: opt.default for opt in _boolean_options(jax_app.commands[name])
    }
    ctx = port_command.make_context(name, [], resilient_parsing=True)
    fields = {
        **PortConfig.model_fields,
        **PortBaseStrategy.find(name).get_settings_type().model_fields,
    }
    options = _boolean_options(port_command)
    assert options
    for opt in options:
        assert ctx.params[opt.name] == opt.default == jax_defaults[opt.name], opt.name
        assert fields[opt.name].default == opt.default, opt.name


def test_without_device_cpu_the_scan_asks_for_cuda(fake_env):  # noqa: F811
    """``python -m krr_tpu_torch simple`` defaults to the card: with no card
    it exits non-zero naming CUDA, and prints no scan."""
    proc = subprocess.run(
        [sys.executable, "-m", "krr_tpu_torch", "simple", "-q", "-f", "json",
         "--kubeconfig", fake_env["kubeconfig"], "-p", fake_env["server"].url],
        cwd=REPO_ROOT, capture_output=True, text=True, timeout=120,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""},
    )
    assert proc.returncode != 0
    assert "cuda" in (proc.stdout + proc.stderr).lower()
    assert '"scans"' not in proc.stdout


#: ``serve`` flags of the JAX command the port lacks beyond
#: ``JAX_ONLY_FLAGS``: federation and push ingest (ROADMAP M10b) and the
#: freshness lineage that rides federation.
SERVE_JAX_ONLY_FLAGS = {
    "--ingest-port", "--ingest-verify-interval", "--ingest-max-body-bytes",
    "--ingest-lookback", "--ingest-max-samples-per-series", "--ingest-max-series",
    "--federation-listen", "--federation-staleness", "--federation-queue-records",
    "--federation-uplink", "--lineage",
}


@pytest.mark.parametrize("name,jax_only", [
    ("serve", JAX_ONLY_FLAGS | SERVE_JAX_ONLY_FLAGS),
    ("diff", JAX_ONLY_FLAGS),
    # eval takes no strategy settings, so no --use_pallas to lack.
    ("eval", JAX_ONLY_FLAGS - {"--use_pallas"}),
])
def test_serve_and_diff_list_the_jax_flags(apps, name, jax_only):
    jax_app, port_app = apps
    jax_flags = _flag_names(jax_app.commands[name])
    port_flags = _flag_names(port_app.commands[name])
    assert port_flags - jax_flags == PORT_ONLY_FLAGS
    assert jax_flags - port_flags == jax_only
    help_text = _invoke(port_app, [name, "--help"]).output
    for flag in port_flags:
        assert flag in help_text


@pytest.mark.parametrize("name", ["serve", "diff", "eval"])
def test_serve_and_diff_boolean_defaults_match_jax(apps, name):
    """The real parser with no flags lands every boolean (the dual-name
    ``--hysteresis/--no-hysteresis``, ``--sentinel``, ``--savings``,
    ``--response-cache`` included) on the JAX command's default and on the
    Config or settings field it feeds."""
    jax_app, port_app = apps
    port_command = port_app.commands[name]
    jax_defaults = {opt.name: opt.default for opt in _boolean_options(jax_app.commands[name])}
    ctx = port_command.make_context(name, [], resilient_parsing=True)
    fields = {
        **PortConfig.model_fields,
        **PortBaseStrategy.find("tdigest").get_settings_type().model_fields,
    }
    options = _boolean_options(port_command)
    assert options
    for opt in options:
        assert ctx.params[opt.name] == opt.default == jax_defaults[opt.name], opt.name
        if opt.name in fields:
            assert fields[opt.name].default == opt.default, opt.name
    if name == "serve":
        for flag in ("hysteresis_enabled", "sentinel_enabled", "savings_enabled", "response_cache_enabled"):
            assert ctx.params[flag] is True


@pytest.mark.parametrize("args,item", [
    # Watch discovery is ported; beside it, push ingest still refuses.
    (["--discovery-mode", "watch", "--metrics-mode", "push"], "M10b"),
    (["--metrics-mode", "push"], "M10b"),
])
def test_serve_modes_of_later_slices_exit_naming_their_item(apps, args, item):
    _, port_app = apps
    result = CliRunner().invoke(port_app, ["serve", *args, "--device", "cpu", "-p", "http://127.0.0.1:9"])
    assert result.exit_code == 1
    assert "not ported yet" in result.output and item in result.output


def _timeline_file(path: str, ticks: int = 24) -> None:
    from krr_tpu_torch.obs.timeline import ScanTimeline

    from .test_torch_history import synthetic_records

    timeline = ScanTimeline.open(path)
    for record in synthetic_records(ticks, inject=ticks > 0):
        timeline.append(record)
    timeline.close()


@pytest.mark.parametrize("args", [
    ["--trend", "--timeline", "{F}"],
    ["--timeline", "{F}", "-f", "json"],
    ["--trend", "--timeline", "{F}", "-n", "5"],
    ["--trend", "--timeline", "{E}"],
    ["--trend", "--timeline", "{F}", "--trace", "x.json"],
], ids=["text", "json", "newest5", "empty", "with-trace"])
def test_analyze_trend_equal_jax(apps, tmp_path, args):
    full, empty = str(tmp_path / "timeline.log"), str(tmp_path / "empty.log")
    _timeline_file(full)
    _timeline_file(empty, ticks=0)
    argv = ["analyze", *(a.format(F=full, E=empty) for a in args)]
    jax_app, port_app = apps
    jax_result, port_result = CliRunner().invoke(jax_app, argv), CliRunner().invoke(port_app, argv)
    assert port_result.exit_code == jax_result.exit_code
    assert port_result.output == jax_result.output
    if "{F}" in args and "--trace" not in args:
        assert port_result.exit_code == 0 and "regress" in port_result.output


@pytest.fixture(scope="module")
def journal_env(apps, fake_env, tmp_path_factory):  # noqa: F811
    """A serve journal over the fake fleet's real object keys: three ticks of
    the live raw recommendations, moved between ticks, one workload missing
    from the first tick."""
    from krr_tpu.core.config import Config as JaxConfig
    from krr_tpu.history.diff import live_values
    from krr_tpu.history.journal import RecommendationJournal

    config = JaxConfig(
        kubeconfig=fake_env["kubeconfig"], prometheus_url=fake_env["server"].url,
        strategy="tdigest", quiet=True,
    )
    values = asyncio.run(live_values(config))
    keys = sorted(values)
    cpu = np.asarray([values[k][0] for k in keys], np.float32)
    mem = np.asarray([values[k][1] for k in keys], np.float32)
    path = str(tmp_path_factory.mktemp("journal") / "serve.journal")
    journal = RecommendationJournal(path)
    t0 = 1_700_000_000.0
    journal.append_tick(t0, keys[1:], cpu[1:] * 0.5, mem[1:] * 2.0, np.ones(len(keys) - 1, bool))
    journal.append_tick(t0 + 900.0, keys, cpu * 1.25, mem, np.ones(len(keys), bool))
    journal.append_tick(t0 + 1800.0, keys, cpu, mem * 0.75, np.ones(len(keys), bool))
    journal.close()
    return {"path": path, "t0": t0}


@pytest.mark.parametrize("fmt", ["json", "yaml", "pprint", "table"])
@pytest.mark.parametrize("points", ["newest_two", "at", "baseline", "live", "live_at", "namespace"])
def test_diff_stdout_equal_jax(apps, fake_env, journal_env, points, fmt):  # noqa: F811
    t0 = journal_env["t0"]
    extra = {
        "newest_two": [],
        "at": ["--at", str(t0 + 900.0)],
        "baseline": ["--baseline", str(t0), "--at", str(t0 + 1800.0)],
        "live": ["--live"],
        "live_at": ["--live", "--at", str(t0 + 900.0)],
        "namespace": ["-n", "prod"],
    }[points]
    jax_result, port_result = _both(
        apps, fake_env, ["diff", "--journal", journal_env["path"], "-f", fmt, *extra],
    )
    assert jax_result.exit_code == 0, jax_result.output
    assert port_result.exit_code == 0, port_result.output
    assert port_result.output == jax_result.output


def test_diff_errors_equal_jax(apps, tmp_path, journal_env):
    jax_app, port_app = apps
    for argv in (
        ["diff", "--journal", str(tmp_path / "missing")],
        ["diff"],
        ["diff", "--journal", journal_env["path"], "--live", "--baseline", "1"],
        ["diff", "--journal", journal_env["path"], "--at", "5"],
    ):
        jax_result, port_result = CliRunner().invoke(jax_app, argv), CliRunner().invoke(port_app, argv)
        assert port_result.exit_code == jax_result.exit_code == 2, argv
        assert port_result.output == jax_result.output


@pytest.mark.parametrize("argv", [
    ["serve"],
    ["diff", "--live", "--journal", "{J}"],
], ids=["serve", "diff-live"])
def test_without_device_cpu_serve_and_live_diff_ask_for_cuda(fake_env, journal_env, argv):  # noqa: F811
    """``serve`` and ``diff --live`` default to the card: with no card they
    exit 1 naming CUDA. A journal-vs-journal diff needs no card."""
    base = [sys.executable, "-m", "krr_tpu_torch"]
    common = ["-q", "--kubeconfig", fake_env["kubeconfig"], "-p", fake_env["server"].url]
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run(
        [*base, *(a.format(J=journal_env["path"]) for a in argv), *common, "--port", "0"]
        if argv[0] == "serve" else [*base, *(a.format(J=journal_env["path"]) for a in argv), *common],
        cwd=REPO_ROOT, capture_output=True, text=True, timeout=120, env=env,
    )
    assert proc.returncode == 1, proc.stderr
    assert "cuda" in (proc.stdout + proc.stderr).lower()
    if argv[0] == "diff":
        journal_diff = subprocess.run(
            [*base, "diff", "--journal", journal_env["path"], "-f", "json", "-q"],
            cwd=REPO_ROOT, capture_output=True, text=True, timeout=120, env=env,
        )
        assert journal_diff.returncode == 0, journal_diff.stderr
        assert json.loads(journal_diff.stdout)["scans"]
