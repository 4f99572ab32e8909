"""The port's trace import, stitching, critical-path attribution, ``analyze``
and the scan commands' ``--trace --profile --statusz --metrics-dump`` held
against the JAX package's.

Hand-built Chrome payloads (a golden scan with known geometry, three
processes joined by remote links, a foreign trace without the exporter's
``args``) and a JAX CLI ``--trace`` file go through both packages'
``traces_from_chrome``, ``stitch_chrome``, ``profile_chrome_payload`` and
``render_text``: the outputs are equal. ``analyze`` runs through both
click apps (files and a tiny in-test HTTP server). Both scan CLIs run on
the fake cluster (the port with ``--device cpu``): their statusz verdicts
and event totals are equal, with the values that depend on wall time or
the time of day masked — ``evaluated_at``, each objective's ``since`` and
the threshold objectives' ``last_value``.
"""

from __future__ import annotations

import glob
import http.server
import json
import threading

import pytest
from click.testing import CliRunner

from krr_tpu import main as jax_main
from krr_tpu.obs import profile as jax_profile
from krr_tpu.obs import trace as jax_trace
from krr_tpu_torch import main as port_main
from krr_tpu_torch.obs import profile as port_profile
from krr_tpu_torch.obs import trace as port_trace

from .test_integrations import fake_env  # noqa: F401  (module-scoped fixture)


def event(name, pid, tid, start, end, trace_id=None, span_id=None, parent_id=None, wall=None, **attrs):
    """One complete ("X") Chrome event in the exporter's shape; times in s."""
    args = dict(attrs)
    if trace_id is not None:
        args.update(trace_id=trace_id, span_id=span_id, parent_id=parent_id)
        if wall is not None:
            args["wall_start"] = wall
    return {"name": name, "cat": "scan", "ph": "X", "ts": start * 1e6, "dur": (end - start) * 1e6,
            "pid": pid, "tid": tid, "args": args}


def golden_payload() -> dict:
    """scan [0,10]: discover [0,1], fetch [1,9] with one prom_query
    [1.5,8.5] carrying a phase split, fold [8,9.5], compute [9.5,10] with
    pack / quantile / round stages; then a second scan of the same process
    with a retried, phaseless query."""
    w = 1_700_000_000.0
    t = "scan-a-1"
    first = [
        event("discover", 1, 0, 0.0, 1.0, t, "2", "1", w),
        event("prom_query", 1, 1, 1.5, 8.5, t, "4", "3", w + 1.5, route="streamed", status="ok", retries=1,
              bytes=1_000_000, decoded_bytes=250_000, retry_wait=0.5, encoding="gzip", phase_connect=0.5,
              phase_ttfb=2.0, phase_body_read=2.0, phase_decode=0.5, phase_sink=1.0, phase_queue_wait=0.25),
        event("fetch", 1, 0, 1.0, 9.0, t, "3", "1", w + 1.0, cluster="default", rows=4),
        event("fold", 1, 2, 8.0, 9.5, t, "5", "1", w + 8.0),
        event("pack", 1, 0, 9.5, 9.6, t, "7", "6", w + 9.5, rows=4),
        event("quantile", 1, 0, 9.6, 9.9, t, "8", "6", w + 9.6, rows=4, path="resident"),
        event("round", 1, 0, 9.9, 9.95, t, "9", "6", w + 9.9, rows=4),
        event("compute", 1, 0, 9.5, 10.0, t, "6", "1", w + 9.5, rows=4),
        event("scan", 1, 0, 0.0, 10.0, t, "1", None, w, kind="cli", objects=4),
    ]
    t2 = "scan-a-2"
    second = [
        event("discover", 2, 0, 20.0, 20.2, t2, "b", "a", w + 20.0),
        event("prom_query", 2, 0, 20.3, 23.0, t2, "d", "c", w + 20.3, retries=2, retry_wait=1.0),
        event("fetch", 2, 0, 20.2, 23.5, t2, "c", "a", w + 20.2),
        event("compute", 2, 0, 23.5, 24.0, t2, "e", "a", w + 23.5),
        event("scan", 2, 0, 20.0, 24.5, t2, "a", None, w + 20.0, kind="cli"),
    ]
    return {"traceEvents": [{"ph": "M", "pid": 1, "name": "process_name", "args": {"name": t}}, *first, *second],
            "displayTimeUnit": "ms"}


def linked_payloads() -> list[dict]:
    """A shard's scan, the aggregator apply it fed (a remote child) and a
    replica install of the aggregator's tick, plus a foreign trace."""
    w = 1_700_000_100.0
    shard = {"traceEvents": [
        event("fetch", 1, 0, 0.1, 0.8, "scan-s-1", "2", "1", w + 0.1, node="shard-a"),
        event("scan", 1, 0, 0.0, 1.0, "scan-s-1", "1", None, w, node="shard-a", kind="serve"),
    ]}
    aggregator = {"traceEvents": [
        event("apply_record", 1, 0, 0.2, 0.4, "scan-g-1", "2", "1", w + 1.2, node="aggregator"),
        event("apply", 1, 0, 0.0, 0.5, "scan-g-1", "1", None, w + 1.0, node="aggregator",
              remote_trace_id="scan-s-1", remote_parent="1", remote_node="shard-a"),
    ]}
    replica = {"traceEvents": [
        event("install", 1, 0, 0.0, 0.3, "scan-r-1", "1", None, w + 2.0, node="replica-1",
              remote_trace_id="scan-g-1", remote_parent="1", remote_node="aggregator"),
    ]}
    foreign = {"traceEvents": [event("step", 7, 3, 1.0, 2.0), event("op", 7, 3, 1.2, 1.5)]}
    return [shard, aggregator, replica, foreign]


def span_rows(traces) -> list:
    return [[(s.name, s.trace_id, s.span_id, s.parent_id, s.start, s.end, s.attributes) for s in spans]
            for spans in traces]


@pytest.mark.parametrize("payload", ["golden", "linked", "foreign"])
def test_traces_from_chrome_equal_jax(payload):
    payloads = {"golden": golden_payload(), "linked": linked_payloads()[1], "foreign": linked_payloads()[3]}
    chrome = payloads[payload]
    got = port_trace.traces_from_chrome(chrome)
    want = jax_trace.traces_from_chrome(chrome)
    if payload == "foreign":  # no exporter ids: fresh span ids, compared by shape
        assert [[(s.name, s.trace_id, s.parent_id, s.start, s.end) for s in spans] for spans in got] == \
            [[(s.name, s.trace_id, s.parent_id, s.start, s.end) for s in spans] for spans in want]
    else:
        assert span_rows(got) == span_rows(want)


def test_stitch_chrome_equals_jax():
    payloads = linked_payloads()
    stitched = port_trace.stitch_chrome(payloads)
    assert stitched == jax_trace.stitch_chrome(payloads)
    processes = [e for e in stitched["traceEvents"] if e.get("name") == "process_name"]
    assert len(processes) == 2  # the linked fleet and the foreign trace
    remote = [e for e in stitched["traceEvents"] if e.get("args", {}).get("remote")]
    assert {e["name"] for e in remote} == {"apply", "install"}
    assert port_trace.stitch_chrome([]) == jax_trace.stitch_chrome([])


@pytest.mark.parametrize("n", [None, 1])
def test_profile_and_render_equal_jax(n):
    payload = golden_payload()
    got = port_profile.profile_chrome_payload(payload, n=n)
    want = jax_profile.profile_chrome_payload(payload, n=n)
    assert got == want
    assert port_profile.render_text(got) == jax_profile.render_text(want)
    for scan in got["scans"]:
        assert sum(scan["categories"].values()) == pytest.approx(scan["wall_seconds"], abs=1e-3)
    if n is None:
        golden = got["scans"][0]
        assert golden["categories"]["fetch_transport"] == pytest.approx(4.5)
        assert golden["categories"]["compute"] == pytest.approx(0.5)
    # Live spans agree with their re-import.
    traces = port_trace.traces_from_chrome(payload)
    assert port_profile.profile_traces(traces) == jax_profile.profile_traces(jax_trace.traces_from_chrome(payload))


def test_overlapping_phases_keep_the_partition_queue3_item13():
    """A query whose phases overlap (a streamed body sunk while it is read)
    sums more phase seconds than its duration. The JAX package then clamps
    ``fetch_other`` at 0 and its categories pass the wall; the port scales
    the split to the attributed wall: the same proportions, the other
    categories equal, and the categories sum to the wall."""
    payload = golden_payload()
    (query,) = [e for e in payload["traceEvents"] if e["name"] == "prom_query" and e["pid"] == 1]
    query["args"].update(phase_body_read=4.5, phase_sink=2.5)  # 9.5 phase s over a 7 s query
    port = port_profile.profile_chrome_payload(payload)["scans"][0]
    jax = jax_profile.profile_chrome_payload(payload)["scans"][0]
    assert sum(jax["categories"].values()) > jax["wall_seconds"] + 1.0
    assert sum(port["categories"].values()) == pytest.approx(port["wall_seconds"], abs=1e-5)
    split = ("fetch_transport", "fetch_decode", "fetch_backoff")
    assert {k: v for k, v in port["categories"].items() if k not in split} == {
        k: v for k, v in jax["categories"].items() if k not in split}  # fetch_other: the fetch span's rest
    ratio = jax["categories"]["fetch_transport"] / port["categories"]["fetch_transport"]
    for key in ("fetch_decode", "fetch_backoff"):
        assert jax["categories"][key] / port["categories"][key] == pytest.approx(ratio, rel=1e-5)
    derived = ("categories", "category_pct")
    assert {k: v for k, v in port.items() if k not in derived} == {k: v for k, v in jax.items() if k not in derived}


# ------------------------------------------------------------------ the CLIs
@pytest.fixture(scope="module")
def apps():
    jax_main.load_commands()
    port_main.load_commands()
    return jax_main.app, port_main.app


def _invoke(app, args):
    return CliRunner().invoke(app, args, catch_exceptions=False)


def _scan(app, env, args):
    common = ["--kubeconfig", env["kubeconfig"], "-p", env["server"].url, "-q", "-f", "json"]
    result = _invoke(app, [*args, *common])
    assert result.exit_code == 0, result.output
    return result.stdout


def masked_status(status: dict) -> dict:
    """``--statusz`` JSON with the values that depend on wall time or the
    time of day masked: ``evaluated_at``, each objective's ``since`` and
    the threshold objectives' ``last_value`` (the scan wall, the window's
    age)."""
    status.pop("evaluated_at")
    for objective in status["objectives"]:
        objective.pop("since")
        if objective["kind"] == "threshold":
            objective.pop("last_value")
    return status


def _instrumented_scans(apps, env, tmp_path_factory, name: str) -> dict:
    """Both CLIs' ``simple`` scan with ``--trace --profile --statusz
    --metrics-dump``: {package: {artifact: path}}; their stdout is equal."""
    jax_app, port_app = apps
    out, stdout = {}, {}
    for package, app, extra in (("jax", jax_app, []), ("port", port_app, ["--device", "cpu"])):
        tmp = tmp_path_factory.mktemp(f"{name}-{package}")
        paths = {kind: str(tmp / file) for kind, file in (
            ("trace", "trace.json"), ("profile", "profile.json"), ("statusz", "statusz.json"),
            ("metrics", "metrics.prom"),
        )}
        stdout[package] = _scan(app, env, [
            "simple", *extra, "--trace", paths["trace"], "--profile", paths["profile"],
            "--statusz", paths["statusz"], "--metrics-dump", paths["metrics"],
            "--backoff-cap-seconds", "0.01", "--retry-deadline-seconds", "0.05",
        ])
        out[package] = paths
    assert stdout["port"] == stdout["jax"]
    return out


@pytest.fixture(scope="module")
def instrumented(apps, fake_env, tmp_path_factory):  # noqa: F811
    return _instrumented_scans(apps, fake_env, tmp_path_factory, "healthy")


@pytest.fixture(scope="module")
def prod_down(apps, fake_env, tmp_path_factory):  # noqa: F811
    """The same scans while the fake Prometheus fails the ``prod``
    namespace's queries (2 of the 4 objects)."""
    fake_env["metrics"].fail_namespaces = frozenset({"prod"})
    try:
        return _instrumented_scans(apps, fake_env, tmp_path_factory, "prod-down")
    finally:
        fake_env["metrics"].fail_namespaces = frozenset()


@pytest.mark.parametrize("regime, bad, firing", [
    ("instrumented", 0.0, []), ("prod_down", 2.0, ["fetch_failed_rows"]),
])
def test_statusz_verdicts_and_totals_equal_jax(request, regime, bad, firing):
    scans = request.getfixturevalue(regime)
    status = {p: masked_status(json.load(open(paths["statusz"]))) for p, paths in scans.items()}
    assert status["port"] == status["jax"]
    objectives = {o["name"]: o for o in status["port"]["objectives"]}
    # Every one of the fleet's 4 objects was fetched (the migrate Job has no
    # samples, which is no fetch failure).
    assert objectives["fetch_failed_rows"]["events"] == {"bad": bad, "total": 4.0}
    assert objectives["scan_failures"]["events"] == {"bad": 0.0, "total": 1.0}
    assert status["port"]["firing"] == firing
    slo = {p: [line for line in open(paths["metrics"]).read().splitlines() if line.startswith("krr_tpu_slo_")]
           for p, paths in scans.items()}
    assert slo["port"] and slo["port"] == slo["jax"]


def test_profile_partitions_its_wall_and_analyze_agrees(instrumented, apps):
    jax_app, port_app = apps
    report = json.load(open(instrumented["port"]["profile"]))
    (scan,) = report["scans"]
    assert sum(scan["categories"].values()) == pytest.approx(scan["wall_seconds"], abs=1e-3)
    assert scan["kind"] == "cli" and scan["categories"]["fetch_transport"] > 0
    # analyze over the same scan's --trace file gives the --profile report.
    trace = instrumented["port"]["trace"]
    assert json.loads(_invoke(port_app, ["analyze", "--trace", trace, "-f", "json"]).stdout) == report
    names = {e["name"] for e in json.load(open(trace))["traceEvents"] if e["ph"] == "X"}
    assert {"scan", "discover", "fetch", "prom_query", "compute", "pack", "quantile", "round"} <= names


@pytest.mark.parametrize("source", ["jax", "port", "golden"])
@pytest.mark.parametrize("fmt", ["text", "json"])
def test_analyze_trace_stdout_equals_jax(instrumented, apps, tmp_path, source, fmt):
    jax_app, port_app = apps
    if source == "golden":
        path = tmp_path / "golden.json"
        path.write_text(json.dumps(golden_payload()))
        path = str(path)
    else:
        path = instrumented[source]["trace"]
    for args in (["--trace", path, "-f", fmt], ["--trace", path, "-f", fmt, "-n", "1"]):
        want, got = _invoke(jax_app, ["analyze", *args]), _invoke(port_app, ["analyze", *args])
        assert got.exit_code == want.exit_code == 0
        assert got.stdout == want.stdout
    payload = json.load(open(path))
    assert port_profile.render_text(port_profile.profile_chrome_payload(payload)) == \
        jax_profile.render_text(jax_profile.profile_chrome_payload(payload))


def test_analyze_stitch_and_errors_equal_jax(apps, tmp_path):
    jax_app, port_app = apps
    files = []
    for i, payload in enumerate(linked_payloads()):
        path = tmp_path / f"p{i}.json"
        path.write_text(json.dumps(payload))
        files += ["--trace", str(path)]
    out = tmp_path / "stitched.json"
    assert _invoke(port_app, ["analyze", "--stitch", *files, "-o", str(out)]).exit_code == 0
    assert json.loads(out.read_text()) == jax_trace.stitch_chrome(linked_payloads())
    for args in ([], ["--trace", files[1], "--trace", files[3]], ["--trace", str(tmp_path / "missing.json")]):
        want = CliRunner().invoke(jax_app, ["analyze", *args])
        got = CliRunner().invoke(port_app, ["analyze", *args])
        assert got.exit_code == want.exit_code == 2
        assert got.output == want.output
    empty = tmp_path / "empty.json"
    empty.write_text(json.dumps({"traceEvents": []}))
    want = CliRunner().invoke(jax_app, ["analyze", "--trace", str(empty)])
    got = CliRunner().invoke(port_app, ["analyze", "--trace", str(empty)])
    assert got.exit_code == want.exit_code == 1 and got.output == want.output


@pytest.fixture
def trace_server():
    """A tiny HTTP server answering ``/debug/trace`` with the golden payload
    (``?n=1``: its newest scan), and an empty ring under ``/empty``."""
    payload = golden_payload()

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802
            if self.path.startswith("/empty/"):
                body = {"traceEvents": []}
            elif self.path == "/debug/trace?n=1":
                body = {"traceEvents": [e for e in payload["traceEvents"] if e.get("pid") == 2]}
            else:
                body = payload
            data = json.dumps(body).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def log_message(self, *args):
            pass

    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{server.server_address[1]}"
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()


def test_analyze_url_against_a_live_trace_ring(apps, trace_server):
    jax_app, port_app = apps
    for args in (["--url", trace_server], ["--url", trace_server, "-n", "1", "-f", "json"],
                 ["--url", trace_server + "/empty"], ["--stitch", "--url", trace_server]):
        want, got = _invoke(jax_app, ["analyze", *args]), _invoke(port_app, ["analyze", *args])
        assert got.exit_code == want.exit_code == 0, got.output
        assert got.stdout == want.stdout
    report = json.loads(_invoke(port_app, ["analyze", "--url", trace_server, "-f", "json"]).stdout)
    assert report["aggregate"]["scan_count"] == 2


def test_profile_dir_writes_a_torch_profiler_trace(apps, fake_env, tmp_path):  # noqa: F811
    _jax_app, port_app = apps
    plain = _scan(port_app, fake_env, ["tdigest", "--device", "cpu"])
    profiled = _scan(port_app, fake_env, ["tdigest", "--device", "cpu", "--profile_dir", str(tmp_path)])
    assert profiled == plain
    (path,) = glob.glob(str(tmp_path / "krr-tpu-torch.*.pt.trace.json"))
    events = json.load(open(path))["traceEvents"]
    assert any(e.get("ph") == "X" for e in events)


@pytest.mark.parametrize("device, fenced", [("cuda", True), ("cuda:0", True), ("cpu", False), (None, False)])
def test_profiled_holds_device_work_inside_the_window(monkeypatch, tmp_path, device, fenced):
    """On a CUDA device the profiler's window opens and closes
    ``PROFILE_MARGIN_SECONDS`` of host time away from the body's fenced
    device work (the profiler drops device records outside its window);
    on the CPU nothing is fenced and nothing waits."""
    import torch
    import torch.profiler

    from krr_tpu_torch.strategies import base

    calls = []

    class FakeProfile:
        def __init__(self, activities, **kwargs):
            calls.append(("start", tuple(sorted(a.name for a in activities))))

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            calls.append(("stop",))

        def export_chrome_trace(self, path):
            calls.append(("export",))

    monkeypatch.setattr(torch.profiler, "profile", FakeProfile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda dev=None: calls.append(("sync", dev)))
    monkeypatch.setattr(base.time, "sleep", lambda seconds: calls.append(("sleep", seconds)))
    with base.profiled(str(tmp_path), device):
        calls.append(("body",))
    margin = [("sync", device), ("sleep", base.PROFILE_MARGIN_SECONDS)] if fenced else []
    activities = ("CPU", "CUDA") if fenced else ("CPU",)
    assert calls == [("start", activities), *margin, ("body",), *margin, ("stop",), ("export",)]
