"""The Prometheus route: a tiny fleet fetched through the port's own
``PrometheusLoader`` from the benchmark's fake Prometheus renders what the
injected route renders; the fake answers each query form the port sends as
NumPy reads the same arrays, refuses what it does not evaluate, and is gone
when a run ends; planted faults of the fake read not correct."""

import dataclasses
import functools
import gzip
import json
import os
import urllib.error
import urllib.parse
import urllib.request

import numpy as np
import pytest

from benchmark import harness, prometheus, scan, spec
from benchmark.reference.recommend import recommend

CELL = "simple-14d-15m-prom.uniform"
SEED = 2**31 + 57
CONTAINERS = 40
NAMESPACES = 4
CPU = prometheus.CPU_METRIC
MEMORY = prometheus.MEMORY_METRIC


def prom_cell(mix="uniform", namespaces=NAMESPACES):
    """The cell over ``mix``, its fleet in ``namespaces`` namespaces."""
    cell = spec.load_cell(CELL)
    with open(spec.mix_path(cell.root, mix, ".json")) as f:
        loaded = json.load(f)
    return dataclasses.replace(cell, mix_name=mix, mix=loaded, config={**cell.config, "namespaces": namespaces})


def injected(cell):
    config = {key: value for key, value in cell.config.items() if key != "history_source"}
    return dataclasses.replace(cell, config=config)


def test_the_configuration_is_simple_14d_15m_fetched_from_prometheus():
    cell, base = spec.load_cell(CELL), spec.load_cell("simple-14d-15m.uniform")
    assert scan.history_source(cell) == "prometheus" and scan.history_source(base) == "injected"
    assert cell.config["containers"] == 10_000 and cell.config["reduced"] == []
    same = ("strategy", "settings", "cpu_min_millicores", "memory_min_mb", "namespaces", "cpu_cores",
            "memory_bytes", "allocations", "guarantee")
    assert {key: cell.config[key] for key in same} == {key: base.config[key] for key in same}
    fetch = {entry["name"] for entry in cell.per_layer if entry["layer"].startswith("fetch")}
    assert fetch == {"fetch_ms", "fetch_wire_mib", "fetch_points_per_s"}


@pytest.mark.parametrize("mix", ["uniform", "ragged"])
def test_a_tiny_fleet_over_prometheus_renders_the_injected_json(mix):
    cell = prom_cell(mix)
    fleet = scan.Fleet(cell, SEED, "cpu", containers=CONTAINERS)
    plain = scan.Fleet(injected(cell), SEED, "cpu", containers=CONTAINERS)
    with scan.histories(cell, fleet) as served:
        assert served is not None
        fetched = [scan.scan(cell, fleet, k, "cpu") for k in range(scan.SAMPLE_SETS)]
    handed = [scan.scan(injected(cell), plain, k, "cpu") for k in range(scan.SAMPLE_SETS)]
    for over_the_wire, in_memory in zip(fetched, handed):
        assert over_the_wire.rendered is not None and over_the_wire.rendered == in_memory.rendered
        assert over_the_wire.wire_bytes > 0 and in_memory.wire_bytes is None
    assert fetched[0].rendered != fetched[1].rendered  # the two sets differ
    readings = harness.judge(cell, fleet, fetched, harness.reference_answers(cell, fleet))
    assert {r.name: r.value for r in readings} == {"cpu_mismatches": 0.0, "memory_mismatches": 0.0}


def test_a_tiny_run_over_prometheus_is_correct_and_reads_the_fetch_layer():
    outcome = harness.run_cell(prom_cell(), SEED, 0.0, True, "cpu", 0.0, containers=CONTAINERS)
    assert outcome.correct and outcome.failed == 0, outcome.line()
    assert outcome.setup_parts["fake_s"] > 0
    assert {"fetch_ms", "fetch_wire_mib", "fetch_points_per_s", "pack_ms", "assemble_ms", "render_ms"} <= set(
        outcome.metrics)
    assert set(outcome.missing) == {"device_idle_pct"}  # no profiler trace of a card
    assert all(entry["value"] > 0 for entry in outcome.metrics.values())


# ---------------------------------------------------------------- the fake
@pytest.fixture(scope="module")
def fake():
    """A ragged fleet of 12 containers in 3 namespaces, served."""
    cell = prom_cell("ragged", namespaces=3)
    fleet = scan.Fleet(cell, SEED, "cpu", containers=12)
    with scan.histories(cell, fleet) as served:
        yield cell, fleet, served


def _get(served, sample_set, path, params, encoding="gzip"):
    url = f"{served.url(sample_set)}{path}?{urllib.parse.urlencode(params)}"
    request = urllib.request.Request(url, headers={"Accept-Encoding": encoding} if encoding else {})
    try:
        with urllib.request.urlopen(request, timeout=60) as response:
            body, status, coding = response.read(), response.status, response.headers.get("Content-Encoding")
    except urllib.error.HTTPError as e:
        body, status, coding = e.read(), e.code, None
    return status, json.loads(gzip.decompress(body) if coding == "gzip" else body)


def _pods(fleet, sample_set):
    """(namespace, pod) → (cpu, memory) samples of a sample set."""
    starts = np.concatenate([[0], np.cumsum(fleet.shape.pod_samples)[:-1]])
    names = [(obj.namespace, pod) for obj in fleet.objects for pod in obj.pods]
    drawn = fleet.samples[sample_set]
    return {name: (drawn.cpu[s:s + n], drawn.memory[s:s + n])
            for name, s, n in zip(names, starts.tolist(), fleet.shape.pod_samples.tolist())}


def _window(cell, served):
    step = cell.config["settings"]["timeframe_duration"] * 60.0
    start = served.end - cell.config["settings"]["history_duration"] * 3600.0
    return start, step


def _expected(fleet, served, sample_set, step, keep, low, high, resource):
    """The series NumPy reads for pods ``keep`` over grid times [low, high]."""
    out = {}
    for (namespace, pod), samples in _pods(fleet, sample_set).items():
        if not keep(namespace, pod):
            continue
        values = samples[0 if resource == "cpu" else 1]
        stamps = served.end - step * np.arange(len(values))[::-1]
        inside = (stamps >= low) & (stamps <= high)
        if inside.any():
            out[(namespace, pod)] = (stamps[inside], values[inside])
    return out


def _assert_matrix(answer, expected, with_namespace):
    assert answer["status"] == "success" and answer["data"]["resultType"] == "matrix"
    got = {}
    for series in answer["data"]["result"]:
        metric = series["metric"]
        assert set(metric) == ({"namespace", "pod", "container"} if with_namespace else {"pod", "container"})
        namespace = metric.get("namespace") or next(ns for ns, pod in expected if pod == metric["pod"])
        stamps = np.array([float(t) for t, _ in series["values"]])
        values = np.array([float(v) for _, v in series["values"]])
        assert all("e" not in v and "E" not in v for _, v in series["values"])
        got[(namespace, metric["pod"])] = (stamps, values)
    assert set(got) == set(expected)
    for key, (stamps, values) in expected.items():
        np.testing.assert_array_equal(got[key][0], stamps)
        np.testing.assert_array_equal(got[key][1], values)  # the generator's doubles, exactly


@pytest.mark.parametrize("encoding", ["gzip", None])
@pytest.mark.parametrize("sample_set", [0, 1])
def test_the_namespace_range_queries_return_the_samples_numpy_reads(fake, encoding, sample_set):
    cell, fleet, served = fake
    start, step = _window(cell, served)
    for resource, query in (("cpu", f'sum by (pod, container) ({CPU}{{namespace="ns-1"}})'),
                            ("memory", f'sum by (pod, container) ({MEMORY}{{job="kubelet", '
                                       f'metrics_path="/metrics/cadvisor", image!="", namespace="ns-1"}})')):
        status, answer = _get(served, sample_set, "/api/v1/query_range",
                              {"query": query, "start": start, "end": served.end, "step": "15m"}, encoding)
        assert status == 200
        expected = _expected(fleet, served, sample_set, step, lambda ns, pod: ns == "ns-1", start, served.end,
                             resource)
        _assert_matrix(answer, expected, with_namespace=False)


def test_the_coalesced_shard_and_workload_shapes_and_a_sub_window(fake):
    cell, fleet, served = fake
    start, step = _window(cell, served)
    low, high = start + 900 * 700, start + 900 * 1200
    pods = [pod for obj in fleet.objects if obj.namespace == "ns-2" for pod in obj.pods][:2]
    cases = [
        (f'sum by (namespace, pod, container) ({CPU}{{namespace=~"ns-0|ns-2"}})', True,
         lambda ns, pod: ns in ("ns-0", "ns-2")),
        (f'sum by (pod, container) ({CPU}{{namespace="ns-2", pod=~"{"|".join(pods)}"}})', False,
         lambda ns, pod: pod in pods),
        (f'sum by (pod, container) ({CPU}{{namespace="ns-0", pod!~"workload-0-.*", container="main"}})', False,
         lambda ns, pod: ns == "ns-0" and not pod.startswith("workload-0-")),
    ]
    for query, with_namespace, keep in cases:
        status, answer = _get(served, 0, "/api/v1/query_range",
                              {"query": query, "start": low, "end": high, "step": 900})
        assert status == 200
        _assert_matrix(answer, _expected(fleet, served, 0, step, keep, low, high, "cpu"), with_namespace)
    query = f'sum by (pod) ({CPU}{{namespace="ns-2", pod=~"{pods[0]}", container="main"}})'
    status, answer = _get(served, 1, "/api/v1/query_range", {"query": query, "start": start, "end": served.end,
                                                             "step": "15m"})
    (series,) = answer["data"]["result"]
    assert series["metric"] == {"pod": pods[0]}
    np.testing.assert_array_equal([float(v) for _, v in series["values"]], _pods(fleet, 1)[("ns-2", pods[0])][0])


def test_the_instant_probes(fake):
    cell, fleet, served = fake
    in_ns = sum(len(obj.pods) for obj in fleet.objects if obj.namespace == "ns-1")
    query = f'count(sum by (pod, container) ({CPU}{{namespace="ns-1"}}))'
    status, answer = _get(served, 0, "/api/v1/query", {"query": query, "time": served.end})
    assert status == 200 and answer["data"] == {"resultType": "vector",
                                                "result": [{"metric": {}, "value": [served.end, str(in_ns)]}]}
    assert _get(served, 0, "/api/v1/query", {"query": "example"})[1]["data"]["result"] == []
    # An instant 4 minutes past a grid point reads that point's sample (lookback 5 minutes); 6 past, nothing.
    at = served.end - 900 * 3 + 240
    status, answer = _get(served, 1, "/api/v1/query", {"query": f'{MEMORY}{{namespace="ns-0"}}', "time": at})
    expected = {pod: values[1][-4] for (ns, pod), values in _pods(fleet, 1).items()
                if ns == "ns-0" and len(values[1]) >= 4}
    got = {series["metric"]["pod"]: float(series["value"][1]) for series in answer["data"]["result"]}
    assert got == expected and all(s["metric"]["image"] for s in answer["data"]["result"])
    status, answer = _get(served, 1, "/api/v1/query", {"query": f'{MEMORY}{{namespace="ns-0"}}', "time": at + 120})
    assert answer["data"]["result"] == []


@pytest.mark.parametrize("query, start_offset, step", [
    (f'rate({CPU}[5m])', 0, "15m"),
    (f'max_over_time((sum by (pod, container) ({CPU}{{namespace="ns-0"}}))[3600s:900s])', 0, "1h"),
    (f'sum({CPU})', 0, "15m"),
    ("count_over_time(vector(1)[120s:60s])", 0, "15m"),
    (f'sum by (pod, container) ({CPU}{{namespace=~"ns\\-0"}})', 0, "15m"),  # PromQL knows no \- escape
    (f'sum by (pod, container) ({CPU}{{namespace="ns-0"}})', 0, "5m"),  # off the grid's step
    (f'sum by (pod, container) ({CPU}{{namespace="ns-0"}})', 60, "15m"),  # off the grid's start
    (f'sum by (namespace) ({CPU})', 0, "15m"),  # a sum over many series a group
])
def test_a_query_the_fake_does_not_evaluate_gets_400(fake, query, start_offset, step):
    cell, _fleet, served = fake
    start, _step = _window(cell, served)
    status, answer = _get(served, 0, "/api/v1/query_range",
                          {"query": query, "start": start + start_offset, "end": served.end, "step": step})
    assert status == 400 and answer["status"] == "error" and answer["errorType"] == "bad_data"


def test_values_are_written_as_go_writes_them():
    assert [prometheus.go_float(v) for v in (5.1234e-05, 1e16, 3.0, 1430085760.0, 0.1, -2.5e-07)] == [
        "0.000051234", "10000000000000000", "3", "1430085760", "0.1", "-0.00000025"]
    values = np.array([5.1234e-05, 0.31602784991264343, 7.0, 2.0**-20])
    assert prometheus.format_values(values) == [prometheus.go_float(v) for v in values.tolist()]
    assert [float(text) for text in prometheus.format_values(values)] == values.tolist()


# ------------------------------------------------------- planted faults
def _decisive_pod(cell, fleet):
    """A pod of sample set 0 whose last sample, left out, changes an answer."""
    settings = cell.config["settings"]
    drawn, counts = fleet.samples[0], fleet.shape.pod_samples

    def answers(cpu, memory, lengths):
        return recommend(cpu, memory, fleet.shape.replicas, lengths, cpu_percentile=settings["cpu_percentile"],
                         memory_buffer_percentage=settings["memory_buffer_percentage"],
                         cpu_min_millicores=cell.config["cpu_min_millicores"],
                         memory_min_mb=cell.config["memory_min_mb"])

    whole = answers(drawn.cpu, drawn.memory, counts)
    ends = np.cumsum(counts)
    for pod in range(len(counts)):
        lengths = counts.copy()
        lengths[pod] -= 1
        cut = answers(np.delete(drawn.cpu, ends[pod] - 1), np.delete(drawn.memory, ends[pod] - 1), lengths)
        if cut.cpu_request != whole.cpu_request or cut.memory_request != whole.memory_request:
            return pod
    raise AssertionError("no pod's last sample decides an answer")


@pytest.mark.parametrize("fault", ["drop_last", "other_set", "three_digits"])
def test_a_planted_fault_of_the_fake_is_not_correct(monkeypatch, fault):
    cell = prom_cell()
    options = {"fault": fault}
    if fault == "drop_last":
        options["fault_pod"] = _decisive_pod(cell, scan.Fleet(cell, SEED, "cpu", containers=CONTAINERS))
    monkeypatch.setattr(scan, "histories", functools.partial(scan.histories, **options))
    outcome = harness.run_cell(cell, SEED, 0.0, False, "cpu", 0.0, containers=CONTAINERS)
    assert not outcome.correct, outcome.line()


# ------------------------------------------------------------- lifetime
def _watched(monkeypatch):
    processes = []
    original = prometheus.served

    @functools.wraps(original)
    def watched(*args, **kwargs):
        with original(*args, **kwargs) as served:
            processes.append(served.process)
            yield served

    import contextlib

    monkeypatch.setattr(prometheus, "served", contextlib.contextmanager(watched))
    return processes


def _gone(process):
    """The process has ended and been waited for, and left no child."""
    children = f"/proc/{process.pid}/task/{process.pid}/children"
    return process.returncode is not None and not os.path.exists(children)


def test_the_fake_is_gone_once_a_run_returns(monkeypatch):
    processes = _watched(monkeypatch)
    outcome = harness.run_cell(prom_cell(), SEED, 0.0, False, "cpu", 0.0, containers=12)
    assert outcome.correct and len(processes) == 1 and _gone(processes[0])
    assert processes[0].returncode == 0


def test_the_fake_is_gone_once_a_run_raises(monkeypatch):
    processes = _watched(monkeypatch)

    def broken(*args, **kwargs):
        raise RuntimeError("a scan that fails")

    monkeypatch.setattr(scan, "scan", broken)
    with pytest.raises(RuntimeError, match="a scan that fails"):
        harness.run_cell(prom_cell(), SEED, 0.0, False, "cpu", 0.0, containers=12)
    assert len(processes) == 1 and _gone(processes[0])
