"""``BENCHMARK.json`` and the files it names keep to the benchmark's
contract: names, units, lengths, and a file for every configuration, mix
and per-layer metric."""

import json
import math

import pytest

from benchmark import spec

BENCH = spec.load_benchmark()
NAMES = ([m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]] + [c["name"] for c in BENCH["configs"]]
         + [w["name"] for w in BENCH["workloads"]] + [w["traffic"] for w in BENCH["workloads"]]
         + [key for c in BENCH["configs"] for key in c["reduced"]])


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "benchmark/run.py"] and BENCH["paths"] == ["benchmark"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len((spec.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("name", NAMES)
def test_names_use_only_the_allowed_characters(name):
    assert spec.NAME.match(name), name


def test_units_lines_and_uniqueness():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert all(spec.UNIT.match(m["unit"]) for m in metrics)
    assert all(m["better"] in ("lower", "higher") for m in metrics)
    for group in (metrics, BENCH["configs"], BENCH["workloads"]):
        assert len({entry["name"] for entry in group}) == len(group)
    texts = [w["why"] for w in BENCH["workloads"]] + [c["why"] for c in BENCH["configs"]] + [
        c["source"] for c in BENCH["configs"]] + [m["layer"] for m in BENCH["per_layer"]]
    assert all(1 <= len(t) <= 200 and "\n" not in t and "\t" not in t for t in texts)


def test_end_to_end_metrics_and_bounds():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert {"setup_s", "peak_device_mib"} <= set(e2e)
    assert all(0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace") for m in e2e.values())
    assert all(set(m) <= {"name", "unit", "better", "bound", "source", "workloads"} for m in e2e.values())


def test_every_per_layer_metric_has_its_reader_and_moves_an_end_to_end_metric():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    for metric in BENCH["per_layer"]:
        assert set(metric) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert metric["moves"] in e2e and metric["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
        assert spec.metric_path(spec.ROOT, metric["name"]).is_file()
        assert set(metric.get("workloads", cells)) <= cells


def test_every_cell_finds_its_configuration_and_mix():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files) and all(f.startswith("benchmark/") for f in files)
    for workload in BENCH["workloads"]:
        cell = spec.load_cell(workload["name"])
        assert cell.chips == 1 and cell.config["name"] == workload["config"]
        assert spec.samples_per_pod(cell.config) * cell.config["settings"]["timeframe_duration"] == (
            cell.config["settings"]["history_duration"] * 60)
        entry = {c["name"]: c for c in BENCH["configs"]}[workload["config"]]
        assert entry["reduced"] == cell.config["reduced"]


def test_the_digest_guarantee_is_its_documented_relative_error():
    config = spec.load_cell("tdigest-28d-1m.uniform").config
    stated = math.sqrt(config["settings"]["digest_gamma"]) - 1
    assert config["guarantee"]["cpu_relative_error"] == stated * 1.05
    from krr_tpu_torch.strategies.tdigest import TDigestStrategySettings

    settings = TDigestStrategySettings(**config["settings"])
    assert settings.cpu_spec().relative_error == stated


def test_the_configurations_state_the_ports_defaults():
    from krr_tpu_torch.core.config import Config
    from krr_tpu_torch.strategies.simple import SimpleStrategySettings

    defaults = Config()
    for name in ("simple-14d-15m.uniform", "tdigest-28d-1m.uniform"):
        config = spec.load_cell(name).config
        assert (config["cpu_min_millicores"], config["memory_min_mb"]) == (
            defaults.cpu_min_value, defaults.memory_min_value)
    simple = spec.load_cell("simple-14d-15m.uniform").config["settings"]
    assert SimpleStrategySettings(**simple) == SimpleStrategySettings()
    assert json.loads(json.dumps(simple)) == simple
