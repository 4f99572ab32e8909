"""Tiny cells driven through ``Runner.run`` on the CPU (the port's plain
versions) and held to the reference, as a run on the card holds them; the
control and the planted faults come out not correct."""

import json
import shutil
from decimal import Decimal

import pytest

from benchmark import check, harness, scan, spec

CELLS = ["simple-14d-15m.uniform", "tdigest-28d-1m.uniform", "simple-14d-15m.ragged"]
SEED = 2**31 + 99
CONTAINERS = 24


def tiny_run(name, trace=False, root=spec.ROOT):
    cell = spec.load_cell(name, root)
    return harness.run_cell(cell, SEED, 0.0, trace, "cpu", 0.0, containers=CONTAINERS)


@pytest.mark.parametrize("name", CELLS)
def test_a_tiny_cell_agrees_with_the_reference(name):
    outcome = tiny_run(name)
    assert outcome.correct, outcome.line()
    assert outcome.attempted == CONTAINERS and outcome.failed == 0  # a window of 0 s: one scan
    assert all(reading.holds for reading in outcome.readings)
    assert set(outcome.metrics) == {"setup_s"}  # peak_device_mib is read on a card alone
    line = outcome.line()
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "setup_parts", "checks"]
    assert line["setup_parts"]["build_s"] == 0.0 and line["setup_parts"]["warmup_scan_s"] > 0


def test_a_traced_tiny_cell_reads_the_host_layers_and_names_the_rest():
    outcome = tiny_run("simple-14d-15m.ragged", trace=True)
    assert outcome.correct
    host = {"scan_containers_per_s.host", "discover_ms", "post_compute_ms", "pack_ms", "pad_waste_pct",
            "device_stage_ms", "finalize_ms", "assemble_ms", "render_ms", "cast_ms", "h2d_ms", "h2d_mib",
            "pack_minor_faults"}
    assert set(outcome.metrics) == host
    assert set(outcome.missing) == {"h2d_gbps", "kernels_roofline", "device_idle_pct"}
    assert outcome.metrics["pad_waste_pct"]["value"] > 50
    assert all(entry["value"] > 0 for entry in outcome.metrics.values())


def test_a_new_mix_and_cell_need_no_edit(tmp_path):
    shutil.copytree(spec.ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: p.read_bytes() for p in (tmp_path / "benchmark").rglob("*") if p.is_file()}
    (tmp_path / "benchmark" / "mixes" / "singletons.json").write_text(json.dumps(
        {"why": "one pod a container, a third of them short", "replica_weights": [1],
         "full_pod_share": 0.67, "shape_seed": 3}))
    bench = spec.load_benchmark()
    bench["workloads"].append({"name": "tdigest-28d-1m.singletons", "config": "tdigest-28d-1m",
                               "traffic": "singletons", "chips": 1, "why": "one pod a container"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    outcome = tiny_run("tdigest-28d-1m.singletons", root=tmp_path)
    assert outcome.correct and outcome.attempted == CONTAINERS
    assert all(p.read_bytes() == data for p, data in before.items())


@pytest.mark.parametrize("name", CELLS)
def test_the_bfloat16_control_is_not_correct(name):
    cell = spec.load_cell(name)
    fleet = scan.Fleet(cell, SEED, "cpu", containers=200)
    exact = harness.reference_answers(cell, fleet)
    low = harness.reference_answers(cell, fleet, precision="bfloat16")
    readings = check.worst([check.compare(check.as_rendered(low[i]), exact[i], cell.config["guarantee"],
                                          harness.cpu_floor(cell)) for i in exact])
    assert not all(reading.holds for reading in readings)
    assert {r.name: r.value for r in readings}["memory_mismatches"] > 20


def _stale(strategy_class):
    """A scan that returns the first scan's answers, whatever it reads."""
    original = strategy_class.run_batch
    first = {}

    def run_batch(self, batch):
        if "results" not in first:
            first["results"] = original(self, batch)
        return first["results"]

    return run_batch


def _half(original):
    """Half of every row's samples left out."""
    from krr_tpu_torch.models.series import PackedSeries

    def packed(self, resource):
        whole = original(self, resource)
        return PackedSeries(values=whole.values, counts=(whole.counts + 1) // 2)

    return packed


def _half_the_rows(original):
    """The later half of the batch's rows left out."""
    from krr_tpu_torch.models.series import PackedSeries

    def packed(self, resource):
        whole = original(self, resource)
        counts = whole.counts.copy()
        counts[len(counts) // 2:] = 0
        return PackedSeries(values=whole.values, counts=counts)

    return packed


def _altered(original, resource_name, amount):
    """One container's answer moved where the strategy produces it."""
    from krr_tpu_torch.models import ResourceType
    from krr_tpu_torch.strategies.base import ResourceRecommendation

    resource = ResourceType(resource_name)

    def finalize(*args, **kwargs):
        results = original(*args, **kwargs)
        answer = results[0][resource]
        moved = lambda value: None if value is None else value + Decimal(amount)
        results[0][resource] = ResourceRecommendation(request=moved(answer.request), limit=moved(answer.limit))
        return results

    return finalize


def _bucket_above(original):
    """The digest's query reads each bucket's estimate from the bucket above."""
    import torch

    def bucket_estimates(spec):
        estimates = original(spec)
        return torch.cat([estimates[1:], estimates[-1:] * spec.gamma])

    return bucket_estimates


def test_the_digest_fault_of_the_control_script_reads_past_the_guarantee():
    from benchmark import control

    cell = spec.load_cell("tdigest-28d-1m.uniform")
    fleet = scan.Fleet(cell, SEED, "cpu", containers=40)
    exact = harness.reference_answers(cell, fleet, sets=[0])[0]
    guarantee, floor = cell.config["guarantee"], harness.cpu_floor(cell)
    sound = check.compare(control.digest_answers(cell, fleet, exact, 0), exact, guarantee, floor)
    fault = check.compare(control.digest_answers(cell, fleet, exact, 1), exact, guarantee, floor)
    assert all(reading.holds for reading in sound), sound
    gap = {r.name: r for r in fault}["cpu_gap"]
    assert not gap.holds and gap.value > 1.5 * gap.limit


# Half of each row's samples left out moves a p99 of stationary samples by
# far less than the digest's error, so the digest's cell leaves out half the
# rows instead.
FAULTS = [(name, fault) for name in ("simple-14d-15m.uniform", "tdigest-28d-1m.uniform")
          for fault in ("state_unchanged", "memory_answer_altered")] + [
    ("simple-14d-15m.uniform", "half_the_samples"), ("tdigest-28d-1m.uniform", "half_the_rows"),
    ("simple-14d-15m.ragged", "cpu_answer_altered"), ("tdigest-28d-1m.uniform", "digest_bucket_off_by_one")]


@pytest.mark.parametrize("name, fault", FAULTS)
def test_a_planted_fault_is_not_correct(monkeypatch, name, fault):
    from krr_tpu_torch.models.series import FleetBatch
    from krr_tpu_torch.strategies import simple, tdigest

    if fault == "state_unchanged":
        for cls in (simple.SimpleStrategy, tdigest.TDigestStrategy):
            monkeypatch.setattr(cls, "run_batch", _stale(cls))
    elif fault == "digest_bucket_off_by_one":
        from krr_tpu_torch.ops import digest as digest_ops

        monkeypatch.setattr(digest_ops, "bucket_estimates", _bucket_above(digest_ops.bucket_estimates))
    elif fault == "half_the_samples":
        monkeypatch.setattr(FleetBatch, "packed", _half(FleetBatch.packed))
    elif fault == "half_the_rows":
        monkeypatch.setattr(FleetBatch, "packed", _half_the_rows(FleetBatch.packed))
    else:
        resource, amount = ("memory", "1000000") if fault == "memory_answer_altered" else ("cpu", "0.001")
        altered = _altered(simple.finalize_fleet, resource, amount)
        monkeypatch.setattr(simple, "finalize_fleet", altered)
        monkeypatch.setattr(tdigest, "finalize_fleet", altered)
    outcome = tiny_run(name)
    assert not outcome.correct, outcome.line()
