"""The bench's journal, chaos, eval, discovery, fetch-plan, wire and
fleet-observability legs (`bench_torch.py`) on the CPU.

`journal_leg`, `chaos_leg`, `eval_leg`, `discovery_leg`, `fetchplan_leg`,
`wire_leg` and `fleet_obs_leg` drive the port's history journal, serve
under scripted faults, eval replays, watch discovery, fetch planner, wire
shrink and federation lineage. What is held here:

* (a) one ``--smoke --device cpu`` run of these seven legs in a subprocess
  (``BENCH_SKIP_E2E`` and every other leg's skip) under the import
  blocker of `tests/torch_bench_support.py`: no process imports ``jax*``
  or ``krr_tpu.*``; every field `tests/test_bench_smoke.py` requires of
  these legs is there, but ``> 0`` on the rounded
  ``discovery_reconcile_seconds`` (a reconcile under 0.05 ms reads 0.0;
  ``discovery_speedup`` keeps the unrounded ratio); every exact gate's
  line says ``ok``; each wall-clock gate (``WALL_CLOCK_GATES``) ran, and
  one that FAILED is reported with ``warnings.warn``, not asserted
  (`chip_smoke.py` asserts them on the card); every leg is listed in
  ``kernel_launches_by_leg``, with no launch: the plain versions count
  none.
* (b) `bench.py`'s same legs in this process at the same smoke sizes and
  seeds: their exact gates held, and every field that counts work equals
  the port's (``PINNED``; the journal's appended and compacted records
  are read from its line). Not pinned, with the reason:
  ``chaos_breaker_opens`` (the breaker's cooldown and half-open probes run
  on the wall clock: 4 in a CPU run of the port, 5 in one of the JAX leg);
  every ``*_seconds``, ``*_per_sec``, ``*_speedup`` and overhead field
  (wall clock).
* (c) the exact gates are real: for each leg with one, one case makes its
  comparator report a difference, and ``main`` exits 1 naming that gate.
* (d) the eval leg's board against the JAX leg's: the same ranking,
  incidents, flaps and counts, the slacks within ROADMAP Queue 3 item 10's
  tolerance; and the launches ``eval_leg`` expects on the card equal what
  its replays call, counted at the wrappers' call sites.
* the chaos fakes (`tests/fakes/torch_chaos.py`) against the originals: a
  fault timeline's schedule and what it sets on the fakes, the disk-fault
  seams' raising ops, ``fleet_replay_input``'s arrays, and ``run_soak``'s
  report on a never-faulted control.
"""

from __future__ import annotations

import asyncio
import contextlib
import dataclasses
import errno
import io
import json
import os
import re
import warnings

import numpy as np
import pytest

import bench
import bench_torch
import krr_tpu.eval as jax_eval
import krr_tpu_torch.eval as port_eval
import krr_tpu_torch.obs.trace as port_trace
from tests.fakes import chaos, torch_chaos
from tests.fakes.servers import FakeBackend, FakeCluster, FakeMetrics
from tests.test_torch_eval import SLACK_FIELDS, assert_slack_close
from tests.torch_bench_support import (
    NO_LAUNCHES,
    blocked_smoke,
    broken_gate_run,
    count_wrapper_calls,
    gate_lines,
    jax_legs,
    meets,
    parity_failures,
)

#: The skip knobs of the seven legs.
RUN = ("BENCH_SKIP_JOURNAL", "BENCH_SKIP_CHAOS", "BENCH_SKIP_EVAL", "BENCH_SKIP_DISCOVERY",
       "BENCH_SKIP_FETCHPLAN", "BENCH_SKIP_WIRE", "BENCH_SKIP_FLEETOBS")

#: The seven legs as ``kernel_launches_by_leg`` names them.
LEGS = ("journal", "chaos", "eval", "discovery", "fetchplan", "wire", "fleet_obs")

#: The gates whose result must not depend on the host's speed.
EXACT_GATES = (
    "chaos_no_starvation", "chaos_down_tick_aborts", "chaos_recovery_bitexact",
    "eval_deterministic", "eval_ranks_labeled_archetypes",
    "discovery_bitexact",
    "fetchplan_engaged", "fetchplan_bitexact", "fetchplan_autotuner",
    "wire_bitexact", "wire_engaged", "wire_ratio",
    "fleet_trace_stitched", "fleet_freshness_monotonic",
    *(f"{leg}_kernel_launches" for leg in LEGS),
)

#: The gates that read a wall clock. ``fleet_lineage_overhead`` is half
#: exact: its line must say ``bitexact=True`` either way.
WALL_CLOCK_GATES = ("chaos_down_tick_wall_bounded", "discovery_reconcile_beats_relist", "fleet_lineage_overhead")

#: The fields `tests/test_bench_smoke.py:42-47` and `:87-122`, `:163-178`
#: require of these legs: (comparison, bound), or None for presence.
REQUIRED = {
    "journal_append_records_per_sec": (">", 0), "journal_compact_records_per_sec": (">", 0),
    "journal_diff_objects_per_sec": (">", 0),
    "chaos_ticks": (">=", 8), "chaos_degraded_ticks": ("==", 2), "chaos_aborted_ticks": ("==", 1),
    "chaos_breaker_opens": (">=", 1), "chaos_recovered_bitexact": ("==", 1.0), "chaos_down_tick_seconds": (">", 0),
    "eval_workloads": (">=", 3), "eval_samples": (">", 0), "eval_replay_seconds": (">", 0),
    "eval_replay_rows_per_sec": (">", 0),
    "discovery_bitexact": ("==", 1.0), "discovery_reconcile_beats_relist": None,
    "discovery_relist_seconds": (">", 0), "discovery_reconcile_seconds": None, "discovery_speedup": (">", 0),
    "fetchplan_coalesced": (">=", 1), "fetchplan_sharded": (">=", 2), "fetchplan_bitexact": ("==", 1.0),
    "fetchplan_autotune_engaged": ("==", 1.0),
    "wire_bitexact": ("==", 1.0), "wire_gzip_responses": (">=", 1), "wire_downsampled_queries": (">=", 1),
    "wire_compression_ratio": (">=", 5.0),
    "fleet_trace_stitched": ("==", 1.0), "fleet_freshness_monotonic": ("==", 1.0),
    "fleet_lineage_bitexact": ("==", 1.0), "fleet_stitched_components": (">=", 1), "fleet_stitched_lanes": (">=", 4),
    "fleet_lineage_epochs": (">=", 1), "fleet_lineage_wall_seconds": (">", 0),
    "fleet_control_wall_seconds": (">", 0), "fleet_lineage_overhead_seconds": None,
}

#: The fields that count work, equal between the packages at the same
#: sizes and seeds (the ``journal_*`` two are read from the journal's line).
PINNED = (
    "journal_appends", "journal_compacted_records",
    "chaos_ticks", "chaos_degraded_ticks", "chaos_aborted_ticks", "chaos_recovered_bitexact",
    "eval_workloads", "eval_samples",
    "discovery_workloads", "discovery_churn_per_round", "discovery_bitexact",
    "fetchplan_coalesced", "fetchplan_sharded", "fetchplan_bitexact", "fetchplan_autotune_engaged",
    "wire_identity_mb", "wire_compressed_mb", "wire_compression_ratio", "wire_gzip_responses",
    "wire_downsampled_queries", "wire_bitexact",
    "fleet_obs_ticks", "fleet_trace_stitched", "fleet_stitched_components", "fleet_stitched_lanes",
    "fleet_freshness_monotonic", "fleet_lineage_epochs", "fleet_lineage_bitexact",
)


def journal_counts(stderr: str) -> dict:
    """The journal leg's appended and compacted records, from its line."""
    match = re.search(r"^bench: journal (\d+) appends .* compaction of (\d+) recs", stderr, re.M)
    return {"journal_appends": int(match.group(1)), "journal_compacted_records": int(match.group(2))}


@pytest.fixture(scope="module")
def legs_run(tmp_path_factory):
    """(rc, payload, stderr, refused imports, started command lines) of the
    seven legs' blocked smoke run."""
    return blocked_smoke(tmp_path_factory.mktemp("legs"), RUN)


# ----------------------------------------------------------------------- (a)
def test_no_process_imports_jax(legs_run):
    rc, payload, stderr, refused, started = legs_run
    assert refused == {}, refused
    assert any("bench_torch.py" in line for line in started), started
    assert payload, stderr[-4000:]


@pytest.mark.parametrize("field", REQUIRED)
def test_fields_of_bench_smoke_present(field, legs_run):
    _rc, payload, stderr, _refused, _started = legs_run
    secondary = payload["secondary"]
    assert field in secondary, stderr[-4000:]
    assert meets(secondary[field], REQUIRED[field]), (field, secondary[field], REQUIRED[field])


@pytest.mark.parametrize("gate", EXACT_GATES)
def test_exact_gate_ok(gate, legs_run):
    _rc, _payload, stderr, _refused, _started = legs_run
    assert gate_lines(stderr).get(gate) == "ok", stderr[-4000:]


@pytest.mark.parametrize("gate", WALL_CLOCK_GATES)
def test_wall_clock_gate_ran(gate, legs_run):
    rc, payload, stderr, _refused, _started = legs_run
    line = gate_lines(stderr).get(gate)
    assert line is not None, stderr[-4000:]
    if gate == "fleet_lineage_overhead" and line != "ok":
        assert "bitexact=True" in line, line
    if line != "ok":
        assert rc == 1 and payload["parity"] == "fail" and gate in parity_failures(stderr)
        warnings.warn(f"wall-clock gate {gate} {line} on this host (asserted on the card by chip_smoke.py)")


def test_every_leg_launch_counted(legs_run):
    _rc, payload, stderr, _refused, _started = legs_run
    assert payload["secondary"]["kernel_launches_by_leg"] == dict.fromkeys(LEGS, NO_LAUNCHES), stderr[-4000:]


def test_only_wall_clock_gates_may_fail(legs_run):
    rc, payload, stderr, _refused, _started = legs_run
    failures = parity_failures(stderr)
    assert set(failures) <= set(WALL_CLOCK_GATES), failures
    assert (rc, payload["parity"]) == ((1, "fail") if failures else (0, "ok")), stderr[-4000:]


# ----------------------------------------------------------------------- (b)
@pytest.fixture(scope="module")
def jax_run():
    """`bench.py`'s seven legs in this process at the smoke sizes: their
    ``secondary`` (with the journal's counts) and ``{gate: ok}``."""
    secondary, gates, err = jax_legs((lambda secondary, check: bench.journal_leg(secondary), bench.chaos_leg,
                                      bench.eval_leg, bench.discovery_leg, bench.fetchplan_leg, bench.wire_leg,
                                      bench.fleet_obs_leg))
    secondary.update(journal_counts(err))
    return secondary, gates


def test_jax_legs_held_their_exact_gates(jax_run):
    _secondary, gates = jax_run
    held = [gate for gate in EXACT_GATES if not gate.endswith("_kernel_launches")]
    assert {gate: gates.get(gate) for gate in held} == dict.fromkeys(held, True)


@pytest.mark.parametrize("field", PINNED)
def test_work_counts_equal_bench(field, legs_run, jax_run):
    _rc, payload, stderr, _refused, _started = legs_run
    port = dict(payload["secondary"], **journal_counts(stderr))
    assert port[field] == jax_run[0][field], (field, port[field], jax_run[0][field])


# ----------------------------------------------------------------------- (c)
def _never(*args, **kwargs):
    return False


#: leg → (its skip knob, (module, attribute, replacement), the gate it fails).
GATE_CASES = {
    "chaos": ("BENCH_SKIP_CHAOS", (torch_chaos, "stores_bitexact", lambda a, b: (False, "injected")),
              "chaos_recovery_bitexact"),
    "eval": ("BENCH_SKIP_EVAL", (bench_torch, "same_text", _never), "eval_deterministic"),
    "discovery": ("BENCH_SKIP_DISCOVERY", (bench_torch, "same_dumps", _never), "discovery_bitexact"),
    "fetchplan": ("BENCH_SKIP_FETCHPLAN", (bench_torch, "same_array", _never), "fetchplan_bitexact"),
    "wire": ("BENCH_SKIP_WIRE", (bench_torch, "same_array", _never), "wire_bitexact"),
    "fleet_obs": ("BENCH_SKIP_FLEETOBS", (port_trace, "stitch_chrome", lambda payloads: {"traceEvents": []}),
                  "fleet_trace_stitched"),
}


@pytest.mark.parametrize("leg", GATE_CASES)
def test_exact_gates_are_real(leg, monkeypatch, capsys):
    skip, (module, name, replacement), gate = GATE_CASES[leg]
    monkeypatch.setattr(module, name, replacement)
    rc, payload, failures, err = broken_gate_run(skip, {}, capsys)
    assert (rc, payload["parity"]) == (1, "fail"), err[-3000:]
    assert gate in failures and set(failures) <= {gate, *WALL_CLOCK_GATES}, failures
    assert f"bench: parity [{gate}] FAILED" in err


# ----------------------------------------------------------------------- (d)
def _first_board(package, run, monkeypatch) -> dict:
    """The first board ``run()`` renders through ``package``, parsed."""
    boards = []
    render = package.render_scoreboard

    def keep(board, fmt):
        boards.append(render(board, fmt))
        return boards[-1]

    monkeypatch.setattr(package, "render_scoreboard", keep)
    run()
    return json.loads(boards[0])


def test_eval_board_equals_bench(monkeypatch):
    for key, value in bench_torch.SMOKE_DEFAULTS.items():
        monkeypatch.setenv(key, value)
    gates: dict = {}

    def check(name, ok, detail=""):
        gates[name] = ok

    with contextlib.redirect_stderr(io.StringIO()):
        port = _first_board(port_eval, lambda: bench_torch.eval_leg({}, check, dict(os.environ), "cpu"), monkeypatch)
        jax = _first_board(jax_eval, lambda: bench.eval_leg({}, check), monkeypatch)
    assert gates == {"eval_deterministic": True, "eval_ranks_labeled_archetypes": True}
    assert [s["strategy"] for s in port["scores"]] == [s["strategy"] for s in jax["scores"]]
    assert {k: v for k, v in port.items() if k != "scores"} == {k: v for k, v in jax.items() if k != "scores"}
    for port_row, jax_row in zip(port["scores"], jax["scores"]):
        assert {k: v for k, v in port_row.items() if k not in SLACK_FIELDS} == {
            k: v for k, v in jax_row.items() if k not in SLACK_FIELDS}
        for field in SLACK_FIELDS:
            assert_slack_close(port_row[field], jax_row[field])


def test_eval_launches_equal_its_replays_calls(monkeypatch):
    """Two boards of ``simple`` (K1 + K2) and ``tdigest`` (K3 + K2), one
    ``run_batch`` a replay tick: 12 ticks a strategy at the smoke size."""
    calls = count_wrapper_calls(monkeypatch)
    env = {**bench_torch.SMOKE_DEFAULTS}
    with contextlib.redirect_stderr(io.StringIO()):
        expected = bench_torch.eval_leg({}, lambda *a: None, env, "cpu")
    assert calls == expected
    assert expected == {**NO_LAUNCHES, "bisect_select": 12, "row_max": 24, "digest_hist": 12}


# ------------------------------------------------------------- the fakes
#: Every knob of a fault spec, over three spans.
TIMELINE_SPANS = (
    (1, 2, dict(fail_namespaces=frozenset({"diurnal"}))),
    (3, 3, dict(down=True, latency_seconds=0.01)),
    (5, 6, dict(fail_rate=0.3, fault_seed=7, truncate_bodies=True, freeze_discovery=True)),
)


def _fake_knobs(backend) -> dict:
    metrics = backend.metrics
    knobs = {name: getattr(metrics, name) for name in
             ("down", "fail_namespaces", "fail_rate", "latency_seconds", "truncate_bodies", "fault_seed")}
    return {**knobs, "frozen": backend.frozen_cluster is not None}


def test_fault_timeline_equals_original():
    timelines = [module.FaultTimeline([(a, b, module.FaultSpec(**kw)) for a, b, kw in TIMELINE_SPANS])
                 for module in (torch_chaos, chaos)]
    port, jax = timelines
    assert dataclasses.asdict(torch_chaos.CLEAN) == dataclasses.asdict(chaos.CLEAN)
    for tick in range(8):
        assert dataclasses.asdict(port.at(tick)) == dataclasses.asdict(jax.at(tick))
        assert port.at(tick).clean == jax.at(tick).clean
        backends = [FakeBackend(FakeCluster(), FakeMetrics()) for _ in range(2)]
        port.apply(backends[0], tick)
        jax.apply(backends[1], tick)
        assert _fake_knobs(backends[0]) == _fake_knobs(backends[1])


#: A durable store's fs-op sequence: (op, arguments after the file).
FS_SEQUENCE = ("write", "fsync", "append", "append", "fsync", "truncate", "replace", "fsync_dir")


def _drive(fs, tmp_path) -> list:
    """Run ``FS_SEQUENCE`` through ``fs``: each op's outcome (``ok``, the
    errno, or ``crash``)."""
    outcomes = []
    path = tmp_path / "data"
    with open(path, "wb+") as f:
        for op in FS_SEQUENCE:
            try:
                if op in ("write", "append"):
                    getattr(fs, op)(f, b"payload")
                elif op == "fsync":
                    fs.fsync(f)
                elif op == "truncate":
                    fs.truncate(f, 3)
                elif op == "replace":
                    (tmp_path / "src").write_bytes(b"x")
                    fs.replace(str(tmp_path / "src"), str(tmp_path / "dst"))
                else:
                    fs.fsync_dir(str(tmp_path))
                outcomes.append("ok")
            except OSError as e:
                outcomes.append(e.errno)
            except BaseException as e:  # the crash point is a BaseException
                outcomes.append(type(e).__name__)
    return outcomes


@pytest.mark.parametrize("make", [
    lambda m: m.FaultyFs(),
    lambda m: m.FaultyFs(("append", "fsync"), after=1),
    lambda m: m.FaultyFs(("replace", "truncate"), error=errno.EIO),
    lambda m: m.CrashPointFs(),
    *(lambda m, k=k: m.CrashPointFs(crash_at=k) for k in (0, 3, 7)),
], ids=["faulty-default", "faulty-after", "faulty-eio", "crash-never", "crash-0", "crash-3", "crash-7"])
def test_disk_fault_seams_raise_on_the_same_ops(make, tmp_path):
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    port, jax = make(torch_chaos), make(chaos)
    assert _drive(port, tmp_path / "port") == _drive(jax, tmp_path / "jax")
    assert (port.calls, getattr(port, "faults", None)) == (jax.calls, getattr(jax, "faults", None))


def test_fleet_replay_input_equals_original():
    """The eval leg's fleet (`bench.py:516-523`) at the default sizes."""
    fleets = [module.build_fleet(tuple(module.ArchetypeSpec(kind, workloads=2, pods=2)
                                       for kind in ("oom-loop", "diurnal", "bursty-batch")), samples=240, seed=31)
              for module in (torch_chaos, chaos)]
    port, jax = torch_chaos.fleet_replay_input(fleets[0]), chaos.fleet_replay_input(fleets[1])
    assert port.keys == jax.keys
    for field in ("cpu", "mem", "timestamps"):
        assert np.asarray(getattr(port, field)).tobytes() == np.asarray(getattr(jax, field)).tobytes(), field
    assert port.step_seconds == jax.step_seconds


def test_run_soak_control_equals_original(tmp_path):
    """A never-faulted soak of a small archetype fleet through each
    package's serve: the same report counts and tick outcomes, and stores
    equal bit for bit."""
    from krr_tpu.core.config import Config as JaxConfig

    reports = []
    for module in (torch_chaos, chaos):
        fleet = module.build_fleet((module.ArchetypeSpec("diurnal", workloads=1, pods=1),
                                    module.ArchetypeSpec("oom-loop", workloads=1, pods=1)), samples=240, seed=29)
        server = module.ServerThread(fleet.backend).start()
        try:
            kubeconfig = module.write_kubeconfig(tmp_path / f"kubeconfig-{module.__name__}", server.url)
            common = dict(kubeconfig=kubeconfig, prometheus_url=server.url)
            if module is torch_chaos:
                config = bench_torch._service_config("cpu", 300.0, **common)
            else:
                config = JaxConfig(strategy="tdigest", quiet=True, server_port=0, scan_interval_seconds=300.0,
                                   hysteresis_enabled=False,
                                   other_args={"history_duration": 1, "timeframe_duration": 1}, **common)
            reports.append(asyncio.run(module.run_soak(config, fleet.backend, None, ticks=3)))
        finally:
            server.stop()
    port, jax = reports
    assert port.counts() == jax.counts()
    assert [(t.tick, t.ok, t.degraded, t.stale_workloads, t.consecutive_failures) for t in port.ticks] == [
        (t.tick, t.ok, t.degraded, t.stale_workloads, t.consecutive_failures) for t in jax.ticks]
    assert torch_chaos.stores_bitexact(port.store, jax.store) == (True, "")
