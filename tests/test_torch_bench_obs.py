"""The bench's observability legs (`bench_torch.py`) on the CPU.

`obs_leg` (one digest-ingest scan with and without a recording tracer),
`analyze_smoke_leg` (``python -m krr_tpu_torch analyze`` over its trace),
`obs_device_leg` (``SimpleStrategy.run_batch`` with and without
`krr_tpu_torch.obs.device.DeviceObs`; K1 + K2 on the card) and
`sentinel_leg` (the regression sentinel over synthetic timelines). What is
held here:

* (a) one ``--smoke --device cpu`` run of these four legs in a subprocess
  (``BENCH_SKIP_E2E`` and every other leg's skip) under the import blocker
  of `tests/torch_bench_support.py`, which also notes every process's
  command line: no process imports ``jax*`` or ``krr_tpu.*``, the analyze
  child included; every field `tests/test_bench_smoke.py:48-77` requires
  of these legs is there; every exact gate's line says ``ok``; each
  wall-clock gate (``WALL_CLOCK_GATES``: a 2 % overhead, which a loaded CPU
  cannot hold) ran, and one that FAILED is reported with
  ``warnings.warn``, not asserted (`chip_smoke.py` asserts them on the
  card); every leg is listed in ``kernel_launches_by_leg``, with no launch:
  the plain versions count none.
* (b) `bench.py`'s same legs in this process at the same smoke sizes and
  seeds: their exact gates held, and every field that counts work equals
  the port's (``PINNED``). Not pinned: every ``*_seconds``, ``*_pct`` and
  ``sentinel_recorder_seconds_per_tick`` (wall clock).
* (c) the exact gates are real: a broken comparator (or an empty trace for
  ``analyze``) makes ``main`` exit 1 naming that gate.
* the launches ``obs_device_leg`` expects on the card equal what its
  ``run_batch`` calls, counted at the wrappers' call sites.
"""

from __future__ import annotations

import contextlib
import io
import warnings

import pytest

import bench
import bench_torch
import krr_tpu_torch.obs.trace as port_trace
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

#: The four legs as ``kernel_launches_by_leg`` names them.
LEGS = ("obs", "analyze", "obs_device", "sentinel")

#: The gates whose result must not depend on the host's speed.
EXACT_GATES = (
    "obs_bitexact", "analyze_smoke",
    "obs_device_bitexact", "obs_device_stages", "obs_device_pad_waste",
    "sentinel_detects_injected", "sentinel_attribution_correct", "sentinel_zero_false_positives",
    *(f"{leg}_kernel_launches" for leg in LEGS),
)

#: The gates that compare two wall clocks.
WALL_CLOCK_GATES = ("obs_overhead<2%", "obs_device_overhead<2%", "timeline_overhead<2%")

#: The fields `tests/test_bench_smoke.py:48-77` requires of these legs:
#: (comparison, bound), or None for presence.
REQUIRED = {
    "obs_plain_scan_seconds": (">", 0), "obs_traced_scan_seconds": (">", 0), "obs_spans_per_scan": (">", 0),
    "obs_trace_overhead_pct": None,
    "obs_device_plain_seconds": (">", 0), "obs_device_traced_seconds": (">", 0),
    "obs_device_stage_spans": (">", 0), "obs_device_overhead_pct": None,
    "analyze_smoke": ("==", "ok"), "analyze_scans": (">", 0),
    "sentinel_ticks": (">=", 20), "sentinel_injected_regressions": (">=", 2),
    "sentinel_clean_regressions": ("==", 0.0), "sentinel_recorder_seconds_per_tick": (">", 0),
    "timeline_overhead_pct": None,
}

#: The fields that count work, equal between the packages.
PINNED = ("obs_spans_per_scan", "obs_device_stage_spans", "analyze_smoke", "analyze_scans", "sentinel_ticks",
          "sentinel_clean_regressions", "sentinel_injected_regressions")

#: The spans the port's scan has beyond the JAX package's: ``assemble``,
#: ``gc`` and ``render`` under the root; ``cast`` and ``h2d`` per resource
#: on the resident path.
PORT_SPANS = {"obs_spans_per_scan": 3, "obs_device_stage_spans": 4}


@pytest.fixture(scope="module")
def obs_run(tmp_path_factory):
    """(rc, payload, stderr, refused imports, started command lines) of the
    four legs' blocked smoke run."""
    return blocked_smoke(tmp_path_factory.mktemp("obs"), ("BENCH_SKIP_OBS",))


# ----------------------------------------------------------------------- (a)
def test_no_process_imports_jax(obs_run):
    rc, payload, stderr, refused, started = obs_run
    assert refused == {}, refused
    assert any("bench_torch.py" in line for line in started), started
    # The analyze leg's child ran the port's CLI under the blocker.
    assert any("-m krr_tpu_torch analyze --trace" in line for line in started), started
    assert payload, stderr[-4000:]


@pytest.mark.parametrize("field", REQUIRED)
def test_fields_of_bench_smoke_present(field, obs_run):
    _rc, payload, stderr, _refused, _started = obs_run
    secondary = payload["secondary"]
    assert field in secondary, stderr[-4000:]
    assert meets(secondary[field], REQUIRED[field]), (field, secondary[field], REQUIRED[field])


@pytest.mark.parametrize("gate", EXACT_GATES)
def test_exact_gate_ok(gate, obs_run):
    _rc, _payload, stderr, _refused, _started = obs_run
    assert gate_lines(stderr).get(gate) == "ok", stderr[-4000:]


@pytest.mark.parametrize("gate", WALL_CLOCK_GATES)
def test_wall_clock_gate_ran(gate, obs_run):
    rc, payload, stderr, _refused, _started = obs_run
    line = gate_lines(stderr).get(gate)
    assert line is not None, stderr[-4000:]
    if line != "ok":
        assert rc == 1 and payload["parity"] == "fail" and gate in parity_failures(stderr)
        warnings.warn(f"wall-clock gate {gate} {line} on this host (asserted on the card by chip_smoke.py)")


def test_every_leg_launch_counted(obs_run):
    _rc, payload, stderr, _refused, _started = obs_run
    assert payload["secondary"]["kernel_launches_by_leg"] == dict.fromkeys(LEGS, NO_LAUNCHES), stderr[-4000:]


def test_only_wall_clock_gates_may_fail(obs_run):
    rc, payload, stderr, _refused, _started = obs_run
    failures = parity_failures(stderr)
    assert set(failures) <= set(WALL_CLOCK_GATES), failures
    assert (rc, payload["parity"]) == ((1, "fail") if failures else (0, "ok")), stderr[-4000:]


# ----------------------------------------------------------------------- (b)
@pytest.fixture(scope="module")
def jax_run():
    """`bench.py`'s obs, obs-device and sentinel legs (the analyze leg runs
    inside its obs leg) in this process at the smoke sizes."""
    secondary, gates, _err = jax_legs((bench.obs_leg, bench.obs_device_leg, bench.sentinel_leg))
    return secondary, gates


def test_jax_legs_held_their_exact_gates(jax_run):
    _secondary, gates = jax_run
    held = [gate for gate in EXACT_GATES if not gate.endswith("_kernel_launches")]
    assert {gate: gates.get(gate) for gate in held} == dict.fromkeys(held, True)


@pytest.mark.parametrize("field", PINNED)
def test_work_counts_equal_bench(field, obs_run, jax_run):
    _rc, payload, _stderr, _refused, _started = obs_run
    want = jax_run[0][field] + PORT_SPANS[field] if field in PORT_SPANS else jax_run[0][field]
    assert payload["secondary"][field] == want, (field, payload["secondary"][field], jax_run[0][field])


# ----------------------------------------------------------------------- (c)
def _never(*args, **kwargs):
    return False


def _empty_trace(tracer, path):
    with open(path, "w") as f:
        f.write('{"traceEvents": []}')


#: gate → (module, attribute, replacement).
GATE_CASES = {
    "obs_bitexact": (bench_torch, "same_json", _never),
    "obs_device_bitexact": (bench_torch, "same_repr", _never),
    "analyze_smoke": (port_trace, "write_chrome_trace", _empty_trace),
}


@pytest.mark.parametrize("gate", GATE_CASES)
def test_exact_gates_are_real(gate, monkeypatch, capsys):
    module, name, replacement = GATE_CASES[gate]
    monkeypatch.setattr(module, name, replacement)
    rc, payload, failures, err = broken_gate_run("BENCH_SKIP_OBS", {}, capsys)
    assert (rc, payload["parity"]) == (1, "fail"), err[-3000:]
    assert gate in failures and set(failures) <= {gate, *WALL_CLOCK_GATES}, failures
    assert f"bench: parity [{gate}] FAILED" in err


# ---------------------------------------------------- the launches on the card
@pytest.mark.parametrize("runs", ["3", "5"])
def test_obs_device_launches_equal_its_run_batch_calls(runs, monkeypatch):
    """A warm-up and two ``run_batch`` calls a run, each one ``fleet_exact``
    (K1 + K2)."""
    calls = count_wrapper_calls(monkeypatch)
    env = {**bench_torch.SMOKE_DEFAULTS, "BENCH_OBS_RUNS": runs}
    with contextlib.redirect_stderr(io.StringIO()):
        expected = bench_torch.obs_device_leg({}, lambda *a: None, env, "cpu")
    assert calls == expected
    assert expected == {**NO_LAUNCHES, "bisect_select": 1 + 2 * int(runs), "row_max": 1 + 2 * int(runs)}
