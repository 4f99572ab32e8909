"""The service-plane legs of the port's bench (`bench_torch.py`) on the CPU.

`ingest_leg`, `federation_leg`, `ha_leg`, `readpath_leg`, `store_leg` and
`store_kill_leg` drive the port's push ingest, federation, HA ring and
replica, read path, durable store and SIGKILL soak. What is held here:

* (a) one ``--smoke --device cpu`` run of the six legs in a subprocess
  (``BENCH_SKIP_E2E`` and the other legs' skips) under the import blocker
  of `tests/torch_bench_support.py`, which refuses and records ``jax*`` and
  ``krr_tpu.*`` in every process, the soak's serve subprocesses included:
  none imports either; every field `tests/test_bench_smoke.py` requires of
  these legs is there; every exact gate's line says ``ok``, each leg's
  ``<leg>_kernel_launches`` included (on the CPU every leg is listed in
  ``kernel_launches_by_leg`` with no launch); each wall-clock gate ran and
  printed its line. A wall-clock gate that FAILED
  (``WALL_CLOCK_GATES``: a speed ratio, which a loaded CPU cannot hold) is
  reported with ``warnings.warn``, not asserted; `chip_smoke.py` asserts
  them on the card.
* (b) the JAX package's legs (`bench.py`) in this process at the same
  smoke sizes and seeds: every field that counts work equals the port's
  (``PINNED``). Not pinned, with the reason: ``federation_wire_bytes`` (a
  record's meta carries trace ids and a random shard generation, so the
  payload length moves by a few bytes run to run in either package); every
  ``*_seconds``, ``*_rps``, ``*_ms``, ``*_speedup``, ``*_ratio``,
  ``*_vs_*`` and ``ingest_samples_per_second`` field (wall clock).
* (c) the exact gates are real: for each leg one case makes the
  comparator of one exact gate report a difference, and ``main`` exits 1
  naming that gate.
* (d) the port's fakes (`tests/fakes/torch_federation.py`,
  `tests/fakes/torch_chaos.py`) give the originals' fleets from the legs'
  seeds: the same objects and byte-equal series.
"""

from __future__ import annotations

import asyncio
import gzip
import re
import warnings

import numpy as np
import pytest

import bench
import bench_torch
from tests.fakes import chaos, federation, torch_chaos, torch_federation
from tests.torch_bench_support import NO_LAUNCHES, blocked_smoke, broken_gate_run, gate_lines, jax_legs, parity_failures

#: The service legs' knobs that `main` reads to leave each out.
SKIPS = ("BENCH_SKIP_INGEST", "BENCH_SKIP_FEDERATION", "BENCH_SKIP_HA", "BENCH_SKIP_READPATH", "BENCH_SKIP_STORE")

#: The six legs as ``kernel_launches_by_leg`` names them.
LEGS = ("ingest", "federation", "ha", "readpath", "store", "store_kill")

#: The gates whose result must not depend on the host's speed.
EXACT_GATES = (
    "push_ingest_bitexact", "push_zero_range_queries",
    "federation_bitexact", "federation_engaged",
    "ha_bitexact", "ha_failover_zero_lost_epochs",
    "readpath_hit_rate>=99%", "readpath_304_zero_render", "readpath_pushdown_bitexact",
    "readpath_gzip_roundtrip", "readpath_lru_bounded", "readpath_timeline_recorded",
    "store_recovery_bitexact", "store_kill_recover_bitexact",
    *(f"{leg}_kernel_launches" for leg in LEGS),
)

#: The gates that compare two wall clocks (``readpath_rps>=2x_uncached`` is
#: the smoke size's bar). ``replica_rps_scaling`` is half exact: its line
#: must say ``identical=True`` either way.
WALL_CLOCK_GATES = (
    "push_tick_beats_pull", "replica_rps_scaling", "readpath_rps>=2x_uncached", "store_delta_beats_full_rewrite",
)

#: The fields `tests/test_bench_smoke.py` requires of these legs
#: (`:121-126`, `:151-155`, `:162-167`, `:190-198`, `:205-210`), by leg;
#: the top-level fields are under ``"payload"``.
REQUIRED_FIELDS = {
    "ingest": ("ingest_bitexact", "ingest_zero_range_queries", "ingest_push_tick_seconds",
               "ingest_pull_tick_seconds", "ingest_tick_speedup", "ingest_samples_per_second"),
    "federation": ("federation_bitexact", "federation_shards", "federation_records", "federation_wire_bytes",
                   "federation_fold_seconds"),
    "ha": ("ha_bitexact", "ha_failover_zero_lost_epochs", "ha_duplicates", "ha_primary_rps", "ha_replica_rps",
           "ha_replica_rps_ratio"),
    "readpath": ("readpath_cache_hit_pct", "readpath_p99_ms", "readpath_rps", "readpath_rps_vs_uncached",
                 "readpath_bytes_mb"),
    "store": ("store_persist_seconds", "store_legacy_save_seconds", "store_recovery_seconds",
              "store_delta_vs_legacy", "store_kill_recover_bitexact", "store_kills"),
    "payload": ("readpath_vs_previous_round", "readpath_regression_vs_previous"),
}

#: The values of those fields that do not depend on the host's speed.
EXACT_VALUES = {
    "ingest_bitexact": 1.0, "ingest_zero_range_queries": 1.0,
    "federation_bitexact": 1.0, "federation_shards": 3.0, "federation_records": 12.0,
    "ha_bitexact": 1.0, "ha_failover_zero_lost_epochs": 1.0, "ha_duplicates": 2.0,
    "readpath_cache_hit_pct": 100.0,
    "store_kill_recover_bitexact": 1.0, "store_kills": 2.0,
}

#: The fields that count work, equal between the packages at the same sizes
#: and seeds (``store_legacy_bytes`` is read from the store leg's line).
PINNED = (
    "ingest_workloads", "ingest_rounds", "ingest_rejected_samples", "ingest_bitexact", "ingest_zero_range_queries",
    "federation_shards", "federation_ticks", "federation_rows", "federation_records", "federation_bitexact",
    "ha_ticks", "ha_rows", "ha_duplicates", "ha_bitexact", "ha_failover_zero_lost_epochs",
    "readpath_workloads", "readpath_clients", "readpath_requests", "readpath_bytes_mb", "readpath_cache_hit_pct",
    "store_wal_tick_bytes", "store_legacy_bytes", "store_kill_runs", "store_kills", "store_kill_recover_bitexact",
)

def legacy_bytes(stderr: str) -> int:
    """The legacy rewrite's file size from the store leg's line."""
    return int(re.search(r"vs legacy rewrite [\d.]+ ms \((\d+) B\)", stderr).group(1))


@pytest.fixture(scope="module")
def service_run(tmp_path_factory):
    """(rc, payload, stderr, refused imports, started command lines) of one
    ``bench_torch.py --smoke --device cpu`` of the six legs, under the
    import blocker."""
    return blocked_smoke(tmp_path_factory.mktemp("service"), SKIPS)


# ----------------------------------------------------------------------- (a)
def test_no_process_imports_jax(service_run):
    rc, payload, stderr, refused, started = service_run
    assert refused == {}, refused
    # The blocker was in every process: the bench and the soak's four serve
    # subprocesses (three of the killed soak, one of its control).
    assert any("bench_torch.py" in line for line in started), started
    assert sum("tests.fakes.torch_soak_driver" in line for line in started) == 4, started
    assert payload, stderr[-4000:]


@pytest.mark.parametrize("leg", sorted(REQUIRED_FIELDS))
def test_fields_of_bench_smoke_present(leg, service_run):
    _rc, payload, stderr, _refused, _started = service_run
    where = payload if leg == "payload" else payload["secondary"]
    assert [field for field in REQUIRED_FIELDS[leg] if field not in where] == [], stderr[-4000:]
    for field in REQUIRED_FIELDS[leg]:
        if field in EXACT_VALUES:
            assert where[field] == EXACT_VALUES[field], (field, where[field])


@pytest.mark.parametrize("gate", EXACT_GATES)
def test_exact_gate_ok(gate, service_run):
    _rc, _payload, stderr, _refused, _started = service_run
    assert gate_lines(stderr).get(gate) == "ok", stderr[-4000:]


@pytest.mark.parametrize("gate", WALL_CLOCK_GATES)
def test_wall_clock_gate_ran(gate, service_run):
    rc, payload, stderr, _refused, _started = service_run
    line = gate_lines(stderr).get(gate)
    assert line is not None, stderr[-4000:]
    if gate == "replica_rps_scaling" and line != "ok":
        assert "identical=True" in line, line
    if line != "ok":
        assert rc == 1 and payload["parity"] == "fail" and gate in parity_failures(stderr)
        warnings.warn(f"wall-clock gate {gate} {line} on this host (asserted on the card by chip_smoke.py)")


def test_every_leg_launch_counted(service_run):
    """On the CPU the plain versions count no launch: every leg is listed
    with none."""
    _rc, payload, stderr, _refused, _started = service_run
    assert payload["secondary"]["kernel_launches_by_leg"] == dict.fromkeys(LEGS, NO_LAUNCHES), stderr[-4000:]


def test_only_wall_clock_gates_may_fail(service_run):
    rc, payload, stderr, _refused, _started = service_run
    failures = parity_failures(stderr)
    assert set(failures) <= set(WALL_CLOCK_GATES), failures
    assert (rc, payload["parity"]) == ((1, "fail") if failures else (0, "ok")), stderr[-4000:]


# ----------------------------------------------------------------------- (b)
@pytest.fixture(scope="module")
def jax_run():
    """`bench.py`'s six legs in this process at `bench_torch`'s smoke sizes:
    their ``secondary`` (with the legacy file size) and ``{gate: ok}``."""
    secondary, gates, err = jax_legs((bench.ingest_leg, bench.federation_leg, bench.ha_leg, bench.readpath_leg,
                                      bench.store_leg, bench.store_kill_leg))
    secondary["store_legacy_bytes"] = legacy_bytes(err)
    return secondary, gates


def test_jax_legs_held_their_exact_gates(jax_run):
    _secondary, gates = jax_run
    held = [gate for gate in EXACT_GATES if not gate.endswith("_kernel_launches")]
    assert {gate: gates.get(gate) for gate in held} == dict.fromkeys(held, True)


@pytest.mark.parametrize("field", PINNED)
def test_work_counts_equal_bench(field, service_run, jax_run):
    _rc, payload, stderr, _refused, _started = service_run
    port = dict(payload["secondary"], store_legacy_bytes=legacy_bytes(stderr))
    jax = jax_run[0]
    assert port[field] == jax[field], (field, port[field], jax[field])


# ----------------------------------------------------------------------- (c)
def _never(*args, **kwargs):
    return False


#: leg → (its skip knob, (module, attribute, replacement), the gate it
#: fails, extra knobs). The two store cases run the kill soak with no kill
#: over two ticks (a soak and its control, one serve process each): they
#: hold the comparators' wiring; (a) holds the soak with its two kills.
GATE_CASES = {
    "ingest": ("BENCH_SKIP_INGEST", (bench_torch, "same_array", _never), "push_ingest_bitexact", {}),
    "federation": ("BENCH_SKIP_FEDERATION", (torch_federation, "stores_bitexact_by_key",
                                             lambda a, b: (False, "injected")), "federation_bitexact", {}),
    "ha": ("BENCH_SKIP_HA", (bench_torch, "same_array", _never), "ha_bitexact", {}),
    "readpath": ("BENCH_SKIP_READPATH", (gzip, "decompress", lambda body: b"injected"),
                 "readpath_gzip_roundtrip", {}),
    "store": ("BENCH_SKIP_STORE", (bench_torch, "same_array", _never), "store_recovery_bitexact",
              {"BENCH_STORE_KILLS": "0", "BENCH_STORE_KILL_TICKS": "2"}),
    "store_kill": ("BENCH_SKIP_STORE", (torch_chaos, "stores_bitexact", lambda a, b: (False, "injected")),
                   "store_kill_recover_bitexact", {"BENCH_STORE_KILLS": "0", "BENCH_STORE_KILL_TICKS": "2"}),
}


@pytest.mark.parametrize("leg", GATE_CASES)
def test_exact_gates_are_real(leg, monkeypatch, capsys):
    skip, (module, name, replacement), gate, extra = GATE_CASES[leg]
    monkeypatch.setattr(module, name, replacement)
    rc, payload, failures, err = broken_gate_run(skip, extra, capsys)
    assert (rc, payload["parity"]) == (1, "fail"), err[-3000:]
    assert gate in failures and set(failures) <= {gate, *WALL_CLOCK_GATES}, failures
    assert f"bench: parity [{gate}] FAILED" in err


# ----------------------------------------------------------------------- (d)
#: The federation and HA legs' fleets: (clusters, workloads a namespace, seed).
FEDERATION_FLEETS = {"federation_leg": (3, 2, 53), "ha_leg": (2, 2, 59)}


@pytest.mark.parametrize("leg", FEDERATION_FLEETS)
def test_federation_fake_equals_original(leg):
    clusters, workloads, seed = FEDERATION_FLEETS[leg]
    fleets = [module.MultiClusterFleet(clusters=clusters, namespaces_per_cluster=2,
                                       workloads_per_namespace=workloads, seed=seed)
              for module in (torch_federation, federation)]
    port, jax = fleets
    assert torch_federation.ORIGIN == federation.ORIGIN and port.clusters == jax.clusters
    assert [obj.model_dump(mode="json") for obj in port.all_objects()] == [
        obj.model_dump(mode="json") for obj in jax.all_objects()]
    assert port.series.keys() == jax.series.keys()
    for key, (cpu, mem) in jax.series.items():
        assert port.series[key][0].tobytes() == cpu.tobytes() and port.series[key][1].tobytes() == mem.tobytes()

    # Each shard's inventory and a delta window of its history.
    async def gather(module, fleet, cluster):
        objects = await module.FleetInventory(fleet, clusters=[cluster]).list_scannable_objects([cluster])
        history = module.history_factory(fleet)(cluster)
        got = await history.gather_fleet(objects, 900.0, 60.0, end_time=module.ORIGIN + 3600.0)
        return [obj.model_dump(mode="json") for obj in objects], {
            resource.value: [{pod: values.tobytes() for pod, values in row.items()} for row in rows]
            for resource, rows in got.items()}

    for cluster in jax.clusters:
        assert asyncio.run(gather(torch_federation, port, cluster)) == asyncio.run(gather(federation, jax, cluster))


def test_chaos_fake_equals_original():
    """The kill soak's fleet (`bench.py:725-730`)."""
    fleets = [module.build_fleet((module.ArchetypeSpec("diurnal", workloads=2, pods=1),
                                  module.ArchetypeSpec("oom-loop", workloads=2, pods=1)), samples=240, seed=31)
              for module in (torch_chaos, chaos)]
    port, jax = fleets
    assert torch_chaos.ORIGIN == chaos.ORIGIN and torch_chaos.STEP == chaos.STEP
    assert port.namespaces == jax.namespaces and port.labels == jax.labels
    assert port.metrics.series.keys() == jax.metrics.series.keys()
    for key, (cpu, mem) in jax.metrics.series.items():
        assert np.asarray(port.metrics.series[key][0]).tobytes() == np.asarray(cpu).tobytes()
        assert np.asarray(port.metrics.series[key][1]).tobytes() == np.asarray(mem).tobytes()
    assert port.metrics.enforce_range and jax.metrics.enforce_range
    assert torch_chaos.ServerThread is chaos.ServerThread


@pytest.mark.parametrize("same", [True, False], ids=["equal", "one-bucket-moved"])
def test_store_comparators_equal_originals(same):
    """`stores_bitexact` and `stores_bitexact_by_key` give the originals'
    verdicts, the second on rows in another order."""
    from krr_tpu_torch.core.streaming import DigestStore
    from krr_tpu_torch.ops.digest import DigestSpec

    spec = DigestSpec(gamma=1.01, min_value=1e-7, num_buckets=16)
    keys = [f"c/ns/w{i}/main/Deployment" for i in range(4)]
    a, b = DigestStore(spec=spec, keys=list(keys)), DigestStore(spec=spec, keys=list(keys))
    for store in (a, b):
        store.cpu_counts[:, 3] = np.arange(1, 5, dtype=np.float32)
    if not same:
        b.cpu_counts[2, 3] += 1.0
    assert torch_chaos.stores_bitexact(a, b) == chaos.stores_bitexact(a, b)
    assert torch_chaos.stores_bitexact(a, b)[0] is same
    reordered = DigestStore(spec=spec, keys=list(reversed(keys)))
    reordered.cpu_counts[:] = b.cpu_counts[::-1]
    assert torch_federation.stores_bitexact_by_key(a, reordered) == federation.stores_bitexact_by_key(a, reordered)
    assert torch_federation.stores_bitexact_by_key(a, reordered)[0] is same
