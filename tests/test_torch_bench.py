"""The port's bench (`bench_torch.py`, `bench_e2e_torch.py`) on the CPU.

What is held here, without reading a wall clock in any assertion:

* the whole ``--smoke --device cpu`` run in a subprocess — every kernel
  and end-to-end leg runs, the JSON line carries `bench.py`'s fields, and
  neither script nor any process it starts imports ``jax*`` or
  ``krr_tpu.*`` (an import blocker in a ``sitecustomize`` on
  ``PYTHONPATH`` records and refuses them); the seventeen service-plane
  and observability legs are left out here (``SERVICE_SKIPS``) and held in
  `tests/test_torch_bench_service.py`, `tests/test_torch_bench_legs.py`
  and `tests/test_torch_bench_obs.py`;
* the four parity gates are real: one perturbed element makes ``main``
  print ``"parity": "fail"`` naming that gate, and exit 1;
* an end-to-end leg that fails, times out or returns no payload makes the
  bench exit non-zero;
* ``--device cuda`` without a card exits 1 naming CUDA;
* the bench's host helpers (the Python reference, the round-over-round
  fields) equal `bench.py`'s on the same inputs, and the port reads only
  ``BENCH_TORCH_r*.json`` rounds;
* the legs' programs equal what `bench.py`'s legs compute with the JAX
  package on the same seeded numpy inputs: the exact program and the top-K
  sketch bit for bit, the digest's peak bit for bit and its p99 within one
  bucket (a factor γ: ``log`` differs by an ulp between XLA's CPU backend
  and PyTorch, which can move a sample at a bucket edge).
"""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
import bench_e2e_torch
import bench_torch
from krr_tpu.ops import digest as jax_digest
from krr_tpu.ops import topk_sketch as jax_topk
from krr_tpu.ops.pallas_select import fleet_exact as jax_fleet_exact
from krr_tpu_torch.ops import cuda_select
from krr_tpu_torch.ops import digest as port_digest
from krr_tpu_torch.ops import topk_sketch as port_topk
from tests.torch_bench_support import NO_LAUNCHES, SKIPS

REPO = Path(__file__).resolve().parent.parent

#: The headline fields of `bench.py:3389-3411` (its JSON line).
HEADLINE_FIELDS = (
    "metric", "value", "unit", "vs_baseline", "parity", "runs",
    "raw_containers_per_sec", "raw_spread_pct", "raw_vs_baseline",
    "dispatch_floor_ms", "pipelined_depth", "pipelined_spread_pct",
    "floor_corrected_containers_per_sec",
    # **previous_fields
    "vs_previous_round", "previous_round_file", "previous_round_stable_rate", "regression_vs_previous",
    # **_fetch_trendline_fields(secondary)
    "fetch_vs_previous_round", "previous_round_fetch_seconds", "fetch_regression_vs_previous",
    "wire_vs_previous_round", "previous_round_wire_mb", "wire_regression_vs_previous",
    # **_readpath_trendline_fields(secondary)
    "readpath_vs_previous_round", "previous_round_readpath_p99_ms", "readpath_regression_vs_previous",
    "secondary",
)

#: The knobs that leave out the seventeen service-plane and observability
#: legs (their own files, `tests/test_torch_bench_service.py`,
#: `tests/test_torch_bench_legs.py` and `tests/test_torch_bench_obs.py`,
#: cover them).
SERVICE_SKIPS = dict.fromkeys(SKIPS, "1")

#: A ``sitecustomize`` that refuses and records any import of the JAX
#: package or of JAX in every Python process started with it on the path.
IMPORT_BLOCKER = textwrap.dedent(
    """
    import os, sys

    class _Blocker:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib", "krr_tpu"):
                with open(os.path.join(os.environ["BENCH_TEST_IMPORT_LOG"], str(os.getpid())), "a") as f:
                    f.write(name + "\\n")
                raise ImportError(f"{name} must not be imported by the port's bench")
            return None

    sys.meta_path.insert(0, _Blocker())
    """
)


def last_json(text: str) -> dict:
    return json.loads(text.strip().splitlines()[-1])


def parity_failures(stderr: str) -> list:
    lines = [line for line in stderr.splitlines() if line.startswith("bench: PARITY FAILURES: ")]
    return ast.literal_eval(lines[-1].split(": ", 2)[2]) if lines else []


@pytest.fixture
def kernel_legs_only(monkeypatch, service_legs_skipped):
    """The smoke sizes with the end-to-end subprocesses left out."""
    monkeypatch.setenv("BENCH_SKIP_E2E", "1")


@pytest.fixture
def service_legs_skipped(monkeypatch):
    """The service-plane legs left out."""
    for key, value in SERVICE_SKIPS.items():
        monkeypatch.setenv(key, value)


def test_smoke_runs_every_leg_without_jax(tmp_path):
    site = tmp_path / "site"
    site.mkdir()
    (site / "sitecustomize.py").write_text(IMPORT_BLOCKER)
    log = tmp_path / "imports"
    log.mkdir()
    env = {key: value for key, value in os.environ.items() if not key.startswith("BENCH_")}
    env.update(PYTHONPATH=str(site), BENCH_TEST_IMPORT_LOG=str(log), **SERVICE_SKIPS)
    proc = subprocess.run(
        [sys.executable, str(REPO / "bench_torch.py"), "--smoke", "--device", "cpu"],
        capture_output=True, text=True, timeout=300, cwd=tmp_path, env=env,
    )
    assert not list(log.iterdir()), {p.name: p.read_text() for p in log.iterdir()}
    assert proc.returncode == 0, proc.stderr[-4000:]
    payload = last_json(proc.stdout)
    assert [field for field in HEADLINE_FIELDS if field not in payload] == []
    assert payload["metric"] == "containers_per_sec_exact_p99_7d_at_5s_pipelined"
    assert payload["parity"] == "ok"
    assert payload["value"] > 0
    assert payload["device"] == {"platform": "cpu", "kind": "cpu", "count": 1}
    secondary = payload["secondary"]
    assert secondary.get("topk_containers_per_sec", 0) > 0, secondary
    assert secondary.get("digest_containers_per_sec", 0) > 0, secondary
    # Both end-to-end subprocesses delivered numbers, the streamed
    # pipeline's overlap and its staged control included.
    assert secondary.get("e2e_objects_per_sec", 0) > 0, secondary
    assert secondary.get("fleet_e2e_objects_per_sec", 0) > 0, secondary
    assert "fleet_e2e_overlap_pct" in secondary
    assert secondary.get("fleet_e2e_staged_seconds", 0) > 0
    assert secondary["e2e_containers"] == 8 and secondary["fleet_e2e_containers"] == 12
    assert secondary.get("digest_ingest_100k_objects_per_sec", 0) > 0, secondary
    assert secondary.get("digest_store_rows") == 256, secondary
    assert secondary.get("ingest_samples_per_sec", 0) > 0, secondary


def _bump(tensor, index):
    """A copy of ``tensor`` with one element moved to the next float32."""
    out = tensor.clone()
    out[index] = torch.nextafter(out[index], torch.tensor(float("inf")))
    return out


#: One element of each gate's measured side perturbed: the memory-peak row
#: of ``fleet_exact`` (so the exact p99 the later gates use stays right),
#: the top-K p99, the digest p99 past its error bound, the digest peak.
PERTURBATIONS = {
    "fleet_exact==plain": (cuda_select, "fleet_exact", lambda out: _bump(out, (1, 0))),
    "topk_sketch==exact": (port_topk, "percentile", lambda out: _bump(out, 0)),
    "digest_error_bound": (port_digest, "percentile", lambda out: torch.cat([out[:1] * 1.5, out[1:]])),
    "digest_peak==max": (port_digest, "peak", lambda out: _bump(out, 0)),
}


@pytest.mark.parametrize("gate", [None, *PERTURBATIONS])
def test_parity_gates_are_real(gate, kernel_legs_only, monkeypatch, capsys):
    if gate is not None:
        module, name, perturb = PERTURBATIONS[gate]
        original = getattr(module, name)
        monkeypatch.setattr(module, name, lambda *args, **kwargs: perturb(original(*args, **kwargs)))
    rc = bench_torch.main(["--smoke", "--device", "cpu"])
    out, err = capsys.readouterr()
    payload = last_json(out)
    if gate is None:
        assert (rc, payload["parity"]) == (0, "ok"), err[-3000:]
        assert parity_failures(err) == []
    else:
        assert (rc, payload["parity"]) == (1, "fail"), err[-3000:]
        assert parity_failures(err) == [gate]
        assert f"bench: parity [{gate}] FAILED" in err


@pytest.mark.parametrize(
    "script, note",
    [
        ("import sys; sys.exit(3)", "failed rc=3"),
        ("pass", "no payload"),
        ("print('{}')", "no payload"),
        ("print('not json')", "no payload"),
        ("import time; time.sleep(60)", "timed out after 1 s"),
    ],
    ids=["exit-code", "silent", "empty-payload", "not-json", "timeout"],
)
def test_a_failed_e2e_leg_fails_the_bench(script, note, tmp_path, monkeypatch, capsys, service_legs_skipped):
    leg = tmp_path / "leg.py"
    leg.write_text(script)
    monkeypatch.setattr(bench_torch, "E2E_SCRIPT", str(leg))
    monkeypatch.setattr(bench_torch, "E2E_LEGS", tuple((tag, extra, 1) for tag, extra, _ in bench_torch.E2E_LEGS))
    rc = bench_torch.main(["--smoke", "--device", "cpu"])
    out, err = capsys.readouterr()
    payload = last_json(out)  # what was measured is still printed
    assert rc != 0
    assert payload["parity"] == "ok"
    assert payload["secondary"]["e2e"] == note and payload["secondary"]["fleet_e2e"] == note
    assert "bench: LEG FAILURES:" in err


def test_knobs_come_from_the_environ_argument(tmp_path, monkeypatch, capsys):
    """``main(argv, environ)`` reads its knobs from ``environ`` alone and
    leaves ``os.environ`` as it was: an end-to-end script that fails is never
    started when ``environ`` skips the legs, and a leg that ``os.environ``
    skips runs at ``environ``'s size when ``environ`` does not skip it."""
    leg = tmp_path / "leg.py"
    leg.write_text("import sys; sys.exit(3)")
    monkeypatch.setattr(bench_torch, "E2E_SCRIPT", str(leg))
    monkeypatch.delenv("BENCH_SKIP_E2E", raising=False)
    monkeypatch.setenv("BENCH_SKIP_JOURNAL", "1")
    monkeypatch.setenv("BENCH_JOURNAL_ROWS", "1000")
    before = dict(os.environ)
    environ = {**bench_torch.SMOKE_DEFAULTS, "BENCH_SKIP_E2E": "1", **SERVICE_SKIPS, "BENCH_JOURNAL_ROWS": "9"}
    del environ["BENCH_SKIP_JOURNAL"]
    rc = bench_torch.main(["--device", "cpu"], environ)
    out, err = capsys.readouterr()
    assert rc == 0, err[-3000:]
    payload = last_json(out)
    assert payload["parity"] == "ok" and "e2e" not in payload["secondary"]
    assert payload["secondary"]["kernel_launches_by_leg"] == {"journal": NO_LAUNCHES}
    assert "bench: journal 36 appends" in err and "diff render 9 objects" in err  # 9 rows x 4 ticks
    assert dict(os.environ) == before


@pytest.mark.parametrize("script", [bench_torch, bench_e2e_torch], ids=lambda m: m.__name__)
def test_cuda_without_a_card_exits_1(script, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert script.main(["--device", "cuda"]) == 1
    out, err = capsys.readouterr()
    assert out == ""
    assert "CUDA" in err and "torch.cuda.is_available() is False" in err


def test_python_reference_equals_bench(monkeypatch):
    """The same work between the same clock reads: a clock that advances one
    second a read makes both functions return the same number."""

    def ticking():
        ticking.now += 1.0
        return ticking.now

    ticking.now = 0.0
    monkeypatch.setattr("time.perf_counter", ticking)
    port = bench_torch.python_reference_seconds_per_container(64, 2)
    reads = ticking.now
    ticking.now = 0.0
    assert bench.python_reference_seconds_per_container(64, 2) == port
    assert ticking.now == reads


def _round(directory: Path, name: str, value: float, fetch: float, wire: float, containers: int = 100_000,
           p99: float = 4.0, readpath_workloads: float = 400.0) -> None:
    (directory / name).write_text(json.dumps({
        "n": 1, "cmd": "python3 bench", "rc": 0, "tail": "",
        "parsed": {"metric": "containers_per_sec_exact_p99_7d_at_5s_pipelined", "value": value, "secondary": {
            "fleet_e2e_fetch_seconds": fetch, "fleet_e2e_wire_mb": wire, "fleet_e2e_containers": containers,
            "readpath_p99_ms": p99, "readpath_workloads": readpath_workloads}},
    }))


@pytest.mark.parametrize(
    "current, previous",
    [
        ((1_000_000.0, 30.0, 400.0, 100_000, 4.1, 400.0), (1_010_000.0, 29.0, 401.0)),  # level
        ((900_000.0, 40.0, 500.0, 100_000, 5.0, 400.0), (1_000_000.0, 30.0, 400.0)),  # every gate trips
        ((1_000_000.0, 30.0, 400.0, 12, 4.0, 12.0), (1_000_000.0, 30.0, 400.0)),  # another fleet and readpath width
    ],
    ids=["level", "regressed", "other-width"],
)
def test_round_over_round_fields_equal_bench(current, previous, tmp_path, monkeypatch):
    rate, fetch, wire, containers, p99, readpath_workloads = current
    secondary = {"fleet_e2e_fetch_seconds": fetch, "fleet_e2e_wire_mb": wire, "fleet_e2e_containers": containers,
                 "readpath_p99_ms": p99, "readpath_workloads": readpath_workloads}
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    jax_dir.mkdir()
    port_dir.mkdir()
    _round(jax_dir, "BENCH_r07.json", *previous)
    _round(port_dir, "BENCH_TORCH_r01.json", *previous)
    # A JAX round beside the port's, newer and different: the port ignores it.
    _round(port_dir, "BENCH_r07.json", 1.0, 1.0, 1.0)
    monkeypatch.setattr(bench, "__file__", str(jax_dir / "bench.py"))
    monkeypatch.setattr(bench_torch, "ROUNDS_DIR", str(port_dir))

    assert bench_torch._previous_round_payload()[0] == "BENCH_TORCH_r01.json"
    assert bench_torch._previous_round_payload()[1] == bench._previous_round_payload()[1]
    assert bench_torch._previous_round_stable() == ("BENCH_TORCH_r01.json", bench._previous_round_stable()[1])
    assert bench_torch._fetch_trendline_fields(secondary) == bench._fetch_trendline_fields(secondary)
    readpath = bench_torch._readpath_trendline_fields(secondary)
    assert readpath == bench._readpath_trendline_fields(secondary)
    if readpath_workloads != 400.0:
        assert readpath == {"readpath_vs_previous_round": None, "previous_round_readpath_p99_ms": None,
                            "readpath_regression_vs_previous": False}
    else:
        assert readpath["previous_round_readpath_p99_ms"] == 4.0
        assert readpath["readpath_regression_vs_previous"] == (p99 / 4.0 > 1.15)
    fields = bench_torch._previous_round_fields(rate)
    assert fields["previous_round_file"] == "BENCH_TORCH_r01.json"
    assert fields["previous_round_stable_rate"] == round(bench._previous_round_stable()[1], 1)
    assert fields["vs_previous_round"] == round(rate / bench._previous_round_stable()[1], 3)
    assert fields["regression_vs_previous"] == (rate / previous[0] < 0.95)


def test_a_round_without_a_value_is_no_previous_rate(tmp_path, monkeypatch):
    """The stable rate is the round's headline ``value`` and nothing else."""
    (tmp_path / "BENCH_TORCH_r01.json").write_text(json.dumps({
        "n": 1, "cmd": "python3 bench_torch.py", "rc": 0, "tail": "",
        "parsed": {"pipelined_containers_per_sec": 1_000_000.0}}))
    monkeypatch.setattr(bench_torch, "ROUNDS_DIR", str(tmp_path))
    assert bench_torch._previous_round_stable() is None
    assert bench_torch._previous_round_fields(1.0)["previous_round_file"] is None


def test_no_round_recorded(tmp_path, monkeypatch):
    """No ``BENCH_TORCH_r*.json`` (only a JAX round): every field null."""
    _round(tmp_path, "BENCH_r07.json", 1.0, 1.0, 1.0)
    monkeypatch.setattr(bench_torch, "ROUNDS_DIR", str(tmp_path))
    assert bench_torch._previous_round_payload() is None
    assert bench_torch._previous_round_fields(1.0) == {
        "vs_previous_round": None, "previous_round_file": None,
        "previous_round_stable_rate": None, "regression_vs_previous": False,
    }
    assert all(not value for value in bench_torch._fetch_trendline_fields({"fleet_e2e_fetch_seconds": 1.0}).values())
    assert all(not value for value in bench_torch._readpath_trendline_fields({"readpath_p99_ms": 1.0}).values())


@pytest.mark.parametrize("ragged", [False, True], ids=["full", "ragged"])
def test_leg_programs_equal_bench_on_jax(ragged):
    """`bench_torch`'s three programs on the CPU against `bench.py`'s legs
    (the JAX package's jnp paths) on the same seeded bench-like matrix."""
    rng = np.random.default_rng(3)
    n, t = 24, 700
    u = rng.random((n, t), dtype=np.float32)
    values = (u * u * np.float32(0.8) + np.float32(1e-4)).astype(np.float32)
    mem = rng.uniform(5e7, 4e8, (n, t)).astype(np.float32)
    counts = rng.integers(1, t + 1, n).astype(np.int32) if ragged else np.full(n, t, np.int32)
    pv, pm, pc = torch.from_numpy(values), torch.from_numpy(mem), torch.from_numpy(counts)
    jv, jm, jc = jnp.asarray(values), jnp.asarray(mem), jnp.asarray(counts)

    exact = cuda_select.fleet_exact(pv, pc, pm, pc, 99.0).numpy()
    want = np.asarray(jax_fleet_exact(jv, jc, jm, jc, 99.0))
    np.testing.assert_array_equal(exact.view(np.int32), want.view(np.int32))

    k = port_topk.required_k(t, 99.0)
    assert k == jax_topk.required_k(t, 99.0)
    sketch = jax_topk.build_from_packed(jv, jc, k=k, chunk_size=128)
    want = np.stack([np.asarray(jax_topk.percentile(sketch, 99.0)), np.asarray(jax_topk.peak(sketch))])
    got = bench_torch.topk_step(pv, pc, k).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    np.testing.assert_array_equal(got[0].view(np.int32), exact[0].view(np.int32))

    spec = port_digest.DigestSpec(gamma=1.01, min_value=1e-7, num_buckets=2560)
    jspec = jax_digest.DigestSpec(gamma=1.01, min_value=1e-7, num_buckets=2560)
    d = jax_digest.build_from_packed(jspec, jv, jc, chunk_size=128)
    want_p99, want_peak = np.asarray(jax_digest.percentile(jspec, d, 99.0)), np.asarray(jax_digest.peak(d))
    got = bench_torch.digest_step(spec, pv, pc).numpy()
    np.testing.assert_array_equal(got[1].view(np.int32), want_peak.view(np.int32))
    ratio = np.maximum(got[0], want_p99) / np.minimum(got[0], want_p99)
    assert np.all(ratio <= spec.gamma * (1 + 1e-6)), ratio.max()
