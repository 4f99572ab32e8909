"""The port's mesh across processes (`krr_tpu_torch.parallel`, M7b) against
its single-process mesh and the JAX package's.

The process group is process-wide state, so none is started in the pytest
process: the module's fixture starts every rank as a child process, all at
once, and the tests read the files the ranks wrote. Every wait is bounded,
and a rank that fails has its peers killed at once (a peer would wait in a
collective until the group's timeout).

* ``explicit``: two port ranks started by ``initialize_distributed(
  "127.0.0.1:<port>", 2, rank, device="cpu")`` (gloo). Each runs the five
  sharded functions on (2, 1) and (1, 2) meshes (one CPU device a rank) and
  on (2, 2), (4, 1) and (1, 4) meshes (the CPU twice a rank, as
  `tests/test_torch_parallel.py`'s single-process meshes repeat it), on
  ragged rows with empty rows, NaN samples and widths off every mesh axis;
  then ``Runner.run`` of ``simple``, ``tdigest`` and ``tdigest
  --exact_upgrade``, resident and host-streamed, on the global (2, 1) and
  (1, 2) meshes the strategies resolve, and ``tdigest --state_path`` twice
  into a directory of each rank's own.
* ``env``: two port ranks started from the launcher's ``env://``
  variables, one function on (1, 2).
* ``single``: a world of one, which is the single-process path.
* ``jax``: the JAX package in two processes with two virtual CPU devices
  each (``JAX_CPU_COLLECTIVES_IMPLEMENTATION=gloo`` in the children's
  environment only): the five functions on (1, 4), and the host readbacks
  that raise on (4, 1) and (2, 2) (ROADMAP Queue 3 item 12).

Tolerances are those of `tests/test_torch_parallel.py`: bit-exact but the
JAX ``pmax``'s dropped NaN (Queue 3 item 9), the top-K as a sorted
multiset, the digest against the JAX package's within a bucket at its
edges, and rendered bytes exactly.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time
import zipfile
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]

#: (data, time) meshes over two ranks, and the devices each rank brings.
MESHES = {(2, 1): 1, (1, 2): 1, (2, 2): 2, (4, 1): 2, (1, 4): 2}
#: Rows and columns off every mesh axis, so both axes pad.
N, T, T_SKETCH, K = 29, 37, 301, 128
QS = (50.0, 99.0)
FUNCTIONS = ("bisect_q50", "bisect_q99", "max", "digest", "percentile", "topk")
#: The scans: (port strategy, settings).
SCANS = {"simple": ("simple", {}), "tdigest": ("tdigest", {}), "exact_upgrade": ("tdigest", {"exact_upgrade": True})}
#: The global meshes the strategies resolve over two ranks, by ``mesh_time_axis``.
SCAN_MESHES = {1: (2, 1), 2: (1, 2)}
#: The smallest inputs on which the JAX package's host readback raises
#: when row blocks lie on different processes (ROADMAP Queue 3 item 12).
SMALLEST = {(4, 1): np.array([[1.0], [2.0], [3.0], [4.0]], dtype=np.float32),
            (2, 2): np.array([[1.0, 2.0], [3.0, 4.0]], dtype=np.float32)}
#: Seconds every child process may take, start to end.
DEADLINE = 150.0


def key(shape, name: str, field: str = "") -> str:
    return f"{shape[0]}x{shape[1]}.{name}.{field}"


def inputs() -> dict:
    """The functions' seeded inputs: rows for the select and the max, rows
    for the digest (edge values) and for the top-K (finite edge values, as
    the JAX comparison takes them); and, under ``finite.``, the same rows
    with finite edge values only, for the two-process JAX run (its
    ``device_put`` checks that every process passes equal arrays, which
    fails on any NaN)."""
    from .test_torch_parallel import ragged
    from .test_torch_sketch import FINITE_SPECIAL

    out = {}
    for tag, special in (("", None), ("finite.", FINITE_SPECIAL)):
        kwargs = {} if special is None else {"special": special}
        select = ragged(2, N, T, **kwargs)
        digest = ragged(6, N, T_SKETCH, **kwargs)
        topk = ragged(4, N, T_SKETCH, special=FINITE_SPECIAL)
        for name, (v, c) in (("select", select), ("digest", digest), ("topk", topk)):
            out[f"{tag}{name}_v"], out[f"{tag}{name}_c"] = v, c
    return out


# ----------------------------------------------------------- the children
def sharded_results(parallel, data, mesh, shape, tag: str = "") -> dict:
    """Every function of ``parallel`` (either package's) on ``mesh`` over
    the inputs ``tag`` names, read back to host arrays, keyed by
    :func:`key` under ``tag``. The digest and the top-K come back per row
    block in the port, globally in the JAX package."""
    from krr_tpu_torch.ops import digest as port_digest

    data = {name[len(tag):]: array for name, array in data.items()
            if name.startswith(tag) and "." not in name[len(tag):]}
    out = {}
    v, c = data["select_v"], data["select_c"]
    for q in QS:
        out[key(shape, f"bisect_q{q:.0f}")] = np.asarray(parallel.sharded_percentile_bisect(v, c, q, mesh))
    out[key(shape, "max")] = np.asarray(parallel.sharded_masked_max(v, c, mesh))
    port = parallel.__name__.startswith("krr_tpu_torch")
    if port:
        spec = port_digest.DigestSpec()
        digests, rows = parallel.sharded_fleet_digest(spec, data["digest_v"], data["digest_c"], mesh)
        for i, field in enumerate(("counts", "total", "peak")):
            out[key(shape, "digest", field)] = parallel.gather_rows(digests, lambda d, i=i: d[i], rows)
        sketches, rows = parallel.sharded_fleet_topk(data["topk_v"], data["topk_c"], K, mesh)
        for i, field in enumerate(("values", "total")):
            out[key(shape, "topk", field)] = parallel.gather_rows(sketches, lambda s, i=i: s[i], rows)
    else:
        from krr_tpu.ops.digest import DigestSpec

        spec = DigestSpec()
        digests, rows = parallel.sharded_fleet_digest(spec, data["digest_v"], data["digest_c"], mesh, chunk_size=64)
        for field in ("counts", "total", "peak"):
            out[key(shape, "digest", field)] = np.asarray(getattr(digests, field))[:rows]
        sketch, rows = parallel.sharded_fleet_topk(data["topk_v"], data["topk_c"], K, mesh, chunk_size=64)
        for field in ("values", "total"):
            out[key(shape, "topk", field)] = np.asarray(getattr(sketch, field))[:rows]
    out[key(shape, "percentile")] = np.asarray(parallel.sharded_percentile(spec, digests, 99.0, rows))
    return {tag + name: array for name, array in out.items()}


def _counting(calls: dict):
    """Wrap the per-shard kernels the sharded functions call, counting each
    call by name on this rank (the CPU runs the plain versions, which count
    no launch)."""
    from krr_tpu_torch.parallel import fleet

    def wrap(owner, name):
        fn = getattr(owner, name)

        def counted(*args, **kwargs):
            calls[name] = calls.get(name, 0) + 1
            return fn(*args, **kwargs)

        setattr(owner, name, counted)

    for name in ("masked_percentile_bisect_cuda", "radix_digit_hist", "row_max_chunk"):
        wrap(fleet, name)
    wrap(fleet.digest_ops, "build_from_packed")
    wrap(fleet.topk_ops, "build_from_packed")


def _port_functions(out: Path, rank: int, size: int) -> dict:
    """The functions on every mesh of :data:`MESHES`, and on the smallest
    inputs; each mesh's per-shard calls on this rank."""
    from krr_tpu_torch import parallel
    from krr_tpu_torch.parallel.mesh import MeshDevice

    data = dict(np.load(out / "inputs.npz"))
    results, calls = {}, {}
    _counting_calls: dict = {}
    _counting(_counting_calls)
    for shape, per_rank in MESHES.items():
        devices = [MeshDevice(r, torch.device("cpu")) for r in range(size) for _ in range(per_rank)]
        mesh = parallel.make_mesh(*shape, devices=devices)
        _counting_calls.clear()
        results.update(sharded_results(parallel, data, mesh, shape))
        calls[key(shape, "calls")] = dict(_counting_calls)
        if shape == (1, 4):
            results.update(sharded_results(parallel, data, mesh, shape, "finite."))
        if shape in SMALLEST:
            values = SMALLEST[shape]
            counts = np.full(values.shape[0], values.shape[1], dtype=np.int32)
            results[key(shape, "smallest", "max")] = parallel.sharded_masked_max(values, counts, mesh)
            results[key(shape, "smallest", "bisect")] = parallel.sharded_percentile_bisect(values, counts, 50.0, mesh)
    np.savez(out / f"functions-{rank}.npz", **results)
    return calls


def _port_scans(out: Path, rank: int) -> dict:
    """``Runner.run`` of every scan of :data:`SCANS` on the global meshes of
    :data:`SCAN_MESHES`, resident and host-streamed, and ``tdigest
    --state_path`` twice into this rank's own directory; each JSON to a
    file. Returns each scan's path through the strategy."""
    from .test_torch_simple import jax_objects, long_histories, make_fleet
    from .test_torch_store import PINNED_CLOCK
    from .test_torch_tdigest import run_port

    zipfile.time = PINNED_CLOCK
    dicts, histories = make_fleet(seed=11)
    dumps = [o.model_dump(mode="json") for o in jax_objects(dicts)]
    fleets = {"resident": (None, dumps, histories), "streamed": (None, dumps, long_histories(histories, 30_000))}
    paths = {}
    for time_axis in SCAN_MESHES:
        for name, (strategy, args) in SCANS.items():
            for path, fleet in fleets.items():
                settings = {**args, "mesh_time_axis": time_axis}
                if path == "streamed":
                    settings["host_stream_mb"] = 1
                result, runner = run_port(fleet, settings, strategy=strategy, format="json")
                (out / f"scan-{time_axis}-{name}-{path}-{rank}.json").write_text(result.format("json"))
                strategy_obj = runner.session.strategy
                paths[f"{time_axis}-{name}-{path}"] = (
                    "streamed" if strategy_obj.stream_stats is not None
                    else "resident" if "h2d" in strategy_obj.leg_seconds else "mesh"
                )
    state = out / f"state-{rank}"
    for run in range(2):
        result, _runner = run_port(fleets["resident"], {"state_path": str(state)}, format="json")
        (out / f"state-{run}-{rank}.json").write_text(result.format("json"))
    return paths


def _port_rank(spec: dict) -> None:
    import torch.distributed as dist

    from krr_tpu_torch import parallel
    from krr_tpu_torch.parallel import collectives

    out, rank = Path(spec["out"]), spec.get("rank")
    if spec["how"] == "env":
        world = parallel.initialize_distributed(device="cpu")
    else:
        world = parallel.initialize_distributed(spec["coordinator"], spec["size"], rank, device="cpu")
    record = {
        "rank": world.rank, "size": world.size, "backend": world.backend, "device": str(world.device),
        "devices": [[d.rank, str(d.device)] for d in parallel.mesh_devices("cpu")],
        "backend_of_group": dist.get_backend(), "group_size": dist.get_world_size(), "cards": list(world.cards),
    }
    if "functions" in spec["jobs"]:
        record["calls"] = _port_functions(out, world.rank, world.size)
    if "scans" in spec["jobs"]:
        record["scan_paths"] = _port_scans(out, world.rank)
    if "one" in spec["jobs"]:
        data = dict(np.load(out / "inputs.npz"))
        devices = parallel.mesh_devices("cpu")
        record["mesh"] = None if len(devices) <= 1 else list(parallel.make_mesh(time=len(devices),
                                                                                devices=devices).shape.values())
        mesh = parallel.make_mesh(1, 2, devices=devices if len(devices) > 1 else ["cpu"] * 2)
        np.save(out / f"{spec['name']}-{world.rank}.npy",
                parallel.sharded_percentile_bisect(data["select_v"], data["select_c"], 99.0, mesh))
        record["collectives"] = dict(collectives.STATS)
        try:
            parallel.mesh_devices("cuda")
        except ValueError as error:
            record["other_type"] = str(error)
    (out / f"{spec['name']}-{world.rank}.json").write_text(json.dumps(record))
    dist.destroy_process_group()


def _jax_rank(spec: dict) -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    from krr_tpu.parallel.mesh import initialize_distributed

    out, rank = Path(spec["out"]), spec["rank"]
    initialize_distributed(coordinator_address=spec["coordinator"], num_processes=2, process_id=rank)
    from krr_tpu import parallel
    from krr_tpu.ops.digest import DigestSpec

    assert jax.process_count() == 2 and len(jax.devices()) == 4, (jax.process_count(), jax.devices())
    data = dict(np.load(out / "inputs.npz"))
    np.savez(out / f"jax-{rank}.npz", **sharded_results(parallel, data, parallel.make_mesh(1, 4), (1, 4), "finite."))
    raised = {}
    for shape, values in SMALLEST.items():
        mesh = parallel.make_mesh(*shape)
        counts = np.full(values.shape[0], values.shape[1], dtype=np.int32)
        def percentile(values=values, counts=counts, mesh=mesh):
            digest, rows = parallel.sharded_fleet_digest(DigestSpec(), values, counts, mesh)
            return parallel.sharded_percentile(DigestSpec(), digest, 50.0, rows)

        calls = {
            "max": lambda: parallel.sharded_masked_max(values, counts, mesh),
            "bisect": lambda: parallel.sharded_percentile_bisect(values, counts, 50.0, mesh),
            "percentile": percentile,
        }
        for name, call in calls.items():
            try:
                raised[key(shape, name)] = ["answered", np.asarray(call()).tolist()]
            except RuntimeError as error:
                raised[key(shape, name)] = ["RuntimeError", str(error)]
    (out / f"jax-{rank}.json").write_text(json.dumps(raised))


def child() -> None:
    """A rank's entry point: ``python -c 'from tests.test_torch_distributed
    import child; child()' '<json spec>'``."""
    spec = json.loads(sys.argv[1])
    (_jax_rank if spec["role"] == "jax" else _port_rank)(spec)


# ------------------------------------------------------------- the parent
def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(out: Path, spec: dict, env: dict) -> tuple[subprocess.Popen, Path]:
    log = out / f"{spec['name']}-{spec.get('rank', spec.get('env_rank'))}.log"
    code = "from tests.test_torch_distributed import child; child()"
    with open(log, "w") as sink:
        proc = subprocess.Popen([sys.executable, "-c", code, json.dumps({**spec, "out": str(out)})],
                                cwd=REPO, env=env, stdout=sink, stderr=subprocess.STDOUT)
    return proc, log


def wait_all(procs: list) -> None:
    """Wait for every child, at most :data:`DEADLINE` seconds; the first
    that fails, or the deadline, kills the rest."""
    deadline = time.monotonic() + DEADLINE
    try:
        while any(proc.poll() is None for proc, _log in procs):
            failed = [(proc, log) for proc, log in procs if proc.poll() not in (None, 0)]
            for proc, log in failed:
                raise AssertionError(f"{log.name} exited {proc.returncode}:\n{log.read_text()[-4000:]}")
            assert time.monotonic() < deadline, "a rank ran past the deadline:\n" + "\n".join(
                f"{log.name}: {log.read_text()[-1500:]}" for proc, log in procs if proc.poll() is None)
            time.sleep(0.05)
        for proc, log in procs:
            assert proc.returncode == 0, f"{log.name} exited {proc.returncode}:\n{log.read_text()[-4000:]}"
    finally:
        for proc, _log in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=10)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Run every spawn at once; returns the directory of their files."""
    out = tmp_path_factory.mktemp("ranks")
    np.savez(out / "inputs.npz", **inputs())
    base = {k: v for k, v in os.environ.items()
            if k not in ("XLA_FLAGS", "JAX_PLATFORMS", "JAX_CPU_COLLECTIVES_IMPLEMENTATION", "MASTER_ADDR",
                         "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE")}
    base = {**base, "PYTHONPATH": str(REPO), "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1"}
    jax_env = {**base, "XLA_FLAGS": "--xla_force_host_platform_device_count=2",
               "JAX_CPU_COLLECTIVES_IMPLEMENTATION": "gloo"}
    explicit, jax_port, single, env_port = (free_port() for _ in range(4))
    procs = []
    for rank in range(2):
        procs.append(spawn(out, {"role": "port", "name": "explicit", "how": "explicit", "rank": rank, "size": 2,
                                 "coordinator": f"127.0.0.1:{explicit}", "jobs": ["functions", "scans"]}, base))
        procs.append(spawn(out, {"role": "jax", "name": "jax", "rank": rank,
                                 "coordinator": f"127.0.0.1:{jax_port}"}, jax_env))
        launcher = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(env_port), "WORLD_SIZE": "2", "RANK": str(rank),
                    "LOCAL_RANK": str(rank), "LOCAL_WORLD_SIZE": "2"}
        procs.append(spawn(out, {"role": "port", "name": "env", "how": "env", "env_rank": rank, "jobs": ["one"]},
                           {**base, **launcher}))
    procs.append(spawn(out, {"role": "port", "name": "single", "how": "explicit", "rank": 0, "size": 1,
                             "coordinator": f"127.0.0.1:{single}", "jobs": ["one"]}, base))
    wait_all(procs)
    return out


@pytest.fixture(scope="module")
def references():
    """The single-process references on the same inputs: the port's mesh
    over the CPU repeated, and the JAX package's over the conftest's
    virtual devices."""
    import jax

    import krr_tpu.parallel as jax_parallel
    import krr_tpu_torch.parallel as port_parallel

    data = inputs()
    port, ref = {}, {}
    for shape in MESHES:
        k = shape[0] * shape[1]
        port.update(sharded_results(port_parallel, data, port_parallel.make_mesh(*shape, devices=["cpu"] * k), shape))
        ref.update(sharded_results(jax_parallel, data, jax_parallel.make_mesh(*shape, devices=jax.devices()[:k]),
                                   shape))
    return data, port, ref


def rank_results(ranks: Path) -> list[dict]:
    return [dict(np.load(ranks / f"functions-{rank}.npz")) for rank in range(2)]


def assert_equal_to(got: dict, want: dict, shape, name: str, data: dict, jax_side: bool, tag: str = "") -> None:
    """One function's result against a reference: bit for bit, or, against
    the JAX package, with the contract each function has there."""
    from .test_torch_parallel import assert_moves_at_edges, ordered_sorted
    from .test_torch_select import assert_same
    from .test_torch_sketch import assert_digests_bit_equal
    from krr_tpu_torch.ops import digest as port_digest

    def k(*args) -> str:
        return tag + key(*args)

    if name == "topk":
        np.testing.assert_array_equal(ordered_sorted(got[k(shape, name, "values")]),
                                      ordered_sorted(want[k(shape, name, "values")]))
        np.testing.assert_array_equal(got[k(shape, name, "total")], want[k(shape, name, "total")])
        return
    if name == "digest" and not jax_side:
        fields = ("counts", "total", "peak")
        assert_digests_bit_equal(port_digest.Digest(*(torch.from_numpy(want[k(shape, name, f)]) for f in fields)),
                                 port_digest.Digest(*(torch.from_numpy(got[k(shape, name, f)]) for f in fields)),
                                 data[tag + "digest_v"])
        return
    nan_rows = np.zeros(N, dtype=bool)
    if jax_side and name in ("max", "digest"):
        # The JAX pmax drops a NaN sample (ROADMAP Queue 3 item 9); the port keeps it.
        rows = "select" if name == "max" else "digest"
        v, c = data[f"{tag}{rows}_v"], data[f"{tag}{rows}_c"]
        valid = np.arange(v.shape[1])[None, :] < c[:, None]
        nan_rows = (valid & np.isnan(v)).any(axis=1)
    if name == "digest":
        np.testing.assert_array_equal(got[k(shape, name, "total")], want[k(shape, name, "total")])
        peak, ref_peak = got[k(shape, name, "peak")], want[k(shape, name, "peak")]
        assert_same(peak[~nan_rows], ref_peak[~nan_rows])
        assert np.isnan(peak[nan_rows]).all()
        moved = assert_moves_at_edges(port_digest.DigestSpec(), got[k(shape, name, "counts")],
                                      want[k(shape, name, "counts")], data[tag + "digest_v"], data[tag + "digest_c"])
        assert moved <= 0.001 * float(got[k(shape, name, "total")].sum())
        return
    if name == "percentile" and jax_side:
        return  # a digest estimate: held through its digest above, and bit for bit to the port's own mesh
    assert_same(got[k(shape, name)][~nan_rows], want[k(shape, name)][~nan_rows])
    assert np.isnan(got[k(shape, name)][nan_rows]).all()


# ---------------------------------------------------------------- the tests
@pytest.mark.parametrize("name", FUNCTIONS)
@pytest.mark.parametrize("shape", list(MESHES), ids=lambda s: f"{s[0]}x{s[1]}")
def test_each_rank_equals_the_single_process_meshes(ranks, references, shape, name):
    """On every rank, each function equals the port's single-process mesh
    of the same shape bit for bit, and the JAX package's single-process
    mesh on its virtual devices with that package's contract."""
    data, port, ref = references
    for got in rank_results(ranks):
        assert got[key(shape, "max")].shape == (N,)
        assert_equal_to(got, port, shape, name, data, jax_side=False)
        assert_equal_to(got, ref, shape, name, data, jax_side=True)


@pytest.mark.parametrize("name", FUNCTIONS)
def test_one_by_four_equals_a_two_process_jax_run(ranks, references, name):
    """On (1, 4) over two processes (time across them), each rank's result
    equals the JAX package's two-process run's, which both its processes
    read back whole (on finite rows: see :func:`inputs`)."""
    data, _port, _ref = references
    jax_runs = [dict(np.load(ranks / f"jax-{rank}.npz")) for rank in range(2)]
    for got in rank_results(ranks):
        for jax_run in jax_runs:
            assert_equal_to(got, jax_run, (1, 4), name, data, jax_side=True, tag="finite.")


@pytest.mark.parametrize("shape", list(SMALLEST), ids=lambda s: f"{s[0]}x{s[1]}")
def test_reference_raises_where_row_blocks_span_processes(ranks, shape):
    """ROADMAP Queue 3 item 12: with row blocks on different processes the
    JAX package's host readbacks raise ``RuntimeError`` (the array spans
    devices no process can address), on every process; the port gathers
    every row to every rank: the max and the median of each row."""
    values = SMALLEST[shape]
    for rank in range(2):
        raised = json.loads((ranks / f"jax-{rank}.json").read_text())
        for name in ("max", "bisect", "percentile"):
            kind, message = raised[key(shape, name)]
            assert kind == "RuntimeError" and "non-addressable" in message, (name, kind, message)
    for got in rank_results(ranks):
        np.testing.assert_array_equal(got[key(shape, "smallest", "max")], values.max(axis=1))
        np.testing.assert_array_equal(got[key(shape, "smallest", "bisect")], values[:, 0])


def test_reference_answers_with_time_across_processes(ranks):
    """The same readbacks on (1, 4), time across processes, answer."""
    for rank in range(2):
        raised = json.loads((ranks / f"jax-{rank}.json").read_text())
        assert all(kind == "answered" for name, (kind, _answer) in raised.items() if name.startswith("1x4"))


@pytest.mark.parametrize("shape", list(MESHES), ids=lambda s: f"{s[0]}x{s[1]}")
def test_each_rank_runs_only_its_own_shards(ranks, shape):
    """Each rank calls a shard's kernel once for each shard it owns and for
    no other: the per-shard calls of all the functions, counted on each
    rank, add up to one call per cell of the mesh."""
    data_axis, time_axis = shape
    shards = data_axis * time_axis // 2  # each rank owns half the cells
    select = ({"masked_percentile_bisect_cuda": len(QS) * shards} if time_axis == 1
              else {"radix_digit_hist": len(QS) * 3 * shards})
    want = {**select, "row_max_chunk": shards, "build_from_packed": 2 * shards}
    for rank in range(2):
        record = json.loads((ranks / f"explicit-{rank}.json").read_text())
        assert record["calls"][key(shape, "calls")] == want


@pytest.mark.parametrize("path", ["resident", "streamed"])
@pytest.mark.parametrize("name", list(SCANS))
@pytest.mark.parametrize("time_axis", list(SCAN_MESHES))
def test_runner_renders_jax_bytes_on_every_rank(ranks, jax_scans, time_axis, name, path):
    """``Runner.run`` on the global mesh the strategy resolves over the two
    ranks renders, on every rank, the JAX package's bytes: resident on the
    mesh, and host-streamed with the rows split over both ranks."""
    for rank in range(2):
        record = json.loads((ranks / f"explicit-{rank}.json").read_text())
        assert record["scan_paths"][f"{time_axis}-{name}-{path}"] == ("mesh" if path == "resident" else "streamed")
        assert (ranks / f"scan-{time_axis}-{name}-{path}-{rank}.json").read_text() == jax_scans[(name, path)]


def test_state_path_on_every_rank(ranks, jax_scans, tmp_path, monkeypatch):
    """``tdigest --state_path`` on the (2, 1) mesh, twice: each rank renders
    the JAX package's bytes each run and persists the whole window into its
    own state directory, byte for byte the port's single-process one."""
    from .test_torch_store import PINNED_CLOCK, assert_same_files
    from .test_torch_tdigest import run_port

    monkeypatch.setattr(zipfile, "time", PINNED_CLOCK)
    fleet = jax_scans["fleet"]
    single = tmp_path / "single"
    for run in range(2):
        result, _runner = run_port(fleet, {"state_path": str(single)}, format="json")
        for rank in range(2):
            rendered = (ranks / f"state-{run}-{rank}.json").read_text()
            assert rendered == result.format("json") == jax_scans[("state", run)]
    for rank in range(2):
        assert_same_files(str(ranks / f"state-{rank}"), str(single))


@pytest.fixture(scope="module")
def jax_scans(tmp_path_factory):
    """The JAX package's renders of the scans (the fleet of
    `tests/test_torch_tdigest.py`) and of two ``--state_path`` runs."""
    from .test_torch_simple import jax_objects, long_histories, make_fleet
    from .test_torch_simple import run_jax as run_jax_simple
    from .test_torch_tdigest import run_jax

    dicts, histories = make_fleet(seed=11)
    jax_objs = jax_objects(dicts)
    fleet = (jax_objs, [o.model_dump(mode="json") for o in jax_objs], histories)
    long = (jax_objs, fleet[1], long_histories(histories, 30_000))
    out = {"fleet": fleet}
    for name, (strategy, args) in SCANS.items():
        run = run_jax_simple if strategy == "simple" else run_jax
        out[(name, "resident")] = run(fleet, args, format="json").format("json")
        out[(name, "streamed")] = run(long, {**args, "host_stream_mb": 1}, format="json").format("json")
    state = tmp_path_factory.mktemp("jax-state") / "state"
    for run in range(2):
        out[("state", run)] = run_jax(fleet, {"state_path": str(state)}, format="json").format("json")
    return out


def test_initialize_distributed_explicit_and_env(ranks):
    """The JAX function's three arguments and the launcher's ``env://``
    variables start the same group: gloo on the CPU, each rank's device
    recorded, every rank's device in rank order from ``mesh_devices``, which
    refuses another device type; both give the same answer."""
    for name in ("explicit", "env"):
        for rank in range(2):
            record = json.loads((ranks / f"{name}-{rank}.json").read_text())
            assert (record["rank"], record["size"], record["backend"], record["device"]) == (rank, 2, "gloo", "cpu")
            assert record["devices"] == [[0, "cpu"], [1, "cpu"]]
            assert (record["backend_of_group"], record["group_size"], record["cards"]) == ("gloo", 2, [None, None])
    for rank in range(2):
        record = json.loads((ranks / f"env-{rank}.json").read_text())
        assert record["mesh"] == [1, 2] and "started on cpu" in record["other_type"]
        got = np.load(ranks / f"env-{rank}.npy")
        np.testing.assert_array_equal(got.view(np.uint32), rank_results(ranks)[rank][key((1, 2), "bisect_q99")]
                                      .view(np.uint32))


def test_world_of_one_is_the_single_process_path(ranks, references):
    """A world of one: one device, so the strategies take no mesh; a mesh
    over its device repeated runs in-process with no collective, and equals
    the single-process mesh."""
    _data, port, _ref = references
    record = json.loads((ranks / "single-0.json").read_text())
    assert (record["rank"], record["size"], record["backend"], record["devices"]) == (0, 1, "gloo", [[0, "cpu"]])
    assert record["mesh"] is None and record["collectives"] == {}
    got = np.load(ranks / "single-0.npy")
    np.testing.assert_array_equal(got.view(np.uint32), port[key((1, 2), "bisect_q99")].view(np.uint32))


# ------------------------------------------- the rules, without a process group
@pytest.mark.parametrize(
    "cards, backend",
    [
        (["GPU-a", "GPU-b"], "nccl"),  # a card a rank, each rank seeing every card of its host
        (["GPU-a", "GPU-a"], "gloo"),  # two ranks on one card
        (["GPU-a", "GPU-b", "GPU-a"], "gloo"),  # one card shared, another not
        ([None, None], "gloo"),  # the CPU
        (["GPU-a", None], "gloo"),  # a rank on the CPU
        (["GPU-a"], "nccl"),  # a world of one on a card
    ],
    ids=["own_cards", "shared_card", "one_shared", "cpu", "mixed", "one_rank"],
)
def test_backend_follows_every_ranks_card(cards, backend):
    """The backend is decided from every rank's card identity, the same
    list on every rank: nccl exactly when no two ranks share a card."""
    from krr_tpu_torch.parallel.mesh import choose_backend

    assert choose_backend(cards) == backend


@pytest.mark.parametrize(
    "local_rank, local_size, cards, index",
    [
        (1, 2, 2, 1),  # a card per local rank: its own
        (3, 4, 8, 3),
        (0, 2, 1, 0),  # one card shared by the host's ranks, or each rank shown only its own
        (1, 2, 1, 0),
        (3, 4, 2, 1),  # two cards among four ranks, in turn
    ],
)
def test_local_card(local_rank, local_size, cards, index):
    """A rank's card among those its process sees. A rank restricted by a
    ``CUDA_VISIBLE_DEVICES`` of its own card sees one and takes index 0;
    :func:`test_backend_follows_every_ranks_card` then tells its card from
    its peers' by identity, not by index."""
    from krr_tpu_torch.parallel.mesh import local_card

    assert local_card(local_rank, local_size, cards) == index


def test_transport_device(monkeypatch):
    """gloo collects on the CPU and nccl on the rank's card, so a host
    array's part is carried to the card on nccl and a card's tensor to the
    host on gloo."""
    from krr_tpu_torch.parallel import collectives, mesh

    card = torch.device("cuda", 1)
    world = mesh.World(rank=0, size=2, backend="nccl", device=card, devices=(), cards=("GPU-a", "GPU-b"))
    monkeypatch.setattr(mesh, "_WORLD", world)
    assert collectives.transport_device("nccl") == card
    assert collectives.transport_device("gloo") == torch.device("cpu")


def test_collectives_over_one_rank_are_identities():
    """Over one rank, with no process group, every collective gives its
    input back and records nothing: the single-process meshes run the same
    code."""
    from krr_tpu_torch.parallel import collectives

    collectives.reset_stats()
    x = torch.arange(6, dtype=torch.int32).reshape(2, 3)
    assert collectives.all_reduce(x, torch.distributed.ReduceOp.SUM, [0]) is x
    assert collectives.all_gather(x, [0])[0] is x
    parts = [np.ones((2, 3), np.float32), np.zeros((1, 3), np.float32)]
    got = collectives.gather_row_parts(parts, [0, 0], [2, 1], [0], parts[0], torch.device("cpu"))
    assert all(a is b for a, b in zip(got, parts)) and collectives.STATS == {}


@pytest.mark.parametrize("n", [0, 3, 29])
def test_mesh_row_split_in_one_process(n):
    """A mesh's row split in one process equals the ops layer's split over
    the mesh's devices: the same blocks in row order, host arrays and
    tuples of tensors alike, for a window with no rows, fewer rows than
    cells, and ragged blocks."""
    from krr_tpu_torch import parallel
    from krr_tpu_torch.ops import digest as port_digest
    from krr_tpu_torch.ops import quantile as port_quantile
    from krr_tpu_torch.parallel.fleet import mesh_row_split

    from .test_torch_parallel import ragged

    values, counts = ragged(3, n, 50)
    mesh = parallel.make_mesh(2, 2, devices=["cpu"] * 4)
    spec = port_digest.DigestSpec()
    got = {}
    for name, where in (("mesh", mesh_row_split(mesh)), ("ops", mesh.flat())):
        peak = port_quantile.masked_max_from_host(values, counts, 16, device="cpu", devices=where)
        digest = port_digest.build_from_host(spec, values, counts, 16, device="cpu", devices=where)
        assert peak.shape == (n,) and digest.counts.shape == (n, spec.num_buckets)
        got[name] = [peak, *(field.numpy() for field in digest)]
    for a, b in zip(got["mesh"], got["ops"]):
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))
