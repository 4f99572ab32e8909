"""The port's digest ingest held against the JAX package's.

Digest ingest folds every Prometheus response straight into per-object
log-bucket digests at parse time (the native fused parse+bucketize, or its
Python fallback), so both packages build their ingest digests with the same
code and must agree bit for bit: the parsers and the streamed ingest on the
same bodies; ``gather_fleet_digests`` against the fake apiserver and
Prometheus of ``tests/test_integrations.py``; streamed discovery; the scan
pipeline (`krr_tpu_torch/core/pipeline.py`) with its backpressure and
cancellation; ``stream_fleet_digests`` against the staged gather; and
``Runner.run`` of ``tdigest`` with ``digest_ingest`` (pipeline depth 4 and
0) and with ``state_path`` (resident and host-streamed, both store formats),
whose renders must equal the JAX ``Runner``'s bytes.

The ``state_path`` window digest is the one place where the packages build
digests differently (the port's plain ``digest_hist`` against XLA's): their
stores may then differ by one-bucket moves of samples on a bucket edge, the
digest's own contract, and the tests count such moves instead of assuming
there are none.
"""

from __future__ import annotations

import asyncio
import gc
import threading
import time
import types

import numpy as np
import pytest
import yaml

import krr_tpu.core.config as jax_config
import krr_tpu.core.pipeline as jax_pipeline
import krr_tpu.core.runner as jax_runner
import krr_tpu.core.streaming as jax_streaming
import krr_tpu.integrations.kubernetes as jax_kubernetes
import krr_tpu.integrations.native as jax_native
import krr_tpu.integrations.prometheus as jax_prometheus
import krr_tpu.models.allocations as jax_allocations
import krr_tpu.models.objects as jax_objects_module
import krr_tpu.models.series as jax_series
import krr_tpu.ops.digest as jax_digest
import krr_tpu_torch.core.config as port_config
import krr_tpu_torch.core.pipeline as port_pipeline
import krr_tpu_torch.core.runner as port_runner
import krr_tpu_torch.core.streaming as port_streaming
import krr_tpu_torch.integrations.kubernetes as port_kubernetes
import krr_tpu_torch.integrations.native as port_native
import krr_tpu_torch.integrations.prometheus as port_prometheus
import krr_tpu_torch.models.allocations as port_allocations
import krr_tpu_torch.models.objects as port_objects_module
import krr_tpu_torch.models.series as port_series
import krr_tpu_torch.ops.digest as port_digest

from .fakes.servers import FakeBackend, FakeCluster, FakeMetrics, ServerThread
from .test_integrations import fake_env  # noqa: F401  (module-scoped fixture)
from .test_native import make_response
from .test_torch_simple import jax_objects, long_histories, make_fleet, scan_stages
from .test_torch_tdigest import run_jax, run_port


def _package(config, pipeline, runner, streaming, kubernetes, native, prometheus, allocations, objects, series):
    return types.SimpleNamespace(
        Config=config.Config, ScanPipeline=pipeline.ScanPipeline, runner=runner,
        ScanSession=runner.ScanSession, Runner=runner.Runner, streaming=streaming,
        kubernetes=kubernetes, native=native, prometheus=prometheus,
        ResourceType=allocations.ResourceType, ResourceAllocations=allocations.ResourceAllocations,
        K8sObjectData=objects.K8sObjectData, DigestedFleet=series.DigestedFleet,
    )


PKGS = {
    "jax": _package(jax_config, jax_pipeline, jax_runner, jax_streaming, jax_kubernetes, jax_native,
                    jax_prometheus, jax_allocations, jax_objects_module, jax_series),
    "port": _package(port_config, port_pipeline, port_runner, port_streaming, port_kubernetes, port_native,
                     port_prometheus, port_allocations, port_objects_module, port_series),
}
SPEC = (1.01, 1e-7, 256)  # gamma, min_value, num_buckets


@pytest.fixture(scope="module", autouse=True)
def jax_native_library():
    """The JAX package builds its native library in place: retry its load
    while another test process may still be writing it (see
    ``tests/test_torch_integrations.py``)."""
    deadline = time.monotonic() + 120.0
    while jax_native._load_library() is None and time.monotonic() < deadline:
        jax_native._build_failed = False
        time.sleep(0.5)


def assert_fleets_equal(a, b) -> None:
    assert [o.model_dump(mode="json") for o in a.objects] == [o.model_dump(mode="json") for o in b.objects]
    for f in ("cpu_counts", "cpu_total", "cpu_peak", "mem_total", "mem_peak"):
        got, want = getattr(a, f), getattr(b, f)
        assert got.dtype == want.dtype == np.float64, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    assert a.failed_rows == b.failed_rows


# ------------------------------------------------------------ the parsers
def _bodies() -> "dict[str, bytes]":
    rng = np.random.default_rng(17)
    edge = 1e-7 * 1.01 ** np.arange(1, 40, dtype=np.float64)  # on the bucket edges
    return {
        "gamma": make_response([
            ("pod-a", list(rng.gamma(2.0, 0.05, 700))),
            ("pod-b", [0.0, 1e-9, 1e-7, 12345.678, 0.25, -1.0]),
            ("pod-empty", []),
            ("pod-edges", list(edge) + list(np.nextafter(edge, 0)) + list(np.nextafter(edge, 1))),
        ]),
        "memory": make_response([("p", list(rng.uniform(1e7, 4e9, 400))), ("q", [5e8])]),
        "empty": b'{"status":"success","data":{"resultType":"matrix","result":[]}}',
        "nonfinite": (
            b'{"status":"success","data":{"resultType":"matrix","result":['
            b'{"metric":{"pod":"p"},"values":[[1,"NaN"],[2,"1.5"],[3,"+Inf"],[4,"-Inf"],[5,"2"]]}]}}'
        ),
        "batched_keys": (
            b'{"status":"success","data":{"resultType":"matrix","result":['
            b'{"metric":{"pod":"a","container":"main"},"values":[[1,"1"],[2,"3"]]},'
            b'{"metric":{"pod":"b","container":"x","namespace":"n2"},"values":[[1,"0.125"]]}]}}'
        ),
        "error_status": b'{"status":"error","errorType":"bad_data","error":"query too long"}',
        "truncated": make_response([("p", [1.0, 2.0])])[:-7],
    }


def _outcome(fn, *args):
    try:
        result = fn(*args)
    except Exception as e:  # the failure class must agree, not the message
        return ("raises", type(e).__name__)
    return [
        (entry[0], *(e.tolist() if isinstance(e, np.ndarray) else e for e in entry[1:]))
        for entry in result
    ]


@pytest.mark.parametrize("route", ["native", "python"])
@pytest.mark.parametrize("body", sorted(_bodies()))
def test_parse_matrix_digest_matches(monkeypatch, body, route):
    assert port_native.library_loaded() and jax_native._load_library() is not None
    if route == "python":
        for native in (port_native, jax_native):
            monkeypatch.setattr(native, "_load_library", lambda: None)
    data = _bodies()[body]
    port = _outcome(port_native.parse_matrix_digest, data, *SPEC)
    jax = _outcome(jax_native.parse_matrix_digest, data, *SPEC)
    assert port == jax
    if body == "gamma" and route == "native":
        assert sum(sum(entry[1]) for entry in port) == 700 + 6 + 3 * 39


@pytest.mark.parametrize("route", ["native", "python"])
def test_digest_samples_matches(monkeypatch, route):
    if route == "python":
        for native in (port_native, jax_native):
            monkeypatch.setattr(native, "_load_library", lambda: None)
    rng = np.random.default_rng(3)
    for samples in (rng.gamma(2.0, 0.05, 1000), np.asarray([]), np.asarray([1e-9, 1e-7, 2.0])):
        port = port_native.digest_samples(samples, *SPEC)
        jax = jax_native.digest_samples(samples, *SPEC)
        np.testing.assert_array_equal(port[0], jax[0])
        assert port[1:] == jax[1:]


@pytest.mark.parametrize("chunk", [1, 13, 4096])
@pytest.mark.parametrize("body", ["gamma", "batched_keys", "nonfinite", "empty", "truncated"])
def test_stream_digest_finish_matches(body, chunk):
    """Digest-mode ``StreamIngest.finish`` (the matrix form) over arbitrary
    chunk boundaries."""
    data = _bodies()[body]

    def streamed(native):
        stream = native.open_stream(*SPEC, reserve_series=3)
        try:
            for i in range(0, len(data), chunk):
                stream.feed(data[i:i + chunk])
            keys, counts, totals, peaks = stream.finish()
        except ValueError as e:
            return ("raises", str(e))
        return keys, counts.tolist(), totals.tolist(), peaks.tolist()

    assert streamed(port_native) == streamed(jax_native)


@pytest.mark.parametrize("body", ["gamma", "batched_keys", "memory"])
def test_stream_finish_parse_fold_matches(body):
    """The fleet fast path: ``finish_parse``, ``read_meta`` and the native
    band-sparse ``fold_counts_into`` straight into caller rows."""
    data = _bodies()[body]

    def folded(native):
        stream = native.open_stream(*SPEC)
        stream.feed(data)
        stream.finish_parse()
        names, totals, peaks = stream.read_meta()
        dst = np.zeros((5, SPEC[2]), np.float64)
        rows = np.arange(len(totals), dtype=np.int64)[::-1] % 5
        if rows.size:
            rows[0] = -1  # skipped
        stream.fold_counts_into(rows, dst)
        stream.free()
        return names, totals.tolist(), peaks.tolist(), dst.tolist()

    assert folded(port_native) == folded(jax_native)


# ---------------------------------------------- the loader's digest route
def _discover(pkg, fake_env, **overrides):  # noqa: F811
    config = pkg.Config(kubeconfig=fake_env["kubeconfig"], **overrides)

    async def run():
        loader = pkg.kubernetes.KubernetesLoader(config)
        try:
            clusters = await loader.list_clusters()
            staged = await loader.list_scannable_objects(clusters)
            rows = []
            async for ordinal, positions, objects in loader.stream_scannable_objects(clusters):
                assert len(positions) == len(objects)
                rows.extend(zip([ordinal] * len(objects), positions, objects))
            return staged, rows
        finally:
            await loader.close()

    return asyncio.run(run())


DISCOVERY_OPTIONS = {
    "default": {},
    "per_workload_pods": {"bulk_pod_discovery": False},
    "namespaces": {"namespaces": ["prod", "kube-system"]},
    "all_clusters": {"clusters": "*"},
}


@pytest.mark.parametrize("option", sorted(DISCOVERY_OPTIONS))
def test_streamed_discovery_positions_are_the_staged_indices(fake_env, option):  # noqa: F811
    dumps = {}
    for name, pkg in PKGS.items():
        staged, rows = _discover(pkg, fake_env, **DISCOVERY_OPTIONS[option])
        assert sorted((o, p) for o, p, _ in rows) == [(0, i) for i in range(len(staged))]
        for _ordinal, position, obj in rows:
            assert obj == staged[position]
        dumps[name] = [(o, p, obj.model_dump(mode="json")) for o, p, obj in sorted(rows, key=lambda r: r[:2])]
    assert dumps["port"] == dumps["jax"]
    assert dumps["port"]


def _gather_digests(pkg, fake_env, objects, **overrides):  # noqa: F811
    config = pkg.Config(
        kubeconfig=fake_env["kubeconfig"], prometheus_url=fake_env["server"].url,
        prometheus_backoff_cap_seconds=0.01, prometheus_retry_deadline_seconds=0.05, **overrides,
    )

    async def run():
        loader = pkg.prometheus.PrometheusLoader(config, cluster="fake")
        try:
            return await loader.gather_fleet_digests(objects, 3600.0 * 24 * 14, 900.0, *SPEC)
        finally:
            await loader.close()

    gc_was_enabled = gc.isenabled()
    gc.disable()
    try:
        return asyncio.run(run())
    finally:
        if gc_was_enabled:
            gc.enable()


FETCH_CASES = {
    "batched": {},
    "per_workload": {"batched_fleet_queries": False},
    "fixed_plan": {"fetch_plan": "fixed"},
    "adaptive_plan": {"fetch_plan": "adaptive", "fetch_plan_target_series": 2},
    "compression_off": {"fetch_compression": "off"},
}


@pytest.mark.parametrize("failing", [False, True], ids=["healthy", "prod_failing"])
@pytest.mark.parametrize("case", sorted(FETCH_CASES))
def test_gather_fleet_digests_bit_equal(fake_env, case, failing):  # noqa: F811
    objects = {name: _discover(pkg, fake_env)[0] for name, pkg in PKGS.items()}
    if failing:
        fake_env["metrics"].fail_namespaces = frozenset({"prod"})
    try:
        fleets = {
            name: _gather_digests(pkg, fake_env, objects[name], **FETCH_CASES[case]) for name, pkg in PKGS.items()
        }
    finally:
        fake_env["metrics"].fail_namespaces = frozenset()
    assert_fleets_equal(fleets["port"], fleets["jax"])
    port = fleets["port"]
    if failing:
        assert port.failed_rows == {i for i, o in enumerate(objects["port"]) if o.namespace == "prod"}
    assert port.cpu_total.sum() > 0 and port.mem_total.sum() > 0


# ---------------------------------------------------------- the pipeline
@pytest.mark.parametrize("name", sorted(PKGS))
class TestScanPipeline:
    def test_folds_every_batch_with_stats(self, name):
        async def main():
            seen: list[int] = []
            async with PKGS[name].ScanPipeline(seen.append, depth=2) as pipeline:
                for i in range(7):
                    await pipeline.put(i)
            return pipeline.stats, seen

        stats, seen = asyncio.run(main())
        assert sorted(seen) == list(range(7))
        assert stats.batches == 7
        assert stats.wall_seconds > 0 and stats.fetch_seconds <= stats.wall_seconds
        assert 0.0 <= stats.overlap_pct <= 100.0

    def test_backpressure_bounds_queue_depth(self, name):
        async def main():
            async with PKGS[name].ScanPipeline(lambda _b: time.sleep(0.02), depth=2) as pipeline:
                for i in range(8):
                    await pipeline.put(i)
            return pipeline.stats

        stats = asyncio.run(main())
        assert stats.peak_queue_depth <= 2 and stats.batches == 8
        assert stats.put_blocked_seconds > 0

    def test_fold_error_reraises_and_unblocks_producers(self, name):
        def fold(batch):
            raise ValueError("poisoned batch")

        async def main():
            with pytest.raises(ValueError, match="poisoned batch"):
                async with PKGS[name].ScanPipeline(fold, depth=1) as pipeline:
                    for i in range(6):
                        await pipeline.put(i)

        asyncio.run(asyncio.wait_for(main(), timeout=10))

    def test_abort_while_fold_in_flight_does_not_hang(self, name):
        async def main():
            with pytest.raises(RuntimeError, match="abort mid-fold"):
                async with PKGS[name].ScanPipeline(lambda _b: time.sleep(0.5), depth=2) as pipeline:
                    await pipeline.put(1)
                    await asyncio.sleep(0.1)
                    raise RuntimeError("abort mid-fold")

        asyncio.run(asyncio.wait_for(main(), timeout=10))

    def test_outer_cancellation_mid_fold_reraises_cancelled(self, name):
        """Cancelling the task that owns the pipeline while a fold runs
        unwinds promptly with ``CancelledError``: the consumer re-raises it
        rather than swallowing it into the fold-error slot."""

        async def scan():
            async with PKGS[name].ScanPipeline(lambda _b: time.sleep(0.5), depth=2) as pipeline:
                await pipeline.put(1)
                await asyncio.sleep(30)

        async def main():
            task = asyncio.create_task(scan())
            await asyncio.sleep(0.1)
            task.cancel()
            with pytest.raises(asyncio.CancelledError):
                await task

        asyncio.run(asyncio.wait_for(main(), timeout=10))


def make_obj(pkg, name: str, namespace: str = "default", cluster: str = "c", pods: int = 1):
    return pkg.K8sObjectData(
        cluster=cluster, namespace=namespace, name=name, kind="Deployment", container="main",
        pods=[f"{name}-{j}" for j in range(pods)],
        allocations=pkg.ResourceAllocations(requests={}, limits={}),
    )


def fleet_of(pkg):
    return [
        make_obj(pkg, "web", "default"), make_obj(pkg, "api", "default", pods=2),
        make_obj(pkg, "db", "prod"), make_obj(pkg, "cache", "prod"), make_obj(pkg, "job", "batch"),
        make_obj(pkg, "q1", "queue"), make_obj(pkg, "q2", "queue2"), make_obj(pkg, "q3", "queue3"),
        make_obj(pkg, "edge", "default", cluster="d"), make_obj(pkg, "log", "infra", cluster="d"),
    ]


def pod_series(pod: str, salt: int, n: int = 48) -> np.ndarray:
    seed = (sum(ord(c) for c in pod) * 7919 + salt) % (2**32)
    return np.random.default_rng(seed).gamma(2.0, 0.05, n)


class RawSource:
    """A history source without a fused digest path: the pipeline digests
    its batches on the fold thread (``fold_histories``)."""

    def __init__(self, pkg, fail: bool = False, delay: float = 0.0):
        self.pkg, self.fail, self.delay = pkg, fail, delay

    async def gather_fleet(self, objects, history_seconds, step_seconds, end_time=None):
        if self.delay:
            await asyncio.sleep(self.delay)
        if self.fail:
            raise ConnectionError("cluster down")
        salt = int(end_time or 0)
        return {
            self.pkg.ResourceType.CPU: [{p: pod_series(p, salt) for p in obj.pods} for obj in objects],
            self.pkg.ResourceType.Memory: [{p: pod_series(p, salt + 1) * 1e8 for p in obj.pods} for obj in objects],
        }


class DigestSource(RawSource):
    """A history source with a fused digest path, as the Prometheus loader."""

    async def gather_fleet_digests(self, objects, history_seconds, step_seconds, gamma, min_value,
                                   num_buckets, end_time=None):
        fetched = await self.gather_fleet(objects, history_seconds, step_seconds, end_time=end_time)
        fleet = self.pkg.DigestedFleet.empty(objects, gamma, min_value, num_buckets)
        for i in range(len(objects)):
            for samples in fetched[self.pkg.ResourceType.CPU][i].values():
                fleet.merge_cpu_row(i, *self.pkg.native.digest_samples(samples, gamma, min_value, num_buckets))
            for samples in fetched[self.pkg.ResourceType.Memory][i].values():
                fleet.merge_mem_row(i, float(samples.size), float(samples.max()))
        return fleet


class Inventory:
    def __init__(self, objects, streaming: bool):
        self.objects = objects
        if streaming:
            self.stream_scannable_objects = self._stream

    async def list_clusters(self):
        return sorted({obj.cluster for obj in self.objects})

    async def list_scannable_objects(self, clusters):
        return list(self.objects)

    async def _stream(self, clusters):
        """Per-namespace batches in a scrambled completion order (the
        objects are listed cluster by cluster, so a global position sorts
        like the loader's per-cluster one)."""
        ordinals = {cluster: i for i, cluster in enumerate(await self.list_clusters())}
        by_key: dict = {}
        for position, obj in enumerate(self.objects):
            positions, objs = by_key.setdefault((ordinals[obj.cluster], obj.namespace), ([], []))
            positions.append(position)
            objs.append(obj)
        for key in sorted(by_key, key=lambda k: (k[1][::-1], -k[0])):
            await asyncio.sleep(0)
            yield key[0], *by_key[key]


def session_config(pkg, **overrides):
    other_args = {"history_duration": 1, "timeframe_duration": 1, "digest_ingest": True,
                  "digest_buckets": SPEC[2]}
    if pkg is PKGS["port"]:
        other_args["device"] = "cpu"
    return pkg.Config(strategy="tdigest", quiet=True, other_args=other_args, **overrides)


SOURCES = {"raw": RawSource, "digest": DigestSource}


class TestStreamFleetDigests:
    @pytest.mark.parametrize("depth", [1, 4])
    @pytest.mark.parametrize("source", sorted(SOURCES))
    def test_streamed_equals_staged_and_jax(self, source, depth):
        """The staged gather and the streamed pipeline (a staged inventory,
        and streamed discovery in scrambled order) give bit-identical
        fleets, in the port and in the JAX package, and the same objects in
        the same order."""
        out = {}
        for name, pkg in PKGS.items():
            objects = fleet_of(pkg)

            async def main():
                staged = pkg.ScanSession(
                    session_config(pkg), inventory=Inventory(objects, False),
                    history_factory=lambda cluster: SOURCES[source](pkg),
                )
                want = await staged.gather_fleet_digests(objects, end_time=1000.0)
                session = pkg.ScanSession(
                    session_config(pkg, pipeline_depth=depth), inventory=Inventory(objects, True),
                    history_factory=lambda cluster: SOURCES[source](pkg),
                )
                same, got, stats = await session.stream_fleet_digests(objects, end_time=1000.0)
                assert same is objects
                assert_fleets_equal(got, want)
                discovered, streamed, stats = await session.stream_fleet_digests(end_time=1000.0)
                assert discovered == objects
                assert_fleets_equal(streamed, want)
                assert stats.batches >= 5 and stats.discover_seconds > 0
                return want

            out[name] = asyncio.run(main())
        assert_fleets_equal(out["port"], out["jax"])

    def test_failed_batch_degrades_to_unknown_rows_or_raises(self):
        pkg = PKGS["port"]
        objects = fleet_of(pkg)

        async def main():
            session = pkg.ScanSession(
                session_config(pkg), inventory=Inventory(objects, False),
                history_factory=lambda cluster: DigestSource(pkg, fail=cluster == "d"),
            )
            _objs, fleet, stats = await session.stream_fleet_digests(objects, end_time=1000.0)
            bad = {i for i, obj in enumerate(objects) if obj.cluster == "d"}
            assert fleet.failed_rows == bad and stats.failed_batches >= 1
            for i in bad:
                assert fleet.cpu_total[i] == 0.0 and fleet.cpu_peak[i] == -np.inf
            for i in set(range(len(objects))) - bad:
                assert fleet.cpu_total[i] > 0
            with pytest.raises(ConnectionError, match="cluster down"):
                await session.stream_fleet_digests(objects, end_time=1000.0, raise_on_failure=True)

        asyncio.run(main())

    @pytest.mark.parametrize("depth", [1, 2])
    def test_unfolded_batches_stay_within_two_depth_plus_one(self, monkeypatch, depth):
        """With instant fetches and slow folds, at most ``2 × depth + 1``
        fetched batches are ever waiting to be folded (depth held by the
        fetch slots through their put, depth in the queue, one folding)."""
        pkg = PKGS["port"]
        objects = [make_obj(pkg, f"w{i}", f"ns{i}") for i in range(12)]
        lock = threading.Lock()
        state = {"outstanding": 0, "peak": 0}

        class CountingSource(RawSource):
            async def gather_fleet(self, *args, **kwargs):
                fetched = await super().gather_fleet(*args, **kwargs)
                with lock:
                    state["outstanding"] += 1
                    state["peak"] = max(state["peak"], state["outstanding"])
                return fetched

        fold = port_runner.fold_histories

        def slow_fold(*args):
            time.sleep(0.02)
            fold(*args)
            with lock:
                state["outstanding"] -= 1

        monkeypatch.setattr(port_runner, "fold_histories", slow_fold)
        session = pkg.ScanSession(
            session_config(pkg, pipeline_depth=depth), inventory=Inventory(objects, True),
            history_factory=lambda cluster: CountingSource(pkg),
        )
        _objs, fleet, stats = asyncio.run(session.stream_fleet_digests(end_time=1000.0))
        assert stats.batches == 12 and not fleet.failed_rows
        assert 2 <= state["peak"] <= 2 * depth + 1
        assert state["outstanding"] == 0

    def test_batches_never_split_namespaces_or_mix_clusters(self):
        for name, pkg in PKGS.items():
            objects = fleet_of(pkg)
            batches = pkg.ScanSession._digest_batches(objects, depth=1)
            assert batches == PKGS["jax"].ScanSession._digest_batches(fleet_of(PKGS["jax"]), depth=1)
            for indices in batches:
                assert len({objects[i].cluster for i in indices}) == 1
            owners = {}
            for j, indices in enumerate(batches):
                for i in indices:
                    owners.setdefault((objects[i].cluster, objects[i].namespace), set()).add(j)
            assert all(len(v) == 1 for v in owners.values())


# ------------------------------------------------------ Runner.run parity
@pytest.fixture(scope="module")
def fleet():
    dicts, histories = make_fleet(seed=11)
    jax_objs = jax_objects(dicts)
    return jax_objs, [o.model_dump(mode="json") for o in jax_objs], histories


def bucket_moves(a: np.ndarray, b: np.ndarray) -> "tuple[int, int]":
    """(samples that moved, moves wider than one bucket) between two digest
    count matrices of the same samples: a sample one bucket over changes the
    running count at exactly one bucket, so over each row the summed
    ``|cumsum(a - b)|`` equals the moved samples when every move is one
    bucket, and exceeds it otherwise."""
    diff = a.astype(np.float64) - b.astype(np.float64)
    moved = int(np.abs(diff).sum() // 2)
    spread = int(np.abs(np.cumsum(diff, axis=1)).sum())
    return moved, spread - moved


def open_store(path: str, fmt: str, package: str):
    """One package's store at ``path``, read without a persistence engine."""
    streaming, spec = {
        "jax": (jax_streaming, jax_digest.DigestSpec()),
        "port": (port_streaming, port_digest.DigestSpec()),
    }[package]
    if fmt == "legacy":
        return streaming.DigestStore.load(path)
    return streaming.DigestStore.open_or_create(path, spec)


class TestRunnerParity:
    @pytest.mark.parametrize("depth", [4, 0])
    def test_digest_ingest_renders_jax_bytes(self, fleet, depth):
        jax = run_jax(fleet, {"digest_ingest": True, "use_mesh": False}, format="json", pipeline_depth=depth)
        port, runner = run_port(fleet, {"digest_ingest": True}, format="json", pipeline_depth=depth)
        assert port.format("json") == jax.format("json")
        assert port.format("yaml") == jax.format("yaml")
        assert scan_stages(runner) == [("quantile", "ingest"), ("round", None)]
        assert ("pipeline_batches" in runner.stats) == (depth > 0)
        # Staged, the broken cluster's 9 rows fail. Streamed, an inventory
        # without a streaming API arrives as ONE batch, which both packages
        # fetch from its first object's cluster source (ROADMAP Queue 3).
        assert runner.stats["failed_rows"] == (0 if depth else 9)

    @pytest.mark.parametrize("fmt", ["sharded", "legacy"])
    @pytest.mark.parametrize("window", ["resident", "streamed"])
    def test_state_path_renders_jax_bytes_over_two_runs(self, fleet, tmp_path, window, fmt):
        """Two consecutive ``state_path`` scans into one state per package:
        each run's render equals the JAX ``Runner``'s; the second folds the
        same window again, so every count doubles; the two stores agree but
        for one-bucket moves of edge samples."""
        jax_objs, dumps, histories = fleet
        if window == "streamed":
            fleet = (jax_objs, dumps, long_histories(histories))
        extra = {"host_stream_mb": 1} if window == "streamed" else {}
        suffix = ".npz" if fmt == "legacy" else ""
        paths = {name: str(tmp_path / f"{name}{suffix}") for name in PKGS}
        appended = 0
        for run in range(2):
            jax = run_jax(fleet, {"state_path": paths["jax"], "store_format": fmt, "use_mesh": False, **extra},
                          format="json")
            port, runner = run_port(fleet, {"state_path": paths["port"], "store_format": fmt, **extra},
                                    format="json")
            assert port.format("json") == jax.format("json"), f"run {run}"
            strategy = runner.session.strategy
            assert scan_stages(runner) == [("pack", None), ("digest", None), ("fold", None), ("quantile", "store"),
                                           ("persist", None), ("round", None)]
            assert (strategy.stream_stats is not None) == (window == "streamed")
            stats = strategy.store_stats
            assert stats["folded_rows"] == len(dumps) and stats["rows"] == len(dumps)
            assert stats["epoch"] == (run + 1 if fmt == "sharded" else 0)
            assert stats["wal_appends"] == (1 if fmt == "sharded" else 0)
            appended += stats["wal_appended_bytes"]
            if fmt == "sharded":  # no compaction at this size: the header and every record
                assert stats["wal_bytes"] == 8 + appended
            if run == 0:
                first = open_store(paths["port"], fmt, "port")
        jax_store = open_store(paths["jax"], fmt, "jax")
        port_store = open_store(paths["port"], fmt, "port")
        assert port_store.keys == jax_store.keys == first.keys
        np.testing.assert_array_equal(port_store.cpu_counts, 2 * first.cpu_counts)
        for f in ("cpu_total", "cpu_peak", "mem_total", "mem_peak"):
            np.testing.assert_array_equal(getattr(port_store, f), getattr(jax_store, f), err_msg=f)
        moved, wider = bucket_moves(port_store.cpu_counts, jax_store.cpu_counts)
        assert wider == 0
        assert moved <= 0.001 * port_store.cpu_total.sum()

    def test_streamed_state_equals_resident_state(self, fleet, tmp_path):
        jax_objs, dumps, histories = fleet
        long_fleet = (jax_objs, dumps, long_histories(histories))
        stores = {}
        for window, extra in (("resident", {}), ("streamed", {"host_stream_mb": 1})):
            path = str(tmp_path / window)
            _port, runner = run_port(long_fleet, {"state_path": path, **extra}, format="json")
            assert (runner.session.strategy.stream_stats is not None) == (window == "streamed")
            stores[window] = open_store(path, "sharded", "port")
        for f in ("cpu_counts", "cpu_total", "cpu_peak", "mem_total", "mem_peak"):
            np.testing.assert_array_equal(getattr(stores["streamed"], f), getattr(stores["resident"], f), err_msg=f)

    def test_state_begun_by_one_package_continues_in_the_other(self, fleet, tmp_path):
        """JAX writes the first run, the port the second, JAX the third —
        each render equals an all-JAX control's."""
        control = str(tmp_path / "control")
        mixed = str(tmp_path / "mixed")
        for run, who in enumerate(("jax", "port", "jax")):
            want = run_jax(fleet, {"state_path": control, "use_mesh": False}, format="json")
            if who == "jax":
                got = run_jax(fleet, {"state_path": mixed, "use_mesh": False}, format="json")
            else:
                got, _runner = run_port(fleet, {"state_path": mixed}, format="json")
            assert got.format("json") == want.format("json"), f"run {run}"
        final = open_store(mixed, "sharded", "jax")
        reference = open_store(control, "sharded", "jax")
        assert final.keys == reference.keys
        np.testing.assert_array_equal(final.cpu_total, reference.cpu_total)
        np.testing.assert_array_equal(final.mem_peak, reference.mem_peak)
        moved, wider = bucket_moves(final.cpu_counts, reference.cpu_counts)
        assert wider == 0


@pytest.fixture(scope="module")
def ns_env(tmp_path_factory):
    """A multi-namespace fake: the real loaders stream discovery and fetch
    per namespace batch."""
    cluster = FakeCluster()
    metrics = FakeMetrics()
    metrics.enforce_range = True
    rng = np.random.default_rng(42)
    for namespace, workloads in {"default": ["web", "api"], "prod": ["db"], "batch": ["etl", "cron"]}.items():
        for name in workloads:
            for pod in cluster.add_workload_with_pods("Deployment", name, namespace, pod_count=2):
                metrics.set_series(namespace, "main", pod, cpu=rng.gamma(2.0, 0.05, 120),
                                   memory=rng.uniform(5e7, 2e8, 120))
    server = ServerThread(FakeBackend(cluster, metrics)).start()
    kubeconfig = tmp_path_factory.mktemp("ingest") / "config"
    kubeconfig.write_text(yaml.dump({
        "current-context": "fake",
        "contexts": [{"name": "fake", "context": {"cluster": "fake", "user": "u"}}],
        "clusters": [{"name": "fake", "cluster": {"server": server.url}}],
        "users": [{"name": "u", "user": {"token": "t"}}],
    }))
    yield {"url": server.url, "kubeconfig": str(kubeconfig), "end": FakeBackend.SERIES_ORIGIN + 3600.0}
    server.stop()


@pytest.mark.parametrize("depth", [4, 1, 0])
def test_real_loaders_streamed_scan_equals_jax(ns_env, depth, capsys):
    """The real Kubernetes and Prometheus loaders through ``Runner.run``:
    streamed (discovery, fetch and fold overlapped) or staged, the port's
    render equals the JAX package's."""
    renders = {}
    for name, pkg in PKGS.items():
        other_args = {"history_duration": 1, "timeframe_duration": 1, "digest_ingest": True}
        if name == "port":
            other_args["device"] = "cpu"
        config = pkg.Config(
            kubeconfig=ns_env["kubeconfig"], prometheus_url=ns_env["url"], strategy="tdigest", quiet=True,
            format="json", scan_end_timestamp=ns_env["end"], pipeline_depth=depth, other_args=other_args,
        )
        runner = pkg.Runner(config)

        async def run():
            try:
                return await runner.run()
            finally:
                await runner.session.close()

        renders[name] = asyncio.run(run()).format("json")
        capsys.readouterr()
        if depth:
            assert runner.stats["pipeline_batches"] >= 3
        assert runner.stats["objects"] == 5.0
    assert renders["port"] == renders["jax"]
