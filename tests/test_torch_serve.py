"""The port's ``serve`` plane against the JAX package's, on the same fakes.

A JAX ``KrrServer`` and a port ``KrrServer(device="cpu")`` run side by side
in one process, each with its own state directory, against one fake
apiserver + Prometheus (`tests/fakes/servers.py`, ranged slicing on) under
one injected clock. Each tick is driven by hand on both (``run_once``), and
then the same requests go to both HTTP listeners over raw sockets: the
responses must be byte for byte equal — status line, headers (ETag,
Last-Modified, X-KRR-Epoch, Content-Encoding) and body — on every route.

Fields that carry a measured wall time are the only ones left out, each by
name: ``/healthz`` ``uptime_seconds`` and the scan id (``last_scan_id``,
stamped from the wall clock and a process counter); the sentinel's medians
and bands; the
timeline records' seconds fields; the SLO latency objective's
``last_value``; the timing series of ``/metrics``. The snapshot's
``published_at`` (the ETag's millisecond stamp) reads ``time.time()`` in the
scheduler modules of both packages; the tests pin that clock to the
injected one, so the ETags compare exactly too. ``np.savez`` stamps zip
entries with the wall clock, so ``zipfile``'s clock is pinned as in
``tests/test_torch_store.py`` before the state files are compared.
"""

from __future__ import annotations

import asyncio
import gzip
import json
import os
import time
import types
import zipfile

import numpy as np
import pytest
import yaml

import krr_tpu.server.app as jax_app
import krr_tpu.server.scheduler as jax_scheduler
import krr_tpu_torch.server.app as port_app
import krr_tpu_torch.server.scheduler as port_scheduler
from krr_tpu.core.config import Config as JaxConfig
from krr_tpu.core.runner import ScanSession as JaxSession
from krr_tpu.models.allocations import ResourceAllocations as JaxAllocations
from krr_tpu.models.allocations import ResourceType as JaxResourceType
from krr_tpu.models.objects import K8sObjectData as JaxObject
from krr_tpu.obs.metrics import histogram_quantile as jax_histogram_quantile
from krr_tpu_torch.core.config import Config as PortConfig
from krr_tpu_torch.core.runner import ScanSession as PortSession
from krr_tpu_torch.models.allocations import ResourceAllocations as PortAllocations
from krr_tpu_torch.models.allocations import ResourceType as PortResourceType
from krr_tpu_torch.models.objects import K8sObjectData as PortObject
from krr_tpu_torch.obs.metrics import MetricsRegistry as PortRegistry
from krr_tpu_torch.obs.metrics import histogram_quantile as port_histogram_quantile
from krr_tpu_torch.obs.trace import Tracer as PortTracer

from .fakes.servers import FakeBackend, FakeCluster, FakeMetrics, ServerThread

ORIGIN = FakeBackend.SERIES_ORIGIN
STEP = 60.0
#: First tick: a full 1 h window [ORIGIN, T1] of the fake's 3 h of series.
T1 = ORIGIN + 3600.0

#: Timeline record fields that carry a measured wall time (the scan id too:
#: the tracer stamps it from the wall clock and a process counter), as
#: top-level keys and as keys of the nested blocks. The AIMD in-flight limit
#: follows measured TTFB; the appended WAL bytes follow the length of the
#: fetch planner's measured telemetry in the record (`without_plan_telemetry`).
TIMELINE_TIMING_FIELDS = {"scan_id", "wall", "categories", "phases"}
TIMELINE_NESTED_TIMING = {"persist": ("seconds", "bytes"), "readpath": ("p99_ms",), "plan": ("inflight_limit",)}
#: /metrics series that carry measured time or follow the host's timing, or
#: that name the package (``krr_tpu_build_info`` labels the jax/torch version
#: and backend).
METRIC_TIMING = (
    "krr_tpu_scan_duration_seconds", "krr_tpu_http_request_seconds",
    "krr_tpu_store_recovery_seconds", "krr_tpu_prom_query_seconds",
    "krr_tpu_prom_phase_seconds", "krr_tpu_scan_pipeline_seconds",
    "krr_tpu_scan_pipeline_wait_seconds", "krr_tpu_scan_overlap_pct",
    "krr_tpu_eval_replay_seconds", "krr_tpu_http_read_p99_seconds",
    "krr_tpu_process_", "krr_tpu_build_info", "krr_tpu_prom_retry_backoff_seconds",
    "krr_tpu_scan_pipeline_queue_depth", "krr_tpu_prom_inflight",
    "krr_tpu_compile_", "krr_tpu_device_memory_bytes",
    # The timeline file's size follows the printed length of its records'
    # measured seconds, the WAL's the length of the planner telemetry in its
    # records; keep-alive reuse follows the sockets' timing.
    "krr_tpu_timeline_bytes", "krr_tpu_store_wal_bytes", "krr_tpu_prom_connections_",
)


# ------------------------------------------------------------------ fixtures
@pytest.fixture(scope="module")
def serve_env(tmp_path_factory):
    """Three namespaces on the fake's 60 s grid, sliced to [start, end]."""
    cluster = FakeCluster()
    metrics = FakeMetrics()
    metrics.enforce_range = True
    rng = np.random.default_rng(99)
    shapes = (("web", "default", 2, 0.05), ("db", "prod", 1, 0.2), ("api", "staging", 1, 0.1))
    for name, namespace, pods, scale in shapes:
        kind = "StatefulSet" if name == "db" else "Deployment"
        for pod in cluster.add_workload_with_pods(kind, name, namespace, pod_count=pods):
            metrics.set_series(namespace, "main", pod,
                               cpu=rng.gamma(2.0, scale, 180), memory=rng.uniform(5e7, 4e8, 180))
    server = ServerThread(FakeBackend(cluster, metrics)).start()
    kubeconfig = tmp_path_factory.mktemp("serve") / "config"
    kubeconfig.write_text(yaml.dump({
        "current-context": "fake",
        "contexts": [{"name": "fake", "context": {"cluster": "fake", "user": "fake"}}],
        "clusters": [{"name": "fake", "cluster": {"server": server.url}}],
        "users": [{"name": "fake", "user": {"token": "t"}}],
    }))
    yield {"server": server, "cluster": cluster, "metrics": metrics, "kubeconfig": str(kubeconfig), "rng": rng}
    server.stop()


@pytest.fixture
def pinned(monkeypatch):
    """The injected clock, also read by both schedulers' ``time.time()``
    (the snapshot's ``published_at``) and by ``zipfile``."""
    now = [T1]
    for module in (jax_scheduler, port_scheduler):
        monkeypatch.setattr(module, "time", types.SimpleNamespace(
            time=lambda: now[0], perf_counter=time.perf_counter, monotonic=time.monotonic,
        ))
    monkeypatch.setattr(zipfile, "time", types.SimpleNamespace(
        time=lambda: 1_700_000_000.0, localtime=time.localtime,
    ))
    return now


def serve_settings(env, **overrides) -> dict:
    other_args = {"history_duration": 1, "timeframe_duration": 1}
    other_args.update(overrides.pop("other_args", {}))
    settings = dict(
        kubeconfig=env["kubeconfig"],
        prometheus_url=env["server"].url,
        strategy="tdigest",
        quiet=True,
        server_port=0,
        prometheus_breaker_cooldown_seconds=0.02,
        prometheus_breaker_threshold=100,
        prometheus_backoff_cap_seconds=0.01,
        prometheus_retry_deadline_seconds=0.2,
        discovery_interval_seconds=60.0,
        other_args=other_args,
    )
    settings.update(overrides)
    return settings


class Pair:
    """One JAX and one port server on the same settings and clock."""

    def __init__(self, env, tmp_path, now, *, state: bool = True, sessions=None, **overrides):
        self.now = now
        settings = serve_settings(env, **overrides) if env is not None else overrides
        self.dirs = {}
        servers = []
        for name, config_type, app_module in (("jax", JaxConfig, jax_app), ("port", PortConfig, port_app)):
            mine = json.loads(json.dumps(settings))
            mine.setdefault("other_args", {})
            if state:
                root = tmp_path / name
                root.mkdir(exist_ok=True)
                self.dirs[name] = root
                mine["other_args"]["state_path"] = str(root / "state")
            if name == "port":
                mine["other_args"]["device"] = "cpu"
            config = config_type(**mine)
            session = sessions[name](config) if sessions is not None else None
            servers.append(app_module.KrrServer(config, session=session, clock=lambda: now[0]))
        self.jax, self.port = servers

    async def start(self) -> None:
        await self.jax.start(run_scheduler=False)
        await self.port.start(run_scheduler=False)

    async def run_once(self, at: float):
        self.now[0] = at
        return await self.jax.scheduler.run_once(), await self.port.scheduler.run_once()

    async def get(self, target: str, headers=None, method: str = "GET"):
        return (
            await raw_request(self.jax.port, target, headers, method),
            await raw_request(self.port.port, target, headers, method),
        )

    async def shutdown(self) -> None:
        await self.jax.shutdown()
        await self.port.shutdown()


async def raw_request(port: int, target: str, headers=None, method: str = "GET") -> dict:
    """One HTTP/1.1 request over a fresh socket; the raw response bytes plus
    the parsed status, headers and body."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    lines = [f"{method} {target} HTTP/1.1", "Host: localhost", "Connection: close"]
    lines += [f"{name}: {value}" for name, value in (headers or {}).items()]
    writer.write(("\r\n".join(lines) + "\r\n\r\n").encode("latin-1"))
    await writer.drain()
    data = await reader.read()
    writer.close()
    await writer.wait_closed()
    head, _, body = data.partition(b"\r\n\r\n")
    head_lines = head.decode("latin-1").split("\r\n")
    return {
        "raw": data,
        "status": int(head_lines[0].split()[1]),
        "headers": dict(line.split(": ", 1) for line in head_lines[1:]),
        "body": body,
    }


def statusz_comparable(payload: dict) -> dict:
    """/statusz minus the measured fields: the scan-latency objective's last
    value, the sentinel's medians and bands, and its last verdict's scan id
    and category deviations."""
    payload = json.loads(json.dumps(payload))
    for objective in payload.get("objectives", []):
        if objective["name"] == "scan_latency":
            objective.pop("last_value", None)
    trend = payload.get("trend")
    if trend is not None:
        for baseline in trend["baselines"].values():
            for band in baseline["series"].values():
                band.pop("median")
                band.pop("band")
        if trend["last_verdict"] is not None:
            # The scan id, and the verdict's per-category deviations of
            # measured seconds.
            trend["last_verdict"].pop("scan_id")
            trend["last_verdict"].pop("categories")
    return payload


def healthz_comparable(body: bytes) -> dict:
    payload = json.loads(body)
    payload.pop("uptime_seconds")
    payload.pop("last_scan_id")
    return payload


#: Routes whose bodies carry measured fields, so the bytes served differ.
TIMED_ROUTES = ('"/healthz"', '"/statusz"', '"/metrics"', '"/debug/timeline"')


def series_of(text: str) -> dict:
    """``series line → value`` for every non-timing sample of an exposition."""
    out = {}
    for line in text.splitlines():
        if not line or line.startswith("#") or line.startswith(METRIC_TIMING):
            continue
        if line.startswith("krr_tpu_http_response_bytes_total") and any(r in line for r in TIMED_ROUTES):
            continue
        name, _, value = line.rpartition(" ")
        out[name] = float(value)
    return out


def timeline_comparable(records: list) -> list:
    out = []
    for record in records:
        record = {k: v for k, v in record.items() if k not in TIMELINE_TIMING_FIELDS}
        for block, fields in TIMELINE_NESTED_TIMING.items():
            if block in record:
                record[block] = {k: v for k, v in record[block].items() if k not in fields}
        out.append(record)
    return out


def wal_records(blob: bytes) -> list:
    """The decoded records of a durable-store WAL: ``(meta, ops)`` each."""
    from krr_tpu_torch.core.durastore import FRAME, WAL_MAGIC, decode_ops

    assert blob.startswith(WAL_MAGIC)
    records, offset = [], len(WAL_MAGIC)
    while offset < len(blob):
        length, _crc = FRAME.unpack_from(blob, offset)
        offset += FRAME.size
        records.append(decode_ops(blob[offset : offset + length]))
        offset += length
    return records


def without_plan_telemetry(meta: dict) -> dict:
    """Store metadata minus ``serve_fetch_plan``: the fetch planner's
    per-namespace EWMA of each query's wire bytes, folded in the order the
    concurrent queries complete — measured, and not the same from one run
    of either package to the next."""
    meta = json.loads(json.dumps(meta))
    meta.get("extra", {}).pop("serve_fetch_plan", None)
    return meta


def assert_same_state(jax_root, port_root) -> None:
    """The journal, its key sidecar, the base shards and the manifest byte
    for byte; the WAL record for record (ops exactly, metadata without the
    planner telemetry)."""
    jax_files, port_files = tree(jax_root), tree(port_root)
    assert sorted(port_files) == sorted(jax_files)
    assert {"state.journal", "state.journal.keys.json", "state/MANIFEST.json"} <= set(port_files)
    for name, blob in jax_files.items():
        if name.startswith("state/wal-"):
            jax_wal, port_wal = wal_records(blob), wal_records(port_files[name])
            assert len(port_wal) == len(jax_wal) > 0
            for (jax_meta, jax_ops), (port_meta, port_ops) in zip(jax_wal, port_wal):
                assert without_plan_telemetry(port_meta) == without_plan_telemetry(jax_meta)
                assert len(port_ops) == len(jax_ops)
                for jax_op, port_op in zip(jax_ops, port_ops):
                    assert port_op[0] == jax_op[0] and len(port_op) == len(jax_op)
                    for a, b in zip(jax_op[1:], port_op[1:]):
                        if isinstance(a, np.ndarray):
                            assert a.dtype == b.dtype and np.array_equal(a, b)
                        else:
                            assert a == b
        elif name == "state/MANIFEST.json":
            assert without_plan_telemetry(json.loads(port_files[name])) == without_plan_telemetry(json.loads(blob))
        else:
            assert port_files[name] == blob, name


def tree(root) -> dict:
    """``relative path → bytes`` of every file under ``root`` but the flight
    recorder (its records carry measured seconds) and lock files."""
    out = {}
    for dirpath, _dirs, names in os.walk(root):
        for name in names:
            if name == "timeline.log" or name.endswith(".lock"):
                continue
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


#: The /recommendations variants compared on every tick: formats, filters,
#: pages, encodings.
RECOMMENDATION_TARGETS = (
    ("/recommendations", None),
    ("/recommendations?format=yaml", None),
    ("/recommendations?format=pprint", None),
    ("/recommendations", {"Accept-Encoding": "gzip"}),
    ("/recommendations?format=yaml", {"Accept-Encoding": "gzip, deflate"}),
    ("/recommendations?namespace=default", None),
    ("/recommendations?namespace=prod&namespace=staging", None),
    ("/recommendations?workload=web&container=main", None),
    ("/recommendations?limit=1&offset=1", None),
    ("/recommendations?limit=2&format=yaml", {"Accept-Encoding": "gzip"}),
    ("/recommendations?offset=5", None),
    # zstd when a zstd module is importable (both packages), else gzip.
    ("/recommendations?format=pprint", {"Accept-Encoding": "zstd, gzip"}),
    ("/recommendations?namespace=default", {"Accept-Encoding": "gzip;q=0, identity"}),
)


async def assert_served_equal(pair: Pair) -> None:
    """Every read route of both servers, compared."""
    for target, headers in RECOMMENDATION_TARGETS:
        jax_r, port_r = await pair.get(target, headers)
        assert port_r["raw"] == jax_r["raw"], target
        assert port_r["status"] == 200
        encoding = port_r["headers"].get("Content-Encoding")
        if encoding is not None:
            jax_identity, port_identity = await pair.get(target)
            assert port_identity["raw"] == jax_identity["raw"]
            decoded = (
                gzip.decompress(port_r["body"]) if encoding == "gzip"
                else port_app._ZSTD_FACTORY and __import__("zstandard").ZstdDecompressor().decompress(port_r["body"])
            )
            assert decoded == port_identity["body"]
    # Conditional GETs and HEAD carry the same validators and no body.
    jax_r, port_r = await pair.get("/recommendations")
    etag = port_r["headers"]["ETag"]
    for headers in ({"If-None-Match": etag}, {"If-None-Match": f"W/{etag}"},
                    {"If-Modified-Since": port_r["headers"]["Last-Modified"]}):
        jax_304, port_304 = await pair.get("/recommendations", headers)
        assert port_304["raw"] == jax_304["raw"]
        assert port_304["status"] == 304 and port_304["body"] == b""
    jax_h, port_h = await pair.get("/recommendations?format=yaml", method="HEAD")
    assert port_h["raw"] == jax_h["raw"] and port_h["body"] == b""
    for target in ("/history", "/history?namespace=prod&limit=2", "/history?workload=web", "/drift"):
        jax_r, port_r = await pair.get(target)
        assert port_r["raw"] == jax_r["raw"], target
        jax_304, port_304 = await pair.get(target, {"If-None-Match": port_r["headers"]["ETag"]})
        assert port_304["raw"] == jax_304["raw"] and port_304["status"] == 304
    jax_r, port_r = await pair.get("/healthz")
    assert port_r["status"] == jax_r["status"]
    assert healthz_comparable(port_r["body"]) == healthz_comparable(jax_r["body"])
    jax_r, port_r = await pair.get("/statusz")
    assert port_r["status"] == jax_r["status"] == 200
    assert statusz_comparable(json.loads(port_r["body"])) == statusz_comparable(json.loads(jax_r["body"]))
    jax_r, port_r = await pair.get("/metrics")
    jax_series, port_series = series_of(jax_r["body"].decode()), series_of(port_r["body"].decode())
    assert port_series == jax_series
    jax_r, port_r = await pair.get("/debug/timeline")
    jax_t, port_t = json.loads(jax_r["body"]), json.loads(port_r["body"])
    assert timeline_comparable(port_t["records"]) == timeline_comparable(jax_t["records"])


# ------------------------------------------------------------ the equality run
class TestAgainstJax:
    def test_ticks_serve_equal_bytes_and_files(self, serve_env, tmp_path, pinned):
        """Full, delta, degraded, catch-up and churn ticks: every route and
        every state file equal between the packages after each tick."""
        env = serve_env

        async def main():
            pair = Pair(env, tmp_path, pinned)
            await pair.start()
            try:
                jax_r, port_r = await pair.get("/recommendations")
                assert port_r["raw"] == jax_r["raw"] and port_r["status"] == 503
                assert await pair.run_once(T1) == (True, True)  # full
                await assert_served_equal(pair)
                assert await pair.run_once(T1 + 1800.0) == (True, True)  # delta
                await assert_served_equal(pair)
                env["metrics"].fail_namespaces = frozenset({"prod"})
                try:
                    assert await pair.run_once(T1 + 2400.0) == (True, True)  # degraded
                finally:
                    env["metrics"].fail_namespaces = frozenset()
                assert pair.port.state.stale_workloads
                await assert_served_equal(pair)
                assert await pair.run_once(T1 + 3000.0) == (True, True)  # catch-up
                assert not pair.port.state.stale_workloads
                await assert_served_equal(pair)
                pods = env["cluster"].add_workload_with_pods("Deployment", "late", "batch", pod_count=1)
                for pod in pods:
                    env["metrics"].set_series("batch", "main", pod,
                                              cpu=env["rng"].gamma(2.0, 0.1, 180),
                                              memory=env["rng"].uniform(5e7, 4e8, 180))
                try:
                    assert await pair.run_once(T1 + 3600.0) == (True, True)  # churn
                    await assert_served_equal(pair)
                    assert await pair.run_once(T1 + 3610.0) == (False, False)  # skipped
                finally:
                    env["cluster"].delete_workload("Deployment", "late", "batch")
                await assert_served_equal(pair)
            finally:
                await pair.shutdown()
            assert_same_state(pair.dirs["jax"], pair.dirs["port"])

        asyncio.run(main())


class TestRequestsAgainstJax:
    def test_bad_parameters_and_unknown_routes_answer_the_same(self, serve_env, tmp_path, pinned):
        """The 400s of bad ``?n=``/``limit``/``offset``/``format``, the 404s
        (``/fleet`` on a non-aggregator included) and the 405 of a POST."""
        targets = (
            "/debug/trace?n=x", "/debug/trace?n=-1", "/debug/profile?n=1.5",
            "/debug/profile?format=bogus", "/debug/timeline?n=-3", "/debug/timeline?format=html",
            "/recommendations?limit=x", "/recommendations?offset=-1", "/recommendations?format=csv",
            "/history?limit=-2", "/statusz?format=xml", "/fleet", "/fleet?format=text", "/nope",
        )

        async def main():
            pair = Pair(serve_env, tmp_path, pinned, state=False)
            await pair.start()
            try:
                assert await pair.run_once(T1) == (True, True)
                for target in targets:
                    jax_r, port_r = await pair.get(target)
                    assert port_r["raw"] == jax_r["raw"], target
                    assert port_r["status"] in (400, 404), target
                jax_r, port_r = await pair.get("/recommendations", method="POST")
                assert port_r["raw"] == jax_r["raw"] and port_r["status"] == 405
            finally:
                await pair.shutdown()

        asyncio.run(main())

    def test_saturated_render_pool_sheds_the_same_503(self, serve_env, tmp_path, pinned):
        async def main():
            pair = Pair(serve_env, tmp_path, pinned, state=False, server_render_concurrency=1,
                        server_render_queue=0, response_cache_enabled=False)
            await pair.start()
            try:
                assert await pair.run_once(T1) == (True, True)
                pools = (pair.jax.app.render_pool, pair.port.app.render_pool)
                for pool in pools:
                    await pool._semaphore.acquire()  # a render is "in flight"
                try:
                    for target in ("/recommendations?namespace=prod", "/history", "/drift"):
                        jax_r, port_r = await pair.get(target)
                        assert port_r["raw"] == jax_r["raw"] and port_r["status"] == 503, target
                    jax_r, port_r = await pair.get("/recommendations")  # the fast path
                    assert port_r["raw"] == jax_r["raw"] and port_r["status"] == 200
                finally:
                    for pool in pools:
                        pool._semaphore.release()
                assert pair.port.state.metrics.value("krr_tpu_http_renders_shed_total") == 3
            finally:
                await pair.shutdown()

        asyncio.run(main())

    @pytest.mark.parametrize("zstd", [True, False], ids=["zstd", "no-zstd"])
    def test_negotiate_encoding_matches_jax(self, monkeypatch, zstd):
        """With and without an importable zstd module (the card's machine
        has none)."""
        if zstd:
            pytest.importorskip("zstandard")
        else:
            for module in (jax_app, port_app):
                monkeypatch.setattr(module, "_ZSTD_FACTORY", None)
                monkeypatch.setattr(module, "SUPPORTED_ENCODINGS", ("gzip",))
        headers = (
            "", "gzip", "zstd", "zstd, gzip", "br", "*", "*;q=0", "gzip;q=0", "gzip;q=0, *",
            "identity", "GZIP , Zstd", "zstd;q=0, gzip;q=0.5", "gzip;q=x", " , gzip",
        )
        for header in headers:
            assert port_app.negotiate_encoding(header) == jax_app.negotiate_encoding(header), header
        body = b'{"scans": []}\n' * 50
        for encoding in port_app.SUPPORTED_ENCODINGS + ("identity",):
            assert port_app.encode_body(body, encoding) == jax_app.encode_body(body, encoding)


# ----------------------------------------------------------- the port alone
class TestPortServe:
    def test_incremental_fold_matches_cold_full_scan(self, serve_env):
        """The JAX acceptance test on the port (``--no-hysteresis``): a delta
        tick folded onto a full one serves the bytes of a cold scan over the
        union window, with bit-equal store arrays, and fetched only the
        delta."""
        T2 = T1 + 1800.0

        def server(now, **overrides):
            settings = serve_settings(serve_env, hysteresis_enabled=False, **overrides)
            settings["other_args"]["device"] = "cpu"
            return port_app.KrrServer(PortConfig(**settings), clock=lambda: now[0])

        async def main():
            now = [T1]
            incremental = server(now)
            await incremental.start(run_scheduler=False)
            cold = server([T2], other_args={"history_duration": 1.5})
            await cold.start(run_scheduler=False)
            try:
                assert await incremental.scheduler.tick()
                now[0] = T2
                assert await incremental.scheduler.tick()
                assert await cold.scheduler.tick()
                live = await raw_request(incremental.port, "/recommendations")
                control = await raw_request(cold.port, "/recommendations")
                assert live["body"] == control["body"]
                a, b = incremental.state.store, cold.state.store
                assert a.keys == b.keys and len(a.keys) == 3
                for field in ("cpu_counts", "cpu_total", "cpu_peak", "mem_total", "mem_peak"):
                    assert np.array_equal(getattr(a, field), getattr(b, field)), field
                m = incremental.state.metrics
                assert m.value("krr_tpu_scans_total", kind="full") == 1
                assert m.value("krr_tpu_scans_total", kind="delta") == 1
                assert m.value("krr_tpu_fetch_window_seconds_total", kind="delta") == T2 - T1 - STEP
                assert m.value("krr_tpu_fetch_window_seconds_total", kind="full") == 3600.0
                assert cold.state.metrics.value("krr_tpu_fetch_window_seconds_total", kind="full") == 5400.0
            finally:
                await incremental.shutdown()
                await cold.shutdown()

        asyncio.run(main())

    def test_skipped_ticks_stay_out_of_the_trace_ring(self, serve_env):
        """``Tracer.discard``: a tick with no new grid point leaves the ring
        as it was, and the node identity stamps the export."""
        async def main():
            now = [T1]
            settings = serve_settings(serve_env)
            settings["other_args"]["device"] = "cpu"
            ks = port_app.KrrServer(PortConfig(**settings), clock=lambda: now[0])
            await ks.start(run_scheduler=False)
            try:
                tracer = ks.session.tracer
                assert tracer.enabled and tracer.node == "serve"
                assert await ks.scheduler.tick()
                ring = [spans[0].trace_id for spans in tracer.traces()]
                now[0] += 10.0
                assert not await ks.scheduler.tick()
                assert [spans[0].trace_id for spans in tracer.traces()] == ring == [ks.state.last_scan_id]
                assert ks.state.metrics.value("krr_tpu_scans_skipped_total") == 1
                export = tracer.export_chrome()
                names = [e["args"]["name"] for e in export["traceEvents"] if e["ph"] == "M"]
                assert names == [f"serve:{ring[0]}"]
                assert all(e["args"]["node"] == "serve" for e in export["traceEvents"] if e["ph"] == "X")
            finally:
                await ks.shutdown()

        asyncio.run(main())

    def test_discard_drops_traces_as_jax_does(self):
        """Discarding a ringed trace, an open one, and None: the ring keeps
        the same traces in both packages."""
        from krr_tpu.obs.trace import Tracer as JaxTracer

        rings = []
        for tracer_type in (JaxTracer, PortTracer):
            tracer = tracer_type(ring_scans=4)
            for name in ("a", "b"):
                with tracer.span("scan", scan_id=name):
                    with tracer.span("fetch"):
                        pass
            with tracer.span("scan", scan_id="c"):
                tracer.discard("c")
                with tracer.span("fetch"):
                    pass
            tracer.discard("a")
            tracer.discard(None)
            rings.append([[span.name for span in spans] + [spans[0].trace_id] for spans in tracer.traces()])
        assert rings[1] == rings[0]
        assert ["fetch", "scan", "b"] in rings[1] and all(ring[-1] != "a" for ring in rings[1])


@pytest.mark.parametrize("q", [0.0, 0.5, 0.9, 0.99, 1.0])
def test_histogram_quantile_matches_jax(q):
    tables = [
        [],
        [(0.1, 0.0), (float("inf"), 0.0)],
        [(0.005, 1.0), (0.01, 3.0), (0.025, 3.0), (0.1, 10.0), (float("inf"), 10.0)],
        [(0.5, 2.0), (1.0, 2.0), (float("inf"), 7.0)],
        [(1.0, 5.0), (float("inf"), 5.0)],
    ]
    registry = PortRegistry()
    for value in (0.004, 0.02, 0.3, 0.3, 7.0, 70.0):
        registry.observe("krr_tpu_http_request_seconds", value, route="/recommendations")
    tables.append(registry.histogram_buckets("krr_tpu_http_request_seconds", route="/recommendations"))
    assert registry.histogram_buckets("krr_tpu_http_request_seconds", route="/metrics") is None
    for pairs in tables:
        assert port_histogram_quantile(pairs, q) == jax_histogram_quantile(pairs, q), pairs


# ------------------------------------------------- hysteresis and restarts
class _NoisySource:
    """A noisy-but-stationary injected history source (the JAX
    ``tests/test_server.py`` one): fresh samples from a seeded rng inside a
    narrow band, times ``scale`` (bump it for a regime change)."""

    def __init__(self, resource_type):
        self.resource_type = resource_type
        self.scale = 1.0
        self._rng = np.random.default_rng(42)

    async def gather_fleet(self, objects, history_seconds, step_seconds, **kwargs):
        cpu, memory = self.resource_type.CPU, self.resource_type.Memory
        return {
            cpu: [{obj.pods[0]: self.scale * self._rng.uniform(0.19, 0.21, 12)} for obj in objects],
            memory: [{obj.pods[0]: np.full(12, 1e8)} for obj in objects],
        }


class _Inventory:
    def __init__(self, objects):
        self.objects = objects

    async def list_clusters(self):
        return ["c"]

    async def list_scannable_objects(self, clusters):
        return list(self.objects)


def _objects(object_type, allocations_type, resource_type) -> list:
    none = {resource_type.CPU: None, resource_type.Memory: None}
    return [
        object_type(
            cluster="c", namespace=namespace, name=name, kind="Deployment", container="main",
            pods=[f"{name}-0"], allocations=allocations_type(requests=dict(none), limits=dict(none)),
        )
        for name, namespace in (("web", "default"), ("db", "prod"))
    ]


class TestHysteresisAgainstJax:
    def test_noisy_source_publishes_the_same_series(self, tmp_path, pinned):
        """The gate on: a stationary wiggle publishes nothing new, a regime
        change publishes after the confirmation ticks — the same snapshots,
        suppressed counts, journal, /history and /drift in both packages."""
        packages = {
            "jax": (JaxSession, JaxObject, JaxAllocations, JaxResourceType),
            "port": (PortSession, PortObject, PortAllocations, PortResourceType),
        }
        sources = {name: _NoisySource(pkg[3]) for name, pkg in packages.items()}

        def session_for(name):
            session_type, object_type, allocations_type, resource_type = packages[name]
            return lambda config: session_type(
                config,
                inventory=_Inventory(_objects(object_type, allocations_type, resource_type)),
                history_factory=lambda cluster: sources[name],
            )

        async def main():
            pinned[0] = 1_700_000_000.0
            pair = Pair(
                None, tmp_path, pinned, strategy="tdigest", quiet=True, server_port=0,
                other_args={"history_duration": 1, "timeframe_duration": 1},
                sessions={name: session_for(name) for name in packages},
            )
            await pair.start()
            try:
                published = []
                for tick in range(9):
                    if tick == 5:
                        for source in sources.values():
                            source.scale = 1.6  # the regime change
                    assert await pair.run_once(pinned[0] + (120.0 if tick else 0.0)) == (True, True)
                    await assert_served_equal(pair)
                    jax_r, port_r = await pair.get("/recommendations")
                    published.append(port_r["body"])
                    assert pair.port.state.last_publish_suppressed == pair.jax.state.last_publish_suppressed
                    assert pair.port.state.last_publish_changed == pair.jax.state.last_publish_changed
                assert len(set(published[:6])) == 1  # the stationary wiggle never published
                assert published[-1] != published[0]  # the regime change did
                m = pair.port.state.metrics
                assert m.value("krr_tpu_hysteresis_suppressed_total") > 0
            finally:
                await pair.shutdown()
            assert_same_state(pair.dirs["jax"], pair.dirs["port"])

        asyncio.run(main())


class TestRestartsAcrossPackages:
    @pytest.mark.parametrize("first", ["jax", "port"])
    def test_state_begun_by_one_package_resumes_in_the_other(self, serve_env, tmp_path, pinned, first):
        """Two ticks by one package's server, then each package's server on
        a copy of that state: a restart inside one step serves the
        pre-restart bytes without fetching, and the next tick is equal."""
        import shutil

        async def main():
            origin = tmp_path / "origin"
            origin.mkdir()
            settings = serve_settings(serve_env)
            settings["other_args"]["state_path"] = str(origin / "state")
            if first == "port":
                settings["other_args"]["device"] = "cpu"
            config_type, app_module = (JaxConfig, jax_app) if first == "jax" else (PortConfig, port_app)
            ks = app_module.KrrServer(config_type(**settings), clock=lambda: pinned[0])
            await ks.start(run_scheduler=False)
            try:
                pinned[0] = T1
                assert await ks.scheduler.run_once()
                pinned[0] = T1 + 1800.0
                assert await ks.scheduler.run_once()
                before = (await raw_request(ks.port, "/recommendations"))["body"]
            finally:
                await ks.shutdown()
            for name in ("jax", "port"):
                shutil.copytree(origin, tmp_path / name)

            pair = Pair(serve_env, tmp_path, pinned)
            await pair.start()
            try:
                assert await pair.run_once(T1 + 1800.0 + 30.0) == (False, False)
                jax_r, port_r = await pair.get("/recommendations")
                assert port_r["raw"] == jax_r["raw"] and port_r["body"] == before
                assert pair.port.state.metrics.value("krr_tpu_scans_skipped_total") == 1
                assert await pair.run_once(T1 + 2400.0) == (True, True)
                await assert_served_equal(pair)
            finally:
                await pair.shutdown()
            assert_same_state(tmp_path / "jax", tmp_path / "port")

        asyncio.run(main())


def test_chip_smoke_imports_neither_jax_nor_the_jax_package():
    """``chip_smoke.py`` (its ``serve`` phase included) imports no ``jax*``
    and no ``krr_tpu.*`` module, at top level or inside a function."""
    import ast

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "chip_smoke.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    imported = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            imported.update(alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            imported.add(node.module)
    roots = {name.split(".")[0] for name in imported}
    assert not roots & {"jax", "jaxlib", "krr_tpu"}, sorted(imported)
    assert {"krr_tpu_torch.server.app", "krr_tpu_torch.core.config"} <= imported
