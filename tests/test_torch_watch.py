"""Watch discovery (``--discovery-mode watch``) of the port against the JAX package.

The contracts of ``tests/test_discovery_watch.py``, held side by side: a
JAX ``KubernetesLoader`` and the port's watch one fake apiserver
(`tests/fakes/servers.py`) at the same time, and after every rung of the
resync ladder — churn, bookmark-only progress past a compaction, a
mid-stream disconnect, a forced ``410 Gone``, a divergence behind the
watchers' backs, a warm restart from the snapshot — each watched inventory
must equal, as JSON, a fresh relist's and the other package's. Then one
serve soak in watch mode against a relist control and the JAX package's
watch server: the published ``/recommendations`` bytes are equal.

Watch delivery is asynchronous, so every test waits, with a bounded
timeout, on the condition it asserts (the inventory, the bookmark count, a
relist or a reconnect), never on a fixed sleep after which a counter is
read.
"""

from __future__ import annotations

import asyncio
import json
import time

import numpy as np
import pytest
import yaml

from krr_tpu.core.config import Config as JaxConfig
from krr_tpu.integrations.kubernetes import KubernetesLoader as JaxLoader
from krr_tpu.obs.metrics import MetricsRegistry as JaxRegistry
from krr_tpu_torch.core.config import Config as PortConfig
from krr_tpu_torch.integrations.kubernetes import ClusterLoader as PortClusterLoader
from krr_tpu_torch.integrations.kubernetes import KubernetesLoader as PortLoader
from krr_tpu_torch.obs.metrics import MetricsRegistry as PortRegistry

from .fakes.servers import KIND_ATTRS, FakeBackend, FakeCluster, FakeMetrics, ServerThread, make_workload

#: Every wait on asynchronous watch delivery gives up after this many seconds.
WAIT_SECONDS = 10.0


# ------------------------------------------------------------------ helpers
def dump(objects) -> list:
    """An inventory as JSON values: comparable across the two packages'
    model types."""
    return [obj.model_dump(mode="json") for obj in objects]


def cluster_keys(cluster: FakeCluster) -> set:
    return {
        (kind, item["metadata"]["namespace"], item["metadata"]["name"])
        for kind, attr in KIND_ATTRS.items()
        for item in getattr(cluster, attr)
        if item["metadata"]["namespace"] != "kube-system"
    }


def write_kubeconfig(path, url: str) -> str:
    path.write_text(yaml.dump({
        "current-context": "fake",
        "contexts": [{"name": "fake", "context": {"cluster": "fake", "user": "fake"}}],
        "clusters": [{"name": "fake", "cluster": {"server": url}}],
        "users": [{"name": "fake", "user": {"token": "t"}}],
    }))
    return str(path)


@pytest.fixture()
def watch_env(tmp_path):
    """A function-scoped fake cluster (each test owns its event log) with a
    few workloads across namespaces, kube-system among them."""
    cluster = FakeCluster()
    cluster.add_workload_with_pods("Deployment", "web", "apps", pod_count=2)
    cluster.add_workload_with_pods("Deployment", "worker", "apps", pod_count=1)
    cluster.add_workload_with_pods("StatefulSet", "db", "data", pod_count=2)
    cluster.add_workload_with_pods("Job", "migrate", "data", pod_count=1)
    cluster.add_workload_with_pods("DaemonSet", "kubelet-helper", "kube-system", pod_count=1)
    backend = FakeBackend(cluster, FakeMetrics())
    server = ServerThread(backend).start()
    yield {
        "cluster": cluster,
        "backend": backend,
        "kubeconfig": write_kubeconfig(tmp_path / "kubeconfig", server.url),
        "tmp_path": tmp_path,
    }
    server.stop()


class Loaders:
    """A JAX and a port watch loader on the same settings (each with its own
    metrics registry), plus the port's relist control."""

    def __init__(self, env, **overrides):
        settings = dict(kubeconfig=env["kubeconfig"], quiet=True, discovery_mode="watch", **overrides)
        self.jax_metrics, self.port_metrics = JaxRegistry(), PortRegistry()
        self.jax = JaxLoader(JaxConfig(**settings), metrics=self.jax_metrics)
        self.port = PortLoader(PortConfig(**settings), metrics=self.port_metrics)
        self.relist = PortLoader(PortConfig(kubeconfig=env["kubeconfig"], quiet=True))

    def registries(self):
        return (self.jax_metrics, self.port_metrics)

    async def listed(self) -> "tuple[list, list, list]":
        return tuple([
            dump(await loader.list_scannable_objects(["fake"]))
            for loader in (self.jax, self.port, self.relist)
        ])

    async def converge(self, timeout: float = WAIT_SECONDS) -> list:
        """Wait until both watched inventories equal a fresh relist; the
        final assert carries the difference."""
        deadline = time.monotonic() + timeout
        while True:
            jax, port, relist = await self.listed()
            if jax == relist and port == relist:
                return port
            if time.monotonic() > deadline:
                assert port == relist
                assert jax == relist
            await asyncio.sleep(0.03)

    async def close(self) -> None:
        for loader in (self.jax, self.port, self.relist):
            await loader.close()


async def wait_for(condition, what: str, timeout: float = WAIT_SECONDS) -> None:
    deadline = time.monotonic() + timeout
    while not condition():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out after {timeout} s waiting for {what}")
        await asyncio.sleep(0.02)


def value(registry, name: str, **labels) -> float:
    return registry.value(name, **labels) or 0.0


def bookmarks(registry) -> float:
    return sum(
        count
        for series, count in registry.series("krr_tpu_discovery_watch_events_total").items()
        if ("type", "bookmark") in set(series)
    )


def run(coro):
    return asyncio.run(coro)


def with_loaders(env, body, **overrides):
    async def main():
        loaders = Loaders(env, **overrides)
        try:
            return await body(loaders)
        finally:
            await loaders.close()

    return run(main())


# -------------------------------------------------------------- reconcile
class TestWatchReconcile:
    def test_cold_seed_equals_relist(self, watch_env):
        async def body(loaders):
            jax, port, relist = await loaders.listed()
            assert port == relist == jax
            assert len(port) > 0
            assert all(obj["namespace"] != "kube-system" for obj in port)

        with_loaders(watch_env, body)

    def test_churn_reconciles_bit_exact(self, watch_env):
        cluster = watch_env["cluster"]

        async def body(loaders):
            await loaders.converge()
            # Adds, an in-place update, pod churn (add/delete/relabel) and a
            # delete + recreate (which lands at the END of the relist order).
            cluster.add_workload_with_pods("Deployment", "api", "apps", pod_count=2)
            workload = cluster._find_workload("Deployment", "web", "apps")
            workload["spec"]["template"]["spec"]["containers"].append({"name": "sidecar", "resources": {}})
            cluster.update_workload("Deployment", "web", "apps")
            cluster.delete_pod("web-1", "apps")
            cluster.add_pod("web-9", "apps", {"app": "web"})
            cluster.update_pod("worker-0", "apps", {"app": "none"})  # unselects it
            cluster.delete_workload("StatefulSet", "db", "data")
            cluster.delete_pod("db-0", "data")
            cluster.delete_pod("db-1", "data")
            cluster.add_workload_with_pods("StatefulSet", "db", "data", pod_count=1)
            watched = await loaders.converge()
            names = [(o["kind"], o["name"]) for o in watched]
            assert ("Deployment", "api") in names
            worker = next(o for o in watched if o["name"] == "worker")
            assert worker["pods"] == []  # the relabel unselected its pod

        with_loaders(watch_env, body)

    def test_streamed_batches_keep_the_staged_order(self, watch_env):
        async def body(loaders):
            staged = dump(await loaders.port.list_scannable_objects(["fake"]))

            async def batches(loader):
                out = []
                async for ordinal, positions, objects in loader.stream_scannable_objects(["fake"]):
                    out.append((ordinal, list(positions), dump(objects)))
                return out

            port_batches, jax_batches = await batches(loaders.port), await batches(loaders.jax)
            assert port_batches == jax_batches
            flat = sorted(
                ((ordinal, position, obj) for ordinal, positions, objects in port_batches
                 for position, obj in zip(positions, objects)),
                key=lambda t: (t[0], t[1]),
            )
            assert [obj for _o, _p, obj in flat] == staged
            # One batch per namespace, like the relist streamed path.
            assert all(len({obj["namespace"] for obj in objects}) == 1 for _o, _p, objects in port_batches)

        with_loaders(watch_env, body)


# ---------------------------------------------------------- resync ladder
class TestResyncLadder:
    def test_bookmark_survives_compaction_without_relist(self, watch_env):
        cluster, backend = watch_env["cluster"], watch_env["backend"]

        async def body(loaders):
            await loaders.converge()
            seeds = [r.total("krr_tpu_discovery_relists_total") for r in loaders.registries()]
            # Bookmark-only progress: all 6 streams of each package (4 kinds
            # + the apps/data pod watches) relay it before it becomes the
            # compaction floor…
            cluster.bookmark()
            await wait_for(lambda: all(bookmarks(r) >= 6 for r in loaders.registries()), "6 bookmarks each")
            cluster.compact_watch()
            # …so the reconnect after a disconnect needs NO relist.
            backend.disconnect_watches()
            await wait_for(
                lambda: all(r.total("krr_tpu_discovery_watch_restarts_total") >= 1 for r in loaders.registries()),
                "a reconnect in each package",
            )
            await loaders.converge()
            for registry, seed in zip(loaders.registries(), seeds):
                assert registry.total("krr_tpu_discovery_relists_total") == seed
                assert value(registry, "krr_tpu_discovery_relists_total", reason="410") == 0

        with_loaders(watch_env, body)

    def test_disconnect_catches_up_bit_exact(self, watch_env):
        cluster, backend = watch_env["cluster"], watch_env["backend"]

        async def body(loaders):
            await loaders.converge()
            seeds = [r.total("krr_tpu_discovery_relists_total") for r in loaders.registries()]
            # A converged inventory does not mean its streams have connected:
            # a stream that connects after the disconnect has nothing to
            # drop. A bookmark relayed by all 6 streams of each package
            # proves each is connected and streaming.
            cluster.bookmark()
            await wait_for(lambda: all(bookmarks(r) >= 6 for r in loaders.registries()), "6 bookmarks each")
            backend.disconnect_watches()
            cluster.add_workload_with_pods("Deployment", "after-drop", "apps", pod_count=1)
            cluster.delete_workload("Job", "migrate", "data")
            watched = await loaders.converge()
            assert any(o["name"] == "after-drop" for o in watched)
            assert all(o["name"] != "migrate" for o in watched)
            # The dropped streams came back, by a reconnect or (after
            # repeated failures) a relist of the stream; never a 410. The
            # catch-up can land before a stream's reconnect is counted.
            await wait_for(
                lambda: all(
                    r.total("krr_tpu_discovery_watch_restarts_total") + r.total("krr_tpu_discovery_relists_total")
                    > seed for r, seed in zip(loaders.registries(), seeds)
                ),
                "each package's streams to reconnect",
            )
            for registry in loaders.registries():
                assert value(registry, "krr_tpu_discovery_relists_total", reason="410") == 0

        with_loaders(watch_env, body)

    def test_410_gone_forces_relist(self, watch_env):
        cluster, backend = watch_env["cluster"], watch_env["backend"]

        async def body(loaders):
            await loaders.converge()
            # Paused delivery makes the sequence race-free: no stream can
            # consume the new events before the floor moves past them.
            backend.pause_watch_events = True
            cluster.add_workload_with_pods("Deployment", "survivor", "apps", pod_count=1)
            cluster.compact_watch()
            backend.disconnect_watches()
            backend.pause_watch_events = False
            watched = await loaders.converge()
            assert any(o["name"] == "survivor" for o in watched)
            await wait_for(
                lambda: all(value(r, "krr_tpu_discovery_relists_total", reason="410") >= 1
                            for r in loaders.registries()),
                "a 410 relist in each package",
            )

        with_loaders(watch_env, body)

    def test_verify_relist_catches_a_divergence(self, watch_env):
        cluster = watch_env["cluster"]

        async def body(loaders):
            await loaders.converge()
            # A direct list append records no event: invisible to the watch…
            cluster.deployments.append(make_workload("Deployment", "ghost", "apps"))
            jax, port, relist = await loaders.listed()
            assert all(o["name"] != "ghost" for o in port + jax)
            assert any(o["name"] == "ghost" for o in relist)
            # …until the verify relist audits ground truth (every 1 s).
            watched = await loaders.converge()
            assert any(o["name"] == "ghost" for o in watched)
            for registry in loaders.registries():
                assert registry.total("krr_tpu_discovery_verify_divergences_total") >= 1
                assert value(registry, "krr_tpu_discovery_relists_total", reason="verify") >= 1

        with_loaders(watch_env, body, discovery_verify_interval_seconds=1.0)

    def test_warm_restart_from_snapshot_skips_cold_relist(self, watch_env):
        cluster, backend = watch_env["cluster"], watch_env["backend"]
        paths = {name: str(watch_env["tmp_path"] / f"{name}-inventory.json") for name in ("jax", "port")}

        async def first():
            jax = JaxLoader(JaxConfig(kubeconfig=watch_env["kubeconfig"], quiet=True, discovery_mode="watch",
                                      discovery_snapshot_path=paths["jax"]))
            port = PortLoader(PortConfig(kubeconfig=watch_env["kubeconfig"], quiet=True, discovery_mode="watch",
                                         discovery_snapshot_path=paths["port"]))
            try:
                return dump(await jax.list_scannable_objects(["fake"])), dump(await port.list_scannable_objects(["fake"]))
            finally:
                await jax.close()  # each close persists its final snapshot
                await port.close()

        jax_seen, expected = run(first())
        assert jax_seen == expected
        payloads = {name: json.loads(open(path).read()) for name, path in paths.items()}
        assert payloads["port"]["v"] == 1 and payloads["port"]["clusters"]
        assert payloads["port"] == payloads["jax"]

        lists_before, pods_before = backend.list_request_count, backend.pod_request_count

        async def second(path: str):
            # The port warm-starts from each package's snapshot.
            port = PortLoader(PortConfig(kubeconfig=watch_env["kubeconfig"], quiet=True, discovery_mode="watch",
                                         discovery_snapshot_path=path))
            try:
                assert dump(await port.list_scannable_objects(["fake"])) == expected
                # No workload or pod LIST: the snapshot seeded the inventory
                # and the watches resumed from its resourceVersions.
                assert backend.list_request_count == lists_before
                assert backend.pod_request_count == pods_before
                # …and the watches are live: churn after the restart lands.
                name = f"post-restart-{len(cluster.deployments)}"
                cluster.add_workload_with_pods("Deployment", name, "apps", pod_count=1)
                deadline = time.monotonic() + WAIT_SECONDS
                while True:
                    watched = await port.list_scannable_objects(["fake"])
                    if any(o.name == name for o in watched) or time.monotonic() > deadline:
                        break
                    await asyncio.sleep(0.03)
                assert any(o.name == name for o in watched)
            finally:
                await port.close()

        run(second(paths["port"]))
        # The JAX package's snapshot predates that churn. Its
        # resourceVersions are behind but not compacted, so the port resumes
        # from them and catches up on the live cluster with no LIST.
        run(resume_from(watch_env, paths["jax"]))

    def test_stale_snapshot_rides_the_410_rung(self, watch_env):
        """A snapshot whose resourceVersions predate a compaction still
        warm-starts: the 410 answers relist per stream and converge."""
        cluster = watch_env["cluster"]
        path = str(watch_env["tmp_path"] / "discovery-inventory.json")

        async def first():
            port = PortLoader(PortConfig(kubeconfig=watch_env["kubeconfig"], quiet=True, discovery_mode="watch",
                                         discovery_snapshot_path=path))
            try:
                await port.list_scannable_objects(["fake"])
            finally:
                await port.close()

        run(first())
        cluster.add_workload_with_pods("Deployment", "newer", "apps", pod_count=1)
        cluster.compact_watch()

        async def body(loaders):
            watched = await loaders.converge()
            assert any(o["name"] == "newer" for o in watched)
            await wait_for(lambda: value(loaders.port_metrics, "krr_tpu_discovery_relists_total", reason="410") >= 1,
                           "a 410 relist")

        with_loaders(watch_env, body, discovery_snapshot_path=path)


async def resume_from(env, path: str) -> None:
    """A port watch loader warm-started from ``path`` converges on a fresh
    relist of the live cluster without a workload or pod LIST."""
    backend = env["backend"]
    relist = PortLoader(PortConfig(kubeconfig=env["kubeconfig"], quiet=True))
    try:
        expected = dump(await relist.list_scannable_objects(["fake"]))
    finally:
        await relist.close()
    lists_before, pods_before = backend.list_request_count, backend.pod_request_count
    port = PortLoader(PortConfig(kubeconfig=env["kubeconfig"], quiet=True, discovery_mode="watch",
                                 discovery_snapshot_path=path))
    try:
        deadline = time.monotonic() + WAIT_SECONDS
        while True:
            watched = dump(await port.list_scannable_objects(["fake"]))
            if watched == expected or time.monotonic() > deadline:
                break
            await asyncio.sleep(0.03)
        assert watched == expected
        assert (backend.list_request_count, backend.pod_request_count) == (lists_before, pods_before)
    finally:
        await port.close()


# ------------------------------------------------- pooled relist satellites
class TestPooledRelist:
    def test_pooled_loader_sees_churn_across_rounds(self, watch_env):
        cluster, backend = watch_env["cluster"], watch_env["backend"]

        async def main():
            port = PortLoader(PortConfig(kubeconfig=watch_env["kubeconfig"], quiet=True))
            jax = JaxLoader(JaxConfig(kubeconfig=watch_env["kubeconfig"], quiet=True))
            try:
                first = dump(await port.list_scannable_objects(["fake"]))
                assert dump(await jax.list_scannable_objects(["fake"])) == first
                pods_first = backend.pod_request_count
                cluster.add_workload_with_pods("Deployment", "round2", "apps", pod_count=1)
                cluster.delete_pod("web-0", "apps")
                second = dump(await port.list_scannable_objects(["fake"]))
                pods_second = backend.pod_request_count
                assert dump(await jax.list_scannable_objects(["fake"])) == second
                return first, second, pods_first, pods_second
            finally:
                await port.close()
                await jax.close()

        first, second, pods_first, pods_second = run(main())
        assert any(o["name"] == "round2" for o in second)
        assert all(o["name"] != "round2" for o in first)
        web = next(o for o in second if o["name"] == "web")
        assert "web-0" not in web["pods"]  # the pod index really refreshed
        assert pods_second > pods_first  # the per-round invalidation refetched

    def test_failed_pod_fetch_is_not_cached(self, watch_env):
        backend = watch_env["backend"]

        async def main():
            loader = PortClusterLoader(cluster="fake", config=PortConfig(kubeconfig=watch_env["kubeconfig"], quiet=True))
            try:
                backend.fail_pod_lists = 1
                with pytest.raises(Exception):
                    await loader._namespace_pod_labels("apps")
                index = await loader._namespace_pod_labels("apps")  # retry: a fresh fetch
                assert index.select({"matchLabels": {"app": "web"}})
                backend.fail_pod_lists = 1
                with pytest.raises(Exception):
                    await loader._list_pods("data", "app=db")
                assert await loader._list_pods("data", "app=db") == ["db-0", "db-1"]
            finally:
                await loader.close()

        run(main())

    def test_failed_cluster_is_recorded_with_its_error(self, watch_env):
        """A listing failure degrades the cluster to empty and names it on
        ``last_failed_clusters`` with the error, as the JAX loader does."""
        backend = watch_env["backend"]

        async def main():
            out = []
            for loader_type, config_type, registry in ((JaxLoader, JaxConfig, JaxRegistry()),
                                                       (PortLoader, PortConfig, PortRegistry())):
                loader = loader_type(config_type(kubeconfig=watch_env["kubeconfig"], quiet=True), metrics=registry)
                try:
                    backend.fail_pod_lists = 1_000
                    objects = await loader.list_scannable_objects(["fake"])
                finally:
                    backend.fail_pod_lists = 0
                    await loader.close()
                # The error names the first pod list to fail; the
                # namespaces' lists run concurrently, so keep its kind only.
                failed = {cluster: error.split(" for url ")[0] for cluster, error in loader.last_failed_clusters.items()}
                out.append((dump(objects), failed,
                            registry.value("krr_tpu_discovery_cluster_failures_total", cluster="fake")))
            return out

        jax, port = run(main())
        assert port == jax
        objects, failed, count = port
        assert objects == [] and count == 1
        assert failed == {"fake": "HTTPStatusError: Server error '500 Internal Server Error'"}


# ------------------------------------------------------- serve churn soak
def build_soak_fleet():
    """A deterministic two-namespace fleet with a series registered for the
    workload the churn script adds later, so each soak sees the same
    ground truth."""
    from .fakes.chaos import ArchetypeSpec, build_fleet

    fleet = build_fleet(
        (ArchetypeSpec("diurnal", workloads=2, pods=1), ArchetypeSpec("oom-loop", workloads=2, pods=1)),
        samples=240,
        seed=31,
    )
    rng = np.random.default_rng(77)
    fleet.metrics.set_series("diurnal", "main", "late-0",
                             cpu=rng.gamma(2.0, 0.1, 240), memory=rng.uniform(1e8, 2e8, 240))
    return fleet


async def wait_soak_inventory(server, cluster) -> None:
    inventory = server.session.get_inventory()
    expected = cluster_keys(cluster)
    deadline = time.monotonic() + WAIT_SECONDS
    while True:
        objects = await inventory.list_scannable_objects(["fake"])
        if {(o.kind, o.namespace, o.name) for o in objects} == expected:
            return
        if time.monotonic() > deadline:
            raise AssertionError(f"the inventory never converged on {expected}")
        await asyncio.sleep(0.03)


def soak_settings(kubeconfig: str, url: str, mode: str, port: bool, **other_args) -> dict:
    return dict(
        kubeconfig=kubeconfig,
        prometheus_url=url,
        strategy="tdigest",
        quiet=True,
        server_port=0,
        scan_interval_seconds=300.0,
        # The relist control re-discovers every tick, so both modes see the
        # churn at the same tick boundaries…
        discovery_interval_seconds=0.001,
        # …and the verify audit stays out: every event rides the stream.
        discovery_verify_interval_seconds=3600.0,
        discovery_mode=mode,
        hysteresis_enabled=False,
        prometheus_retry_deadline_seconds=1.0,
        prometheus_backoff_cap_seconds=0.2,
        other_args={"history_duration": 1, "timeframe_duration": 1, **({"device": "cpu"} if port else {}),
                    **other_args},
    )


def run_churn_soak(package: str, mode: str, tmp_path, ticks: int = 6):
    """One serve soak (a real ``KrrServer`` of ``package`` under a pinned
    clock) through a scripted churn: a workload added at tick 1, one deleted
    at tick 2, the watch streams dropped at tick 3. Returns the published
    body bytes, the store, the state and the metrics."""
    import krr_tpu.server.app as jax_app
    import krr_tpu_torch.server.app as port_app

    from .fakes.chaos import ORIGIN

    fleet = build_soak_fleet()
    server = ServerThread(fleet.backend).start()
    try:
        kubeconfig = write_kubeconfig(tmp_path / f"kubeconfig-{package}-{mode}", server.url)
        config_type, app = (PortConfig, port_app) if package == "port" else (JaxConfig, jax_app)
        config = config_type(**soak_settings(kubeconfig, server.url, mode, package == "port"))
        cluster, backend = fleet.cluster, fleet.backend

        async def main():
            now = [ORIGIN + 3600.0]
            ks = app.KrrServer(config, clock=lambda: now[0])
            await ks.start(run_scheduler=False)
            try:
                for tick in range(ticks):
                    now[0] = ORIGIN + 3600.0 + 300.0 * tick
                    assert await ks.scheduler.run_once() is True
                    if tick == 1:
                        cluster.add_workload("Deployment", "late", "diurnal")
                        cluster.add_pod("late-0", "diurnal", {"app": "late"})
                    elif tick == 2:
                        cluster.delete_workload("Deployment", "diurnal-1", "diurnal")
                        cluster.delete_pod("diurnal-1-0", "diurnal")
                    elif tick == 3 and mode == "watch":
                        backend.disconnect_watches()
                    await wait_soak_inventory(ks, cluster)
                snapshot = ks.state.peek()
                return snapshot.body_json, ks.state.store, ks.state, ks.state.metrics
            finally:
                await ks.shutdown()

        return run(main())
    finally:
        server.stop()


def stores_equal(a, b) -> bool:
    return a.keys == b.keys and all(
        np.array_equal(getattr(a, f), getattr(b, f))
        for f in ("cpu_counts", "cpu_total", "cpu_peak", "mem_total", "mem_peak")
    )


def test_watch_soak_serves_the_relist_controls_and_the_jax_servers_bytes(tmp_path):
    body, store, state, metrics = run_churn_soak("port", "watch", tmp_path)
    relist_body, relist_store, relist_state, _ = run_churn_soak("port", "relist", tmp_path)
    jax_body, jax_store, _, _ = run_churn_soak("jax", "watch", tmp_path)

    assert body  # something published
    assert body == relist_body, "the watch server's bytes != the relist control's"
    assert body == jax_body, "the port's watch server's bytes != the JAX package's"
    assert stores_equal(store, relist_store) and stores_equal(store, jax_store)
    assert b'"late"' in body and b'"diurnal-1"' not in body
    assert state.discovery.get("mode") == "watch" and relist_state.discovery.get("mode") == "relist"
    assert value(metrics, "krr_tpu_discovery_relists_total", reason="seed") >= 1
    # Every churn step rode the watch stream: no verify relist fired.
    assert metrics.total("krr_tpu_discovery_watch_events_total") >= 4
    assert value(metrics, "krr_tpu_discovery_relists_total", reason="verify") == 0
    # The watch delete's rows left the store through churn compaction.
    assert metrics.total("krr_tpu_store_compacted_rows_total") >= 1
    # The timeline carries the discovery block of each watch tick.
    blocks = [r.get("discovery") for r in state.timeline.records() if r.get("discovery")]
    assert blocks and all(b["mode"] == "watch" for b in blocks)
    assert any(b.get("adds", 0) > 0 for b in blocks)
    assert all("inventory_age_seconds" in b for b in blocks)


def test_quiet_watch_ticks_skip_the_compaction(tmp_path, monkeypatch):
    """In watch mode discovery runs every tick, but the store compaction
    only runs when the inventory generation moved."""
    import krr_tpu_torch.server.app as port_app
    from krr_tpu_torch.core.streaming import DigestStore

    from .fakes.chaos import ORIGIN

    calls = []
    compact = DigestStore.compact
    monkeypatch.setattr(DigestStore, "compact", lambda self, keys: calls.append(len(keys)) or compact(self, keys))
    fleet = build_soak_fleet()
    server = ServerThread(fleet.backend).start()
    try:
        kubeconfig = write_kubeconfig(tmp_path / "kubeconfig", server.url)
        config = PortConfig(**soak_settings(kubeconfig, server.url, "watch", True))

        async def main():
            now = [ORIGIN + 3600.0]
            ks = port_app.KrrServer(config, clock=lambda: now[0])
            await ks.start(run_scheduler=False)
            try:
                for tick in range(3):
                    now[0] = ORIGIN + 3600.0 + 300.0 * tick
                    assert await ks.scheduler.run_once() is True
            finally:
                await ks.shutdown()

        run(main())
    finally:
        server.stop()
    assert len(calls) == 1  # the first discovery only: no churn after it


def test_serve_derives_the_snapshot_path_and_warm_restarts(tmp_path):
    """Inside a sharded state the snapshot is ``discovery-inventory.json``;
    beside a legacy file it is ``<state_path>.discovery-inventory.json``. A
    second serve on the same state warm-starts with no workload LIST."""
    import krr_tpu_torch.server.app as port_app

    from .fakes.chaos import ORIGIN

    fleet = build_soak_fleet()
    server = ServerThread(fleet.backend).start()
    try:
        kubeconfig = write_kubeconfig(tmp_path / "kubeconfig", server.url)

        def config(state_path: str, **other_args):
            settings = soak_settings(kubeconfig, server.url, "watch", True, state_path=state_path, **other_args)
            settings["discovery_interval_seconds"] = 0.05  # the snapshot's save rate limit
            return PortConfig(**settings)

        async def serve(cfg, start: float):
            now = [start]
            ks = port_app.KrrServer(cfg, clock=lambda: now[0])
            await ks.start(run_scheduler=False)
            try:
                for tick in range(2):
                    now[0] = start + 300.0 * tick
                    await ks.scheduler.run_once()
                return ks.state.metrics, ks.state.discovery.get("mode")
            finally:
                await ks.shutdown()

        state_path = str(tmp_path / "state")
        first = config(state_path)
        run(serve(first, ORIGIN + 3600.0))
        assert first.discovery_snapshot_path == str(tmp_path / "state" / "discovery-inventory.json")
        payload = json.loads((tmp_path / "state" / "discovery-inventory.json").read_text())
        assert payload["v"] == 1 and payload["clusters"]

        lists_before = fleet.backend.list_request_count
        metrics, mode = run(serve(config(state_path), ORIGIN + 3600.0 + 600.0))
        assert fleet.backend.list_request_count == lists_before  # warm start
        assert mode == "watch"
        assert value(metrics, "krr_tpu_discovery_relists_total", reason="seed") == 0

        legacy = config(str(tmp_path / "legacy"), store_format="legacy")
        run(serve(legacy, ORIGIN + 3600.0))
        assert legacy.discovery_snapshot_path == str(tmp_path / "legacy") + ".discovery-inventory.json"
        assert (tmp_path / "legacy.discovery-inventory.json").exists()
    finally:
        server.stop()
