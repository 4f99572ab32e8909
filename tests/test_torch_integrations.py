"""The port's loaders against the JAX package's, loader by loader.

Same fake apiserver + fake Prometheus (``tests/test_integrations.py``), same
kubeconfigs and response bodies through both packages: query strings,
selector logic, kubeconfig credentials, discovered objects (compared as
dicts), fetched histories (bit for bit, float64), fetch plans, and the
native and Python matrix parsers. Two ``ResourceType`` enums live in this
process, so histories are keyed by the resource's string value.
"""

from __future__ import annotations

import asyncio
import base64
import gc
import json
import sys
import time

import numpy as np
import pytest
import yaml

from krr_tpu.core import fetchplan as jax_fetchplan
from krr_tpu.core.config import Config as JaxConfig
from krr_tpu.integrations import kubeconfig as jax_kubeconfig
from krr_tpu.integrations import kubernetes as jax_kubernetes
from krr_tpu.integrations import native as jax_native
from krr_tpu.integrations import prometheus as jax_prometheus
from krr_tpu_torch.core import fetchplan as port_fetchplan
from krr_tpu_torch.core.config import Config as PortConfig
from krr_tpu_torch.integrations import kubeconfig as port_kubeconfig
from krr_tpu_torch.integrations import kubernetes as port_kubernetes
from krr_tpu_torch.integrations import native as port_native
from krr_tpu_torch.integrations import prometheus as port_prometheus

from .test_integrations import fake_env  # noqa: F401  (module-scoped fixture)
from .test_native import make_response



@pytest.fixture(scope="module", autouse=True)
def jax_native_library():
    """The JAX package builds its native library in place, in ``native/``:
    a pytest-xdist worker that loads it while another worker's compiler is
    still writing it fails once and then remembers the failure for the
    whole process, which turned every native parity test of this file red
    in a fresh checkout. Load it again (clearing the remembered failure)
    until the other build has finished, for up to two minutes."""
    deadline = time.monotonic() + 120.0
    while jax_native._load_library() is None and time.monotonic() < deadline:
        jax_native._build_failed = False
        time.sleep(0.5)


PACKAGES = {
    "jax": (JaxConfig, jax_kubernetes, jax_prometheus),
    "port": (PortConfig, port_kubernetes, port_prometheus),
}


# ------------------------------------------------------------ query strings
QUERY_CASES = [
    ("cpu_query", ("default", "web-0|web-1", "main")),
    ("memory_query", ("prod", "db-[0-9]+", "main")),
    ("cpu_namespace_query", ("default",)),
    ("memory_namespace_query", ("kube-system",)),
    ("cpu_namespaces_query", (("alpha", "beta.x", "gamma"),)),
    ("memory_namespaces_query", (("alpha", "beta.x"),)),
    ("cpu_namespace_shard_query", ("mono", "p-1|p-2")),
    ("memory_namespace_shard_query", ("mono", "p\\.3")),
    ("step_string", (900.0,)),
    ("step_string", (15.0,)),
    ("step_string", (0.5,)),
    ("step_string", (5400.0,)),
    ("effective_step_seconds", (0.4,)),
    ("subwindows", (1_700_000_000.0, 1_700_000_000.0 + 120_960 * 5.0, 5.0)),
    ("subwindows", (1_700_000_000.0, 1_700_086_400.0, 60.0, 100)),
    ("window_points_cap", (250, 40_000_000)),
    ("accept_encoding_for", ("auto",)),
    ("accept_encoding_for", ("off",)),
]


@pytest.mark.parametrize("name,args", QUERY_CASES, ids=lambda v: str(v)[:40])
def test_query_builders_match(name, args):
    assert getattr(port_prometheus, name)(*args) == getattr(jax_prometheus, name)(*args)


# -------------------------------------------------------------- selectors
SELECTORS = [
    None,
    {},
    {"matchLabels": {"app": "web"}},
    {"matchLabels": {"app": "web", "tier": "front"}},
    {"matchExpressions": [{"key": "tier", "operator": "In", "values": ["front", "api"]}]},
    {"matchExpressions": [{"key": "tier", "operator": "NotIn", "values": ["db"]}]},
    {"matchLabels": {"app": "web"}, "matchExpressions": [{"key": "gpu", "operator": "Exists"}]},
    {"matchExpressions": [{"key": "legacy", "operator": "DoesNotExist"}]},
    {"matchExpressions": [{"key": "x", "operator": "Bogus", "values": ["1"]}]},
]
LABEL_SETS = [
    {},
    {"app": "web"},
    {"app": "web", "tier": "front"},
    {"app": "web", "tier": "db", "gpu": "1"},
    {"app": "db", "legacy": "yes"},
]


@pytest.mark.parametrize("selector", SELECTORS, ids=lambda s: json.dumps(s)[:40])
def test_selectors_match(selector):
    assert port_kubernetes.build_selector_query(selector) == jax_kubernetes.build_selector_query(selector)
    for labels in LABEL_SETS:
        assert port_kubernetes.match_selector(selector, labels) == jax_kubernetes.match_selector(
            selector, labels
        ), labels
    pods = [(f"pod-{i}", labels) for i, labels in enumerate(LABEL_SETS)]
    if selector:
        assert port_kubernetes.NamespacePods(pods).select(selector) == jax_kubernetes.NamespacePods(
            pods
        ).select(selector)


# -------------------------------------------------------------- kubeconfig
@pytest.fixture(scope="module")
def kubeconfig_path(tmp_path_factory):
    root = tmp_path_factory.mktemp("kubeconfig")
    token_file = root / "token"
    token_file.write_text("file-token\n")
    exec_credential = json.dumps(
        {"apiVersion": "client.authentication.k8s.io/v1", "kind": "ExecCredential",
         "status": {"token": "exec-token"}}
    )
    ca = base64.b64encode(b"-----BEGIN CERTIFICATE-----\nMIIB\n-----END CERTIFICATE-----\n").decode()
    path = root / "config"
    path.write_text(yaml.dump({
        "current-context": "token",
        "contexts": [
            {"name": name, "context": {"cluster": "c", "user": name}}
            for name in ("token", "basic", "tokenfile", "certs", "exec")
        ] + [{"name": "insecure", "context": {"cluster": "insecure", "user": "token"}}],
        "clusters": [
            {"name": "c", "cluster": {"server": "https://k8s.example:6443",
                                      "certificate-authority-data": ca}},
            {"name": "insecure", "cluster": {"server": "https://10.0.0.1",
                                             "insecure-skip-tls-verify": True}},
        ],
        "users": [
            {"name": "token", "user": {"token": "static-token"}},
            {"name": "basic", "user": {"username": "admin", "password": "hunter2"}},
            {"name": "tokenfile", "user": {"tokenFile": str(token_file)}},
            {"name": "certs", "user": {
                "client-certificate-data": base64.b64encode(b"CERT").decode(),
                "client-key-data": base64.b64encode(b"KEY").decode(),
            }},
            {"name": "exec", "user": {"exec": {
                "apiVersion": "client.authentication.k8s.io/v1",
                "command": sys.executable,
                "args": ["-c", f"print({exec_credential!r})"],
            }}},
        ],
    }))
    return str(path)


def _credential_view(credentials) -> dict:
    view = {
        name: getattr(credentials, name)
        for name in ("server", "context_name", "ca_pem", "insecure_skip_tls_verify", "token",
                     "token_file", "username", "password", "exec_spec")
    }
    for name in ("client_cert_file", "client_key_file"):
        path = getattr(credentials, name)
        view[name] = open(path, "rb").read() if path else None
    view["auth_headers"] = credentials.auth_headers()
    return view


@pytest.mark.parametrize("context", [None, "token", "basic", "tokenfile", "certs", "exec", "insecure"])
def test_kubeconfig_credentials_match(kubeconfig_path, context):
    port = port_kubeconfig.resolve_credentials(context, kubeconfig_path)
    jax = jax_kubeconfig.resolve_credentials(context, kubeconfig_path)
    assert _credential_view(port) == _credential_view(jax)
    assert port_kubeconfig.KubeConfig.load(kubeconfig_path).context_names() == (
        jax_kubeconfig.KubeConfig.load(kubeconfig_path).context_names()
    )


# --------------------------------------------------------------- discovery
def _discover(package: str, fake_env, **overrides):  # noqa: F811
    config_type, kubernetes, _ = PACKAGES[package]
    config = config_type(kubeconfig=fake_env["kubeconfig"], **overrides)

    async def run():
        loader = kubernetes.KubernetesLoader(config)
        try:
            clusters = await loader.list_clusters()
            return clusters, await loader.list_scannable_objects(clusters)
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
def test_discovered_objects_match(fake_env, option):  # noqa: F811
    jax_clusters, jax_objects = _discover("jax", fake_env, **DISCOVERY_OPTIONS[option])
    port_clusters, port_objects = _discover("port", fake_env, **DISCOVERY_OPTIONS[option])
    assert port_clusters == jax_clusters == ["fake"]
    assert [o.model_dump(mode="json") for o in port_objects] == [
        o.model_dump(mode="json") for o in jax_objects
    ]
    assert port_objects


# ------------------------------------------------------------------ fetch
def _gather(package: str, fake_env, objects, *, stats: bool, **overrides):  # noqa: F811
    config_type, _, prometheus = PACKAGES[package]
    config = config_type(
        kubeconfig=fake_env["kubeconfig"], prometheus_url=fake_env["server"].url,
        prometheus_backoff_cap_seconds=0.01, prometheus_retry_deadline_seconds=0.05,
        **overrides,
    )
    stats_resources = frozenset({prometheus.ResourceType.Memory}) if stats else frozenset()
    failed: set[int] = set()

    async def run():
        loader = prometheus.PrometheusLoader(config, cluster="fake")
        try:
            return await loader.gather_fleet(
                objects, 3600.0 * 24 * 14, 900.0, end_time=None,
                stats_resources=stats_resources, failed_rows=failed,
            )
        finally:
            await loader.close()

    gc_was_enabled = gc.isenabled()
    gc.disable()
    try:
        histories = asyncio.run(run())
    finally:
        if gc_was_enabled:
            gc.enable()
    return {resource.value: per_object for resource, per_object in histories.items()}, failed


FETCH_CASES = {
    "raw_batched": dict(stats=False),
    "raw_per_workload": dict(stats=False, batched_fleet_queries=False),
    "stats_batched": dict(stats=True),
    "stats_per_workload": dict(stats=True, batched_fleet_queries=False),
    "raw_fixed_plan": dict(stats=False, fetch_plan="fixed"),
    "stats_compression_off": dict(stats=True, fetch_compression="off"),
}


@pytest.mark.parametrize("failing", [False, True], ids=["healthy", "prod_failing"])
@pytest.mark.parametrize("case", sorted(FETCH_CASES))
def test_gather_fleet_histories_bit_equal(fake_env, case, failing):  # noqa: F811
    _, jax_objects = _discover("jax", fake_env)
    _, port_objects = _discover("port", fake_env)
    if failing:
        fake_env["metrics"].fail_namespaces = frozenset({"prod"})
    try:
        jax_histories, jax_failed = _gather("jax", fake_env, jax_objects, **FETCH_CASES[case])
        port_histories, port_failed = _gather("port", fake_env, port_objects, **FETCH_CASES[case])
    finally:
        fake_env["metrics"].fail_namespaces = frozenset()
    assert port_failed == jax_failed
    if failing:
        assert port_failed == {i for i, o in enumerate(port_objects) if o.namespace == "prod"}
    assert set(port_histories) == set(jax_histories) == {"cpu", "memory"}
    samples = 0
    for resource in ("cpu", "memory"):
        for port_row, jax_row in zip(port_histories[resource], jax_histories[resource], strict=True):
            assert list(port_row) == list(jax_row)
            for pod in port_row:
                assert port_row[pod].dtype == jax_row[pod].dtype == np.float64
                assert np.array_equal(port_row[pod], jax_row[pod])
                samples += port_row[pod].size
    assert samples > 0


# ------------------------------------------------------------- fetch plan
PLAN_CASES = {
    "disabled": (dict(enabled=False, target_series=4), {"a": [1, 2], "b": [3]}, None, {}),
    "coalesce_and_shard": (
        dict(target_series=6, max_shards=16),
        {"mono": [3] * 12, "s1": [1], "s2": [1], "s3": [2]}, None, {},
    ),
    "max_shards": (dict(target_series=2, max_shards=3), {"mono": [1] * 40}, None, {}),
    "auto_target": (dict(), {"mono": [2] * 50, "x": [1]}, 10.0, {}),
    "telemetry": (
        dict(target_series=6), {"deceptive": [1, 1], "small": [1]}, None,
        {"deceptive": dict(series=40.0, bytes_seen=1e6), "small": dict(series=1.0)},
    ),
    "fat_series": (
        dict(target_series=1000, target_bytes=1e6), {f"ns{i}": [1] for i in range(6)}, None,
        {f"ns{i}": dict(series=10.0, bytes_seen=10e6) for i in range(6)},
    ),
}


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_fetch_plans_match(case):
    kwargs, sizes, auto_target, telemetry = PLAN_CASES[case]

    def plan(module):
        planner = module.FetchPlanner(**kwargs)
        for namespace, observed in telemetry.items():
            planner.observe(namespace, **observed)
        by_namespace: dict = {}
        pods: list = []
        for namespace, counts in sizes.items():
            for n in counts:
                by_namespace.setdefault(namespace, []).append(len(pods))
                pods.append(n)
        groups = planner.plan(by_namespace, pods, auto_target=auto_target)
        return [(g.kind, g.namespaces, g.indices) for g in groups], planner.state()

    assert plan(port_fetchplan) == plan(jax_fetchplan)


# ----------------------------------------------------------------- parsers
def _bodies() -> "dict[str, bytes]":
    rng = np.random.default_rng(7)
    return {
        "parity": make_response([
            ("pod-a", list(rng.gamma(2.0, 0.05, 500))),
            ("pod-b", [0.0, 1e-9, 12345.678, 0.25]),
            ("pod-empty", []),
            ("pod-c", list(rng.uniform(1e7, 4e8, 300))),
        ]),
        "empty": b'{"status":"success","data":{"resultType":"matrix","result":[]}}',
        "scientific": make_response([("p", [1e-7, 2.5e8, 3.0])]),
        "pod_label_value": (
            b'{"status":"success","data":{"resultType":"matrix","result":['
            b'{"metric":{"container":"pod","namespace":"ns","pod":"web-1"},'
            b'"values":[[1700000000,"0.5"],[1700000060,"0.75"]]}]}}'
        ),
        "values_label_value": (
            b'{"status":"success","data":{"resultType":"matrix","result":['
            b'{"metric":{"container":"values","namespace":"ns","pod":"web-1"},'
            b'"values":[[1700000000,"0.5"],[1700000060,"0.75"]]},'
            b'{"metric":{"container":"main","namespace":"ns","pod":"web-2"},'
            b'"values":[[1700000000,"1.5"]]}]}}'
        ),
        "nonfinite": (
            b'{"status":"success","data":{"resultType":"matrix","result":['
            b'{"metric":{"pod":"p"},"values":[[1,"NaN"],[2,"1.5"],[3,"+Inf"],[4,"-Inf"],[5,"2"]]}]}}'
        ),
        "batched_keys": (
            b'{"status":"success","data":{"resultType":"matrix","result":['
            b'{"metric":{"pod":"a","container":"main"},"values":[[1,"1"],[2,"3"]]},'
            b'{"metric":{"pod":"b"},"values":[[1,"0.125"]]}]}}'
        ),
        "error_status": b'{"status":"error","errorType":"bad_data","error":"query too long"}',
        "garbage": b"not json at all",
        "truncated": make_response([("p", [1.0, 2.0])])[:-7],
    }


def _outcome(fn, body):
    try:
        result = fn(body)
    except Exception as e:  # the failure CLASS must agree, not the message
        return ("raises", type(e).__name__)
    if result is None:
        return None
    return [
        (entry[0], *(e.tolist() if isinstance(e, np.ndarray) else e for e in entry[1:]))
        for entry in result
    ]


@pytest.mark.parametrize("parser", ["parse_matrix", "parse_matrix_python", "parse_matrix_native", "parse_matrix_stats"])
@pytest.mark.parametrize("body", sorted(_bodies()))
def test_parsers_match(parser, body):
    assert port_native.library_loaded() and jax_native._load_library() is not None
    data = _bodies()[body]
    port = _outcome(getattr(port_native, parser), data)
    jax = _outcome(getattr(jax_native, parser), data)
    assert port == jax


@pytest.mark.parametrize("chunk", [1, 7, 4096])
@pytest.mark.parametrize("body", ["parity", "values_label_value", "nonfinite", "empty", "truncated"])
def test_stream_stats_match(body, chunk):
    data = _bodies()[body]

    def streamed(stream):
        try:
            for i in range(0, len(data), chunk):
                stream.feed(data[i:i + chunk])
            return stream.finish()
        except ValueError as e:
            return ("raises", str(e))

    port = streamed(port_native.open_stream())
    jax = streamed(jax_native.open_stream(0.0, 0.0, 0))
    assert port == jax


def test_native_library_is_the_ports_own_build():
    """The port builds its own library from the shared sources into its
    git-ignored build directory — never into ``native/``."""
    assert port_native.library_loaded()
    assert port_native.SO_PATH.endswith("krr_tpu_torch/csrc/build/libfastsamples.so")
    assert port_native.SO_PATH != jax_native._SO_PATH
