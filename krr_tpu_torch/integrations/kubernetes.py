"""Workload discovery over the Kubernetes REST API.

Behavior-compatible with the reference loaders
(`robusta_krr/core/integrations/kubernetes.py:24-212`), built
directly on httpx (the ``kubernetes`` client package is not a dependency):

* enumerates Deployments / StatefulSets / DaemonSets / Jobs across namespaces,
  flattened to one ``K8sObjectData`` per (workload, container);
* resolves pods via a label-selector query built from the workload's
  ``matchLabels`` + ``matchExpressions`` (In/NotIn/Exists/DoesNotExist);
* ``namespaces="*"`` scans everything except ``kube-system``; explicit list
  filters to those namespaces (reference `kubernetes.py:56-60`);
* per-cluster errors degrade to an empty list (fail-soft, reference
  `kubernetes.py:51-54`) — but never silently: each failure counts in
  ``krr_tpu_discovery_cluster_failures_total{cluster}`` (``--metrics-dump``)
  and logs an error, so a fleet that quietly shrank to a subset of its
  clusters is visible.

Improvement over the reference: pod lists are cached per (namespace,
selector), so multi-container workloads issue one pod query instead of one per
container, and the four workload listings share one connection pool.
"""

from __future__ import annotations

import asyncio
from typing import Any, Optional

import httpx

from krr_tpu_torch.core.config import Config
from krr_tpu_torch.integrations.kubeconfig import ClusterCredentials, KubeConfig, resolve_credentials
from krr_tpu_torch.models.allocations import ResourceAllocations
from krr_tpu_torch.models.objects import K8sObjectData
from krr_tpu_torch.utils.logging import KrrLogger, NULL_LOGGER

#: (kind, list path) for each scannable workload type.
WORKLOAD_ENDPOINTS: list[tuple[str, str]] = [
    ("Deployment", "/apis/apps/v1/deployments"),
    ("StatefulSet", "/apis/apps/v1/statefulsets"),
    ("DaemonSet", "/apis/apps/v1/daemonsets"),
    ("Job", "/apis/batch/v1/jobs"),
]


def build_selector_query(selector: Optional[dict[str, Any]]) -> Optional[str]:
    """LabelSelector dict → label-selector query string (reference
    `kubernetes.py:62-81` semantics)."""
    if not selector:
        return None
    parts = [f"{k}={v}" for k, v in (selector.get("matchLabels") or {}).items()]
    for expression in selector.get("matchExpressions") or []:
        operator = expression["operator"].lower()
        key = expression["key"]
        if operator == "exists":
            parts.append(key)
        elif operator == "doesnotexist":
            parts.append(f"!{key}")
        else:
            values = ",".join(expression.get("values") or [])
            parts.append(f"{key} {expression['operator']} ({values})")
    return ",".join(parts)


def match_selector(selector: Optional[dict[str, Any]], labels: dict[str, str]) -> bool:
    """Client-side LabelSelector evaluation with exact Kubernetes semantics —
    the apiserver's rules, replicated for bulk pod discovery:

    * ``matchLabels`` / ``In``: the key must exist with a matching value;
    * ``NotIn``: matches when the key is ABSENT or its value is outside the
      set (k8s treats missing keys as satisfying NotIn);
    * ``Exists`` / ``DoesNotExist``: key presence only;
    * all requirements AND together; an empty/None selector matches nothing
      here (a workload without a selector owns no pods — same outcome as the
      server-side path, which skips the query entirely).
    """
    if not selector:
        return False
    for key, value in (selector.get("matchLabels") or {}).items():
        if labels.get(key) != value:
            return False
    for expression in selector.get("matchExpressions") or []:
        operator = expression["operator"].lower()
        key = expression["key"]
        values = expression.get("values") or []
        if operator == "in":
            if key not in labels or labels[key] not in values:
                return False
        elif operator == "notin":
            if key in labels and labels[key] in values:
                return False
        elif operator == "exists":
            if key not in labels:
                return False
        elif operator == "doesnotexist":
            if key in labels:
                return False
        else:  # unknown operator: fail closed, like a server-side 400 would
            return False
    return True


class KubeApi:
    """Thin async REST wrapper over one cluster's apiserver.

    Client construction is pushed to a worker thread because it can run an
    ``exec`` credential plugin (EKS/GKE token helpers take seconds) — blocking
    the event loop there would serialize the multi-cluster fan-out.
    """

    def __init__(self, credentials: ClusterCredentials, max_connections: int = 32):
        self.credentials = credentials
        self._client: Optional[httpx.AsyncClient] = None
        self._client_lock = asyncio.Lock()
        self._max_connections = max_connections

    async def client(self) -> httpx.AsyncClient:
        if self._client is None:
            async with self._client_lock:
                if self._client is None:
                    self._client = await asyncio.to_thread(
                        self.credentials.make_client, 30.0, self._max_connections
                    )
        return self._client

    #: Page size for list requests — the apiserver streams huge collections
    #: in chunks instead of one giant response (100k-pod namespaces exist).
    LIST_PAGE_LIMIT = 5000

    async def get_json(
        self, path: str, headers: Optional[dict[str, str]] = None, **params: Any
    ) -> dict[str, Any]:
        client = await self.client()
        response = await client.get(
            path, params={k: v for k, v in params.items() if v is not None}, headers=headers
        )
        response.raise_for_status()
        return response.json()

    async def _pages(self, path: str, headers: Optional[dict[str, str]], params: dict[str, Any]):
        """Yield each ``limit``-sized page's items, following
        ``metadata.continue`` tokens. Servers (and fakes) that ignore
        pagination return everything with no continue token — one page.
        ``params`` must not contain ``limit``/``continue`` — pagination owns
        both (callers pass selectors and field filters only)."""
        async for body in self._page_bodies(path, headers, params):
            # `or []`: the apiserver serializes an empty Go slice as
            # `"items": null`, and a None page must not reach the consumers.
            yield body.get("items") or []

    async def list_items(
        self, path: str, headers: Optional[dict[str, str]] = None, **params: Any
    ) -> list[dict[str, Any]]:
        """Paginated collection list, so fleet-scale collections never arrive
        as one unbounded response."""
        return [item async for page in self._pages(path, headers, params) for item in page]

    async def _page_bodies(self, path: str, headers: Optional[dict[str, str]], params: dict[str, Any]):
        """Like :meth:`_pages` but yields whole page BODIES (metadata
        included) — the resourceVersion-capturing twin."""
        continue_token: Optional[str] = None
        while True:
            body = await self.get_json(
                path, headers=headers, limit=self.LIST_PAGE_LIMIT,
                **{"continue": continue_token}, **params,
            )
            yield body
            continue_token = (body.get("metadata") or {}).get("continue")
            if not continue_token:
                return

    async def first_item(
        self, path: str, headers: Optional[dict[str, str]] = None, **params: Any
    ) -> Optional[dict[str, Any]]:
        """First object in a (possibly label-selected) collection.

        The apiserver applies ``labelSelector`` AFTER reading the limit-sized
        chunk from storage, so a selected listing's early pages can be empty
        yet carry a ``metadata.continue`` token — ``limit=1`` on a selected
        listing is a correctness bug, not an optimization. This follows the
        tokens and stops at the first page that yields a match.
        """
        async for page in self._pages(path, headers, params):
            if page:
                return page[0]
        return None

    async def close(self) -> None:
        if self._client is not None:
            await self._client.aclose()
            self._client = None


class NamespacePods:
    """One namespace's pods plus a label inverted index for bulk discovery.

    ``match_selector`` over every pod for every workload is O(workloads ×
    pods) — quadratic for the common one-big-namespace fleet (10k workloads ×
    10k pods = 1e8 Python evaluations ≈ 25 s). The index maps each (label
    key, value) pair to the pods carrying it, so a ``matchLabels`` selector
    (the overwhelmingly common case) resolves as a set intersection over
    exactly the candidate pods; ``matchExpressions`` are evaluated only on
    those candidates (or on the full list when there are no matchLabels)."""

    def __init__(self, pods: list[tuple[str, dict[str, str]]]):
        self.pods = pods
        self.by_label: dict[tuple[str, str], list[int]] = {}
        for j, (_, labels) in enumerate(pods):
            for item in labels.items():
                self.by_label.setdefault(item, []).append(j)

    def select(self, selector: dict[str, Any]) -> list[str]:
        """Pods matching the selector, in listing order (the order the
        server-side path returns)."""
        candidates: Optional[set[int]] = None
        for item in (selector.get("matchLabels") or {}).items():
            hits = self.by_label.get(item)
            if not hits:
                return []
            candidates = set(hits) if candidates is None else candidates & set(hits)
        if candidates is None:  # no matchLabels: expressions scan everything
            positions: "range | list[int]" = range(len(self.pods))
        else:
            positions = sorted(candidates)
        if selector.get("matchExpressions") or candidates is None:
            return [
                self.pods[j][0]
                for j in positions
                if match_selector(selector, self.pods[j][1])
            ]
        return [self.pods[j][0] for j in positions]


class ClusterLoader:
    """Scans one cluster for workloads."""

    def __init__(self, cluster: Optional[str], config: Config, logger: KrrLogger = NULL_LOGGER,
                 api: Optional[KubeApi] = None, metrics=None):
        self.cluster = cluster
        self.config = config
        self.logger = logger
        self.metrics = metrics
        self._api = api
        self._api_lock = asyncio.Lock()
        self._pod_cache: dict[tuple[str, str], asyncio.Task[list[str]]] = {}
        self._namespace_pods: dict[str, asyncio.Task["NamespacePods"]] = {}

    async def api(self) -> KubeApi:
        """Credentials resolve lazily off the event loop (kubeconfig file I/O,
        possibly an exec plugin)."""
        if self._api is None:
            async with self._api_lock:
                if self._api is None:
                    credentials = await asyncio.to_thread(
                        resolve_credentials, self.cluster, self.config.kubeconfig
                    )
                    self._api = KubeApi(credentials)
        return self._api

    #: Ask the apiserver for metadata-only pod lists: bulk discovery needs
    #: just (name, labels), and a PartialObjectMetadataList is an order of
    #: magnitude smaller than full pod objects (spec/status/managedFields)
    #: for large namespaces. Servers that don't support the transform (and
    #: the test fakes) simply return the full list — same extraction either way.
    _METADATA_ONLY = {
        "Accept": "application/json;as=PartialObjectMetadataList;g=meta.k8s.io;v=v1,application/json"
    }

    def begin_round(self) -> None:
        """Start a fresh discovery round on a POOLED loader: the pod-index
        caches are valid only within one listing round (pods churn between
        rounds), so they are invalidated explicitly here instead of relying
        on the old build-a-new-loader-per-round churn — the HTTP client and
        its warm connections survive across rounds."""
        self._pod_cache.clear()
        self._namespace_pods.clear()

    @staticmethod
    async def _await_cached(cache: dict, key, task: "asyncio.Task"):
        """Await a cached pod-fetch future, EVICTING it from the cache if it
        failed — a fetch that raises must not stay cached as a poisoned
        future for the loader's lifetime (retry paths within one round would
        replay the cached exception forever)."""
        try:
            return await task
        except BaseException:
            if task.done() and (task.cancelled() or task.exception() is not None):
                if cache.get(key) is task:
                    del cache[key]
            raise

    async def _namespace_pod_labels(self, namespace: str) -> NamespacePods:
        """All (pod name, labels) in a namespace, label-indexed — ONE
        apiserver request, cached per round; the bulk-discovery backing
        store. A FAILED fetch evicts its future so a later call retries."""
        task = self._namespace_pods.get(namespace)
        if task is None:
            async def fetch() -> NamespacePods:
                api = await self.api()
                items = await api.list_items(
                    f"/api/v1/namespaces/{namespace}/pods", headers=self._METADATA_ONLY
                )
                return NamespacePods(
                    [
                        (item["metadata"]["name"], item["metadata"].get("labels") or {})
                        for item in items
                    ]
                )

            task = asyncio.ensure_future(fetch())
            self._namespace_pods[namespace] = task
        return await self._await_cached(self._namespace_pods, namespace, task)

    async def _list_pods(self, namespace: str, selector: Optional[str]) -> list[str]:
        if selector is None:
            return []
        key = (namespace, selector)
        task = self._pod_cache.get(key)
        if task is None:
            async def fetch() -> list[str]:
                api = await self.api()
                items = await api.list_items(
                    f"/api/v1/namespaces/{namespace}/pods", labelSelector=selector
                )
                return [item["metadata"]["name"] for item in items]

            task = asyncio.ensure_future(fetch())
            self._pod_cache[key] = task
        return await self._await_cached(self._pod_cache, key, task)

    async def _resolve_pods(self, namespace: str, selector: Optional[dict[str, Any]]) -> list[str]:
        """Workload → pod names via a server-side selector query — the
        PER-WORKLOAD discovery path (``--bulk-pod-discovery false``, the
        reference's behavior). Bulk mode never reaches here: `_list_workloads`
        resolves each namespace's pod index once and selects client-side
        inline (the per-workload coroutine fan-out cost more in event-loop
        scheduling than the build itself at fleet scale)."""
        if not selector:
            return []
        return await self._list_pods(namespace, build_selector_query(selector))

    def _make_objects(self, kind: str, item: dict[str, Any], pods: list[str]) -> list[K8sObjectData]:
        """One ``K8sObjectData`` per container of one workload (sync — pod
        resolution happens in the caller)."""
        metadata = item["metadata"]
        spec = item.get("spec", {})
        pod_spec = ((spec.get("template") or {}).get("spec")) or {}
        containers = pod_spec.get("containers") or []
        # Plain validated init beats model_construct here: pydantic v2's
        # validator runs in the Rust core (~2.3 µs/object measured) while
        # model_construct is a pure-Python field loop (~3.8 µs) — the
        # trusted-path "skip validation" intuition is backwards on v2.
        return [
            K8sObjectData(
                cluster=self.cluster,
                namespace=metadata["namespace"],
                name=metadata["name"],
                kind=kind,
                container=container["name"],
                allocations=ResourceAllocations.from_container_spec(container),
                pods=pods,
            )
            for container in containers
        ]

    async def _build_objects(self, kind: str, item: dict[str, Any]) -> list[K8sObjectData]:
        metadata = item["metadata"]
        spec = item.get("spec", {})
        pods = await self._resolve_pods(metadata["namespace"], spec.get("selector"))
        return self._make_objects(kind, item, pods)

    async def _list_kind_items(self, kind: str, path: str) -> list[dict[str, Any]]:
        """List one workload kind's items, namespace-filtered — the listing
        half of discovery."""
        self.logger.debug(f"Listing {kind}s in {self.cluster or 'default'}")
        api = await self.api()
        if self.config.namespaces == "*":
            pages = [await api.list_items(path)]
        else:
            # Explicit namespace list → namespaced endpoints, so a scan scoped
            # to one namespace needs only namespace-level RBAC and doesn't pay
            # for cluster-wide listing (the reference always lists cluster-wide,
            # `kubernetes.py:108`, then filters).
            group, plural = path.rsplit("/", 1)
            pages = await asyncio.gather(
                *[api.list_items(f"{group}/namespaces/{ns}/{plural}") for ns in self.config.namespaces]
            )
        items = [
            item
            for page in pages
            for item in page
            if self._namespace_included(item["metadata"]["namespace"])
        ]
        self.logger.debug(f"Found {len(items)} {kind}s in {self.cluster or 'default'}")
        return items

    async def _list_workloads(self, kind: str, path: str) -> list[K8sObjectData]:
        items = await self._list_kind_items(kind, path)
        if self.config.bulk_pod_discovery:
            # Bulk mode awaits ONE pod-index fetch per distinct namespace,
            # then builds objects in a plain synchronous loop: a gather of
            # per-workload coroutines costs more in event-loop scheduling
            # than the build itself at fleet scale (measured ~14 s of
            # call_soon/Task machinery for 100k workloads — more than half
            # of discovery).
            namespaces = sorted({item["metadata"]["namespace"] for item in items})
            # Concurrent index fetches (they dedupe via cached futures) — a
            # serial await-per-namespace would pay one apiserver RTT at a
            # time across hundreds of namespaces.
            fetched = await asyncio.gather(*[self._namespace_pod_labels(ns) for ns in namespaces])
            indexes = dict(zip(namespaces, fetched))
            objects: list[K8sObjectData] = []
            for item in items:
                selector = item.get("spec", {}).get("selector")
                pods = (
                    indexes[item["metadata"]["namespace"]].select(selector) if selector else []
                )
                objects.extend(self._make_objects(kind, item, pods))
            return objects
        nested = await asyncio.gather(*[self._build_objects(kind, item) for item in items])
        return [obj for objs in nested for obj in objs]

    def _namespace_included(self, namespace: str) -> bool:
        """Filter BEFORE pod resolution: resolving pods for workloads that
        are dropped afterwards would, in bulk mode, dump entire excluded
        namespaces (kube-system is typically one of the largest)."""
        if self.config.namespaces == "*":
            return namespace != "kube-system"  # never scanned by default (reference behavior)
        return namespace in self.config.namespaces

    async def list_scannable_objects(self) -> list[K8sObjectData]:
        self.logger.debug(f"Listing scannable objects in {self.cluster or 'default'}")
        try:
            per_kind = await asyncio.gather(
                *[self._list_workloads(kind, path) for kind, path in WORKLOAD_ENDPOINTS]
            )
        except Exception as e:
            # Fail-soft, but never silent: counted per cluster and logged.
            if self.metrics is not None:
                self.metrics.inc(
                    "krr_tpu_discovery_cluster_failures_total", cluster=self.cluster or "default"
                )
            self.logger.error(f"Error trying to list workloads in cluster {self.cluster or 'default'}: {e}")
            self.logger.debug_exception()
            return []

        # Namespace filtering already happened in _list_workloads (before pod
        # resolution); this flatten is the whole remaining job.
        return [obj for objs in per_kind for obj in objs]

    async def close(self) -> None:
        if self._api is not None:
            await self._api.close()


class KubernetesLoader:
    """Multi-cluster inventory: context resolution + concurrent cluster scans.

    Cluster loaders (and through them the apiserver HTTP clients) are
    POOLED per cluster across listing calls on one event loop, with the
    per-round pod-index caches invalidated explicitly
    (:meth:`ClusterLoader.begin_round`). This is the relist discovery of
    `krr_tpu/integrations/kubernetes.py`; the watch-driven inventory
    (``ClusterWatcher``, ``--discovery-mode watch``) waits for the serve
    slice.
    """

    def __init__(self, config: Config, logger: KrrLogger = NULL_LOGGER, metrics=None):
        self.config = config
        self.logger = logger
        self.metrics = metrics
        self._pool: "dict[Optional[str], ClusterLoader]" = {}
        #: The event loop the pool was built on: repeated ``asyncio.run``
        #: drivers (tests, one-shot CLIs) each bring a fresh loop, and a
        #: pooled httpx client is bound to the loop it was created on — a
        #: loop change discards and rebuilds the pool.
        self._pool_loop: "Optional[asyncio.AbstractEventLoop]" = None

    def _loaders(self, clusters: Optional[list[str]]) -> list[ClusterLoader]:
        loop = asyncio.get_running_loop()
        if self._pool_loop is not loop:
            # Loaders built on a DEAD loop: their clients cannot be awaited
            # from the new loop — references drop and the sockets close.
            self._pool.clear()
            self._pool_loop = loop
        keys: "list[Optional[str]]" = [None] if clusters is None else list(clusters)
        loaders = []
        for key in keys:
            loader = self._pool.get(key)
            if loader is None:
                loader = ClusterLoader(
                    cluster=key, config=self.config, logger=self.logger, metrics=self.metrics
                )
                self._pool[key] = loader
            loaders.append(loader)
        return loaders

    async def _prune_dropped_clusters(self, keys: "list[Optional[str]]") -> None:
        """Close and evict pooled loaders for clusters that left the resolved
        list (kubeconfig context removed, cluster decommissioned)."""
        alive = set(keys)
        for cluster in [c for c in self._pool if c not in alive]:
            loader = self._pool.pop(cluster)
            await loader.close()

    async def list_clusters(self) -> Optional[list[str]]:
        """None means "the cluster we're inside"; otherwise kubeconfig contexts
        filtered by the configured selection (reference `kubernetes.py:171-197`)."""
        if self.config.inside_cluster:
            self.logger.debug("Working inside the cluster")
            return None

        kubeconfig = await asyncio.to_thread(KubeConfig.load, self.config.kubeconfig)
        contexts = kubeconfig.context_names()
        self.logger.debug(f"Found {len(contexts)} clusters: {', '.join(contexts)}")
        self.logger.debug(f"Current cluster: {kubeconfig.current_context}")
        self.logger.debug(f"Configured clusters: {self.config.clusters}")

        if not self.config.clusters:  # None or [] → current context only
            return [kubeconfig.current_context] if kubeconfig.current_context else []
        if self.config.clusters == "*":
            return contexts
        return [context for context in contexts if context in self.config.clusters]

    async def list_scannable_objects(self, clusters: Optional[list[str]]) -> list[K8sObjectData]:
        loaders = self._loaders(clusters)
        await self._prune_dropped_clusters([loader.cluster for loader in loaders])
        for loader in loaders:
            loader.begin_round()
        nested = await asyncio.gather(*[loader.list_scannable_objects() for loader in loaders])
        return [obj for objs in nested for obj in objs]

    async def close(self) -> None:
        """Close the pooled apiserver clients."""
        loaders = list(self._pool.values())
        self._pool.clear()
        await asyncio.gather(*[loader.close() for loader in loaders], return_exceptions=True)
