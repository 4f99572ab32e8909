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
  ``krr_tpu_discovery_cluster_failures_total{cluster}`` and the failing
  clusters surface on the loader's ``last_failed_clusters`` (which serve
  reflects onto ``/healthz``), so a fleet that quietly shrank to a subset
  of its clusters is visible without grepping logs.

Improvement over the reference: pod lists are cached per (namespace,
selector), so multi-container workloads issue one pod query instead of one per
container, and the four workload listings share one connection pool.
"""

from __future__ import annotations

import asyncio
import json
import time
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


class WatchGone(Exception):
    """The apiserver compacted its watch cache past our resourceVersion
    (HTTP ``410 Gone``, or an ERROR event carrying code 410): the stream
    cannot resume — the owner must RELIST and restart the watch from the
    fresh list's resourceVersion."""


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
        self._watch_client: Optional[httpx.AsyncClient] = None
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

    async def watch_client(self) -> httpx.AsyncClient:
        """A SEPARATE, uncapped client for watch streams: each active
        namespace pins one long-lived connection, and on wide clusters that
        would exhaust the request pool's ``max_connections`` — starving the
        very list/pod requests the resync ladder depends on."""
        if self._watch_client is None:
            async with self._client_lock:
                if self._watch_client is None:
                    self._watch_client = await asyncio.to_thread(
                        self.credentials.make_client, 30.0, None
                    )
        return self._watch_client

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

    async def list_collection(
        self, path: str, headers: Optional[dict[str, str]] = None, **params: Any
    ) -> "tuple[list[dict[str, Any]], Optional[str]]":
        """Paginated list that ALSO returns the collection's
        ``metadata.resourceVersion`` — the point in the apiserver's history
        a subsequent watch resumes from. The FIRST page's resourceVersion
        identifies the snapshot (continue pages serve the same consistent
        snapshot, like etcd paging)."""
        items: list[dict[str, Any]] = []
        resource_version: Optional[str] = None
        async for page_body in self._page_bodies(path, headers, params):
            if resource_version is None:
                resource_version = (page_body.get("metadata") or {}).get("resourceVersion")
            items.extend(page_body.get("items") or [])
        return items, resource_version

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

    #: Server-side watch timeout requested on each stream: the apiserver
    #: closes the connection after this many seconds of its own accord, and
    #: the client resumes from its bookmarked resourceVersion — bounded-
    #: lifetime streams are the protocol's keepalive.
    WATCH_TIMEOUT_SECONDS = 300.0

    async def watch(
        self,
        path: str,
        resource_version: Optional[str],
        headers: Optional[dict[str, str]] = None,
        timeout_seconds: Optional[float] = None,
        **params: Any,
    ):
        """One watch stream: yield decoded watch events (``{"type", "object"}``
        dicts, BOOKMARK included) from ``path`` starting AFTER
        ``resource_version``. Raises :class:`WatchGone` on the apiserver's
        ``410 Gone`` (compacted history — the caller must relist); a clean
        server-side timeout simply ends the generator (the caller reconnects
        from its last seen resourceVersion)."""
        timeout_seconds = float(timeout_seconds or self.WATCH_TIMEOUT_SECONDS)
        client = await self.watch_client()
        request_params: dict[str, Any] = {
            "watch": "true",
            "allowWatchBookmarks": "true",
            "timeoutSeconds": int(timeout_seconds),
            **{k: v for k, v in params.items() if v is not None},
        }
        if resource_version is not None:
            request_params["resourceVersion"] = str(resource_version)
        # The read timeout must outlive the SERVER's watch timeout: an idle
        # stream is healthy until the server closes it.
        timeout = httpx.Timeout(10.0, read=timeout_seconds + 30.0)
        async with client.stream(
            "GET", path, params=request_params, headers=headers, timeout=timeout
        ) as response:
            if response.status_code == 410:
                raise WatchGone(
                    f"watch of {path} at resourceVersion {resource_version} is gone (410)"
                )
            response.raise_for_status()
            async for line in response.aiter_lines():
                line = line.strip()
                if not line:
                    continue
                event = json.loads(line)
                if event.get("type") == "ERROR":
                    status = event.get("object") or {}
                    if int(status.get("code") or 0) == 410:
                        raise WatchGone(
                            f"watch of {path} expired mid-stream: {status.get('message')}"
                        )
                    raise RuntimeError(f"watch of {path} failed: {status}")
                yield event

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

    async def close_watch_client(self) -> None:
        """Force-close the watch transport: parked stream reads fail
        immediately instead of waiting out cancellation delivery — the
        reliable half of watch shutdown (an externally-delivered cancel can
        be swallowed inside the HTTP stack's timeout scopes on this Python,
        leaving the read parked; a closed socket cannot be parked on). A
        later watch lazily rebuilds the client."""
        if self._watch_client is not None:
            client, self._watch_client = self._watch_client, None
            await client.aclose()

    async def close(self) -> None:
        if self._client is not None:
            await self._client.aclose()
            self._client = None
        await self.close_watch_client()


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
        #: The last listing failure that degraded this cluster to an empty
        #: inventory (None while healthy) — KubernetesLoader rolls these up
        #: into ``last_failed_clusters`` per discovery round.
        self.last_error: Optional[str] = None
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
        self.last_error = None

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
        half of discovery, shared by the staged and streamed paths."""
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

    def _record_failure(self, error: BaseException) -> None:
        """Fail-soft bookkeeping for a discovery listing that degraded this
        cluster to an empty inventory: counted per cluster (the metric) and
        remembered (``last_error``, rolled up onto /healthz) — a silently
        smaller fleet must not be silent."""
        self.last_error = f"{type(error).__name__}: {error}"[:300]
        if self.metrics is not None:
            self.metrics.inc(
                "krr_tpu_discovery_cluster_failures_total",
                cluster=self.cluster or "default",
            )

    async def list_scannable_objects(self) -> list[K8sObjectData]:
        self.logger.debug(f"Listing scannable objects in {self.cluster or 'default'}")
        self.last_error = None
        try:
            per_kind = await asyncio.gather(
                *[self._list_workloads(kind, path) for kind, path in WORKLOAD_ENDPOINTS]
            )
        except Exception as e:
            self._record_failure(e)
            self.logger.error(f"Error trying to list workloads in cluster {self.cluster or 'default'}: {e}")
            self.logger.debug_exception()
            return []

        # Namespace filtering already happened in _list_workloads (before pod
        # resolution); this flatten is the whole remaining job.
        return [obj for objs in per_kind for obj in objs]

    async def stream_scannable_objects(self):
        """Yield ``(positions, objects)`` batches, one per namespace, as each
        namespace's pod index resolves — the streamed-discovery half of the
        scan pipeline (`krr_tpu_torch.core.pipeline`): a namespace whose inventory
        is complete starts its Prometheus fetch while other namespaces' pod
        indexes are still in flight.

        ``positions[i]`` is the staged index ``objects[i]`` would have had in
        :meth:`list_scannable_objects`' flat list (kind-major item order), so
        a consumer that sorts by position reconstructs the staged order
        exactly — streamed and staged scans then disagree on nothing, list
        order included. Failure granularity is FINER than the staged path's
        cluster-wide fail-soft: a namespace whose pod index fails is skipped
        with a logged error while its siblings still scan (the staged path
        would drop the whole cluster); a failed workload listing still drops
        the cluster, matching staged."""
        if not self.config.bulk_pod_discovery:
            # Per-workload server-side pod resolution has no per-namespace
            # completion structure to stream — one staged batch.
            objects = await self.list_scannable_objects()
            if objects:
                yield list(range(len(objects))), objects
            return
        self.logger.debug(f"Streaming scannable objects in {self.cluster or 'default'}")
        self.last_error = None
        try:
            per_kind = await asyncio.gather(
                *[self._list_kind_items(kind, path) for kind, path in WORKLOAD_ENDPOINTS]
            )
        except Exception as e:
            self._record_failure(e)
            self.logger.error(f"Error trying to list workloads in cluster {self.cluster or 'default'}: {e}")
            self.logger.debug_exception()
            return
        # Staged (kind-major) traversal, bucketed per namespace with each
        # workload's would-be object position carried along.
        position = 0
        by_namespace: dict[str, list[tuple[str, dict[str, Any], int]]] = {}
        for (kind, _path), items in zip(WORKLOAD_ENDPOINTS, per_kind):
            for item in items:
                pod_spec = (((item.get("spec") or {}).get("template") or {}).get("spec")) or {}
                by_namespace.setdefault(item["metadata"]["namespace"], []).append(
                    (kind, item, position)
                )
                position += len(pod_spec.get("containers") or [])
        tasks = {
            asyncio.ensure_future(self._namespace_pod_labels(namespace)): namespace
            for namespace in by_namespace
        }
        try:
            pending = set(tasks)
            while pending:
                done, pending = await asyncio.wait(pending, return_when=asyncio.FIRST_COMPLETED)
                for task in done:
                    namespace = tasks[task]
                    try:
                        index = task.result()
                    except Exception as e:
                        self.logger.error(
                            f"Error resolving pods for namespace {namespace} in "
                            f"{self.cluster or 'default'}: {e} — skipping its workloads"
                        )
                        self.logger.debug_exception()
                        continue
                    positions: list[int] = []
                    objects: list[K8sObjectData] = []
                    for kind, item, item_position in by_namespace[namespace]:
                        selector = (item.get("spec") or {}).get("selector")
                        pods = index.select(selector) if selector else []
                        built = self._make_objects(kind, item, pods)
                        positions.extend(range(item_position, item_position + len(built)))
                        objects.extend(built)
                    if objects:
                        yield positions, objects
        finally:
            for task in tasks:  # an abandoned generator must not leak tasks
                task.cancel()

    async def close(self) -> None:
        if self._api is not None:
            await self._api.close()


class ClusterWatcher:
    """Watch-maintained resident inventory for ONE cluster — the O(churn)
    discovery engine behind ``--discovery-mode watch``.

    One list+watch stream per workload kind (per configured namespace when
    the scan is namespace-scoped), plus one metadata-only pod stream per
    ACTIVE namespace (a namespace holding at least one workload, the same
    set the relist path fetches pod indexes for). Streams request
    ``allowWatchBookmarks`` so an idle inventory's resourceVersion keeps
    advancing — surviving watch-cache compactions without a relist.

    Correctness bar: at every reconcile the emitted object list is
    BIT-IDENTICAL (same objects, same staged order) to what a fresh relist
    would return. Order is preserved by construction: the seed list's order
    is kept (insertion-ordered dicts), MODIFIED events replace in place,
    DELETED removes, and a re-ADDED object lands at the end — exactly where
    a fresh relist would now place it. (Against a real apiserver whose list
    order is storage-key order, accumulated order can drift after
    delete+recreate churn; the periodic verify relist detects and repairs
    any divergence, content or order.)

    The resync ladder, least to most expensive:

    1. stream end / transport error → reconnect from the last seen
       resourceVersion (``krr_tpu_discovery_watch_restarts_total``);
    2. repeated reconnect failures or ``410 Gone`` → RELIST that stream only
       and resume from the fresh resourceVersion
       (``krr_tpu_discovery_relists_total{reason="410"|"watch_error"}``);
    3. the periodic ``--discovery-verify-interval`` full relist diffs the
       whole watched inventory against ground truth — divergence is counted
       (``krr_tpu_discovery_verify_divergences_total``), logged, and
       repaired by adopting the relist and restarting every stream.

    Reconcile cost: event application is O(1) per event; the reconcile tick
    rebuilds pod indexes only for namespaces whose pods churned and re-runs
    selector matching only for workloads invalidated by workload or pod
    churn — everything else re-emits cached ``K8sObjectData`` rows.
    """

    #: Consecutive reconnect failures on one stream before falling back to
    #: a relist of that stream (ladder step 2).
    MAX_STREAM_FAILURES = 3

    def __init__(
        self,
        loader: ClusterLoader,
        config: Config,
        logger: KrrLogger = NULL_LOGGER,
        metrics=None,
        clock=time.time,
    ) -> None:
        self.loader = loader
        self.config = config
        self.logger = logger
        self.metrics = metrics
        self.clock = clock
        self.cluster = loader.cluster
        #: (kind, namespace-or-None) stream → insertion-ordered
        #: {(namespace, name): raw item dict}. Emission iterates kinds in
        #: WORKLOAD_ENDPOINTS order and streams in configured-namespace
        #: order, mirroring the relist's staged order exactly.
        self.items: "dict[tuple[str, Optional[str]], dict[tuple[str, str], dict]]" = {}
        self.stream_rv: "dict[tuple[str, Optional[str]], Optional[str]]" = {}
        #: namespace → insertion-ordered {pod name: labels} (active
        #: namespaces only).
        self.pods: "dict[str, dict[str, dict[str, str]]]" = {}
        self.pod_rv: "dict[str, Optional[str]]" = {}
        #: Bumps on every applied inventory mutation — the scheduler skips
        #: churn compaction (and snapshot writes) while it holds still.
        self.generation = 0
        #: The generation the LAST EMITTED object list corresponds to,
        #: stamped inside reconcile's synchronous build (no await between
        #: stamp and emission). Consumers gate churn work on THIS, not on
        #: the live ``generation``: an event applied during a consumer's
        #: own await window must read as pending churn for the NEXT
        #: reconcile, never as already-handled.
        self.reconciled_generation = -1
        self.seeded = False
        #: Per-STREAM progress (event/bookmark/relist wall time), keyed like
        #: the task maps — watch lag reports the STALEST stream, so one
        #: wedged stream can't hide behind its chatty siblings.
        self.stream_progress: "dict[object, float]" = {}
        self.last_reconcile_at: float = 0.0
        self.last_verify_at: float = 0.0
        self._seed_lock = asyncio.Lock()
        self._kind_tasks: "dict[tuple[str, Optional[str]], asyncio.Task]" = {}
        self._pod_tasks: "dict[str, asyncio.Task]" = {}
        self._dirty_namespaces: set[str] = set()
        self._pod_indexes: "dict[str, NamespacePods]" = {}
        #: namespace → {(kind, name): built objects} — the reconcile cache.
        self._objects_cache: "dict[str, dict[tuple[str, str], list[K8sObjectData]]]" = {}

    # ------------------------------------------------------------- plumbing
    def _inc(self, name: str, value: float = 1, **labels: str) -> None:
        if self.metrics is not None:
            self.metrics.inc(name, value, **labels)

    def _touch(self) -> None:
        self.generation += 1

    @property
    def last_progress_at(self) -> float:
        """The STALEST stream's last progress (event, bookmark, or relist)
        — the honest watch-lag anchor: one wedged stream surfaces even
        while its siblings stay chatty."""
        return min(self.stream_progress.values()) if self.stream_progress else 0.0

    def _progress(self, key) -> None:
        self.stream_progress[key] = float(self.clock())

    def _ns_keys(self) -> "list[Optional[str]]":
        if self.config.namespaces == "*":
            return [None]
        return list(self.config.namespaces)

    def _kind_path(self, path: str, ns_key: Optional[str]) -> str:
        if ns_key is None:
            return path
        group, plural = path.rsplit("/", 1)
        return f"{group}/namespaces/{ns_key}/{plural}"

    def _count_event(self, kind_label: str, type_: str) -> None:
        self._inc(
            "krr_tpu_discovery_watch_events_total", kind=kind_label, type=type_.lower()
        )

    def _active_namespaces(self) -> set[str]:
        return {ns for store in self.items.values() for (ns, _name) in store}

    # ------------------------------------------------------------- seeding
    async def _list_kind_streams(
        self, api: KubeApi
    ) -> "dict[tuple[str, Optional[str]], tuple[dict, Optional[str]]]":
        """Relist every configured (kind, namespace) stream CONCURRENTLY —
        the same fan-out the relist discovery path uses — returning each
        stream's ordered item store + list resourceVersion."""
        keys = [
            (kind, ns_key)
            for kind, _path in WORKLOAD_ENDPOINTS
            for ns_key in self._ns_keys()
        ]
        listed = await asyncio.gather(
            *[
                api.list_collection(self._kind_path(dict(WORKLOAD_ENDPOINTS)[kind], ns_key))
                for kind, ns_key in keys
            ]
        )
        return {
            key: (self._item_store(items), rv)
            for key, (items, rv) in zip(keys, listed)
        }

    async def _fetch_namespace_pods(
        self, namespace: str
    ) -> "tuple[dict[str, dict[str, str]], Optional[str]]":
        """ONE namespace's metadata-only pod projection (name → labels) +
        list resourceVersion — the single definition seed, reseed, and
        verify all share, so the projection can never drift between them."""
        api = await self.loader.api()
        items, rv = await api.list_collection(
            f"/api/v1/namespaces/{namespace}/pods", headers=self.loader._METADATA_ONLY
        )
        return (
            {
                item["metadata"]["name"]: item["metadata"].get("labels") or {}
                for item in items
            },
            rv,
        )

    async def seed(self, *, reason: str = "seed") -> None:
        """Cold start (or full resync): relist every kind stream, replace
        the inventory, and (re)start the watches from the fresh
        resourceVersions. Pod streams reseed lazily at the next reconcile
        (the active-namespace set may have changed wholesale)."""
        async with self._seed_lock:
            api = await self.loader.api()
            fresh = await self._list_kind_streams(api)
            await self._stop_tasks(self._kind_tasks)
            await self._stop_tasks(self._pod_tasks)
            self.items = {key: store for key, (store, _rv) in fresh.items()}
            self.stream_rv = {key: rv for key, (_store, rv) in fresh.items()}
            self.pods.clear()
            self.pod_rv.clear()
            self._pod_indexes.clear()
            self._objects_cache.clear()
            self._dirty_namespaces.clear()
            self.seeded = True
            self.stream_progress = {key: float(self.clock()) for key in self.items}
            self._touch()
            self._inc("krr_tpu_discovery_relists_total", reason=reason)
            for key in self.items:
                self._start_kind_watch(key)

    def _item_store(self, items: "list[dict[str, Any]]") -> "dict[tuple[str, str], dict]":
        return {
            (item["metadata"]["namespace"], item["metadata"]["name"]): item
            for item in items
            if self.loader._namespace_included(item["metadata"]["namespace"])
        }

    async def _seed_namespace_pods(self, namespace: str) -> None:
        pods, rv = await self._fetch_namespace_pods(namespace)
        self.pods[namespace] = pods
        self.pod_rv[namespace] = rv
        self._dirty_namespaces.add(namespace)
        self._progress(namespace)
        self._touch()
        self._start_pod_watch(namespace)

    # ------------------------------------------------------------- watching
    @staticmethod
    def _cancel_watch_task(task: "asyncio.Task") -> None:
        """Stop a watch task RELIABLY: set its stop flag, then cancel.
        Plain cancellation is not enough — a CancelledError delivered while
        the task is parked inside the HTTP stack's read can be absorbed and
        surface as a retryable stream error, which the reconnect loop would
        faithfully survive (observed as a close() that never returns). The
        flag makes the loop exit at its next iteration no matter what the
        delivered exception mutated into."""
        flag = getattr(task, "_krr_stop_flag", None)
        if flag is not None:
            flag.append(True)
        task.cancel()

    def _spawn_watch(self, **kwargs) -> "asyncio.Task":
        stop_flag: list = []
        task = asyncio.ensure_future(self._watch_loop(stop_flag=stop_flag, **kwargs))
        task._krr_stop_flag = stop_flag  # type: ignore[attr-defined]
        return task

    def _start_kind_watch(self, key: "tuple[str, Optional[str]]") -> None:
        kind, ns_key = key
        path = self._kind_path(dict(WORKLOAD_ENDPOINTS)[kind], ns_key)
        old = self._kind_tasks.pop(key, None)
        if old is not None:
            self._cancel_watch_task(old)
        self._kind_tasks[key] = self._spawn_watch(
            label=kind,
            path=path,
            headers=None,
            progress_key=key,
            get_rv=lambda: self.stream_rv.get(key),
            set_rv=lambda rv: self.stream_rv.__setitem__(key, rv),
            apply=lambda etype, obj: self._apply_workload(key, etype, obj),
            reseed=lambda: self._reseed_kind(key),
        )

    def _start_pod_watch(self, namespace: str) -> None:
        old = self._pod_tasks.pop(namespace, None)
        if old is not None:
            self._cancel_watch_task(old)
        self._pod_tasks[namespace] = self._spawn_watch(
            label="Pod",
            path=f"/api/v1/namespaces/{namespace}/pods",
            headers=self.loader._METADATA_ONLY,
            progress_key=namespace,
            get_rv=lambda: self.pod_rv.get(namespace),
            set_rv=lambda rv: self.pod_rv.__setitem__(namespace, rv),
            apply=lambda etype, obj: self._apply_pod(namespace, etype, obj),
            reseed=lambda: self._reseed_namespace_pods(namespace),
        )

    async def _watch_loop(
        self, *, stop_flag, label, path, headers, progress_key, get_rv, set_rv, apply, reseed
    ) -> None:
        """One stream's lifetime: watch → apply events → reconnect on stream
        end → relist on 410 / repeated failure (the resync ladder). The
        ``stop_flag`` check is the guaranteed exit (see
        :meth:`_cancel_watch_task`): every handled exception loops back
        here, so a cancellation the transport swallowed still terminates
        the task within one iteration."""
        failures = 0
        idle_ends = 0
        while True:
            if stop_flag:
                return
            received = False
            try:
                api = await self.loader.api()
                async for event in api.watch(path, get_rv(), headers=headers):
                    failures = 0
                    received = True
                    self._progress(progress_key)
                    obj = event.get("object") or {}
                    etype = str(event.get("type") or "")
                    if etype == "BOOKMARK":
                        rv = (obj.get("metadata") or {}).get("resourceVersion")
                        if rv:
                            set_rv(rv)
                        self._count_event(label, "bookmark")
                        continue
                    apply(etype, obj)
                    rv = (obj.get("metadata") or {}).get("resourceVersion")
                    if rv:
                        set_rv(rv)
                    self._count_event(label, etype)
                # Clean stream end (server-side timeout, scripted
                # disconnect): resume from the last seen resourceVersion.
                self._inc("krr_tpu_discovery_watch_restarts_total")
                if received:
                    idle_ends = 0
                else:
                    # A server (or LB) closing watch streams immediately
                    # with nothing delivered must not trigger a tight
                    # reconnect storm across every stream — back off like a
                    # failure, without the relist escalation.
                    idle_ends += 1
                    await asyncio.sleep(min(0.05 * (2 ** min(idle_ends, 6)), 2.0))
            except asyncio.CancelledError:
                raise
            except WatchGone:
                if stop_flag:
                    return
                self._inc("krr_tpu_discovery_relists_total", reason="410")
                self.logger.warning(
                    f"Watch of {path} in {self.cluster or 'default'} expired "
                    f"(410 Gone) — relisting"
                )
                failures = await self._reseed_guarded(reseed, path, failures)
            except httpx.ReadTimeout:
                # An idle READ timeout is a healthy stream whose server
                # forgot to hang up — reconnect, no failure accounting.
                # Connect/pool timeouts are NOT this: they fall through to
                # the generic branch below so a black-holed apiserver still
                # climbs the failure→relist ladder.
                self._inc("krr_tpu_discovery_watch_restarts_total")
            except Exception as e:
                if stop_flag:
                    return  # shutdown noise: the forced transport close
                failures += 1
                self._inc("krr_tpu_discovery_watch_restarts_total")
                self.logger.warning(
                    f"Watch of {path} in {self.cluster or 'default'} failed "
                    f"({type(e).__name__}: {e}) — "
                    f"{'relisting' if failures >= self.MAX_STREAM_FAILURES else 'reconnecting'}"
                )
                self.logger.debug_exception()
                if failures >= self.MAX_STREAM_FAILURES:
                    self._inc("krr_tpu_discovery_relists_total", reason="watch_error")
                    failures = await self._reseed_guarded(reseed, path, 0)
                await asyncio.sleep(min(0.05 * (2 ** min(failures, 6)), 2.0))

    async def _reseed_guarded(self, reseed, path: str, failures: int) -> int:
        try:
            await reseed()
            return 0
        except asyncio.CancelledError:
            raise
        except Exception as e:
            self.logger.warning(
                f"Relist of {path} in {self.cluster or 'default'} failed "
                f"({type(e).__name__}: {e}) — retrying"
            )
            self.logger.debug_exception()
            await asyncio.sleep(0.2)
            return failures + 1

    # ------------------------------------------------------- event handlers
    def _apply_workload(self, key: "tuple[str, Optional[str]]", etype: str, obj: dict) -> None:
        kind, _ns_key = key
        metadata = obj.get("metadata") or {}
        ns, name = metadata.get("namespace"), metadata.get("name")
        if ns is None or name is None or not self.loader._namespace_included(ns):
            return
        store = self.items.get(key)
        if store is None:
            return
        if etype == "DELETED":
            if store.pop((ns, name), None) is None:
                return
        else:  # ADDED | MODIFIED: replace in place, append when new
            store[(ns, name)] = obj
        self._objects_cache.get(ns, {}).pop((kind, name), None)
        self._touch()

    def _apply_pod(self, namespace: str, etype: str, obj: dict) -> None:
        metadata = obj.get("metadata") or {}
        name = metadata.get("name")
        pods = self.pods.get(namespace)
        if name is None or pods is None:
            return
        if etype == "DELETED":
            if pods.pop(name, None) is None:
                return
        else:
            pods[name] = metadata.get("labels") or {}
        self._dirty_namespaces.add(namespace)
        self._touch()

    # ------------------------------------------------------------- resyncs
    async def _reseed_kind(self, key: "tuple[str, Optional[str]]") -> None:
        kind, ns_key = key
        api = await self.loader.api()
        items, rv = await api.list_collection(
            self._kind_path(dict(WORKLOAD_ENDPOINTS)[kind], ns_key)
        )
        fresh = self._item_store(items)
        # ORDER-sensitive compare (dict `==` ignores it): the relist rung
        # must repair order drift too — emission order IS part of the
        # bit-exactness contract, and accumulated insertion order can drift
        # from a real apiserver's storage-key order after delete+recreate.
        if list(fresh.items()) != list(self.items.get(key, {}).items()):
            self.items[key] = fresh
            for ns_store in self._objects_cache.values():
                for cache_key in [k for k in ns_store if k[0] == kind]:
                    del ns_store[cache_key]
            self._touch()
        self.stream_rv[key] = rv
        self._progress(key)

    async def _reseed_namespace_pods(self, namespace: str) -> None:
        fresh, rv = await self._fetch_namespace_pods(namespace)
        # Order-sensitive, like _reseed_kind: pod listing order feeds
        # NamespacePods and thus the published pod lists.
        if list(fresh.items()) != list(self.pods.get(namespace, {}).items()):
            self.pods[namespace] = fresh
            self._dirty_namespaces.add(namespace)
            self._touch()
        self.pod_rv[namespace] = rv
        self._progress(namespace)

    async def verify(self) -> int:
        """The periodic ground-truth audit: a FULL relist diffed against the
        watched inventory (ordered — content and order both count). Any
        divergence is logged, counted, and repaired by adopting the relist
        and restarting every stream from its resourceVersion. Returns the
        number of diverged streams. (A divergence observed while churn is
        in flight is indistinguishable from a missed event — the repair is
        identical and harmless either way.)"""
        api = await self.loader.api()
        self.last_verify_at = float(self.clock())
        diverged = 0
        fresh_kinds = await self._list_kind_streams(api)
        for key, (store, _rv) in fresh_kinds.items():
            if list(store.items()) != list(self.items.get(key, {}).items()):
                diverged += 1
        active = self._active_namespaces() | {
            ns for (store, _rv) in fresh_kinds.values() for (ns, _n) in store
        }
        audited = sorted(active & set(self.pods))
        pod_results = await asyncio.gather(
            *[self._fetch_namespace_pods(namespace) for namespace in audited]
        )
        fresh_pods: "dict[str, tuple[dict, Optional[str]]]" = {}
        for namespace, (store, rv) in zip(audited, pod_results):
            fresh_pods[namespace] = (store, rv)
            if list(store.items()) != list(self.pods.get(namespace, {}).items()):
                diverged += 1
        self._inc("krr_tpu_discovery_relists_total", reason="verify")
        if diverged:
            self._inc("krr_tpu_discovery_verify_divergences_total", diverged)
            self.logger.warning(
                f"Discovery verify relist found {diverged} diverged stream(s) in "
                f"{self.cluster or 'default'} — adopting the relist and "
                f"restarting the watches"
            )
            self.items = {key: store for key, (store, _rv) in fresh_kinds.items()}
            self.stream_rv = {key: rv for key, (_store, rv) in fresh_kinds.items()}
            for namespace, (store, rv) in fresh_pods.items():
                self.pods[namespace] = store
                self.pod_rv[namespace] = rv
                self._dirty_namespaces.add(namespace)
            self._objects_cache.clear()
            self._touch()
            for key in list(self._kind_tasks):
                self._start_kind_watch(key)
            for namespace in list(self._pod_tasks):
                if namespace in self.pods:
                    self._start_pod_watch(namespace)
        now = float(self.clock())
        for key in list(self.stream_progress):
            self.stream_progress[key] = now  # the audit touched every stream
        return diverged

    # ------------------------------------------------------------ reconcile
    @property
    def verify_interval(self) -> float:
        value = float(getattr(self.config, "discovery_verify_interval_seconds", 0.0))
        return value or 4.0 * float(getattr(self.config, "discovery_interval_seconds", 3600.0))

    async def _ensure_pods(self) -> None:
        """Converge the pod streams onto the ACTIVE namespace set: list+watch
        newly active namespaces, drop streams (and pods) of namespaces whose
        last workload left. Loops because a workload event for a brand-new
        namespace can land while the seeds are in flight."""
        while True:
            active = self._active_namespaces()
            for namespace in set(self.pods) - active:
                task = self._pod_tasks.pop(namespace, None)
                if task is not None:
                    self._cancel_watch_task(task)
                self.pods.pop(namespace, None)
                self.pod_rv.pop(namespace, None)
                self._pod_indexes.pop(namespace, None)
                self._objects_cache.pop(namespace, None)
                self._dirty_namespaces.discard(namespace)
                self.stream_progress.pop(namespace, None)
                self._touch()
            missing = sorted(active - set(self.pods))
            if not missing:
                return
            await asyncio.gather(*[self._seed_namespace_pods(ns) for ns in missing])

    async def reconcile(self) -> list[K8sObjectData]:
        """The O(churn) discovery tick: apply accumulated watch state to an
        object list bit-identical to a fresh relist's."""
        now = float(self.clock())
        if not self.seeded:
            await self.seed()
        if not self.last_verify_at:
            self.last_verify_at = now  # the verify cadence starts at seed
        elif now - self.last_verify_at >= self.verify_interval:
            try:
                await self.verify()
            except Exception as e:
                # The audit is advisory: a transient apiserver error during
                # the verify relist must not blank a perfectly healthy
                # resident inventory for the tick — keep serving the
                # watched state and retry the audit next interval.
                self.logger.warning(
                    f"Discovery verify relist for {self.cluster or 'default'} "
                    f"failed ({type(e).__name__}: {e}) — keeping the watched "
                    f"inventory; next audit in {self.verify_interval:.0f}s"
                )
                self.logger.debug_exception()
        await self._ensure_pods()
        for namespace in sorted(self._dirty_namespaces):
            pods = self.pods.get(namespace)
            if pods is None:
                continue
            self._pod_indexes[namespace] = NamespacePods(list(pods.items()))
            # Pod churn invalidates every cached workload of the namespace:
            # their selector matches may have changed.
            self._objects_cache.pop(namespace, None)
        self._dirty_namespaces.clear()
        # Stamp the generation INSIDE the synchronous build (no await from
        # here to return): an event applied during a consumer's later await
        # windows bumps ``generation`` past this stamp and reads as pending
        # churn for the next reconcile — never as already-handled.
        self.reconciled_generation = self.generation
        objects: list[K8sObjectData] = []
        for kind, _path in WORKLOAD_ENDPOINTS:
            for ns_key in self._ns_keys():
                for (ns, name), item in self.items.get((kind, ns_key), {}).items():
                    ns_cache = self._objects_cache.setdefault(ns, {})
                    built = ns_cache.get((kind, name))
                    if built is None:
                        selector = (item.get("spec") or {}).get("selector")
                        index = self._pod_indexes.get(ns)
                        pods = index.select(selector) if (selector and index is not None) else []
                        built = self.loader._make_objects(kind, item, pods)
                        ns_cache[(kind, name)] = built
                    objects.extend(built)
        self.last_reconcile_at = now
        return objects

    # ------------------------------------------------------------- snapshot
    def snapshot_token(self) -> tuple:
        """Cheap change detector for snapshot persistence: the generation
        AND every stream's resourceVersion. Bookmarks advance rvs without
        churn, and a quiet fleet's snapshot must keep its rvs fresh or the
        warm restart it exists for degenerates into 410s + a full relist."""
        return (
            self.generation,
            tuple(
                sorted((f"{kind}\x00{ns or ''}", rv) for (kind, ns), rv in self.stream_rv.items())
            ),
            tuple(sorted(self.pod_rv.items())),
        )

    def to_snapshot(self) -> dict:
        """JSON-serializable inventory + resourceVersions — the warm-restart
        seed persisted beside the window cursor."""
        return {
            "streams": [
                {
                    "kind": kind,
                    "namespace": ns_key,
                    "rv": self.stream_rv.get((kind, ns_key)),
                    "items": list(store.values()),
                }
                for (kind, ns_key), store in self.items.items()
            ],
            "pods": [
                {
                    "namespace": namespace,
                    "rv": self.pod_rv.get(namespace),
                    "pods": [[name, labels] for name, labels in pods.items()],
                }
                for namespace, pods in self.pods.items()
            ],
        }

    def load_snapshot(self, snapshot: dict) -> bool:
        """Warm-start from a persisted snapshot: seed the inventory without
        a relist and start the watches from the saved resourceVersions (a
        compacted resourceVersion simply rides the 410 rung of the ladder).
        Returns False (cold path stays in charge) when the snapshot doesn't
        cover the configured streams — e.g. the namespace selection changed
        since it was written."""
        streams = {
            (s.get("kind"), s.get("namespace")): s for s in snapshot.get("streams", [])
        }
        expected = [
            (kind, ns_key)
            for kind, _path in WORKLOAD_ENDPOINTS
            for ns_key in self._ns_keys()
        ]
        if set(expected) != set(streams):
            return False
        self.items = {
            key: self._item_store(streams[key].get("items") or []) for key in expected
        }
        self.stream_rv = {key: streams[key].get("rv") for key in expected}
        self.pods = {
            entry["namespace"]: {name: labels for name, labels in entry.get("pods") or []}
            for entry in snapshot.get("pods", [])
        }
        self.pod_rv = {
            entry["namespace"]: entry.get("rv") for entry in snapshot.get("pods", [])
        }
        self._dirty_namespaces = set(self.pods)
        self.seeded = True
        now = float(self.clock())
        self.stream_progress = {
            **{key: now for key in self.items},
            **{namespace: now for namespace in self.pods},
        }
        self._touch()
        for key in self.items:
            self._start_kind_watch(key)
        for namespace in self.pods:
            self._start_pod_watch(namespace)
        return True

    # --------------------------------------------------------------- close
    async def _stop_tasks(self, tasks: dict) -> None:
        pending = list(tasks.values())
        tasks.clear()
        for task in pending:
            self._cancel_watch_task(task)
        if not pending:
            return
        _done, alive = await asyncio.wait(pending, timeout=0.5)
        if alive:
            # The cancellation was swallowed inside the transport's timeout
            # scopes (observed on this Python/anyio pairing): force the
            # parked reads to fail by closing the watch client — the stop
            # flags then end each loop at its next iteration. Bounded wait:
            # shutdown must never hang on a library's cancellation quirks.
            if self.loader._api is not None:
                await self.loader._api.close_watch_client()
            await asyncio.wait(alive, timeout=5.0)

    async def stop(self) -> None:
        await self._stop_tasks(self._kind_tasks)
        await self._stop_tasks(self._pod_tasks)


class KubernetesLoader:
    """Multi-cluster inventory: context resolution + concurrent cluster scans.

    Cluster loaders (and through them the apiserver HTTP clients) are
    POOLED per cluster across discovery rounds: steady-state discovery
    reuses warm connections instead of paying reconnect + TLS per round,
    with the per-round pod-index caches invalidated explicitly
    (:meth:`ClusterLoader.begin_round`). With ``--discovery-mode watch``
    each pooled loader additionally carries a :class:`ClusterWatcher` and
    listing calls become in-memory reconciles of accumulated watch events —
    O(churn) instead of O(fleet) — with the relist kept as the cold-start
    seed, the 410/desync resync path, and the default mode.
    """

    def __init__(self, config: Config, logger: KrrLogger = NULL_LOGGER, metrics=None):
        self.config = config
        self.logger = logger
        self.metrics = metrics
        #: cluster → error string for every cluster whose LAST discovery
        #: round failed (fail-soft degraded to an empty cluster inventory),
        #: refreshed per listing call. The serve scheduler copies it onto
        #: ``ServerState.discovery_failed_clusters`` for /healthz.
        self.last_failed_clusters: dict[str, str] = {}
        self.discovery_mode: str = str(getattr(config, "discovery_mode", "relist"))
        self._pool: "dict[Optional[str], ClusterLoader]" = {}
        self._watchers: "dict[Optional[str], ClusterWatcher]" = {}
        #: The event loop the pool was built on: repeated ``asyncio.run``
        #: drivers (tests, one-shot CLIs) each bring a fresh loop, and a
        #: pooled httpx client or watcher task is bound to the loop it was
        #: created on — a loop change discards and rebuilds the pool.
        self._pool_loop: "Optional[asyncio.AbstractEventLoop]" = None
        self._snapshot: "Optional[dict]" = None
        self._snapshot_loaded = False
        self._snapshot_token: "Optional[tuple]" = None
        self._snapshot_saved_at = 0.0
        #: (expires_at, resolved clusters) — watch-mode TTL cache for
        #: kubeconfig context resolution (see :meth:`list_clusters`).
        self._clusters_cache: "Optional[tuple[float, Optional[list[str]]]]" = None

    # ----------------------------------------------------------- the pool
    def _discard_pool(self) -> None:
        """Drop loaders/watchers built on a DEAD loop: their clients and
        tasks cannot be awaited from the new loop — references drop and the
        kernel closes the sockets. (The long-lived serve process never hits
        this; it is the repeated-``asyncio.run`` test/CLI pattern.)"""
        for watcher in self._watchers.values():
            for task in [*watcher._kind_tasks.values(), *watcher._pod_tasks.values()]:
                try:
                    ClusterWatcher._cancel_watch_task(task)
                except RuntimeError:
                    pass  # the owning loop is already closed
        self._watchers.clear()
        self._pool.clear()

    def _loaders(self, clusters: Optional[list[str]]) -> list[ClusterLoader]:
        loop = asyncio.get_running_loop()
        if self._pool_loop is not loop:
            if self._pool:
                self._discard_pool()
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
        """Evict pool + watcher entries for clusters that left the resolved
        list (kubeconfig context removed, cluster decommissioned): their
        watch streams would otherwise retry a dead apiserver forever,
        poisoning the watch-lag gauge and the persisted snapshot."""
        alive = set(keys)
        for cluster in [c for c in self._watchers if c not in alive]:
            watcher = self._watchers.pop(cluster)
            await watcher.stop()
            self.logger.info(
                f"Dropped the watch inventory for removed cluster {cluster or 'default'}"
            )
        for cluster in [c for c in self._pool if c not in alive]:
            loader = self._pool.pop(cluster)
            await loader.close()

    def _watcher_for(self, loader: ClusterLoader) -> ClusterWatcher:
        watcher = self._watchers.get(loader.cluster)
        if watcher is None:
            watcher = ClusterWatcher(
                loader, self.config, logger=self.logger, metrics=self.metrics
            )
            self._watchers[loader.cluster] = watcher
            snapshot = (self._snapshot or {}).get(loader.cluster or "")
            if snapshot:
                if watcher.load_snapshot(snapshot):
                    self.logger.info(
                        f"Discovery inventory for {loader.cluster or 'default'} "
                        f"warm-started from the persisted snapshot "
                        f"({sum(len(s) for s in watcher.items.values())} workloads) — "
                        f"cold relist skipped"
                    )
                else:
                    self.logger.warning(
                        f"Discovery snapshot for {loader.cluster or 'default'} does "
                        f"not match the configured namespace selection — cold relist"
                    )
        return watcher

    # ------------------------------------------------- snapshot persistence
    @property
    def _snapshot_path(self) -> "Optional[str]":
        return getattr(self.config, "discovery_snapshot_path", None) or None

    async def _load_snapshot_once(self) -> None:
        if self._snapshot_loaded:
            return
        self._snapshot_loaded = True
        path = self._snapshot_path
        if not path:
            return

        def read() -> "Optional[dict]":
            import os

            if not os.path.exists(path):
                return None
            with open(path, "r", encoding="utf-8") as f:
                return json.load(f)

        try:
            payload = await asyncio.to_thread(read)
        except (OSError, ValueError) as e:
            self.logger.warning(
                f"Discovery snapshot at {path} is unreadable ({e}) — cold relist"
            )
            return
        if payload and payload.get("v") == 1:
            self._snapshot = payload.get("clusters") or {}

    def inventory_generation(self) -> "Optional[int]":
        """Monotonic churn counter over the watchers' LAST EMITTED object
        lists — None in relist mode (no resident inventory to version). The
        serve scheduler gates churn compaction on it (the JAX package's
        shard also gates its inventory re-sends): it advances only when a
        reconcile actually emits churn, so an
        event applied mid-consumer (between the emit and the consumer's
        read) still counts as pending for the next tick."""
        if self.discovery_mode != "watch" or not self._watchers:
            return None
        return sum(w.reconciled_generation for w in self._watchers.values())

    async def _maybe_save_snapshot(self, *, force: bool = False) -> None:
        path = self._snapshot_path
        if not path or not self._watchers:
            return
        # Token, not bare generation: bookmarks advance resourceVersions
        # with zero churn, and a quiet fleet's persisted rvs must stay
        # fresh enough to survive the apiserver's watch-cache compaction.
        token = tuple(
            sorted(
                (cluster or "", watcher.snapshot_token())
                for cluster, watcher in self._watchers.items()
            )
        )
        if token == self._snapshot_token:
            return
        now = time.time()
        min_interval = min(
            float(getattr(self.config, "discovery_interval_seconds", 3600.0)), 300.0
        )
        if not force and now - self._snapshot_saved_at < min_interval:
            return
        payload = {
            "v": 1,
            "clusters": {
                (cluster or ""): watcher.to_snapshot()
                for cluster, watcher in self._watchers.items()
                if watcher.seeded
            },
        }

        def save() -> None:
            from krr_tpu_torch.core.streaming import atomic_write

            with atomic_write(path, "w") as f:
                json.dump(payload, f, separators=(",", ":"))

        try:
            await asyncio.to_thread(save)
        except OSError as e:
            self.logger.warning(
                f"Persisting the discovery snapshot to {path} failed ({e}) — "
                f"the next warm restart pays a cold relist"
            )
            return
        self._snapshot_token = token
        self._snapshot_saved_at = now

    # ------------------------------------------------------------- listing
    async def list_clusters(self) -> Optional[list[str]]:
        """None means "the cluster we're inside"; otherwise kubeconfig contexts
        filtered by the configured selection (reference `kubernetes.py:171-197`).
        In watch mode discovery runs EVERY tick, so cluster resolution rides
        a short TTL cache — re-reading + re-parsing the kubeconfig per tick
        would be the last O(not-churn) cost left in the loop. (Relist mode
        keeps the per-call read: it already runs at discovery cadence.)"""
        if self.config.inside_cluster:
            self.logger.debug("Working inside the cluster")
            return None
        if self.discovery_mode == "watch":
            cached = self._clusters_cache
            if cached is not None and time.time() < cached[0]:
                return cached[1]

        kubeconfig = await asyncio.to_thread(KubeConfig.load, self.config.kubeconfig)
        contexts = kubeconfig.context_names()
        self.logger.debug(f"Found {len(contexts)} clusters: {', '.join(contexts)}")
        self.logger.debug(f"Current cluster: {kubeconfig.current_context}")
        self.logger.debug(f"Configured clusters: {self.config.clusters}")

        if not self.config.clusters:  # None or [] → current context only
            resolved = [kubeconfig.current_context] if kubeconfig.current_context else []
        elif self.config.clusters == "*":
            resolved = contexts
        else:
            resolved = [context for context in contexts if context in self.config.clusters]
        if self.discovery_mode == "watch":
            ttl = min(float(getattr(self.config, "discovery_interval_seconds", 3600.0)), 300.0)
            self._clusters_cache = (time.time() + ttl, resolved)
        return resolved

    def _collect_failures(self, loaders: list[ClusterLoader]) -> None:
        self.last_failed_clusters = {
            loader.cluster or "default": loader.last_error
            for loader in loaders
            if loader.last_error
        }

    async def _reconcile_cluster(self, loader: ClusterLoader) -> list[K8sObjectData]:
        """One cluster's watch-mode reconcile, with the relist path's
        fail-soft verdict: an inventory failure degrades to an empty list
        (counted + surfaced), never a crashed round."""
        loader.last_error = None
        try:
            return await self._watcher_for(loader).reconcile()
        except Exception as e:
            loader._record_failure(e)
            self.logger.error(
                f"Error reconciling watched inventory for cluster "
                f"{loader.cluster or 'default'}: {e}"
            )
            self.logger.debug_exception()
            return []

    async def list_scannable_objects(self, clusters: Optional[list[str]]) -> list[K8sObjectData]:
        loaders = self._loaders(clusters)
        await self._prune_dropped_clusters([loader.cluster for loader in loaders])
        if self.discovery_mode == "watch":
            await self._load_snapshot_once()
            nested = await asyncio.gather(
                *[self._reconcile_cluster(loader) for loader in loaders]
            )
            self._collect_failures(loaders)
            await self._maybe_save_snapshot()
            return [obj for objs in nested for obj in objs]
        for loader in loaders:
            loader.begin_round()
        try:
            nested = await asyncio.gather(*[loader.list_scannable_objects() for loader in loaders])
        finally:
            self._collect_failures(loaders)
        return [obj for objs in nested for obj in objs]

    async def stream_scannable_objects(self, clusters: Optional[list[str]]):
        """Yield ``(cluster_ordinal, positions, objects)`` batches as each
        cluster's namespaces complete discovery (`ClusterLoader.
        stream_scannable_objects`), interleaved across clusters in completion
        order. ``cluster_ordinal`` is the cluster's index in the staged
        cluster list, so sorting batches by ``(ordinal, position)`` recovers
        exactly :meth:`list_scannable_objects`' flat order. Per-cluster
        errors degrade to that cluster's absence (fail-soft, like staged).
        In watch mode the whole inventory is resident, so each cluster's
        reconcile yields its per-namespace batches immediately — same batch
        shape, same staged positions, no apiserver round trips."""
        loaders = self._loaders(clusters)
        await self._prune_dropped_clusters([loader.cluster for loader in loaders])
        if self.discovery_mode == "watch":
            await self._load_snapshot_once()
            try:
                for ordinal, loader in enumerate(loaders):
                    objects = await self._reconcile_cluster(loader)
                    by_namespace: "dict[str, tuple[list[int], list[K8sObjectData]]]" = {}
                    for position, obj in enumerate(objects):
                        positions, batch = by_namespace.setdefault(obj.namespace, ([], []))
                        positions.append(position)
                        batch.append(obj)
                    for positions, batch in by_namespace.values():
                        yield ordinal, positions, batch
            finally:
                # Like the relist branch: an early consumer abort must not
                # leave /healthz showing the PREVIOUS round's failures.
                self._collect_failures(loaders)
                await self._maybe_save_snapshot()
            return
        queue: asyncio.Queue = asyncio.Queue()
        _CLUSTER_DONE = object()
        for loader in loaders:
            loader.begin_round()

        async def pump(ordinal: int, loader: ClusterLoader) -> None:
            try:
                async for positions, objects in loader.stream_scannable_objects():
                    await queue.put((ordinal, positions, objects))
            except Exception as e:
                # The generator records its own listing failures; this
                # catches everything past them (a mid-stream transport
                # death) — same fail-soft verdict, same accounting.
                loader._record_failure(e)
                self.logger.error(
                    f"Error trying to list workloads in cluster {loader.cluster or 'default'}: {e}"
                )
                self.logger.debug_exception()
            finally:
                await queue.put(_CLUSTER_DONE)

        pumps = [asyncio.ensure_future(pump(i, loader)) for i, loader in enumerate(loaders)]
        try:
            remaining = len(loaders)
            while remaining:
                item = await queue.get()
                if item is _CLUSTER_DONE:
                    remaining -= 1
                    continue
                yield item
        finally:
            for task in pumps:  # an abandoned generator must not leak pumps
                task.cancel()
            await asyncio.gather(*pumps, return_exceptions=True)
            self._collect_failures(loaders)

    # ------------------------------------------------------- status + close
    def discovery_status(self, now: Optional[float] = None) -> dict:
        """The discovery posture /healthz, /statusz, and the timeline record
        surface: the active mode plus, in watch mode, how old the resident
        inventory is (seconds since the last reconcile emitted it) and the
        watch lag (seconds since the STALEST stream last made progress —
        an event, a bookmark, or a relist)."""
        status: dict = {"mode": self.discovery_mode}
        if self.discovery_mode != "watch" or not self._watchers:
            return status
        now = float(now if now is not None else time.time())
        progress = [w.last_progress_at for w in self._watchers.values() if w.last_progress_at]
        reconciled = [w.last_reconcile_at for w in self._watchers.values() if w.last_reconcile_at]
        status["watch_lag_seconds"] = (
            round(max(0.0, now - min(progress)), 3) if progress else None
        )
        status["inventory_age_seconds"] = (
            round(max(0.0, now - min(reconciled)), 3) if reconciled else None
        )
        status["generation"] = self.inventory_generation()
        status["watch_streams"] = sum(
            len(w._kind_tasks) + len(w._pod_tasks) for w in self._watchers.values()
        )
        if self.metrics is not None:
            if status["inventory_age_seconds"] is not None:
                self.metrics.set(
                    "krr_tpu_discovery_inventory_age_seconds", status["inventory_age_seconds"]
                )
            if status["watch_lag_seconds"] is not None:
                self.metrics.set(
                    "krr_tpu_discovery_watch_lag_seconds", status["watch_lag_seconds"]
                )
        return status

    async def close(self) -> None:
        """Stop the watch streams, persist a final inventory snapshot (warm
        restarts skip the cold relist), and close the pooled clients."""
        for watcher in self._watchers.values():
            await watcher.stop()
        await self._maybe_save_snapshot(force=True)
        self._watchers.clear()
        loaders = list(self._pool.values())
        self._pool.clear()
        await asyncio.gather(*[loader.close() for loader in loaders], return_exceptions=True)
