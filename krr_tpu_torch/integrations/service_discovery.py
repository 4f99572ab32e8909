"""In-cluster service/ingress discovery (used to auto-find Prometheus).

Behavior-compatible with `robusta_krr/utils/service_discovery.py`:
scan Services across all namespaces for each label selector; in-cluster the URL
is the cluster-DNS form, outside it's the apiserver proxy URL (requests then
ride the apiserver's auth); fall back to Ingress hosts; cache results for 15
minutes. (The reference's double ``find_ingress_host`` call — a quirk noted in
SURVEY.md §2.15 — is not reproduced.)
"""

from __future__ import annotations

from typing import Optional

from krr_tpu_torch.integrations.kubernetes import KubeApi
from krr_tpu_torch.utils.logging import KrrLogger, NULL_LOGGER
from krr_tpu_torch.utils.ttl_cache import TTLCache

SERVICE_CACHE_TTL_SEC = 900

#: Well-known Prometheus service selectors (reference `prometheus.py:22-34`).
PROMETHEUS_SELECTORS = [
    "app=kube-prometheus-stack-prometheus",
    "app=prometheus,component=server",
    "app=prometheus-server",
    "app=prometheus-operator-prometheus",
    "app=prometheus-msteams",
    "app=rancher-monitoring-prometheus",
    "app=prometheus-prometheus",
]


class ServiceDiscovery:
    cache: TTLCache = TTLCache(maxsize=8, ttl=SERVICE_CACHE_TTL_SEC)

    def __init__(self, api: KubeApi, inside_cluster: bool, logger: KrrLogger = NULL_LOGGER):
        self.api = api
        self.inside_cluster = inside_cluster
        self.logger = logger

    async def find_service_url(self, label_selector: str) -> Optional[str]:
        # Only the first match is used, but the listing must still page: the
        # apiserver applies label selectors after chunking, so a small `limit`
        # on a selected listing returns empty pages with continue tokens.
        svc = await self.api.first_item("/api/v1/services", labelSelector=label_selector)
        if svc is None:
            return None
        name = svc["metadata"]["name"]
        namespace = svc["metadata"]["namespace"]
        port = svc["spec"]["ports"][0]["port"]
        if self.inside_cluster:
            return f"http://{name}.{namespace}.svc.cluster.local:{port}"
        server = self.api.credentials.server.rstrip("/")
        return f"{server}/api/v1/namespaces/{namespace}/services/{name}:{port}/proxy"

    async def find_ingress_host(self, label_selector: str) -> Optional[str]:
        if self.inside_cluster:
            return None
        ingress = await self.api.first_item(
            "/apis/networking.k8s.io/v1/ingresses", labelSelector=label_selector
        )
        if ingress is None:
            return None
        host = ingress["spec"]["rules"][0]["host"]
        return f"http://{host}"

    async def find_url(self, selectors: list[str]) -> Optional[str]:
        cache_key = (self.api.credentials.server, ",".join(selectors))
        cached = self.cache.get(cache_key)
        if cached:
            return cached
        for selector in selectors:
            self.logger.debug(f"Trying service selector {selector}")
            url = await self.find_service_url(selector)
            if url:
                self.cache[cache_key] = url
                return url
            self.logger.debug(f"Trying ingress selector {selector}")
            url = await self.find_ingress_host(selector)
            if url:
                self.cache[cache_key] = url
                return url
        return None
