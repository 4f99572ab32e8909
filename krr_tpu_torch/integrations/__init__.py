from krr_tpu_torch.integrations.kubeconfig import KubeConfig, resolve_credentials
from krr_tpu_torch.integrations.kubernetes import ClusterLoader, KubeApi, KubernetesLoader
from krr_tpu_torch.integrations.prometheus import PrometheusLoader, PrometheusNotFound
from krr_tpu_torch.integrations.service_discovery import ServiceDiscovery

__all__ = [
    "KubeConfig",
    "resolve_credentials",
    "ClusterLoader",
    "KubeApi",
    "KubernetesLoader",
    "PrometheusLoader",
    "PrometheusNotFound",
    "ServiceDiscovery",
]
