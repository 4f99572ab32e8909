"""Re-export of the shared metrics registry (`krr_tpu_torch.obs.metrics`),
under the JAX package's `krr_tpu/server/metrics.py` name: one declaration
table and one exposition renderer for the one-shot CLI and serve."""

from krr_tpu_torch.obs.metrics import (  # noqa: F401
    SERVER_METRICS,
    MetricsRegistry,
    _escape_label,
    _format_value,
    record_build_info,
)

__all__ = ["SERVER_METRICS", "MetricsRegistry", "record_build_info"]
