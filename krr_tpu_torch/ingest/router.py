"""Series router: decoded remote-write label records → digest-store routes.

A copy of `krr_tpu/ingest/router.py` over the port's modules.

The push twin of the pull path's PromQL label matching
(`krr_tpu_torch.integrations.prometheus.cpu_query` / `memory_query`): the same two
metric names, the same cadvisor filters on the memory series (``job``,
``metrics_path``, non-empty ``image``), so a fleet scraped by a remote-writing
Prometheus routes exactly the series the range queries would have selected.
Unroutable series are REJECTED WITH A REASON (counted upstream), never
guessed at — an unknown label set must not poison a window.
"""

from __future__ import annotations

from typing import Union

#: The recording rule the reference's CPU query reads (PAPER.md layer 4).
CPU_METRIC = "node_namespace_pod_container:container_cpu_usage_seconds_total:sum_irate"
#: Working-set bytes straight from cadvisor (the memory query's selector).
MEM_METRIC = "container_memory_working_set_bytes"

#: Route: (resource "cpu"|"mem", namespace, pod, container).
Route = tuple[str, str, str, str]


def parse_labels(record: bytes) -> "dict[str, str] | None":
    """One decoder label record ('\\t'-joined alternating name/value fields)
    → a label dict, or None when malformed (odd field count, bad UTF-8)."""
    parts = record.split(b"\t")
    if len(parts) % 2:
        return None
    try:
        fields = [p.decode("utf-8") for p in parts]
    except UnicodeDecodeError:
        return None
    return dict(zip(fields[::2], fields[1::2]))


def route_record(record: bytes) -> Union[Route, str]:
    """Route one series' label record, or return the rejection reason —
    one of ``malformed_labels`` / ``unknown_metric`` / ``filtered`` /
    ``missing_labels`` (the ``reason`` label on the rejected-samples
    counter)."""
    labels = parse_labels(record)
    if labels is None:
        return "malformed_labels"
    name = labels.get("__name__", "")
    if name == CPU_METRIC:
        resource = "cpu"
    elif name == MEM_METRIC:
        # The memory query's selector: job="kubelet",
        # metrics_path="/metrics/cadvisor", image!="" — pause containers and
        # non-kubelet scrapes of the same metric must not fold.
        if (
            labels.get("job") != "kubelet"
            or labels.get("metrics_path") != "/metrics/cadvisor"
            or not labels.get("image")
        ):
            return "filtered"
        resource = "mem"
    else:
        return "unknown_metric"
    namespace = labels.get("namespace", "")
    pod = labels.get("pod", "")
    container = labels.get("container", "")
    if not (namespace and pod and container):
        return "missing_labels"
    return (resource, namespace, pod, container)
