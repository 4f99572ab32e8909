"""On-demand debug dumps: SIGUSR2 writes the trace ring + metrics snapshot.

Port of the one-shot half of `krr_tpu/obs/dump.py`. A long scan that is
"taking forever" usually gets killed before anyone captures what it was
doing. SIGUSR2 turns that moment into artifacts instead: the handler writes
the tracer's completed-scan ring as Chrome trace-event JSON, the shared
registry as a Prometheus exposition snapshot (process self-metrics and
build info refreshed), and the ring's critical-path attribution report
(`krr_tpu_torch.obs.profile`) to TIMESTAMPED files — next to the configured
``--trace`` / ``--metrics-dump`` targets when set, the working directory
otherwise — and logs one structured line naming the paths.

One installation flavour: ``signal.signal`` (the handler runs in the main
thread between bytecodes; it only does Python-level file IO, which is safe
there, and never calls into ``torch.cuda``). The event-loop flavour and the
flight recorder's trend artifact come with the serve slice. Platforms
without SIGUSR2 are a no-op.
"""

from __future__ import annotations

import itertools
import os
import signal
import time
from typing import Optional

from krr_tpu_torch.obs.metrics import MetricsRegistry, record_build_info, refresh_process_metrics
from krr_tpu_torch.obs.trace import NullTracer, write_chrome_trace

#: Per-process dump sequence — two dumps inside one second must not
#: overwrite each other.
_SEQUENCE = itertools.count(1)


def _dump_path(target: Optional[str], stem: str, stamp: str, suffix: str) -> str:
    """``<target>.<stamp>-<n><suffix>`` next to the configured target, or
    ``<stem>.<stamp>-<n><suffix>`` in the working directory without one."""
    n = next(_SEQUENCE)
    if target:
        return os.path.join(
            os.path.dirname(os.path.abspath(target)),
            f"{os.path.basename(target)}.{stamp}-{n}{suffix}",
        )
    return f"{stem}.{stamp}-{n}{suffix}"


def debug_dump(
    tracer: NullTracer,
    metrics: MetricsRegistry,
    *,
    device: str,
    trace_target: Optional[str] = None,
    metrics_target: Optional[str] = None,
    logger=None,
) -> tuple[str, ...]:
    """Write the trace ring + a metrics exposition snapshot + the ring's
    critical-path attribution report; ``device`` labels the build info.
    Returns the three written paths. Never raises past logging — a debug
    aid must not take down the process it is inspecting."""
    from krr_tpu_torch.obs.profile import write_profile_report

    stamp = time.strftime("%Y%m%dT%H%M%S", time.gmtime())
    trace_path = _dump_path(trace_target, "krr-tpu-trace", stamp, ".json")
    metrics_path = _dump_path(metrics_target, "krr-tpu-metrics", stamp, ".prom")
    profile_path = _dump_path(trace_target, "krr-tpu-profile", stamp, ".profile.json")
    paths = (trace_path, metrics_path, profile_path)
    try:
        write_chrome_trace(tracer, trace_path)
        refresh_process_metrics(metrics)
        record_build_info(metrics, device)
        metrics.inc("krr_tpu_debug_dumps_total")
        with open(metrics_path, "w") as f:
            f.write(metrics.render())
        write_profile_report(tracer, profile_path)
    except Exception:
        if logger is not None:
            logger.warning(f"debug dump failed ({' '.join(paths)})")
            logger.debug_exception()
        return paths
    if logger is not None:
        logger.info(
            f"debug dump written: trace={trace_path} metrics={metrics_path} "
            f"profile={profile_path}"
        )
    return paths


def install_signal_dump(
    tracer: NullTracer,
    metrics: MetricsRegistry,
    *,
    device: str,
    trace_target: Optional[str] = None,
    metrics_target: Optional[str] = None,
    logger=None,
) -> bool:
    """Install the SIGUSR2 handler through ``signal.signal``. Returns
    whether a handler was installed (False off-unix or off the main
    thread)."""
    if not hasattr(signal, "SIGUSR2"):
        return False

    def dump(*_args) -> None:
        debug_dump(
            tracer,
            metrics,
            device=device,
            trace_target=trace_target,
            metrics_target=metrics_target,
            logger=logger,
        )

    try:
        signal.signal(signal.SIGUSR2, dump)
    except (ValueError, OSError):
        # Not the main thread: a debug hook is optional.
        return False
    return True
