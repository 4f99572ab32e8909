"""On-demand debug dumps: SIGUSR2 writes the trace ring + metrics snapshot.

Port of `krr_tpu/obs/dump.py`. A wedged serve process (or a long scan that
is "taking forever") usually gets killed before anyone captures what it was
doing. SIGUSR2 turns that moment into artifacts instead: the handler writes
the tracer's completed-scan ring as Chrome trace-event JSON, the shared
registry as a Prometheus exposition snapshot (process self-metrics and build
info refreshed), and the ring's critical-path attribution report
(`krr_tpu_torch.obs.profile`) to TIMESTAMPED files — next to the configured
``--trace`` / ``--metrics-dump`` targets when set, the working directory
otherwise — and logs one structured line naming the paths. A process with a
scan flight recorder (serve) adds a fourth artifact: the timeline's records
with the sentinel's trend report over them.

Two installation flavours, one per execution mode: serve installs through
the event loop (``loop.add_signal_handler``; the dump itself runs in the
loop's default executor so a trend replay never stalls the loop), one-shot
scans through ``signal.signal`` (the handler runs in the main thread
between bytecodes; it only does Python-level file IO, which is safe there).
Neither calls into ``torch.cuda``. Platforms without SIGUSR2 are a no-op.
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
    timeline=None,
    sentinel=None,
) -> tuple[str, ...]:
    """Write the trace ring + a metrics exposition snapshot + the ring's
    critical-path attribution report — and, when the process carries a scan
    flight recorder (serve), a fourth artifact: the timeline's records with
    the sentinel trend report over them (`krr_tpu_torch.obs.sentinel` — the
    same JSON ``GET /debug/timeline`` serves). ``device`` labels the build
    info. Returns the written paths (three, or four with a timeline). Never
    raises past logging — a debug aid must not take down the process it is
    inspecting."""
    import json

    from krr_tpu_torch.obs.profile import write_profile_report

    stamp = time.strftime("%Y%m%dT%H%M%S", time.gmtime())
    trace_path = _dump_path(trace_target, "krr-tpu-trace", stamp, ".json")
    metrics_path = _dump_path(metrics_target, "krr-tpu-metrics", stamp, ".prom")
    profile_path = _dump_path(trace_target, "krr-tpu-profile", stamp, ".profile.json")
    paths = [trace_path, metrics_path, profile_path]
    trend_path = None
    if timeline is not None:
        trend_path = _dump_path(trace_target, "krr-tpu-trend", stamp, ".trend.json")
        paths.append(trend_path)
    try:
        write_chrome_trace(tracer, trace_path)
        refresh_process_metrics(metrics)
        record_build_info(metrics, device)
        metrics.inc("krr_tpu_debug_dumps_total")
        with open(metrics_path, "w") as f:
            f.write(metrics.render())
        write_profile_report(tracer, profile_path)
        if timeline is not None:
            from krr_tpu_torch.obs.sentinel import sentinel_knobs, trend_report

            records = timeline.records()
            with open(trend_path, "w") as f:
                json.dump(
                    {
                        "records": records,
                        "trend": trend_report(records, **sentinel_knobs(sentinel)),
                        "live": sentinel.status() if sentinel is not None else None,
                    },
                    f,
                    indent=2,
                )
                f.write("\n")
    except Exception:
        if logger is not None:
            logger.warning(f"debug dump failed ({' '.join(paths)})")
            logger.debug_exception()
        return tuple(paths)
    if logger is not None:
        logger.info(
            f"debug dump written: trace={trace_path} metrics={metrics_path} "
            f"profile={profile_path}"
            + (f" trend={trend_path}" if trend_path else "")
        )
    return tuple(paths)


def install_signal_dump(
    tracer: NullTracer,
    metrics: MetricsRegistry,
    *,
    device: str,
    trace_target: Optional[str] = None,
    metrics_target: Optional[str] = None,
    logger=None,
    loop=None,
    timeline=None,
    sentinel=None,
) -> bool:
    """Install the SIGUSR2 handler. With ``loop`` (serve) it registers on
    the event loop; without (one-shot scans) through ``signal.signal``.
    Serve passes its flight recorder + sentinel so the dump gains the trend
    artifact. Returns whether a handler was installed (False off-unix or
    off the main thread)."""
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
            timeline=timeline,
            sentinel=sentinel,
        )

    try:
        if loop is not None:
            # Off the loop: a trend replay over a full retained timeline is
            # real CPU (median/MAD over thousands of records) and the dump
            # handler must not stall /healthz probes or the scheduler.
            loop.add_signal_handler(
                signal.SIGUSR2, lambda: loop.run_in_executor(None, dump)
            )
        else:
            signal.signal(signal.SIGUSR2, dump)
    except (NotImplementedError, ValueError, OSError):
        # Non-unix event loops / non-main threads: a debug hook is optional.
        return False
    return True
