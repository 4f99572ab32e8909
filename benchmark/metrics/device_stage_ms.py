"""device_stage_ms: the ``compute`` span less its ``pack`` and ``round``
stages, a scan: the host-to-device copies, the kernels and the readback
(the ``quantile`` stage, with ``digest`` where the strategy has one, and
the copies that precede them)."""

import statistics


def read(run):
    parts = zip(run.span_seconds("compute"), run.span_seconds("pack"), run.span_seconds("round"))
    return 1000.0 * statistics.fmean(compute - pack - rounding for compute, pack, rounding in parts)
