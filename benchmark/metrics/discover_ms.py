"""discover_ms: ``ScanSession.discover``'s wall a scan (``Runner.stats``)."""

import statistics


def read(run):
    return 1000.0 * statistics.fmean(run.stat("discover_seconds"))
