"""fetch_ms: ``ScanSession.gather_fleet_history``'s wall a scan
(``Runner.stats``): the range queries, inflate, the native parse and the
routing of series back to containers."""

import statistics


def read(run):
    return 1000.0 * statistics.fmean(run.stat("fetch_seconds"))
