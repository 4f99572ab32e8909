"""post_compute_ms: a scan's ``Runner.run`` wall less its discover, fetch
and compute legs (``Runner.stats``): result assembly (rounding,
``ResourceScan.calculate``, the score) and the JSON render and write."""

import statistics


def read(run):
    legs = zip(run.stat("discover_seconds"), run.stat("fetch_seconds"), run.stat("compute_seconds"))
    return 1000.0 * statistics.fmean(
        (record.end - record.start) - sum(parts) for record, parts in zip(run.scans, legs)
    )
