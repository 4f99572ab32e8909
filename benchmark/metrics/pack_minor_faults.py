"""pack_minor_faults: the ``minor_faults`` of a scan's ``pack`` stage span:
the process's minor page faults while the histories were packed (fresh
buffers faulted in page by page)."""

import statistics

from benchmark.traced import Missing


def read(run):
    run.span_seconds("pack")  # raises Missing for a scan without the span
    faults = [[span.attributes.get("minor_faults") for span in spans if span.name == "pack"] for spans in run.spans]
    if any(count is None for counts in faults for count in counts):
        raise Missing("a pack span without minor_faults")
    return statistics.fmean(sum(counts) for counts in faults)
