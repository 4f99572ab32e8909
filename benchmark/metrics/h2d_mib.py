"""h2d_mib: the ``bytes`` of a scan's ``h2d`` stage spans, summed over the
resources, in MiB: the value and count tensors copied to the card."""

import statistics

from benchmark.traced import Missing


def read(run):
    run.span_seconds("h2d")  # raises Missing for a scan without the span
    copies = [[span.attributes.get("bytes") for span in spans if span.name == "h2d"] for spans in run.spans]
    if any(size is None for sizes in copies for size in sizes):
        raise Missing("an h2d span without bytes")
    return statistics.fmean(sum(sizes) for sizes in copies) / 2**20
