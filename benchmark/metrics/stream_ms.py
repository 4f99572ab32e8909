"""stream_ms: the ``quantile`` stage span whose ``path`` is ``host_stream``,
a scan: the window streamed from host memory in time chunks, the folds on
the card, and the readback (``strategies/simple.py`` ``_run_streamed``)."""

import statistics

from benchmark.traced import Missing


def read(run):
    streamed = [[span.duration for span in spans
                 if span.name == "quantile" and span.attributes.get("path") == "host_stream"]
                for spans in run.spans]
    absent = [i for i, durations in enumerate(streamed) if not durations]
    if absent:
        raise Missing(f"no quantile span with path host_stream in scans {absent[:5]}")
    return 1000.0 * statistics.fmean(sum(durations) for durations in streamed)
