"""finalize_ms: the ``round`` stage span a scan: ``finalize_fleet``'s
Decimal conversion and memory buffer."""


def read(run):
    return run.mean_span_ms("round")
