"""h2d_ms: the ``h2d`` stage spans a scan, summed over the resources: the
copies of the float32 values and int32 counts to the card, fenced."""


def read(run):
    return run.mean_span_ms("h2d")
