"""pack_ms: the ``pack`` stage span a scan: the ragged histories packed
into the rectangular host matrices (``FleetBatch.packed``)."""


def read(run):
    return run.mean_span_ms("pack")
