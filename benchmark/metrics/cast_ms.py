"""cast_ms: the ``cast`` stage spans a scan, summed over the resources:
the host scale of the packed matrix and its float32 copy
(``fleet_device_arrays``)."""


def read(run):
    return run.mean_span_ms("cast")
