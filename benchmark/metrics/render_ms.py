"""render_ms: the ``render`` span a scan: ``Result.format`` (the JSON of
every object) and ``print_result``."""


def read(run):
    return run.mean_span_ms("render")
