"""assemble_ms: the ``assemble`` span a scan: each object's result rounded
(``_round_result``) and built (``ResourceScan.calculate``), and the
``Result`` with its score."""


def read(run):
    return run.mean_span_ms("assemble")
