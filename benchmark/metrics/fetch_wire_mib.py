"""fetch_wire_mib: ``krr_tpu_prom_wire_bytes_total`` a scan, summed over
its ``route`` labels, in MiB: the response bytes read off the transport,
compressed where the response was."""

import statistics

from benchmark.traced import Missing


def read(run):
    values = [record.wire_bytes for record in run.scans]
    if any(value is None for value in values):
        raise Missing("no krr_tpu_prom_wire_bytes_total counter: no range query read a byte")
    return statistics.fmean(values) / 2**20
