"""pad_waste_pct: ``krr_tpu_pad_waste_pct{resource="cpu"}``, the share of
the packed CPU matrix that is padding, averaged over the scans."""

import statistics

from benchmark.traced import Missing


def read(run):
    values = [record.pad_waste_cpu for record in run.scans]
    if any(value is None for value in values):
        raise Missing('no krr_tpu_pad_waste_pct{resource="cpu"} gauge')
    return statistics.fmean(values)
