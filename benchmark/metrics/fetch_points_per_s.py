"""fetch_points_per_s: the samples a scan fetches over Prometheus (every
sample of every pod, both resources) over its fetch leg
(``Runner.stats["fetch_seconds"]``): the fetch layer's rate in samples a
second. ``krr_tpu_prom_points_total`` counts each query's grid points, not
its samples, so the count comes from the fleet."""

import statistics

from benchmark.traced import Missing


def read(run):
    if run.fetched_samples is None:
        raise Missing("the histories were not fetched over Prometheus")
    return run.fetched_samples / statistics.fmean(run.stat("fetch_seconds"))
