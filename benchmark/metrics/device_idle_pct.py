"""device_idle_pct: the share of the window in which no kernel, copy or
set ran on the card (the union of their intervals in the profiler's
trace)."""

from benchmark.traced import Missing


def read(run):
    if not run.busy:
        raise Missing("no device operation in the window")
    return 100.0 * (1.0 - run.busy_seconds / run.window_seconds)
