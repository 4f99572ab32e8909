"""stream_kernels_roofline: the bytes the scans' reductions need
(``benchmark.roofline``) at the card's published bandwidth, over the device
time of every kernel the scans launched, whatever its name: read as
``kernels_roofline`` reads it, in the streamed cell."""

from benchmark import roofline
from benchmark.traced import Missing


def read(run):
    seconds = run.op_seconds("kernel")
    if seconds <= 0.0:
        raise Missing("no kernel in the trace")
    return roofline.share_pct(run.work_bytes * len(run.scans), seconds)
