"""h2d_gbps: bytes copied host to device over the copies' device time,
from the profiler's trace."""

from benchmark.traced import Missing


def read(run):
    copies = [op for op in run.ops if op.category == "gpu_memcpy" and "HtoD" in op.name]
    if not copies or any(op.bytes is None for op in copies):
        raise Missing("no host-to-device copy with a byte count in the trace")
    return sum(op.bytes for op in copies) / sum(op.end - op.start for op in copies) / 1e9
