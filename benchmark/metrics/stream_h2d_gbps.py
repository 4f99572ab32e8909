"""stream_h2d_gbps: the bytes of the host-to-device copies from pinned
memory (the streamed chunks) over their device time, from the profiler's
trace."""

from benchmark.traced import Missing


def read(run):
    copies = [op for op in run.ops if op.category == "gpu_memcpy" and "HtoD" in op.name and "Pinned" in op.name]
    if not copies or any(op.bytes is None for op in copies):
        raise Missing("no host-to-device copy from pinned memory with a byte count in the trace")
    return sum(op.bytes for op in copies) / sum(op.end - op.start for op in copies) / 1e9
