"""stream_copy_wait_ms: the ``stream_wait`` stage spans a scan, summed: the
host waiting for a pinned staging buffer's previous copy to the card before
it fills the buffer again (``ops/chunked.py`` ``HostChunkStreamer``)."""


def read(run):
    return run.mean_span_ms("stream_wait")
