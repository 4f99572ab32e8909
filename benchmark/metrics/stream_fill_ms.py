"""stream_fill_ms: the ``stream_fill`` stage spans a scan, summed: each
chunk's host fill, the packed window's columns scaled and cast into a
pinned staging buffer (``ops/chunked.py`` ``HostChunkStreamer._fill``)."""


def read(run):
    return run.mean_span_ms("stream_fill")
