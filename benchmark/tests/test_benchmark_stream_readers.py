"""The readers of the host stream's spans (``quantile`` on the
``host_stream`` path, ``stream_fill``, ``stream_wait``), of its pinned
copies and of its kernels, on hand-made scans, with and without what they
read."""

import pytest

from benchmark import roofline, spec, traced
from benchmark.harness import _reader
from benchmark.scan import ScanRecord

PINNED = "Memcpy HtoD (Pinned -> Device)"
PAGEABLE = "Memcpy HtoD (Pageable -> Device)"


class Span:
    def __init__(self, name, start, end, span_id, parent_id=None, **attributes):
        self.name, self.start, self.end, self.span_id, self.parent_id = name, start, end, span_id, parent_id
        self.attributes = attributes

    @property
    def duration(self):
        return self.end - self.start


def _scan_spans(offset, path="host_stream", chunks=3):
    """One scan's trace: compute with pack, the quantile stage (2 s) holding
    a 0.1 s fill a chunk and a 0.05 s wait before each fill but the first
    two, then round."""
    spans = [Span("scan", offset, offset + 9.0, 1), Span("compute", offset + 1.0, offset + 6.0, 2, 1),
             Span("pack", offset + 1.0, offset + 3.0, 3, 2),
             Span("quantile", offset + 3.0, offset + 5.0, 4, 2, path=path)]
    at, span_id = offset + 3.0, 5
    for i in range(chunks):
        if i >= 2:
            spans.append(Span("stream_wait", at, at + 0.05, span_id, 4))
            at, span_id = at + 0.05, span_id + 1
        spans.append(Span("stream_fill", at, at + 0.1, span_id, 4, bytes=1000, minor_faults=0))
        at, span_id = at + 0.1, span_id + 1
    spans.append(Span("round", offset + 5.0, offset + 5.5, span_id, 2))
    return spans


def _run(spans, ops=()):
    scans = [ScanRecord(sample_set=i % 2, start=10.0 * i, end=10.0 * i + 9.0,
                        stats={"discover_seconds": 0.001, "fetch_seconds": 0.5, "compute_seconds": 5.0},
                        pad_waste_cpu=0.05, rendered="{}") for i in range(len(spans))]
    return traced.TracedRun(scans=scans, spans=spans, ops=list(ops), window=(0.0, 10.0 * len(spans)),
                             containers=50, work_bytes=335)


def _read(name, run):
    return _reader(spec.load_cell("simple-30d-1m.streamed"), name)(run)


def _ops():
    return [traced.DeviceOp(3.1, 3.2, "gpu_memcpy", PINNED, 2 * 10**9),
            traced.DeviceOp(3.2, 3.25, "gpu_memcpy", PAGEABLE, 10**9),
            traced.DeviceOp(3.3, 3.4, "gpu_memcpy", PINNED, 10**9),
            traced.DeviceOp(3.4, 3.45, "kernel", "void topk_select_kernel<1408>(float const*)", None),
            traced.DeviceOp(13.1, 13.2, "gpu_memcpy", PINNED, 10**9),
            traced.DeviceOp(13.4, 13.45, "kernel", "row_max_kernel(float const*)", None)]


def test_the_stream_readers_on_hand_made_scans():
    run = _run([_scan_spans(0.0, chunks=3), _scan_spans(10.0, chunks=5)], _ops())
    assert _read("stream_ms", run) == pytest.approx(2000.0)
    assert _read("stream_fill_ms", run) == pytest.approx((300.0 + 500.0) / 2)
    assert _read("stream_copy_wait_ms", run) == pytest.approx((50.0 + 150.0) / 2)
    assert _read("stream_h2d_gbps", run) == pytest.approx(4 * 10**9 / 0.3 / 1e9)  # the pinned copies alone
    assert _read("stream_kernels_roofline", run) == pytest.approx(100 * 2 * 335 / roofline.PEAK_BYTES_PER_S / 0.1)
    assert _read("stream_kernels_roofline", run) == _read("kernels_roofline", run)


def test_stream_ms_reads_only_the_host_stream_path():
    run = _run([_scan_spans(0.0), _scan_spans(10.0, path="resident")])
    with pytest.raises(traced.Missing):
        _read("stream_ms", run)


@pytest.mark.parametrize("name, absent", [("stream_ms", "quantile"), ("stream_fill_ms", "stream_fill"),
                                          ("stream_copy_wait_ms", "stream_wait")])
def test_a_stream_span_reader_without_its_span_fails_loudly(name, absent):
    spans = [_scan_spans(0.0), [s for s in _scan_spans(10.0) if s.name != absent]]
    with pytest.raises(traced.Missing):
        _read(name, _run(spans, _ops()))


@pytest.mark.parametrize("name, ops", [
    ("stream_h2d_gbps", []),
    ("stream_h2d_gbps", [traced.DeviceOp(3.1, 3.2, "gpu_memcpy", PAGEABLE, 10**9)]),
    ("stream_h2d_gbps", [traced.DeviceOp(3.1, 3.2, "gpu_memcpy", PINNED, None)]),
    ("stream_kernels_roofline", []),
    ("stream_kernels_roofline", [traced.DeviceOp(3.1, 3.2, "gpu_memcpy", PINNED, 10**9)]),
])
def test_a_device_reader_without_its_copies_or_kernels_fails_loudly(name, ops):
    with pytest.raises(traced.Missing):
        _read(name, _run([_scan_spans(0.0)], ops))
