"""The reduction from spans and the profiler's trace to the per-layer
metrics, on hand-made records."""

import pytest

from benchmark import roofline, traced
from benchmark.harness import _reader
from benchmark.scan import ScanRecord
from benchmark import spec


class Span:
    def __init__(self, name, start, end, span_id, parent_id=None):
        self.name, self.start, self.end, self.span_id, self.parent_id = name, start, end, span_id, parent_id

    @property
    def duration(self):
        return self.end - self.start


def test_union_merges_and_clips():
    assert traced.union([(3, 5), (0, 2), (1, 2.5), (4, 9)], 0.5, 8) == [[0.5, 2.5], [3, 8]]
    merged = traced.union([(0, 1), (2, 3)], 0, 10)
    assert traced.covered(merged, 0.5, 2.5) == pytest.approx(1.0)
    assert traced.covered(merged, 5, 6) == 0.0


def test_idle_time_goes_to_the_deepest_host_span_open():
    host = [(0.0, 10.0, 0, "runner"), (1.0, 4.0, 2, "pack"), (4.0, 6.0, 2, "quantile"), (1.0, 7.0, 1, "compute")]
    busy = traced.union([(4.5, 5.5), (9.0, 9.5)], 0.0, 12.0)
    idle = traced.idle_by_label(host, busy, 0.0, 12.0)
    assert idle == pytest.approx({"runner": 1.0 + 3.0 - 0.5, "pack": 3.0, "quantile": 1.0, "compute": 1.0, "harness": 2.0})
    assert sum(idle.values()) + 1.5 == pytest.approx(12.0)


def test_device_ops_land_on_the_host_clock():
    events = [
        {"ph": "X", "cat": "user_annotation", "name": traced.SCAN_MARK, "ts": 1_000_000.0, "dur": 5.0},
        {"ph": "X", "cat": "user_annotation", "name": traced.SCAN_MARK, "ts": 3_000_000.0, "dur": 5.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD (Pageable -> Device)", "ts": 1_500_000.0,
         "dur": 100_000.0, "args": {"bytes": 800_000_000}},
        {"ph": "X", "cat": "kernel", "name": "void (anonymous namespace)::k<true>(float const*)",
         "ts": 1_600_000.0, "dur": 2_000.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 1_500_000.0, "dur": 10.0},
    ]
    ops = traced.device_ops(events, marks=[100.0, 102.0])
    assert [(op.category, round(op.start, 6)) for op in ops] == [("gpu_memcpy", 100.5), ("kernel", 100.6)]
    assert ops[0].bytes == 800_000_000 and ops[1].bytes is None
    assert traced.short_name(ops[1].name) == "k"
    assert traced.short_name("at::native::reduce_kernel") == "at::native::reduce_kernel"
    with pytest.raises(traced.Missing):
        traced.device_ops(events, marks=[100.0])


def test_roofline_counts_real_samples_counts_and_results():
    assert roofline.work_bytes(cpu_samples=1000, memory_samples=30, rows=10) == 4 * 1030 + 80 + 80
    assert roofline.share_pct(roofline.PEAK_BYTES_PER_S, 2.0) == pytest.approx(50.0)


def _run(spans, ops=(), pad=1.0):
    scans = [ScanRecord(sample_set=i % 2, start=10.0 * i, end=10.0 * i + 8.0,
                        stats={"discover_seconds": 0.001, "fetch_seconds": 0.5, "compute_seconds": 5.0},
                        pad_waste_cpu=pad, rendered="{}") for i in range(len(spans))]
    return traced.TracedRun(scans=scans, spans=spans, ops=list(ops), window=(0.0, 10.0 * len(spans)),
                             containers=50, work_bytes=335)


def _scan_spans(offset):
    return [Span("scan", offset + 0.1, offset + 6.0, 1), Span("compute", offset + 1.0, offset + 6.0, 2, 1),
            Span("pack", offset + 1.0, offset + 3.0, 3, 2), Span("quantile", offset + 3.0, offset + 5.0, 4, 2),
            Span("round", offset + 5.0, offset + 5.5, 5, 2)]


def _read(name, run):
    return _reader(spec.load_cell("simple-14d-15m.uniform"), name)(run)


def test_readers_on_hand_made_scans():
    ops = [traced.DeviceOp(3.5, 3.6, "gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 10**9),
           traced.DeviceOp(3.7, 3.8, "kernel", "k(float)", None),
           traced.DeviceOp(13.5, 13.6, "gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 10**9),
           traced.DeviceOp(13.7, 13.8, "kernel", "k(float)", None)]
    run = _run([_scan_spans(0.0), _scan_spans(10.0)], ops)
    assert _read("pack_ms", run) == pytest.approx(2000.0)
    assert _read("finalize_ms", run) == pytest.approx(500.0)
    assert _read("device_stage_ms", run) == pytest.approx(2500.0)
    assert _read("discover_ms", run) == pytest.approx(1.0)
    assert _read("post_compute_ms", run) == pytest.approx(2499.0)
    assert _read("pad_waste_pct", run) == pytest.approx(1.0)
    assert _read("h2d_gbps", run) == pytest.approx(10.0)
    assert _read("kernels_roofline", run) == pytest.approx(100 * 2 * 335 / roofline.PEAK_BYTES_PER_S / 0.2)
    assert _read("device_idle_pct", run) == pytest.approx(98.0)
    assert _read("scan_containers_per_s.host", run) == pytest.approx(2 * 50 / 20.0)
    breakdown = run.breakdown()
    assert {name for name, _ in breakdown["device_ops"]} == {"Memcpy HtoD (Pageable -> Device)", "k"}
    assert dict(breakdown["idle_gaps"])["pack"] == pytest.approx(4.0)
    assert len(breakdown["device_ops"]) <= 10 and len(breakdown["idle_gaps"]) <= 10


@pytest.mark.parametrize("name", ["pack_ms", "finalize_ms", "device_stage_ms", "pad_waste_pct", "h2d_gbps",
                                  "kernels_roofline", "device_idle_pct"])
def test_a_reader_with_nothing_to_read_fails_loudly(name):
    spans = [[s for s in _scan_spans(0.0) if s.name not in ("pack", "round")]]
    with pytest.raises(traced.Missing):
        _read(name, _run(spans, pad=None))
