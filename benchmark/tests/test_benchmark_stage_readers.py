"""The readers of the runner's ``assemble`` and ``render`` spans, the
device stage's ``cast`` and ``h2d`` spans (with their ``bytes``) and the
``pack`` span's ``minor_faults``, on hand-made scans."""

import pytest

from benchmark import spec, traced
from benchmark.harness import _reader
from benchmark.scan import ScanRecord

MIB = 2**20


class Span:
    def __init__(self, name, start, end, span_id, parent_id=None, **attributes):
        self.name, self.start, self.end, self.span_id, self.parent_id = name, start, end, span_id, parent_id
        self.attributes = attributes

    @property
    def duration(self):
        return self.end - self.start


def _scan_spans(offset, faults, resources=("cpu", "memory")):
    """One scan's trace: the root, compute with pack, a cast and an h2d
    stage per resource (0.25 s and 0.5 s each, 3 MiB and 1 MiB), quantile
    and round, then assemble and render under the root."""
    spans = [Span("scan", offset, offset + 9.0, 1), Span("compute", offset + 1.0, offset + 6.0, 2, 1),
             Span("pack", offset + 1.0, offset + 2.0, 3, 2, minor_faults=faults)]
    at, span_id = offset + 2.0, 4
    for resource, size in zip(resources, (3 * MIB, MIB)):
        spans.append(Span("cast", at, at + 0.25, span_id, 2, resource=resource, minor_faults=0))
        spans.append(Span("h2d", at + 0.25, at + 0.75, span_id + 1, 2, resource=resource, bytes=size, minor_faults=0))
        at, span_id = at + 0.75, span_id + 2
    spans += [Span("quantile", at, offset + 5.5, span_id, 2, path="resident"),
              Span("round", offset + 5.5, offset + 6.0, span_id + 1, 2),
              Span("assemble", offset + 6.0, offset + 7.5, span_id + 2, 1),
              Span("render", offset + 7.5, offset + 9.0 - 0.25 * offset / 10, span_id + 3, 1)]
    return spans


def _run(spans):
    scans = [ScanRecord(sample_set=i % 2, start=10.0 * i, end=10.0 * i + 9.0,
                        stats={"discover_seconds": 0.001, "fetch_seconds": 0.5, "compute_seconds": 5.0},
                        pad_waste_cpu=1.0, rendered="{}") for i in range(len(spans))]
    return traced.TracedRun(scans=scans, spans=spans, ops=[], window=(0.0, 10.0 * len(spans)),
                             containers=50, work_bytes=335)


def _read(name, run):
    return _reader(spec.load_cell("simple-14d-15m.uniform"), name)(run)


def test_the_stage_readers_on_hand_made_scans():
    run = _run([_scan_spans(0.0, 1_000), _scan_spans(10.0, 3_000)])
    assert _read("assemble_ms", run) == pytest.approx(1500.0)
    assert _read("render_ms", run) == pytest.approx(1375.0)  # 1.5 s, then 1.25 s
    assert _read("cast_ms", run) == pytest.approx(500.0)  # two resources a scan
    assert _read("h2d_ms", run) == pytest.approx(1000.0)
    assert _read("h2d_mib", run) == pytest.approx(4.0)
    assert _read("pack_minor_faults", run) == pytest.approx(2_000.0)


def test_the_h2d_bytes_sum_each_scans_spans():
    run = _run([_scan_spans(0.0, 5, resources=("cpu",)), _scan_spans(10.0, 5)])
    assert _read("h2d_mib", run) == pytest.approx((3.0 + 4.0) / 2)
    assert _read("cast_ms", run) == pytest.approx((250.0 + 500.0) / 2)


@pytest.mark.parametrize("name, absent", [
    ("assemble_ms", "assemble"), ("render_ms", "render"), ("cast_ms", "cast"), ("h2d_ms", "h2d"),
    ("h2d_mib", "h2d"), ("pack_minor_faults", "pack"),
])
def test_a_stage_reader_without_its_span_fails_loudly(name, absent):
    spans = [_scan_spans(0.0, 10), [s for s in _scan_spans(10.0, 10) if s.name != absent]]
    with pytest.raises(traced.Missing):
        _read(name, _run(spans))


@pytest.mark.parametrize("name, span, attribute", [("h2d_mib", "h2d", "bytes"),
                                                   ("pack_minor_faults", "pack", "minor_faults")])
def test_a_counter_reader_without_its_attribute_fails_loudly(name, span, attribute):
    spans = _scan_spans(0.0, 10)
    for s in spans:
        if s.name == span:
            del s.attributes[attribute]
    with pytest.raises(traced.Missing):
        _read(name, _run([spans]))
