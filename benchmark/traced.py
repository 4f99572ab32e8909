"""What a traced run (``--trace 1``) reads: the port's stage spans per
scan, the runner's stats, and the device's work from ``torch.profiler``'s
trace, placed on the host clock.

The profiler's clock is tied to the host's by a mark per scan (a
``record_function`` entered just before the scan's host time is taken).
Device work is the union of kernel, copy and set intervals. Idle time is
attributed to what the host was doing: the deepest port span open at that
moment (``pack``, ``digest``, ``quantile``, ``round``, ``compute``,
``discover``, ``fetch``), ``runner`` inside ``Runner.run`` but outside its
spans (assembly, render), or ``harness`` between scans.
"""

from __future__ import annotations

import bisect
import re
import statistics
from dataclasses import dataclass, field
from typing import Optional

#: Chrome trace categories of the card's own work.
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
#: The profiler mark entered around each scan.
SCAN_MARK = "benchmark.scan"


class Missing(Exception):
    """A reader found nothing to read (a span, gauge or trace record is
    absent): the metric is left out of the result line and named on
    standard error, never reported as 0."""


@dataclass(frozen=True)
class DeviceOp:
    start: float  # host clock, seconds
    end: float
    category: str
    name: str
    bytes: Optional[int]


def short_name(name: str) -> str:
    """A kernel's function name without its return type, namespace of its
    own file, template arguments and signature."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    return re.split(r"[<(]", name, maxsplit=1)[0]


def device_ops(events: list, marks: list) -> list[DeviceOp]:
    """The device's operations of a Chrome trace, on the host clock.
    ``marks`` are the host times at which each scan's profiler mark was
    entered; the offset between the two clocks is their median gap."""
    starts = sorted(float(e["ts"]) for e in events if e.get("name") == SCAN_MARK and e.get("ph") == "X")
    if len(starts) != len(marks):
        raise Missing(f"{len(starts)} scan marks in the trace, {len(marks)} scans")
    offset = statistics.median(ts / 1e6 - mark for ts, mark in zip(starts, marks))
    ops = []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATEGORIES or "dur" not in e:
            continue
        start = float(e["ts"]) / 1e6 - offset
        size = (e.get("args") or {}).get("bytes")
        ops.append(DeviceOp(start, start + float(e["dur"]) / 1e6, e["cat"], e.get("name", ""),
                            None if size is None else int(size)))
    return sorted(ops, key=lambda op: op.start)


def union(intervals: list, low: float, high: float) -> list:
    """Merged intervals, clipped to [low, high]."""
    merged: list = []
    for start, end in sorted(intervals):
        start, end = max(start, low), min(end, high)
        if end <= start:
            continue
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return merged


def covered(merged: list, low: float, high: float) -> float:
    """Length of [low, high] that ``merged`` (sorted, disjoint) covers."""
    total = 0.0
    i = max(0, bisect.bisect_right([s for s, _ in merged], low) - 1)
    while i < len(merged) and merged[i][0] < high:
        total += max(0.0, min(high, merged[i][1]) - max(low, merged[i][0]))
        i += 1
    return total


def idle_by_label(host: list, busy: list, low: float, high: float) -> dict:
    """Idle device seconds in [low, high] by the deepest host interval open
    then: ``host`` holds (start, end, depth, label); ``busy`` is merged.
    Time under no host interval is ``harness``'s."""
    points = sorted({low, high, *(t for s, e, _d, _l in host for t in (s, e) if low < t < high)})
    idle: dict = {}
    for a, b in zip(points, points[1:]):
        middle = (a + b) / 2
        label, depth = "harness", -1
        for s, e, d, name in host:
            if s <= middle < e and d > depth:
                label, depth = name, d
        gap = (b - a) - covered(busy, a, b)
        if gap > 0:
            idle[label] = idle.get(label, 0.0) + gap
    return idle


def host_intervals(scan_spans: list, scan_bounds: list) -> list:
    """(start, end, depth, label) of each scan's ``Runner.run`` (``runner``)
    and of its port spans, nested by their parents; the root ``scan`` span
    reads as ``runner``."""
    out = []
    for spans, (start, end) in zip(scan_spans, scan_bounds):
        out.append((start, end, 0, "runner"))
        by_id = {span.span_id: span for span in spans}
        for span in spans:
            depth, parent = 1, span.parent_id
            while parent is not None and parent in by_id:
                depth, parent = depth + 1, by_id[parent].parent_id
            out.append((span.start, span.end, depth, "runner" if span.parent_id is None else span.name))
    return out


@dataclass
class TracedRun:
    """Everything the per-layer readers see (``benchmark/metrics/*.py``)."""

    scans: list  # ScanRecord per scan of the window
    spans: list  # per scan: the port's spans of its trace
    ops: list  # DeviceOp on the host clock
    window: tuple  # (start, end) of the window on the host clock
    containers: int  # containers a scan right-sizes
    work_bytes: int  # bytes one scan's reductions need (benchmark.roofline)
    fetched_samples: Optional[int] = None  # samples a scan fetches over Prometheus (None: injected)
    busy: list = field(default_factory=list)

    def __post_init__(self) -> None:
        self.busy = union([(op.start, op.end) for op in self.ops], *self.window)

    def stat(self, key: str) -> list:
        values = [record.stats.get(key) for record in self.scans]
        if any(value is None for value in values):
            raise Missing(f"Runner.stats has no {key!r}")
        return values

    def span_seconds(self, name: str) -> list:
        """Per scan, the summed duration of its spans called ``name``."""
        totals = [sum(span.duration for span in spans if span.name == name) for spans in self.spans]
        absent = [i for i, spans in enumerate(self.spans) if not any(span.name == name for span in spans)]
        if absent:
            raise Missing(f"no {name!r} span in scans {absent[:5]}")
        return totals

    def mean_span_ms(self, name: str) -> float:
        return 1000.0 * statistics.fmean(self.span_seconds(name))

    @property
    def window_seconds(self) -> float:
        return self.window[1] - self.window[0]

    @property
    def busy_seconds(self) -> float:
        return sum(end - start for start, end in self.busy)

    def op_seconds(self, category: str) -> float:
        return sum(op.end - op.start for op in self.ops if op.category == category)

    def breakdown(self, entries: int = 10) -> dict:
        """The device operations that took most time, and idle time by what
        the host was doing, each the ``entries`` largest."""
        by_name: dict = {}
        for op in self.ops:
            if self.window[0] <= op.start < self.window[1]:
                name = short_name(op.name) if op.category == "kernel" else op.name
                by_name[name] = by_name.get(name, 0.0) + (op.end - op.start)
        bounds = [(record.start, record.end) for record in self.scans]
        idle = idle_by_label(host_intervals(self.spans, bounds), self.busy, *self.window)
        top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:entries]]
        return {"device_ops": top(by_name), "idle_gaps": top(idle)}
