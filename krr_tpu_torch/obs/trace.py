"""Dependency-free hierarchical tracing: spans, a bounded trace ring, and
Chrome trace-event export.

A copy of the single-process part of `krr_tpu/obs/trace.py`. One scan is one
TRACE: a root ``scan`` span plus children following the taxonomy
``scan → discover → fetch(cluster=…) → compute`` (the per-query Prometheus
spans from `krr_tpu_torch.integrations.prometheus` nest under their
``fetch``). The root span's ``trace_id`` doubles as the **scan id**
(:func:`current_ids`).

Propagation rides a module-level :mod:`contextvars` variable, so parentage
follows the asyncio task tree AND ``asyncio.to_thread`` hops for free
(both copy the caller's context) — concurrent fetch tasks each see their
own current span with zero locking on the hot path. Completed spans buffer
per trace; when the ROOT completes, the whole trace moves into a bounded
ring (``ring_scans`` traces, oldest evicted) that ``--trace FILE`` exports
as Chrome trace-event JSON — loadable in ``chrome://tracing`` and Perfetto.

:func:`traces_from_chrome` reads such an export back into spans (the
``analyze`` command's input). Cross-process stitching, as in the JAX
package: any ROOT span may carry ``remote_trace_id``/``remote_parent``/
``remote_node`` attributes naming the span in ANOTHER process that caused
it; :func:`propagation_context` builds the wire form of that link,
:func:`link_remote_parent` applies it, and :func:`stitch_chrome` merges
several processes' Chrome exports (``analyze --stitch``) into ONE trace:
remote links union traces into connected components, every source process
keeps its own lane block, and timestamps rebase onto the shared
``wall_start`` wall clock. A tracer may carry a ``node`` identity (serve
stamps ``"serve"``) that names its lanes in the export.

Cost discipline: the default for every scan path is :data:`NULL_TRACER`,
whose ``span()`` returns one shared no-op context manager — no allocation,
no contextvar touch, no lock — so tracing is near-free when disabled. A
real tracer takes one lock acquisition per span *completion* (never
per-sample or per-row work), and each trace caps at
``max_spans_per_trace`` spans (beyond it spans are counted, not stored, and
the root gains a ``dropped_spans`` attribute) so a pathological fan-out
can't grow host memory unbounded. Each span a real tracer activates
(``span()``) also opens a ``torch.profiler.record_function`` range named
``krr.<span name>``, so a ``torch.profiler`` trace holds the program's own
spans on the profiler's clock; ``start_span`` leaves (queries whose open
and close may lie in different tasks) open none.
"""

from __future__ import annotations

import contextvars
import itertools
import sys
import threading
import time
from collections import deque
from typing import Any, Optional

#: The active span. Module-level so structured logging can stamp
#: scan_id/span_id without holding a tracer reference.
_CURRENT: contextvars.ContextVar[Optional["Span"]] = contextvars.ContextVar(
    "krr_tpu_current_span", default=None
)

_TRACE_IDS = itertools.count(1)
_SPAN_IDS = itertools.count(1)


def current_ids() -> "tuple[Optional[str], Optional[str]]":
    """(scan_id, span_id) of the active span, or (None, None) — the hook
    structured log lines use to correlate with traces."""
    span = _CURRENT.get()
    if span is None:
        return None, None
    return span.trace_id, f"{span.span_id:x}"


def _new_trace_id() -> str:
    # Monotonic per process + a time component so ids from restarts don't
    # collide in aggregated logs; cheap and dependency-free.
    return f"scan-{int(time.time()):x}-{next(_TRACE_IDS)}"


class Span:
    """One timed operation. ``start``/``end`` are perf_counter seconds
    relative to the owning tracer's epoch (see ``Tracer.wall_of``)."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "start", "end", "attributes")

    def __init__(self, name: str, trace_id: str, parent_id: Optional[int], attributes: dict):
        self.name = name
        self.trace_id = trace_id
        self.span_id = next(_SPAN_IDS)
        self.parent_id = parent_id
        self.start = 0.0
        self.end = 0.0
        self.attributes = attributes

    def set(self, **attributes: Any) -> None:
        """Attach/overwrite attributes mid-flight (retries, points, bytes…)."""
        self.attributes.update(attributes)

    @property
    def duration(self) -> float:
        return max(0.0, self.end - self.start)


def _profiler_range(name: str):
    """A ``torch.profiler.record_function`` range named ``krr.<name>``, so a
    profiler running around the span (the benchmark's ``--trace 1``, a
    strategy's ``profile_dir``) holds the span on its own clock, with the
    kernels and copies launched inside correlated to it. None when torch is
    not loaded: no profiler can then be running, and this module imports
    without torch."""
    torch = sys.modules.get("torch")
    if torch is None:
        return None
    return torch.profiler.record_function(f"krr.{name}")


class _SpanContext:
    """Context manager activating a span: sets the contextvar on enter (so
    children and log lines see it) and opens its profiler range
    (:func:`_profiler_range`), records + deactivates on exit."""

    __slots__ = ("_tracer", "span", "_token", "_range")

    def __init__(self, tracer: "Tracer", span: Span):
        self._tracer = tracer
        self.span = span
        self._token: Optional[contextvars.Token] = None
        self._range = None

    def __enter__(self) -> Span:
        self._token = _CURRENT.set(self.span)
        self._range = _profiler_range(self.span.name)
        if self._range is not None:
            self._range.__enter__()
        self.span.start = time.perf_counter()
        return self.span

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.span.end = time.perf_counter()
        if self._range is not None:
            self._range.__exit__(exc_type, exc, tb)
        if self._token is not None:
            _CURRENT.reset(self._token)
        if exc is not None:
            self.span.attributes.setdefault("error", f"{type(exc).__name__}: {exc}"[:200])
        self._tracer._record(self.span)
        return False


class _NullSpan:
    """The shared no-op span/context: every disabled-path call lands here."""

    __slots__ = ()
    trace_id = None
    span_id = None
    parent_id = None
    name = ""
    start = end = duration = 0.0

    def set(self, **attributes: Any) -> None:
        pass

    @property
    def attributes(self) -> dict:
        return {}

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False


_NULL_SPAN = _NullSpan()


class NullTracer:
    """No-op tracer — the default on every scan path. ``span()`` returns one
    shared singleton: no allocation, no contextvar write, no lock."""

    enabled = False

    def span(self, name: str, **attributes: Any) -> _NullSpan:
        return _NULL_SPAN

    def start_span(self, name: str, **attributes: Any) -> _NullSpan:
        return _NULL_SPAN

    def finish_span(self, span: Any) -> None:
        pass

    def traces(self, n: Optional[int] = None) -> "list[list[Span]]":
        return []

    def export_chrome(self, n: Optional[int] = None) -> dict:
        return {"traceEvents": [], "displayTimeUnit": "ms"}

    def discard(self, trace_id: Optional[str]) -> None:
        pass


NULL_TRACER = NullTracer()


class Tracer(NullTracer):
    """Recording tracer: bounded ring of completed scan traces."""

    enabled = True

    def __init__(
        self,
        ring_scans: int = 16,
        max_spans_per_trace: int = 4096,
        node: Optional[str] = None,
    ):
        #: perf_counter↔wall anchors taken together, so exported timestamps
        #: can be mapped to wall time.
        self.epoch_perf = time.perf_counter()
        self.epoch_wall = time.time()
        #: Process identity stamped onto exported events ("serve") — what
        #: `stitch_chrome` names lanes by.
        self.node = node
        self._ring: "deque[list[Span]]" = deque(maxlen=max(1, ring_scans))
        self._open: dict[str, list[Span]] = {}
        self._dropped: dict[str, int] = {}
        #: Trace ids already flushed (ringed or discarded) → count of spans
        #: that arrived AFTER the flush. An aborted scan can leave orphaned
        #: fetch tasks whose spans complete after the root closed; without
        #: this ledger `_record` would resurrect the trace as a permanently
        #: open entry — a slow leak in a long-lived process. Bounded FIFO.
        self._flushed: dict[str, int] = {}
        self._max_spans = max(1, max_spans_per_trace)
        self._lock = threading.Lock()

    # ------------------------------------------------------------- creation
    def span(self, name: str, *, scan_id: Optional[str] = None, **attributes: Any) -> _SpanContext:
        """A span activated for the ``with`` body: children created inside
        (same task, child tasks, ``to_thread`` hops) parent to it. A span
        opened with no active parent is a ROOT — it starts a new trace whose
        id is ``scan_id`` (or a generated one); ``scan_id`` is ignored on
        non-root spans."""
        return _SpanContext(self, self._make(name, scan_id, attributes))

    def start_span(self, name: str, *, scan_id: Optional[str] = None, **attributes: Any) -> Span:
        """A span that is timed but NOT activated (nothing nests under it) —
        for leaf work and code shapes where a ``with`` block can't bracket
        the operation (async generators). Pair with :meth:`finish_span`."""
        span = self._make(name, scan_id, attributes)
        span.start = time.perf_counter()
        return span

    def finish_span(self, span: Span) -> None:
        span.end = time.perf_counter()
        self._record(span)

    def _make(self, name: str, scan_id: Optional[str], attributes: dict) -> Span:
        parent = _CURRENT.get()
        if parent is not None:
            return Span(name, parent.trace_id, parent.span_id, attributes)
        return Span(name, scan_id or _new_trace_id(), None, attributes)

    # ------------------------------------------------------------ recording
    def _record(self, span: Span) -> None:
        with self._lock:
            if span.parent_id is not None and span.trace_id in self._flushed:
                # A straggler from an already-flushed trace (e.g. a fetch
                # task the aborted scan never awaited): count it, don't
                # reopen the trace.
                self._flushed[span.trace_id] += 1
                return
            spans = self._open.setdefault(span.trace_id, [])
            if len(spans) >= self._max_spans and span.parent_id is not None:
                self._dropped[span.trace_id] = self._dropped.get(span.trace_id, 0) + 1
            else:
                spans.append(span)
            if span.parent_id is None:
                # Root closed: the trace is complete (children exit before
                # their parent's ``with`` block does) — move it to the ring.
                dropped = self._dropped.pop(span.trace_id, 0)
                if dropped:
                    span.attributes["dropped_spans"] = dropped
                self._ring.append(self._open.pop(span.trace_id))
                self._mark_flushed(span.trace_id)

    def _mark_flushed(self, trace_id: str) -> None:
        """Remember (bounded) that a trace id is done, so stragglers can be
        dropped instead of reopening it. Holds the lock's caller."""
        self._flushed[trace_id] = 0
        while len(self._flushed) > 4 * (self._ring.maxlen or 1):
            self._flushed.pop(next(iter(self._flushed)))

    def discard(self, trace_id: Optional[str]) -> None:
        """Drop a trace — open OR already ringed — by id (a scheduler tick
        that turned out to be a no-op shouldn't evict a real scan from the
        ring)."""
        if trace_id is None:
            return
        with self._lock:
            self._open.pop(trace_id, None)
            self._dropped.pop(trace_id, None)
            self._mark_flushed(trace_id)
            for i in range(len(self._ring) - 1, -1, -1):
                if self._ring[i] and self._ring[i][0].trace_id == trace_id:
                    del self._ring[i]
                    break

    # -------------------------------------------------------------- reading
    def traces(self, n: Optional[int] = None) -> "list[list[Span]]":
        """The newest ``n`` completed traces (all, when n is None), oldest
        first; each is the trace's spans in completion order."""
        with self._lock:
            snapshot = list(self._ring)
        if n is not None and n > 0:
            snapshot = snapshot[-n:]
        return snapshot

    def wall_of(self, span: Span) -> float:
        """Wall-clock unix time of a span's start."""
        return self.epoch_wall + (span.start - self.epoch_perf)

    def export_chrome(self, n: Optional[int] = None) -> dict:
        """Chrome trace-event JSON (the ``chrome://tracing`` / Perfetto
        format): one process per scan trace, complete ("X") events in
        microseconds since the tracer epoch, span/parent ids under ``args``.
        Concurrent sibling spans are laid out onto separate ``tid`` lanes by
        a greedy interval fit so viewers render true nesting instead of
        stacking overlapping slices."""
        events: list[dict] = []
        for pid, spans in enumerate(self.traces(n), start=1):
            if not spans:
                continue
            process_name = (
                f"{self.node}:{spans[0].trace_id}" if self.node else f"{spans[0].trace_id}"
            )
            events.append(
                {
                    "ph": "M",
                    "pid": pid,
                    "name": "process_name",
                    "args": {"name": process_name},
                }
            )
            # Lane layout: spans sorted by (start, -end) take the first lane
            # whose innermost open interval CONTAINS them (true nesting);
            # anything else (an overlapping sibling) opens a new lane.
            lanes: list[list[Span]] = []
            order = sorted(spans, key=lambda s: (s.start, -s.end))
            assigned: dict[int, int] = {}
            for span in order:
                tid = None
                for lane_index, stack in enumerate(lanes):
                    while stack and stack[-1].end <= span.start:
                        stack.pop()
                    if not stack or (stack[-1].start <= span.start and stack[-1].end >= span.end):
                        tid = lane_index
                        stack.append(span)
                        break
                if tid is None:
                    lanes.append([span])
                    tid = len(lanes) - 1
                assigned[span.span_id] = tid
            for span in spans:
                args = {
                    "trace_id": span.trace_id,
                    "span_id": f"{span.span_id:x}",
                    "parent_id": f"{span.parent_id:x}" if span.parent_id else None,
                    "wall_start": round(self.wall_of(span), 6),
                }
                if self.node:
                    args["node"] = self.node
                args.update(span.attributes)
                events.append(
                    {
                        "name": span.name,
                        "cat": "scan",
                        "ph": "X",
                        "ts": round((span.start - self.epoch_perf) * 1e6, 3),
                        "dur": round(span.duration * 1e6, 3),
                        "pid": pid,
                        "tid": assigned[span.span_id],
                        "args": args,
                    }
                )
        return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_chrome_trace(tracer: NullTracer, path: str) -> None:
    """Dump the tracer's ring as Chrome trace JSON (the ``--trace FILE``
    exit hook; safe on a NullTracer — writes an empty trace)."""
    import json

    with open(path, "w") as f:
        json.dump(tracer.export_chrome(), f)
        f.write("\n")


def traces_from_chrome(payload: dict) -> "list[list[Span]]":
    """Rebuild per-scan span lists from Chrome trace-event JSON previously
    produced by :meth:`Tracer.export_chrome` — the inverse the offline
    analysis path (``analyze --trace FILE``,
    `krr_tpu_torch.obs.profile`) rides. Only complete (``"X"``) events are
    considered; ``ts``/``dur`` come back as seconds relative to the
    exporting tracer's epoch, and the ``args`` ids/attributes are restored
    onto :class:`Span` objects. Foreign trace JSON without the exporter's
    ``args`` degrades gracefully: spans still carry name/start/end, grouped
    by ``pid``."""
    by_trace: dict[tuple, list[Span]] = {}
    for event in payload.get("traceEvents", ()):
        if event.get("ph") != "X":
            continue
        args = dict(event.get("args") or {})
        trace_id = args.pop("trace_id", None) or f"pid-{event.get('pid', 0)}"
        span_id = args.pop("span_id", None)
        parent_id = args.pop("parent_id", None)
        args.pop("wall_start", None)
        span = Span(str(event.get("name", "")), str(trace_id), None, args)
        try:
            span.span_id = int(span_id, 16)
        except (TypeError, ValueError):
            pass  # keep the freshly-allocated id
        try:
            span.parent_id = int(parent_id, 16) if parent_id else None
        except (TypeError, ValueError):
            span.parent_id = None
        span.start = float(event.get("ts", 0.0)) / 1e6
        span.end = span.start + float(event.get("dur", 0.0)) / 1e6
        by_trace.setdefault((event.get("pid", 0), str(trace_id)), []).append(span)
    return [spans for _key, spans in sorted(by_trace.items(), key=lambda kv: kv[0][0])]


# --------------------------------------------------- cross-process stitching
def propagation_context(span, node: Optional[str] = None) -> "Optional[dict]":
    """The wire form of a trace link: ``{trace_id, span_id[, node]}`` for a
    live span, carried in a KRRFED1 record's ``extra`` metadata (DELTA) or
    the epoch feed's meta JSON (EPOCH) so the receiving process can join its
    work to this span as a remote child. None for a null span (tracing
    disabled) — the link simply doesn't ride the wire."""
    if getattr(span, "trace_id", None) is None:
        return None
    ctx = {"trace_id": span.trace_id, "span_id": f"{span.span_id:x}"}
    if node:
        ctx["node"] = node
    return ctx


def link_remote_parent(span, ctx: "Optional[dict]") -> None:
    """Stamp a received propagation context onto a span as remote-parent
    attributes. The span's LOCAL parentage is untouched (``parent_id`` stays
    within its own process trace, preserving the root-close ring invariant);
    the ``remote_*`` attributes are what `stitch_chrome` re-parents by."""
    if not ctx or not isinstance(ctx, dict) or not ctx.get("trace_id"):
        return
    span.set(
        remote_trace_id=str(ctx["trace_id"]),
        remote_parent=str(ctx.get("span_id") or ""),
        remote_node=str(ctx.get("node") or ""),
    )


def stitch_chrome(payloads: "list[dict]") -> dict:
    """Merge Chrome trace exports from MULTIPLE processes (shards,
    aggregator, replicas — each payload one ``/debug/trace`` body or
    ``--trace`` file) into ONE stitched trace:

    * remote links (``remote_trace_id`` on a span joining another process's
      trace) union traces into connected components — each component
      becomes one stitched Chrome process, so a shard tick, the aggregator
      apply it fed, and the replica installs it produced render as one
      causally-joined trace;
    * every source process keeps its own block of ``tid`` lanes (offset so
      lanes from different processes NEVER overlap), labeled with the
      exporter's ``node`` identity;
    * timestamps rebase onto the shared wall clock (each event's
      ``wall_start``) relative to the component's earliest span, so
      cross-process ordering is honest even though each tracer had its own
      perf_counter epoch;
    * a root span carrying ``remote_parent`` is re-parented under the named
      remote span (``args.parent_id`` gains the stitched id, ``args.remote``
      marks the hop), so viewers and `traces_from_chrome` see the join.
    """
    parent: dict[str, str] = {}

    def find(x: str) -> str:
        while parent.setdefault(x, x) != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    def union(a: str, b: str) -> None:
        parent[find(a)] = find(b)

    #: (source index, source pid) → one exported process's events + identity.
    groups: dict[tuple, dict] = {}
    owner_of_trace: dict[str, tuple] = {}
    for source, payload in enumerate(payloads):
        for event in (payload or {}).get("traceEvents", ()):
            if event.get("ph") != "X":
                continue
            args = event.get("args") or {}
            key = (source, event.get("pid", 0))
            group = groups.setdefault(
                key, {"events": [], "trace_ids": set(), "node": None, "min_wall": None}
            )
            group["events"].append(event)
            trace_id = str(args.get("trace_id") or f"src{source}-pid{event.get('pid', 0)}")
            group["trace_ids"].add(trace_id)
            owner_of_trace.setdefault(trace_id, key)
            if group["node"] is None and args.get("node"):
                group["node"] = str(args["node"])
            find(trace_id)
            remote = args.get("remote_trace_id")
            if remote:
                union(trace_id, str(remote))
            wall = args.get("wall_start")
            if wall is not None:
                wall = float(wall)
                if group["min_wall"] is None or wall < group["min_wall"]:
                    group["min_wall"] = wall

    components: dict[str, list[tuple]] = {}
    for key, group in groups.items():
        root = find(next(iter(sorted(group["trace_ids"]))))
        components.setdefault(root, []).append(key)

    def group_start(key: tuple) -> tuple:
        group = groups[key]
        wall = group["min_wall"] if group["min_wall"] is not None else float("inf")
        return (wall, key)

    events: list[dict] = []
    stitched_pid = 0
    for _root, keys in sorted(
        components.items(), key=lambda kv: min(group_start(k) for k in kv[1])
    ):
        stitched_pid += 1
        keys = sorted(keys, key=group_start)
        walls = [groups[k]["min_wall"] for k in keys if groups[k]["min_wall"] is not None]
        base_wall = min(walls) if walls else None
        nodes = sorted({groups[k]["node"] for k in keys if groups[k]["node"]})
        label = "+".join(nodes) if nodes else _root
        events.append(
            {
                "ph": "M",
                "pid": stitched_pid,
                "name": "process_name",
                "args": {"name": f"fleet:{label}"},
            }
        )
        tid_base = 0
        for key in keys:
            group = groups[key]
            source, _pid = key
            lane_label = group["node"] or next(iter(sorted(group["trace_ids"])))
            events.append(
                {
                    "ph": "M",
                    "pid": stitched_pid,
                    "tid": tid_base,
                    "name": "thread_name",
                    "args": {"name": lane_label},
                }
            )
            max_tid = 0
            for event in group["events"]:
                args = dict(event.get("args") or {})
                tid = int(event.get("tid", 0) or 0)
                max_tid = max(max_tid, tid)
                if args.get("span_id"):
                    args["span_id"] = f"{source}:{args['span_id']}"
                remote = args.get("remote_trace_id")
                remote_parent = args.get("remote_parent")
                if args.get("parent_id"):
                    args["parent_id"] = f"{source}:{args['parent_id']}"
                elif remote and remote_parent and str(remote) in owner_of_trace:
                    remote_source = owner_of_trace[str(remote)][0]
                    args["parent_id"] = f"{remote_source}:{remote_parent}"
                    args["remote"] = True
                wall = args.get("wall_start")
                ts = event.get("ts", 0.0)
                if wall is not None and base_wall is not None:
                    ts = round((float(wall) - base_wall) * 1e6, 3)
                events.append(
                    {
                        "name": event.get("name"),
                        "cat": "scan",
                        "ph": "X",
                        "ts": ts,
                        "dur": event.get("dur", 0.0),
                        "pid": stitched_pid,
                        "tid": tid_base + tid,
                        "args": args,
                    }
                )
            tid_base += max_tid + 1
    return {"traceEvents": events, "displayTimeUnit": "ms"}
