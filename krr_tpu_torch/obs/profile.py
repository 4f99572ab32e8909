"""Critical-path attribution: turn a scan trace into an answer to "where
did the wall go, and what would killing the fetch wall actually buy?".

A copy of `krr_tpu/obs/profile.py`: pure span geometry over a COMPLETED
scan trace (`krr_tpu_torch.obs.trace` — the live ring or a re-imported
``--trace`` file), producing:

* **Category attribution** — every instant of the scan wall is attributed
  to exactly one category by a sweep over the trace's span intervals:
  ``fetch_transport`` / ``fetch_decode`` / ``fetch_backoff`` /
  ``fetch_other`` / ``fold`` / ``compute`` / ``discover`` / ``publish`` /
  ``other`` / ``idle``; the categories sum to the wall by construction.
  Overlapping spans resolve by a fixed priority with fetch on top: a fold
  or compute running UNDER an active fetch is hidden work costing no wall,
  so what survives in the fold/compute buckets is their *exposed*
  (critical-path) time only. The compute stages (``pack``, ``digest``,
  ``quantile``, ``round``) nest under ``compute`` and add no category.
* **Phase split** — the attributed fetch wall divides into transport
  (connect + request-write + TTFB + body-read), decode (parse + native
  sink), and backoff, proportionally to the per-query phase sums the
  instrumented loader stamps onto each ``prom_query`` span; queue wait and
  unaccounted span time land in ``fetch_other``.
* **What-if estimate** — ``wall_if_fetch_free = wall − fetch-exclusive
  time`` (instants where ONLY fetch-category spans were active).
* **The critical path itself** — a backward walk from the scan's end
  picking, at every instant, the deepest active span: the chain of spans
  whose completion actually gated the scan, with per-segment durations.

No clock reads, no registry — so it runs identically over the live ring
(``--profile``, the SIGUSR2 dump) and over an exported trace file
(``analyze``).
"""

from __future__ import annotations

from typing import Any, Optional

#: Report category keys, in render order. They partition the scan wall.
CATEGORIES = (
    "fetch_transport",
    "fetch_decode",
    "fetch_backoff",
    "fetch_other",
    "fold",
    "compute",
    "discover",
    "publish",
    "other",
    "idle",
)

#: Span name → timeline category. ``prom_query`` is kept distinct from its
#: enclosing ``fetch`` span so fetch wall can be split into in-query time
#: (phase-attributable) and around-query time (routing, probes, python).
_NAME_CATEGORY = {
    "prom_query": "prom",
    "fetch": "fetch",
    "fold": "fold",
    # The federation aggregate tick's replay of queued shard delta records:
    # it IS the tick's fold leg — the same WAL apply path a recovery
    # replays — so it shares the bucket (the JAX package's names, so a
    # trace of either package attributes alike).
    "apply": "fold",
    # Per-record replay spans under `apply` (remote-linked to the shard
    # tick that encoded the record) — same WAL-apply work, same bucket.
    "apply_record": "fold",
    # A replica's epoch-feed install (decode + snapshot swap): the closest
    # local analogue is the publish leg it mirrors from the source side.
    "install": "publish",
    "compute": "compute",
    "pack": "compute",
    "digest": "compute",
    "quantile": "compute",
    "round": "compute",
    "discover": "discover",
    "publish": "publish",
}

#: Sweep priority (first active wins an overlapped instant). Fetch-side
#: categories outrank fold/compute: work hidden under an active fetch is
#: free wall — the streamed pipeline's whole point — so only EXPOSED
#: fold/compute time survives into those buckets. ``discover`` sits below
#: compute because streamed discovery runs fused under the fetch leg.
_PRIORITY = ("prom", "fetch", "fold", "compute", "publish", "discover", "other")

#: Phase grouping for the fetch split (see
#: `krr_tpu_torch.integrations.prometheus.TRANSPORT_PHASES`).
_TRANSPORT_PHASES = ("connect", "request_write", "ttfb", "body_read")
_DECODE_PHASES = ("decode", "sink")


def _span_depth(span, by_id: dict) -> int:
    depth = 0
    seen = set()
    while span.parent_id is not None and span.parent_id in by_id and span.parent_id not in seen:
        seen.add(span.parent_id)
        span = by_id[span.parent_id]
        depth += 1
    return depth


def _category_of(span, by_id: dict) -> Optional[str]:
    """Timeline category of one span, ancestor-aware: a ``fold`` or
    ``quantile`` under ``compute`` is device-stage detail, not pipeline
    fold — its wall already belongs to the enclosing compute span."""
    name = span.name
    walker, seen = span, set()
    while walker.parent_id is not None and walker.parent_id in by_id and walker.parent_id not in seen:
        seen.add(walker.parent_id)
        walker = by_id[walker.parent_id]
        if walker.name == "compute":
            return None  # covered by the compute span itself
        if walker.name == "publish":
            return None  # scheduler render stages under publish
    return _NAME_CATEGORY.get(name, "other" if span.parent_id is not None else None)


def _sweep(root, spans: list, by_id: dict) -> tuple[dict, float, float]:
    """One pass over the trace's interval boundaries: per-category
    attributed seconds (priority-resolved), idle seconds, and the
    fetch-EXCLUSIVE seconds behind the what-if estimate."""
    events: list[tuple[float, int, str]] = []
    for span in spans:
        if span is root:
            continue
        category = _category_of(span, by_id)
        if category is None:
            continue
        start = max(span.start, root.start)
        end = min(span.end, root.end)
        if end > start:
            events.append((start, 1, category))
            events.append((end, -1, category))
    events.sort(key=lambda item: item[0])
    attributed = {category: 0.0 for category in _PRIORITY}
    active = {category: 0 for category in _PRIORITY}
    idle = 0.0
    fetch_exclusive = 0.0
    prev = root.start
    for t, delta, category in events:
        if t > prev:
            segment = t - prev
            for candidate in _PRIORITY:
                if active[candidate] > 0:
                    attributed[candidate] += segment
                    break
            else:
                idle += segment
            fetchish = active["prom"] > 0 or active["fetch"] > 0
            others = any(
                active[c] > 0 for c in _PRIORITY if c not in ("prom", "fetch")
            )
            if fetchish and not others:
                fetch_exclusive += segment
        active[category] += delta
        prev = t
    if root.end > prev:
        idle += root.end - prev
    return attributed, idle, fetch_exclusive


def _critical_path(root, spans: list, by_id: dict, max_segments: int = 128) -> list[dict]:
    """Backward walk from the scan's end: at every instant, the deepest
    active span is the one whose completion gated everything above it; its
    segment extends back to the latest point where something even deeper
    was active. Returns chronological ``{name, seconds, …key attrs}``
    segments (adjacent same-span segments merged)."""
    timed = [s for s in spans if s.end > s.start]
    if root not in timed:
        timed.append(root)
    depths = {s.span_id: _span_depth(s, by_id) for s in timed}
    eps = 1e-9
    t = root.end
    segments: list[tuple[Any, float, float]] = []  # (span, start, end)
    while t - root.start > 1e-6 and len(segments) < max_segments:
        probe = t - eps
        active = [s for s in timed if s.start <= probe < s.end]
        if not active:
            # Idle gap: extend back to the latest span end before t.
            previous_end = max(
                (s.end for s in timed if s.end <= probe), default=root.start
            )
            segments.append((None, max(previous_end, root.start), t))
            t = max(previous_end, root.start)
            continue
        pick = max(active, key=lambda s: (depths[s.span_id], s.start))
        # A deeper span ending inside the pick cuts the segment: the walk
        # will select it next round.
        cut = max(
            (
                s.end
                for s in timed
                if s.end <= probe and s.end > pick.start and depths[s.span_id] > depths[pick.span_id]
            ),
            default=pick.start,
        )
        seg_start = max(cut, root.start)
        if t - seg_start < 1e-9:
            t -= 1e-6  # degenerate geometry: force progress
            continue
        segments.append((pick, seg_start, t))
        t = seg_start
    segments.reverse()
    out: list[dict] = []
    for span, start, end in segments:
        name = span.name if span is not None else "(idle)"
        if out and out[-1]["name"] == name and out[-1].get("_id") == (span.span_id if span else None):
            out[-1]["seconds"] += end - start
            continue
        entry: dict = {"name": name, "seconds": end - start, "_id": span.span_id if span else None}
        if span is not None:
            for key in ("namespace", "cluster", "route", "path", "kind"):
                value = span.attributes.get(key)
                if value is not None:
                    entry[key] = value
        out.append(entry)
    for entry in out:
        entry.pop("_id", None)
        entry["seconds"] = round(entry["seconds"], 6)
    return out


def _float_attr(span, key: str) -> float:
    try:
        return float(span.attributes.get(key) or 0.0)
    except (TypeError, ValueError):
        return 0.0


def profile_trace(spans: list) -> Optional[dict]:
    """Attribution report for ONE completed scan trace (its span list).
    Returns None for traces without a root span (nothing to anchor the
    wall to)."""
    if not spans:
        return None
    by_id = {s.span_id: s for s in spans}
    roots = [s for s in spans if s.parent_id is None or s.parent_id not in by_id]
    if not roots:
        return None
    root = max(roots, key=lambda s: s.end - s.start)
    wall = max(root.end - root.start, 0.0)

    attributed, idle, fetch_exclusive = _sweep(root, spans, by_id)

    # Per-query rollup: the phase sums that split the attributed fetch wall.
    prom_spans = [s for s in spans if s.name == "prom_query"]
    phase_seconds: dict[str, float] = {}
    backoff = 0.0
    retries = 0
    wire_bytes = 0
    decoded_bytes = 0
    encodings: dict[str, int] = {}
    prom_duration = 0.0
    for span in prom_spans:
        prom_duration += max(0.0, span.end - span.start)
        backoff += _float_attr(span, "retry_wait")
        retries += int(_float_attr(span, "retries"))
        wire_bytes += int(_float_attr(span, "bytes"))
        decoded_bytes += int(_float_attr(span, "decoded_bytes"))
        encoding = span.attributes.get("encoding")
        if encoding:
            encodings[str(encoding)] = encodings.get(str(encoding), 0) + 1
        for key, value in span.attributes.items():
            if key.startswith("phase_"):
                try:
                    phase_seconds[key[6:]] = phase_seconds.get(key[6:], 0.0) + float(value)
                except (TypeError, ValueError):
                    pass

    transport_sum = sum(phase_seconds.get(p, 0.0) for p in _TRANSPORT_PHASES)
    decode_sum = sum(phase_seconds.get(p, 0.0) for p in _DECODE_PHASES)
    prom_attr = attributed["prom"]
    categories = {key: 0.0 for key in CATEGORIES}
    phased = transport_sum + decode_sum + backoff
    if prom_duration > 1e-9 and phased > 1e-9:
        # Split the attributed in-query wall proportionally to the summed
        # per-query phases (sums, not wall: concurrent windows overlap on
        # the timeline but their phase ratios are what we know). Phases can
        # overlap inside one query too (a streamed body is sunk while it is
        # read), so their sum can pass the queries' durations: the split is
        # then scaled to the attributed wall, keeping the categories a
        # partition of the scan's wall (ROADMAP Queue 3 item 13).
        scale = prom_attr / max(prom_duration, phased)
        categories["fetch_transport"] = transport_sum * scale
        categories["fetch_decode"] = decode_sum * scale
        categories["fetch_backoff"] = backoff * scale
        categories["fetch_other"] = max(0.0, prom_attr - phased * scale)
    else:
        # No phase telemetry (pre-instrumentation trace, or a fake source
        # with no prom_query spans): an opaque query is transport by
        # default — that is what the reference treated Prometheus as.
        categories["fetch_transport"] = prom_attr
    categories["fetch_other"] += attributed["fetch"]
    for key in ("fold", "compute", "discover", "publish", "other"):
        categories[key] = attributed[key]
    categories["idle"] = idle

    what_if_wall = max(0.0, wall - fetch_exclusive)
    report = {
        "scan_id": root.trace_id,
        "kind": root.attributes.get("kind"),
        "wall_seconds": round(wall, 6),
        "categories": {key: round(value, 6) for key, value in categories.items()},
        "category_pct": {
            key: round(100.0 * value / wall, 2) if wall > 1e-9 else 0.0
            for key, value in categories.items()
        },
        "fetch": {
            "queries": len(prom_spans),
            "retries": retries,
            "backoff_seconds": round(backoff, 6),
            "wire_bytes": wire_bytes,
            "decoded_bytes": decoded_bytes,
            # Negotiated Content-Encoding per completed query — identity
            # creeping in while compression is on means something on the
            # path stripped Accept-Encoding.
            "encodings": encodings,
            "phase_seconds": {k: round(v, 6) for k, v in sorted(phase_seconds.items())},
        },
        "what_if": {
            "fetch_exclusive_seconds": round(fetch_exclusive, 6),
            "wall_if_fetch_free_seconds": round(what_if_wall, 6),
            "speedup_if_fetch_free": (
                round(wall / what_if_wall, 3) if what_if_wall > 1e-9 else None
            ),
        },
        "critical_path": _critical_path(root, spans, by_id),
    }
    return report


def profile_traces(traces: list) -> dict:
    """Attribution report over a sequence of completed scan traces (the
    ring's shape: oldest first). Scans without a usable root are skipped;
    ``aggregate`` sums the category attribution across the kept scans."""
    scans = [report for report in (profile_trace(t) for t in traces) if report is not None]
    totals = {key: 0.0 for key in CATEGORIES}
    wall = 0.0
    for report in scans:
        wall += report["wall_seconds"]
        for key in CATEGORIES:
            totals[key] += report["categories"][key]
    fetch_total = sum(
        totals[k] for k in ("fetch_transport", "fetch_decode", "fetch_backoff", "fetch_other")
    )
    return {
        "scans": scans,
        "aggregate": {
            "scan_count": len(scans),
            "wall_seconds": round(wall, 6),
            "categories": {key: round(value, 6) for key, value in totals.items()},
            "category_pct": {
                key: round(100.0 * value / wall, 2) if wall > 1e-9 else 0.0
                for key, value in totals.items()
            },
            "fetch_pct": round(100.0 * fetch_total / wall, 2) if wall > 1e-9 else 0.0,
        },
    }


def render_text(report: dict) -> str:
    """Human rendering of a `profile_traces` report — the default
    ``analyze`` output."""
    lines: list[str] = []
    aggregate = report.get("aggregate", {})
    lines.append(
        f"critical-path attribution over {aggregate.get('scan_count', 0)} scan(s), "
        f"{aggregate.get('wall_seconds', 0.0):.3f}s total wall "
        f"(fetch {aggregate.get('fetch_pct', 0.0):.1f}%)"
    )
    for scan in report.get("scans", []):
        wall = scan["wall_seconds"]
        lines.append("")
        lines.append(
            f"scan {scan['scan_id']}"
            + (f" [{scan['kind']}]" if scan.get("kind") else "")
            + f": wall {wall:.3f}s"
        )
        for key in CATEGORIES:
            seconds = scan["categories"][key]
            if seconds < 5e-4:
                continue
            pct = scan["category_pct"][key]
            bar = "#" * max(1, int(round(pct / 2.5)))
            lines.append(f"  {key:<16} {seconds:>9.3f}s {pct:>5.1f}%  {bar}")
        fetch = scan["fetch"]
        if fetch["queries"]:
            mb = fetch["wire_bytes"] / 1e6
            lines.append(
                f"  {fetch['queries']} queries, {fetch['retries']} retries "
                f"({fetch['backoff_seconds']:.2f}s backoff), {mb:.1f} MB wire"
            )
        what_if = scan["what_if"]
        speedup = what_if["speedup_if_fetch_free"]
        lines.append(
            f"  what-if fetch were free: wall {what_if['wall_if_fetch_free_seconds']:.3f}s"
            + (f" ({speedup:.2f}x)" if speedup else "")
        )
        path = [seg for seg in scan["critical_path"] if seg["seconds"] >= 1e-3]
        if path:
            lines.append("  critical path: " + " -> ".join(
                f"{seg['name']}"
                + (f"[{seg['namespace']}]" if "namespace" in seg else "")
                + f" {seg['seconds']:.3f}s"
                for seg in path[-8:]
            ))
    return "\n".join(lines) + "\n"


def profile_chrome_payload(payload: dict, n: Optional[int] = None) -> dict:
    """`profile_traces` over an exported Chrome trace JSON payload — the
    ``analyze --trace FILE`` path. ``n`` keeps only the newest N
    scans BEFORE profiling, so the aggregate covers exactly the scans
    reported."""
    from krr_tpu_torch.obs.trace import traces_from_chrome

    traces = traces_from_chrome(payload)
    if n is not None and n > 0:
        traces = traces[-n:]
    return profile_traces(traces)


def write_profile_report(tracer, path: str) -> None:
    """Dump the tracer ring's attribution report as JSON — the shared exit
    hook behind ``--profile FILE`` and the SIGUSR2 dump's third artifact,
    so the surfaces can't drift apart. The spans are profiled as the
    Chrome export holds them (``ts`` and ``dur`` rounded to the nanosecond
    each), so ``analyze --trace`` over the same ring's export gives this
    report exactly: profiling the live spans, an end within a nanosecond
    of a microsecond edge could round the other way in the file."""
    import json

    from krr_tpu_torch.obs.trace import traces_from_chrome

    with open(path, "w") as f:
        json.dump(profile_traces(traces_from_chrome(tracer.export_chrome())), f, indent=2)
        f.write("\n")
