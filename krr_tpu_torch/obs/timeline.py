"""The scan flight recorder: a durable, append-only per-scan timeline.

A copy of `krr_tpu/obs/timeline.py`: the same framed file, byte for byte,
so either package reads the other's timeline.

The obs stack can explain any SINGLE scan — spans (`krr_tpu_torch.obs.trace`),
critical-path attribution (`krr_tpu_torch.obs.profile`), transport phases — but
every artifact is ephemeral: the trace ring holds 16 scans in memory,
``/statusz`` only knows rolling SLO windows, and a restart forgets
everything. This module gives the observability layer a TIME AXIS that
survives restarts: each completed scan distills into one compact JSON
record appended to a crash-safe log file beside the durable digest store,
and the regression sentinel (`krr_tpu_torch.obs.sentinel`) maintains rolling
baselines over exactly those records.

On-disk format (the durastore framing, reused):

``timeline.log`` (inside the sharded state directory; ``<state_path>.timeline``
beside a legacy single-file store) = an 8-byte magic header
(``KRRTLN1\\n``) followed by length-framed records —
``[u32 LE payload_len][u32 LE crc32(payload)][payload]`` — where each
payload is one scan record as UTF-8 JSON. An append is frame + flush +
fsync, exactly like a WAL delta (`krr_tpu_torch.core.durastore`): commit is the
fsync returning, and the durability-critical WRITES (appends, retention
rewrites) route through the injectable
:class:`~krr_tpu_torch.core.streaming.FsOps` seam so the chaos fakes can script
ENOSPC/EIO/crashes at any single fault point; recovery reads and the
torn-tail truncation at open are direct, like the durastore's.

Durability rules (property-tested in ``tests/test_timeline.py`` and
SIGKILL-soaked in ``tests/test_chaos.py``):

* A torn tail (crash mid-append, ENOSPC part-way) or a bit-flipped record
  is detected by framing + CRC at open and truncated back to the last
  valid record — the recovered file is bit-identical to the pre-crash file
  up to the last durable record, never half a record.
* A failed append marks the tail dirty; the next append truncates back to
  the last known-good size first, so a transient disk fault can't corrupt
  every later record. Appends degrade: the in-memory ring keeps the record
  either way (the sentinel keeps classifying while the disk heals).
* Retention compaction: once the on-disk record count exceeds twice
  ``retain_records``, the newest ``retain_records`` rewrite atomically
  (:func:`~krr_tpu_torch.core.streaming.atomic_write`) — the file stays bounded
  for arbitrarily long serve lifetimes.

One record per completed serve tick (:func:`build_scan_record`): the
profile category seconds (fetch_transport/decode/backoff, fold, compute,
publish, idle…), transport-phase sums, the fetch-plan shape
(coalesced/sharded query counts, live in-flight limit), rows / wire bytes
/ failed rows / stale workloads, the publish-vs-suppressed verdict,
persist seconds/bytes/epoch, and an SLO burn snapshot. Records are plain
dicts on purpose: ``GET /debug/timeline`` serves them verbatim,
``analyze --trend`` replays them offline, and the tests synthesize them —
all through the same sentinel code.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Any, Optional

from krr_tpu_torch.core.durastore import FRAME, frame_crc
from krr_tpu_torch.core.streaming import FS, FsOps, atomic_write

#: On-disk magic header; the version rides in each record's ``v`` field.
TIMELINE_MAGIC = b"KRRTLN1\n"
#: Schema version stamped into every record.
RECORD_VERSION = 1


def _encode(record: dict) -> bytes:
    payload = json.dumps(record, separators=(",", ":"), sort_keys=True).encode("utf-8")
    return FRAME.pack(len(payload), frame_crc(payload)) + payload


def _scan_frames(blob: bytes) -> "tuple[list[dict], int]":
    """Parse framed records out of ``blob`` (header already stripped off the
    caller's offset accounting is NOT done here — pass bytes after the
    magic). Returns ``(records, good_bytes)`` where ``good_bytes`` counts
    only whole, CRC-valid, JSON-decodable records — the truncation point
    for torn or corrupt tails."""
    records: list[dict] = []
    good = 0
    pos = 0
    n = len(blob)
    while pos + FRAME.size <= n:
        length, crc = FRAME.unpack_from(blob, pos)
        end = pos + FRAME.size + length
        if end > n:
            break
        payload = blob[pos + FRAME.size : end]
        if frame_crc(payload) != crc:
            break
        try:
            record = json.loads(payload.decode("utf-8"))
        except (UnicodeDecodeError, ValueError):
            break  # CRC vouched for the bytes; a decode failure is an
            # encoder bug — stop cleanly at the previous record.
        if not isinstance(record, dict):
            break
        records.append(record)
        good = end
        pos = end
    return records, good


class ScanTimeline:
    """Bounded ring of scan records, optionally backed by the durable log.

    ``path=None`` is the memory-only recorder (serve without a state path):
    everything works — ``/debug/timeline``, the sentinel — except surviving
    a restart."""

    def __init__(
        self,
        path: Optional[str] = None,
        *,
        retain_records: int = 4096,
        fs: Optional[FsOps] = None,
        metrics=None,
        logger=None,
    ) -> None:
        self.path = path
        self.retain_records = max(1, int(retain_records))
        self.fs = fs or FS
        self.metrics = metrics
        self.logger = logger
        self._ring: "deque[dict]" = deque(maxlen=self.retain_records)
        #: Guards the ring only: the scheduler appends from a worker thread
        #: while ``/debug/timeline`` renders and SIGUSR2 dumps snapshot
        #: ``records()`` from OTHER worker threads — an unguarded
        #: ``list(deque)`` against a concurrent append is a "deque mutated
        #: during iteration" 500. Disk I/O stays outside the lock.
        self._ring_lock = threading.Lock()
        self._file = None
        self._size = 0
        self._disk_records = 0
        #: Set when an append failed part-way: the next append truncates the
        #: file back to the last known-good size before writing.
        self._dirty_tail = False

    # ------------------------------------------------------------------ open
    @classmethod
    def open(
        cls,
        path: Optional[str],
        *,
        retain_records: int = 4096,
        fs: Optional[FsOps] = None,
        metrics=None,
        logger=None,
    ) -> "ScanTimeline":
        """Open (or create) the timeline at ``path`` — recovery truncates a
        torn/corrupt tail back to the last durable record and applies
        retention. ``path=None`` builds the memory-only recorder."""
        self = cls(
            path, retain_records=retain_records, fs=fs, metrics=metrics, logger=logger
        )
        if path is None:
            return self
        if not os.path.exists(path):
            self._reset_file()
        else:
            self._recover()
        if self._file is None:  # a retention compaction inside _recover
            self._open_append()  # already reopened the append handle
        self._update_gauges()
        return self

    def _recover(self) -> None:
        with open(self.path, "rb") as f:
            blob = f.read()
        if blob[: len(TIMELINE_MAGIC)] != TIMELINE_MAGIC:
            self._warn(
                f"scan timeline {self.path} has an unrecognized header — resetting it"
            )
            self._reset_file()
            return
        records, good = _scan_frames(blob[len(TIMELINE_MAGIC) :])
        good += len(TIMELINE_MAGIC)
        if good < len(blob):
            self._warn(
                f"scan timeline {self.path} ends in {len(blob) - good} invalid "
                f"byte(s) (torn or corrupt record) — truncating to the last "
                f"valid record ({len(records)} retained)"
            )
            os.truncate(self.path, good)
        self._size = good
        self._disk_records = len(records)
        for record in records[-self.retain_records :]:
            self._ring.append(record)
        if self._disk_records > self.retain_records:
            self._compact()

    def _reset_file(self) -> None:
        with open(self.path, "wb") as f:
            self.fs.write(f, TIMELINE_MAGIC)
            f.flush()
            self.fs.fsync(f)
        self._size = len(TIMELINE_MAGIC)
        self._disk_records = 0

    def _open_append(self) -> None:
        self._file = open(self.path, "ab")

    def _warn(self, message: str) -> None:
        if self.logger is not None:
            self.logger.warning(message)

    def _update_gauges(self) -> None:
        if self.metrics is not None:
            self.metrics.set("krr_tpu_timeline_records", len(self._ring))
            self.metrics.set("krr_tpu_timeline_bytes", self._size if self.path else 0)

    # ---------------------------------------------------------------- append
    def append(self, record: dict) -> bool:
        """Record one scan: the in-memory ring keeps it unconditionally;
        with a backing file the record is framed, appended, and fsync'd
        (commit = the fsync returning). Returns whether the record is
        DURABLE; a disk fault (ENOSPC/EIO) degrades to False with the tail
        marked dirty — the caller keeps serving, the next append truncates
        the torn bytes first, and the ``krr_tpu_timeline_append_failures_total``
        counter says how many records exist only in memory."""
        with self._ring_lock:
            self._ring.append(record)
        if self.path is None:
            self._update_gauges()
            return False
        durable = True
        frame = _encode(record)
        try:
            f = self._file
            if f is None:
                self._open_append()
                f = self._file
            if self._dirty_tail:
                self.fs.truncate(f, self._size)
                self._dirty_tail = False
            try:
                self.fs.append(f, frame)
                f.flush()
                self.fs.fsync(f)
            except BaseException:
                self._dirty_tail = True
                raise
            self._size += len(frame)
            self._disk_records += 1
        except OSError as e:
            durable = False
            if self.metrics is not None:
                self.metrics.inc("krr_tpu_timeline_append_failures_total")
            self._warn(
                f"scan timeline append to {self.path} failed "
                f"({type(e).__name__}: {e}) — record kept in memory only"
            )
        if durable and self._disk_records > 2 * self.retain_records:
            try:
                self._compact()
            except OSError as e:
                # A failed retention rewrite must not undo the append's
                # verdict (the record IS durable) or escape to the caller —
                # the sentinel keeps classifying while the disk heals.
                # Whatever state the atomic rewrite reached (old file
                # intact, or new generation fully committed), the file
                # itself is authoritative: re-derive the bookkeeping from
                # it and retry compaction at a later append.
                self._warn(
                    f"scan timeline retention compaction of {self.path} failed "
                    f"({type(e).__name__}: {e}) — retrying at a later append"
                )
                self._resync()
        self._update_gauges()
        return durable

    def _resync(self) -> None:
        """Rebuild size/record bookkeeping from the file after a failed
        compaction, and reopen the append handle. Defensive all the way
        down: on a disk too sick to even read, leave the tail marked dirty
        so the next append truncates back before writing."""
        if self._file is not None:
            self._file.close()
            self._file = None
        try:
            with open(self.path, "rb") as f:
                blob = f.read()
            if blob[: len(TIMELINE_MAGIC)] == TIMELINE_MAGIC:
                records, good = _scan_frames(blob[len(TIMELINE_MAGIC) :])
                self._size = len(TIMELINE_MAGIC) + good
                self._disk_records = len(records)
                self._dirty_tail = self._size < len(blob)
            else:
                self._dirty_tail = True
            self._open_append()
        except OSError:
            self._dirty_tail = True

    def _compact(self) -> None:
        """Retention: atomically rewrite the file with only the newest
        ``retain_records`` records (the in-memory ring, which holds exactly
        them)."""
        if self._file is not None:
            self._file.close()
            self._file = None
        with self._ring_lock:
            snapshot = list(self._ring)
        body = b"".join(_encode(record) for record in snapshot)
        with atomic_write(self.path, "wb", fs=self.fs) as f:
            f.write(TIMELINE_MAGIC + body)
        self._size = len(TIMELINE_MAGIC) + len(body)
        self._disk_records = len(snapshot)
        self._dirty_tail = False
        self._open_append()
        if self.metrics is not None:
            self.metrics.inc("krr_tpu_timeline_compactions_total")
        self._update_gauges()

    # --------------------------------------------------------------- reading
    def records(self, n: Optional[int] = None) -> "list[dict]":
        """The newest ``n`` retained records (all when None), oldest first."""
        with self._ring_lock:
            out = list(self._ring)
        if n is not None and n > 0:
            out = out[-n:]
        return out

    @property
    def nbytes(self) -> int:
        return self._size if self.path else 0

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None

    @staticmethod
    def read_records(path: str, n: Optional[int] = None) -> "list[dict]":
        """READ-ONLY parse of a timeline file — the ``krr-tpu analyze
        --trend`` input path. Tolerates a torn tail (stops at the last
        valid record) and NEVER writes: the file may belong to a running
        server mid-append."""
        with open(path, "rb") as f:
            blob = f.read()
        if blob[: len(TIMELINE_MAGIC)] != TIMELINE_MAGIC:
            raise ValueError(
                f"{path} is not a krr-tpu scan timeline (bad magic header)"
            )
        records, _good = _scan_frames(blob[len(TIMELINE_MAGIC) :])
        if n is not None and n > 0:
            records = records[-n:]
        return records


# ----------------------------------------------------------- record building
def build_scan_record(
    profile: Optional[dict],
    stats: dict,
    *,
    metrics=None,
    slo=None,
    plan_delta: Optional[dict] = None,
) -> dict:
    """Distill one completed scan into the compact timeline record.

    ``profile`` is the scan's `krr_tpu_torch.obs.profile.profile_trace` report
    (None degrades to zeroed categories — a recorder must never abort the
    tick it is recording); ``stats`` is the scheduler's per-tick stash
    (window, rows, publish verdict, persist outcome); ``plan_delta`` the
    per-tick fetch-plan counter deltas the scheduler tracks."""
    wall = float(profile["wall_seconds"]) if profile else 0.0
    categories = dict(profile["categories"]) if profile else {}
    fetch = profile["fetch"] if profile else {}
    record: dict[str, Any] = {
        "v": RECORD_VERSION,
        "ts": round(float(stats.get("window_end") or time.time()), 3),
        "scan_id": stats.get("scan_id"),
        "kind": stats.get("kind", "delta"),
        "wall": round(wall, 6),
        "window_seconds": round(
            float(stats.get("window_end", 0.0)) - float(stats.get("window_start", 0.0)), 3
        ),
        "categories": {k: round(float(v), 6) for k, v in categories.items()},
        "phases": {
            k: round(float(v), 6) for k, v in (fetch.get("phase_seconds") or {}).items()
        },
        "rows": int(stats.get("objects", 0)),
        "failed_rows": int(stats.get("failed_rows", 0)),
        "backfilled": int(stats.get("backfilled", 0)),
        "stale_workloads": int(stats.get("stale", 0)),
        "queries": int(fetch.get("queries", 0)),
        "retries": int(fetch.get("retries", 0)),
        "wire_bytes": int(fetch.get("wire_bytes", 0)),
        "decoded_bytes": int(fetch.get("decoded_bytes", 0)),
        "publish": {
            "changed": int(stats.get("publish_changed") or 0),
            "suppressed": int(stats.get("publish_suppressed") or 0),
        },
        "persist": {
            "seconds": round(float(stats.get("persist_seconds", 0.0)), 6),
            "bytes": int(stats.get("persist_bytes", 0)),
            "epoch": stats.get("epoch"),
            "failing": bool(stats.get("persist_failing", False)),
        },
    }
    # Wire-shrink observability (satellites of the compressed-transport PR):
    # the per-tick encoding census, the live compression ratio (None until a
    # compressed response contributed — an all-identity tick has no ratio to
    # claim), and how many stats queries rode the downsample rewrite. A
    # silent fallback to identity shows up here as the ratio vanishing and
    # wire_bytes jumping — which the sentinel's wire_mb band turns into a
    # paged trend verdict instead of a mystery slowdown.
    encodings = {
        str(k): int(v) for k, v in (fetch.get("encodings") or {}).items()
    }
    record["encodings"] = encodings
    wire = record["wire_bytes"]
    decoded = record["decoded_bytes"]
    # Only when EVERY response negotiated an encoding: on a mixed tick —
    # exactly the half-stripped-Accept-Encoding regime this field helps
    # diagnose — identity responses add wire bytes with no matching
    # decoded contribution, which would drag the ratio DOWN and read as
    # "compression degraded" instead of "some responses fell back". The
    # encodings census carries the mixed-tick signal; the ratio stays an
    # honest measurement or absent.
    compressed_only = bool(encodings) and all(k != "identity" for k in encodings)
    record["wire_compression_ratio"] = (
        round(decoded / wire, 3)
        if compressed_only and wire > 0 and decoded > 0
        else None
    )
    if "discovery" in stats:
        # Discovery posture for the tick: the active mode (relist|watch),
        # watch event deltas (adds/updates/drops/bookmarks), watch restarts
        # and relist fallbacks, and inventory/watch freshness ages — the
        # trendable side of watch-driven incremental discovery.
        record["discovery"] = dict(stats["discovery"])
    if stats.get("ingest"):
        # Push-ingest posture for the tick (--metrics-mode push): how many
        # windows folded from the plane vs rode range legs, the audit
        # verdict when one ran, and the plane's freshness/buffer state —
        # the trendable side of the zero-range-query steady state.
        record["ingest"] = dict(stats["ingest"])
    if "federation" in stats:
        # Aggregate ticks (federation mode): shard census + per-tick
        # applied records and delta wire bytes — the trendable federation
        # cost beside the apply seconds already in `categories["fold"]`.
        record["federation"] = dict(stats["federation"])
    if "lineage" in stats:
        # The epoch's end-to-end freshness lineage (newest sample → fold →
        # apply → publish, plus the newest replica-acked install) — what
        # the sentinel bands per hop so a freshness regression pages with
        # the guilty stage named.
        record["lineage"] = dict(stats["lineage"])
    if "readpath" in stats:
        # Read-path serving deltas for the tick window (requests / 304s /
        # cache hits / misses / sheds / bytes / p99) — the sentinel bands
        # ``read_p99_ms`` over these so a read-latency regression pages as
        # a trend verdict like any scan-cost regression.
        record["readpath"] = dict(stats["readpath"])
    plan: dict[str, Any] = {
        "coalesced": int((plan_delta or {}).get("coalesced", 0)),
        "sharded": int((plan_delta or {}).get("sharded", 0)),
        "downsampled": int((plan_delta or {}).get("downsampled", 0)),
    }
    if metrics is not None:
        inflight = metrics.series("krr_tpu_prom_inflight_limit")
        if inflight:
            plan["inflight_limit"] = max(inflight.values())
    record["plan"] = plan
    if slo is not None:
        status = slo.status(now=stats.get("window_end"))
        record["slo"] = {
            "firing": status["firing"],
            "burn": {
                o["name"]: o["burn_rate"]["slow"] for o in status["objectives"]
            },
        }
    return record
