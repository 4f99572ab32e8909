"""Append-only journal of recommendation ticks — the serve flight recorder.

A copy of `krr_tpu/history/journal.py`: the same record layout, key sidecar
and epoch markers, byte for byte, so either package reads the other's file.

Every scheduler recompute appends one fixed-width record per workload:
``(tick timestamp, workload identity hash, raw CPU recommendation, raw
memory recommendation, flags)``. Values are the strategy's RAW outputs (the
CPU percentile in cores, the peak memory in MB *before* the buffer
multiplier and rounding); the ``published`` flag marks ticks whose raw value
became the published recommendation (the hysteresis gate opened, or the
workload's first tick), so the published series is reconstructible by
forward-filling flagged records — the journal stores the raw series ONCE,
not raw + published twice.

On-disk format: an 8-byte magic header followed by packed little-endian
records (28 bytes each, `RECORD_DTYPE`). Appends go straight to the open
file handle with an fsync — the recorder must survive the crash it exists to
explain. Crash semantics:

* A torn FINAL record (crash mid-append) is detected by file length, dropped
  at open, and the file truncated back to the last whole record; a sub-header
  stub (crash before the first header write) restarts fresh — a torn write
  is a warning, never fatal, and never desyncs later appends.
* Retention compaction trims memory every tick but rewrites the file —
  through the shared ``atomic_write`` (tmp + fsync + rename) under
  ``DigestStore.locked``, the same discipline the digest store uses — only
  once ~10% of the on-disk records have aged out (``REWRITE_FRACTION``):
  a steady-state journal must not pay a whole-file fsync per tick. A crash
  mid-compaction keeps the pre-compaction journal intact, and readers
  (``krr-tpu diff``, opened ``readonly``) serialize against the rewrite.

Workload identity: records carry an 8-byte BLAKE2b hash of the store's
``object_key`` string; the hash → key-string table lives in a JSON sidecar
(``<path>.keys.json``, atomically rewritten when new keys appear). A missing
sidecar degrades to hex-hash display names, never to data loss.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
from typing import Optional

import numpy as np

from krr_tpu_torch.utils.logging import KrrLogger

#: One journal record. float32 value slots round-trip the digest store's own
#: float32 recommendation outputs bit-exactly (which is what makes restart
#: re-seeding of the hysteresis gate exact).
RECORD_DTYPE = np.dtype(
    [("ts", "<f8"), ("key_hash", "<u8"), ("cpu", "<f4"), ("mem", "<f4"), ("flags", "<u4")]
)

MAGIC = b"KRRJRNL1"

#: Flag bit: this tick's raw value became the published recommendation.
FLAG_PUBLISHED = 1

#: Flag bit: the record is a publish-EPOCH marker, not a recommendation —
#: ``key_hash`` holds the durable store's epoch for the tick batch that
#: FOLLOWS it (marker-first framing), ``ts`` the tick timestamp. Markers
#: exist only on disk: readers filter them out of the in-memory arrays, so
#: every records() consumer sees recommendation rows only. They are what
#: lets a restart reconcile journal-ahead-of-store deterministically
#: (``reconcile_epoch``) instead of heuristically.
FLAG_EPOCH = 2


def hash_key(key: str) -> int:
    """Stable 64-bit workload identity hash (BLAKE2b-8 of ``object_key``)."""
    return int.from_bytes(hashlib.blake2b(key.encode(), digest_size=8).digest(), "little")


class RecommendationJournal:
    """Columnar in-memory journal with optional append-only file persistence.

    ``path=None`` keeps the journal memory-only (a server without
    ``--state_path`` still gets drift detection and hysteresis; it just
    forgets on restart). Thread contract: appends/compaction come from the
    scheduler's single in-flight scan, reads from HTTP worker threads — a
    plain lock guards array swaps, and read snapshots stay consistent
    because records are append-only and compaction swaps arrays wholesale.
    """

    def __init__(
        self,
        path: Optional[str] = None,
        *,
        retention_seconds: float = 7 * 24 * 3600.0,
        logger: Optional[KrrLogger] = None,
        readonly: bool = False,
    ) -> None:
        """``readonly=True`` (the ``krr-tpu diff`` open): never creates,
        truncates, or appends to the file — a reader racing the owning
        server's in-flight append just drops the not-yet-complete tail from
        its in-memory snapshot, while the on-disk repair (truncation) stays
        exclusively the writer's, done before its first append."""
        self.path = path or None
        self.retention_seconds = float(retention_seconds)
        self.logger = logger
        self.readonly = bool(readonly)
        self._lock = threading.Lock()
        self._records = np.empty(0, dtype=RECORD_DTYPE)
        self._n = 0
        self._names: dict[int, str] = {}
        self._file = None
        #: Records trimmed from memory but still on disk — the rewrite debt
        #: that triggers the next atomic file compaction (see ``compact``).
        self._stale_in_file = 0
        #: On-disk epoch markers as ``(file record index, epoch)`` pairs,
        #: ascending — populated at open, consumed by ``reconcile_epoch``.
        self._markers: list[tuple[int, int]] = []
        #: Newest epoch this journal has recorded (None: no markers — a
        #: pre-epoch journal or a memory-only one).
        self.last_epoch: Optional[int] = None
        #: Cached ts bounds (see ``_install``).
        self._min_ts: Optional[float] = None
        self._max_ts: Optional[float] = None
        if self.path:
            self._open_file()

    # ------------------------------------------------------------ persistence
    def _keys_path(self) -> str:
        return self.path + ".keys.json"

    def _warn(self, message: str) -> None:
        if self.logger is not None:
            self.logger.warning(message)

    def _open_file(self) -> None:
        from krr_tpu_torch.core.streaming import DigestStore

        if self.readonly:
            # Lock-free: DigestStore.locked creates <path>.lock, which a
            # purely-read open must not do (read-only state dirs, copied
            # snapshots). Reading from ONE fd is consistent on its own — a
            # concurrent compaction rename doesn't affect an open fd, and an
            # in-flight append shows up as a torn tail, which readers drop.
            if not os.path.exists(self.path):
                raise ValueError(f"no journal at {self.path}")
            self._read_records()
        elif os.path.exists(self.path):
            with DigestStore.locked(self.path):
                size, torn, stub = self._read_records()
                if stub and size:
                    # A crash between file creation and the header write
                    # leaves a short stub — OUR OWN crash artifact, not
                    # corruption: start fresh instead of refusing to boot
                    # until an operator deletes it.
                    os.truncate(self.path, 0)
                elif torn:
                    # Crash mid-append: drop the torn tail AND truncate it
                    # on disk — appending after a misaligned tail would
                    # corrupt every later record. WRITER-only: a reader's
                    # misaligned tail may simply be the owning server's
                    # append in flight, so it drops the tail from its
                    # snapshot and leaves the file alone.
                    self._warn(
                        f"journal at {self.path} ends in a torn record "
                        f"({torn} trailing bytes) — dropping it"
                    )
                    os.truncate(self.path, size - torn)
        if os.path.exists(self._keys_path()):
            try:
                with open(self._keys_path()) as f:
                    self._names = {int(h): key for h, key in json.load(f).items()}
            except (ValueError, OSError) as e:
                self._warn(f"journal key table at {self._keys_path()} is unreadable ({e}); "
                           f"workloads will display as hashes until they re-appear")
                self._names = {}
        if not self.readonly:
            self._file = open(self.path, "ab")
            if self._file.tell() == 0:
                self._file.write(MAGIC)
                self._file.flush()
                os.fsync(self._file.fileno())

    def _read_records(self) -> "tuple[int, int, bool]":
        """Parse the file from ONE open fd into memory, returning
        ``(size, torn_bytes, is_stub)``. fstat on the open handle, not
        ``getsize`` on the path — a compaction rename racing the open must
        not mix the sizes of two file versions."""
        with open(self.path, "rb") as f:
            size = os.fstat(f.fileno()).st_size
            if size < len(MAGIC):
                if size:
                    self._warn(
                        f"journal at {self.path} is a {size}-byte stub "
                        f"(crash before the header write?) — starting fresh"
                    )
                self._markers = []
                self.last_epoch = None
                self._install(np.empty(0, dtype=RECORD_DTYPE))
                return size, 0, True
            if f.read(len(MAGIC)) != MAGIC:
                raise ValueError(
                    f"journal at {self.path} has an unrecognized header; "
                    f"delete the file to start fresh"
                )
            payload = size - len(MAGIC)
            whole = payload // RECORD_DTYPE.itemsize
            data = np.fromfile(f, dtype=RECORD_DTYPE, count=whole)
        # Epoch markers live only on disk: strip them from the in-memory
        # arrays (every records() consumer sees recommendation rows only)
        # but remember their file positions for reconcile_epoch.
        is_marker = (data["flags"] & FLAG_EPOCH) != 0
        self._markers = [
            (int(i), int(data["key_hash"][i])) for i in np.flatnonzero(is_marker)
        ]
        self.last_epoch = self._markers[-1][1] if self._markers else None
        self._install(data[~is_marker] if self._markers else data)
        return size, payload - whole * RECORD_DTYPE.itemsize, False

    def _install(self, records: np.ndarray) -> None:
        """Swap in a record array and refresh the cached ts bounds (kept
        incrementally so newest_ts/oldest_ts — /healthz, per-tick metrics —
        never scan the whole array)."""
        self._records = records
        self._n = len(records)
        if self._n:
            self._min_ts = float(records["ts"].min())
            self._max_ts = float(records["ts"].max())
        else:
            self._min_ts = None
            self._max_ts = None

    def _save_names(self) -> None:
        from krr_tpu_torch.core.streaming import atomic_write

        with atomic_write(self._keys_path(), "w") as f:
            json.dump({str(h): key for h, key in self._names.items()}, f)

    def close(self) -> None:
        with self._lock:
            if self._file is not None:
                self._file.close()
                self._file = None

    # ---------------------------------------------------------------- appends
    def _ensure_capacity(self, n: int) -> None:
        if n <= len(self._records):
            return
        grown = np.empty(max(n, 2 * len(self._records), 1024), dtype=RECORD_DTYPE)
        grown[: self._n] = self._records[: self._n]
        self._records = grown

    def append_tick(
        self,
        ts: float,
        keys: list[str],
        cpu: np.ndarray,
        mem: np.ndarray,
        published: np.ndarray,
        *,
        epoch: Optional[int] = None,
    ) -> None:
        """Record one recompute: the raw recommendation for every workload,
        with ``published`` marking rows whose raw value became the published
        one. Appended to memory and (when persistent) fsync'd to disk.

        ``epoch`` (the durable store's publish epoch for this tick) writes
        an epoch MARKER record before the batch — marker-first, so records
        following marker ``E`` belong to epoch ``E``'s tick and a restart
        can truncate exactly the ticks the store never durably published
        (``reconcile_epoch``). One write + one fsync covers marker and
        batch together."""
        if self.readonly:
            raise RuntimeError("journal opened readonly")
        n = len(keys)
        if n == 0:
            return
        batch = np.empty(n, dtype=RECORD_DTYPE)
        batch["ts"] = float(ts)
        hashes = np.fromiter((hash_key(k) for k in keys), dtype=np.uint64, count=n)
        batch["key_hash"] = hashes
        batch["cpu"] = np.asarray(cpu, dtype=np.float32)
        batch["mem"] = np.asarray(mem, dtype=np.float32)
        batch["flags"] = np.where(np.asarray(published, dtype=bool), FLAG_PUBLISHED, 0).astype("<u4")
        with self._lock:
            self._ensure_capacity(self._n + n)
            self._records[self._n : self._n + n] = batch
            self._n += n
            ts = float(ts)
            self._min_ts = ts if self._min_ts is None else min(self._min_ts, ts)
            self._max_ts = ts if self._max_ts is None else max(self._max_ts, ts)
            fresh = {int(h): k for h, k in zip(hashes, keys) if int(h) not in self._names}
            if fresh:
                self._names.update(fresh)
            if epoch is not None:
                self.last_epoch = int(epoch)
            if self._file is not None:
                payload = batch.tobytes()
                if epoch is not None:
                    marker = np.zeros(1, dtype=RECORD_DTYPE)
                    marker["ts"] = ts
                    marker["key_hash"] = np.uint64(int(epoch))
                    marker["flags"] = FLAG_EPOCH
                    payload = marker.tobytes() + payload
                self._file.write(payload)
                self._file.flush()
                os.fsync(self._file.fileno())
                if fresh:
                    self._save_names()

    def reconcile_epoch(self, store_epoch: int) -> Optional[str]:
        """Deterministic journal↔store crash reconciliation at startup,
        BEFORE any append. The serve tick journals first and persists the
        store second, so a crash in between leaves the journal one epoch
        ahead; restart refetches and re-journals that window, which would
        duplicate its records. With epoch markers the resolution is exact:

        * journal ahead (markers past ``store_epoch``) → truncate the file
          back to just before the first unproven tick's marker — those
          ticks were never durably published and will be re-journaled
          verbatim by the refetch;
        * store ahead (newest marker below ``store_epoch``) → the journal
          lost ticks the store kept (deleted/rolled-back file): keep both,
          warn — history is missing but nothing is inconsistent;
        * no markers (pre-epoch or memory-only journal) → None: nothing to
          reconcile against, legacy behavior stands.

        Returns the verdict ("consistent" / "journal_ahead" /
        "store_ahead") or None when markers are absent."""
        if self.readonly:
            raise RuntimeError("journal opened readonly")
        with self._lock:
            if not self.path or not self._markers:
                return None
            cut = next(
                (idx for idx, epoch in self._markers if epoch > int(store_epoch)), None
            )
            if cut is None:
                if self.last_epoch is not None and self.last_epoch < int(store_epoch):
                    self._warn(
                        f"journal at {self.path} is behind the digest store "
                        f"(journal epoch {self.last_epoch}, store epoch "
                        f"{int(store_epoch)}) — keeping both; the missing "
                        f"ticks' history was lost with the journal"
                    )
                    return "store_ahead"
                return "consistent"
            from krr_tpu_torch.core.streaming import DigestStore

            if self._file is not None:
                self._file.close()
                self._file = None
            with DigestStore.locked(self.path):
                before = self._n
                os.truncate(self.path, len(MAGIC) + cut * RECORD_DTYPE.itemsize)
                self._read_records()
                dropped = before - self._n
                self._file = open(self.path, "ab")
            self._warn(
                f"journal at {self.path} ran ahead of the digest store "
                f"(journal epoch past {int(store_epoch)}) — dropped {dropped} "
                f"record(s) from tick(s) the store never durably published; "
                f"they re-journal when the windows refetch"
            )
            return "journal_ahead"

    # ------------------------------------------------------------- compaction
    #: File rewrite triggers once this fraction of the on-disk records has
    #: aged out of memory. At steady state (journal span == retention) EVERY
    #: tick drops the oldest tick's records — rewriting + fsyncing the whole
    #: multi-hundred-MB file each tick, under the journal lock, inside the
    #: publish hop, would dominate the tick. The in-memory trim stays
    #: per-tick; the file carries at most ~10% aged records between rewrites
    #: (they re-trim on reload).
    REWRITE_FRACTION = 0.1

    def compact(self, now: float) -> int:
        """Drop records older than the retention window from the in-memory
        journal, returning the count dropped (no-op when nothing ages out).
        The file is rewritten atomically once enough of it has aged out
        (``REWRITE_FRACTION``) — not on every trim."""
        if self.readonly:
            raise RuntimeError("journal opened readonly")
        cutoff = float(now) - self.retention_seconds
        with self._lock:
            live = self._records[: self._n]
            keep = live["ts"] >= cutoff
            dropped = int(self._n - np.count_nonzero(keep))
            if not dropped:
                return 0
            self._install(live[keep])  # fancy indexing: already a fresh array
            surviving = {int(h) for h in np.unique(self._records["key_hash"])}
            self._names = {h: k for h, k in self._names.items() if h in surviving}
            if self.path:
                self._stale_in_file += dropped
                if self._stale_in_file >= self.REWRITE_FRACTION * (self._n + self._stale_in_file):
                    self._rewrite()
                    self._stale_in_file = 0
            return dropped

    def _rewrite(self) -> None:
        from krr_tpu_torch.core.streaming import DigestStore, atomic_write

        if self._file is not None:
            self._file.close()
            self._file = None
        # Re-stamp the NEWEST epoch marker into the rewritten file: older
        # markers interleave the raw file (not the in-memory arrays) and
        # are legitimately dropped — only the newest tick can ever be
        # journal-ahead-of-store (the tick journals first, persists second)
        # — but dropping that one too used to degrade reconcile_epoch to
        # its documented no-marker no-op, so a crash landing between a
        # compaction and the tick's store persist reconciled heuristically
        # instead of exactly. Marker-first framing is preserved: the marker
        # lands just before the first record of the newest tick.
        live = self._records[: self._n]
        marker_bytes = b""
        marker_index: Optional[int] = None
        if self.last_epoch is not None and self._n:
            newest = self._max_ts
            marker_index = int(np.argmax(live["ts"] == newest))
            marker = np.zeros(1, dtype=RECORD_DTYPE)
            marker["ts"] = newest
            marker["key_hash"] = np.uint64(int(self.last_epoch))
            marker["flags"] = FLAG_EPOCH
            marker_bytes = marker.tobytes()
        try:
            with DigestStore.locked(self.path):
                with atomic_write(self.path) as f:
                    f.write(MAGIC)
                    if marker_index is None:
                        f.write(live.tobytes())
                    else:
                        f.write(live[:marker_index].tobytes())
                        f.write(marker_bytes)
                        f.write(live[marker_index:].tobytes())
                self._save_names()
            self._markers = (
                [] if marker_index is None else [(marker_index, int(self.last_epoch))]
            )
        finally:
            # Reopen the append handle even when the rewrite failed (disk
            # full mid-compaction): atomic_write left the old file intact,
            # and a None handle would silently downgrade every later
            # append_tick to memory-only until the next rewrite.
            self._file = open(self.path, "ab")

    # ------------------------------------------------------------------ reads
    def records(self) -> np.ndarray:
        """Read-only snapshot of the live records (zero-copy: appends land
        past the snapshot's end and compaction swaps arrays wholesale, so a
        held view never observes mutation)."""
        with self._lock:
            view = self._records[: self._n]
        view.setflags(write=False)
        return view

    @property
    def record_count(self) -> int:
        return self._n

    @property
    def nbytes(self) -> int:
        return self._n * RECORD_DTYPE.itemsize

    @property
    def oldest_ts(self) -> Optional[float]:
        return self._min_ts

    @property
    def newest_ts(self) -> Optional[float]:
        return self._max_ts

    def key_name(self, key_hash: int) -> str:
        """The key string for a hash, or its hex form when the sidecar table
        was lost (display-only degradation)."""
        return self._names.get(int(key_hash), f"{int(key_hash):016x}")

    def records_by_workload(self):
        """Yield ``(key name, ts-sorted records)`` per workload — THE
        group-by for per-workload consumers (``GET /history``, offline
        tooling), so grouping/sort rules live in one place."""
        recs = self.records()
        if not len(recs):
            return
        order = np.lexsort((recs["ts"], recs["key_hash"]))
        recs = recs[order]
        hashes = recs["key_hash"]
        starts = np.flatnonzero(np.r_[True, hashes[1:] != hashes[:-1]])
        bounds = np.r_[starts, len(recs)]
        for start, end in zip(bounds[:-1], bounds[1:]):
            yield self.key_name(hashes[start]), recs[start:end]

    def tick_timestamps(self) -> np.ndarray:
        """Sorted unique tick timestamps in the retained window."""
        return np.unique(self.records()["ts"])

    def last_published(self) -> dict[str, tuple[float, float]]:
        """key → (cpu, mem) of each workload's newest PUBLISHED values — the
        trailing published baseline, used to re-seed the hysteresis gate
        after a restart (exact: float32 round-trips bit-identically).

        Per-RESOURCE forward fill, mirroring the gate: a published record
        stores the tick's RAW values, and when one resource was NaN at the
        publish the gate kept its prior finite held value — so a NaN slot
        falls back to the previous published record's finite value instead
        of seeding the gate with NaN. Hashes with no key-table entry (lost
        sidecar) are SKIPPED: a hex display name can never match a live
        ``object_key``, so seeding it would park dead state in the gate —
        those workloads just re-publish on their first tick instead."""
        recs = self.records()
        if not len(recs):
            return {}
        pub = recs[(recs["flags"] & FLAG_PUBLISHED) != 0]
        order = np.argsort(pub["ts"], kind="stable")
        out: dict[str, tuple[float, float]] = {}
        skipped = 0
        for row in pub[order]:
            name = self._names.get(int(row["key_hash"]))
            if name is None:
                skipped += 1
                continue
            prev_cpu, prev_mem = out.get(name, (float("nan"), float("nan")))
            cpu, mem = float(row["cpu"]), float(row["mem"])
            out[name] = (
                cpu if np.isfinite(cpu) else prev_cpu,
                mem if np.isfinite(mem) else prev_mem,
            )
        if skipped:
            self._warn(
                f"{skipped} published journal records have no key-table entry "
                f"(lost sidecar?) — their workloads re-publish on the next tick"
            )
        return out
