"""Durable sharded digest persistence: MANIFEST + base shards + delta WAL.

A copy of `krr_tpu/core/durastore.py`: the manifest, base shards, WAL
frames, CRC-32s and the legacy ``.npz`` are byte for byte the JAX
package's, so either package recovers the other's state.

The monolithic ``.npz`` rewrite (``DigestStore.save``) rewrites the whole
store on every persist, a cost that grows linearly with the fleet. This
module replaces it with a state DIRECTORY whose per-persist cost is one
small appended record:

``<state_path>/``
    ``MANIFEST.json``          the atomic commit point: format version, spec,
                               publish epoch at the last compaction, the
                               shard map with per-file CRC-32 checksums and
                               byte sizes, the live WAL's name, and the
                               ``extra_meta`` as of the last compaction.
                               Written via :func:`atomic_write` (tmp + fsync
                               + rename + directory fsync).
    ``base-<epoch>-<i>.npz``   contiguous row-range snapshots of the store
                               (the same byte format as the legacy single
                               file, sliced), written at compaction time.
    ``wal-<epoch>.log``        the delta write-ahead log: an 8-byte magic
                               header, then length-framed records —
                               ``[u32 payload_len][u32 crc32(payload)]
                               [payload]`` — each carrying one persist's
                               captured mutation ops (folded windows in CSR,
                               grown keys, dropped keys), the publish epoch,
                               and the full ``extra_meta`` (serve cursor /
                               quarantine / fetch-plan telemetry ride the
                               record header: same atomicity contract as
                               the monolithic save).

Durability rules (every one fault-injected in ``tests/test_torch_store.py``,
against the JAX package's store on the same operations):

* A persist appends ONE record and fsyncs — commit is the fsync returning.
  A torn tail (crash mid-append, mid-fsync, ENOSPC part-way) is detected by
  framing + CRC at open, truncated back to the last valid record, and the
  store reconstructs exactly the last durably-published state.
* A corrupt record mid-WAL (bit flip) stops replay THERE: everything from
  the corrupt record on is dropped and truncated — deterministic, never a
  partially-applied record.
* A corrupt BASE shard fails loudly with the offending file named — base
  snapshots are checksummed in the manifest and never silently skipped.
* Compaction (threshold-triggered: WAL bytes vs base bytes) writes NEW
  epoch-stamped shard files + a NEW empty WAL, fsyncs them, then flips the
  manifest atomically; old files are deleted after the flip and swept at
  the next open if the delete itself was lost. A crash at ANY point leaves
  either the old manifest (old files intact) or the new one (new files
  fully fsynced before the flip).
* Legacy single-file state auto-migrates on first sharded open: the file is
  renamed to ``<path>.migrating`` (preserved until the directory's manifest
  is durable), the directory is built beside it, and only then is the
  sidecar removed — a crash mid-migration restarts it from the sidecar.
  ``--store_format legacy`` keeps the old single-file shape bit-exact.

Epoch protocol: ``epoch`` increments once per durable persist and is
stamped into every WAL record (and the manifest at compaction). The serve
scheduler stamps the SAME epoch into the recommendation journal (an epoch
marker record precedes each tick's batch), so a restart can detect
journal-ahead-of-store (crash between the journal append and the store
persist) — and reconcile deterministically by truncating the journal back
to the store's epoch — instead of heuristically (see
``RecommendationJournal.reconcile_epoch``).
"""

from __future__ import annotations

import io
import json
import os
import shutil
import struct
import time
import zlib
from typing import Optional

import numpy as np

from krr_tpu_torch.core.streaming import (
    FS,
    DigestStore,
    FsOps,
    atomic_write,
    csr_encode,
    flatnonzero_f32,
)
from krr_tpu_torch.ops.digest import DigestSpec
from krr_tpu_torch.utils.logging import KrrLogger

MANIFEST_NAME = "MANIFEST.json"
#: On-disk format version stamped into the manifest.
STORE_FORMAT_VERSION = 1
WAL_MAGIC = b"KRRWAL1\n"
#: [u32 LE payload length][u32 LE crc32(payload)]
_FRAME = struct.Struct("<II")


def _crc(data: bytes) -> int:
    return zlib.crc32(data) & 0xFFFFFFFF


#: Public aliases for sibling durable logs that REUSE this framing (the
#: scan timeline, `krr_tpu/obs/timeline.py`; the federation wire protocol,
#: `krr_tpu/federation/protocol.py`, in the JAX package): same ``[u32 LE payload_len]
#: [u32 LE crc32(payload)][payload]`` frames, same torn-tail discipline.
FRAME = _FRAME
frame_crc = _crc


# --------------------------------------------------------- record seams
#
# The WAL record's encode/decode/apply halves are PUBLIC module functions:
# the federation subsystem (`krr_tpu/federation`) promotes the exact same
# record bytes from a disk format to a network protocol — a scanner shard
# encodes its tick's captured ops with `encode_ops` and the aggregator
# replays them with `decode_ops` + `apply_ops`, so the wire format and the
# WAL format cannot drift apart.

def encode_ops(ops: list, *, epoch: int, extra: dict, num_buckets: int) -> bytes:
    """Encode captured mutation ops (`DigestStore.pending_ops`) into one
    record payload: an ``.npz`` whose ``meta`` member carries the epoch,
    caller annotations (``extra``), and the op descriptors, with the fold
    windows stored sparsely (CSR)."""
    descriptors: list[dict] = []
    arrays: dict[str, np.ndarray] = {}
    for i, op in enumerate(ops):
        kind = op[0]
        if kind in ("fold", "fold_csr"):
            if kind == "fold":
                _, keys, cpu_counts, cpu_total, cpu_peak, mem_total, mem_peak = op
                # The bit-view occupied scan: the window matrix is the
                # record's dominant cost at fleet scale, and the fast
                # scan replays bit-identically (see flatnonzero_f32).
                vals, cols, indptr = csr_encode(
                    cpu_counts, num_buckets, len(cpu_total),
                    flat=flatnonzero_f32(cpu_counts),
                )
            else:  # pre-encoded by compact_pending (persist-failure backlog)
                _, keys, vals, cols, indptr, cpu_total, cpu_peak, mem_total, mem_peak = op
            arrays[f"f{i}_vals"] = vals
            arrays[f"f{i}_cols"] = cols
            arrays[f"f{i}_indptr"] = indptr
            arrays[f"f{i}_cpu_total"] = np.asarray(cpu_total, np.float32)
            arrays[f"f{i}_cpu_peak"] = np.asarray(cpu_peak, np.float32)
            arrays[f"f{i}_mem_total"] = np.asarray(mem_total, np.float32)
            arrays[f"f{i}_mem_peak"] = np.asarray(mem_peak, np.float32)
            descriptor = {"kind": "fold"}
            if keys is not None:  # whole-store folds elide the key list
                descriptor["keys"] = list(keys)
            descriptors.append(descriptor)
        else:  # grow / drop carry only keys
            descriptors.append({"kind": kind, "keys": list(op[1])})
    meta = {"epoch": int(epoch), "extra": extra, "ops": descriptors}
    buf = io.BytesIO()
    # JSON as a uint8 byte array: np.savez stores str scalars as UCS-4
    # (4 bytes per char — a fleet-wide key list would quadruple).
    np.savez(
        buf,
        meta=np.frombuffer(json.dumps(meta).encode("utf-8"), dtype=np.uint8),
        **arrays,
    )
    return buf.getvalue()


def decode_ops(payload: bytes) -> "tuple[dict, list]":
    """Decode one record payload FULLY into ``(meta, parsed_ops)`` without
    touching any store — the parse half of replay. A payload that fails to
    decode raises before anything applies, so a replayer can stop cleanly
    at the previous record, never half-applied."""
    with np.load(io.BytesIO(payload), allow_pickle=False) as data:
        meta = json.loads(bytes(data["meta"]).decode("utf-8"))
        parsed: list[tuple] = []
        for i, op in enumerate(meta["ops"]):
            kind = op["kind"]
            if kind == "fold":
                parsed.append(
                    (
                        kind,
                        op.get("keys"),
                        data[f"f{i}_vals"],
                        data[f"f{i}_cols"],
                        data[f"f{i}_indptr"],
                        data[f"f{i}_cpu_total"],
                        data[f"f{i}_cpu_peak"],
                        data[f"f{i}_mem_total"],
                        data[f"f{i}_mem_peak"],
                    )
                )
            elif kind in ("grow", "drop"):
                parsed.append((kind, list(op["keys"])))
            else:
                raise ValueError(f"unknown WAL op kind {kind!r}")
    return meta, parsed


def apply_ops(store: DigestStore, parsed: list) -> None:
    """Apply decoded ops onto ``store`` in order — the mutate half of
    replay. Ordered replay of captured fold CONTRIBUTIONS re-runs the same
    exact float32 adds and peak maxes, so the per-key state is
    bit-identical to having folded the windows directly. Does NOT touch
    ``extra_meta`` or any epoch bookkeeping (callers own both: WAL
    recovery installs the record's extra wholesale, the federation
    aggregator keeps its own fleet-level meta)."""
    for op in parsed:
        kind = op[0]
        if kind == "fold":
            _, keys, vals, cols, indptr, cpu_total, cpu_peak, mem_total, mem_peak = op
            rows = len(indptr) - 1
            if keys is None:
                # Whole-store fold (key list elided at capture: it
                # equaled the store's rows). Apply the CSR straight
                # onto the row arrays — bit-identical to the dense
                # fold (CSR positions are unique, the skipped cells
                # would have added +0.0) without materializing a
                # dense [N x B] window per replayed record.
                if len(store.keys) != rows:
                    raise ValueError(
                        f"whole-store fold expects {rows} rows, store has {len(store.keys)}"
                    )
                cols = np.asarray(cols).astype(np.int64, copy=False)
                row_of = np.repeat(np.arange(rows, dtype=np.int64), np.diff(indptr))
                store.cpu_counts.ravel()[row_of * store.spec.num_buckets + cols] += vals
                store.cpu_total += cpu_total
                np.maximum(store.cpu_peak, cpu_peak, out=store.cpu_peak)
                store.mem_total += mem_total
                np.maximum(store.mem_peak, mem_peak, out=store.mem_peak)
            else:
                # Keyed records scatter sparsely (no dense [rows x B]
                # materialization — the aggregator replays MANY of these
                # per tick) and re-capture in CSR form, so a durable
                # aggregator's own WAL appends pin kilobytes, not dense
                # windows. Bit-identical to the dense fold (see
                # `DigestStore.merge_window_csr`).
                store.merge_window_csr(
                    keys, vals, cols, indptr,
                    cpu_total, cpu_peak, mem_total, mem_peak,
                )
        elif kind == "grow":
            store.rows_for(op[1])
        else:  # "drop" — the parse phase rejected unknown kinds
            store.compact(frozenset(store.keys) - set(op[1]))


class DurableStore:
    """A resident :class:`DigestStore` plus its durable on-disk form.

    ``fmt == "sharded"``: the state-directory layout above, delta appends
    per persist, threshold compaction. ``fmt == "legacy"``: the classic
    single-file atomic rewrite (the escape hatch — byte-compatible with
    existing state files). Callers hold ``DigestStore.locked(path)`` around
    open/persist cycles exactly as before; a running serve process owns its
    state exclusively between ticks.
    """

    def __init__(
        self,
        store: DigestStore,
        path: str,
        fmt: str,
        *,
        shard_rows: int = 32768,
        compact_wal_ratio: float = 0.5,
        compact_min_bytes: int = 16 << 20,
        fs: Optional[FsOps] = None,
        metrics=None,
        logger: Optional[KrrLogger] = None,
    ) -> None:
        self.store = store
        self.path = path
        self.fmt = fmt
        self.shard_rows = int(shard_rows)
        self.compact_wal_ratio = float(compact_wal_ratio)
        self.compact_min_bytes = int(compact_min_bytes)
        self.fs = fs or FS
        self.metrics = metrics
        self.logger = logger
        #: Publish epoch: the number of durable persists this state has
        #: seen. 0 for a fresh (or legacy-format) store.
        self.epoch = 0
        self._shards: list[dict] = []
        self._wal_name: Optional[str] = None
        self._wal_file = None
        self._wal_size = 0
        self._wal_records = 0
        self._base_bytes = 0
        #: Set when an append failed part-way: the next persist truncates
        #: the file back to the last known-good size before writing.
        self._wal_dirty_tail = False

    @property
    def wal_size(self) -> int:
        """Bytes in the live WAL (header included) — the public read the
        scheduler uses to attribute per-tick appended bytes; 0 for the
        legacy single-file format."""
        return self._wal_size

    # ------------------------------------------------------------------ open
    @classmethod
    def open(
        cls,
        path: str,
        spec: DigestSpec,
        *,
        store_format: str = "sharded",
        shard_rows: int = 32768,
        compact_wal_ratio: float = 0.5,
        compact_min_bytes: int = 16 << 20,
        fs: Optional[FsOps] = None,
        metrics=None,
        logger: Optional[KrrLogger] = None,
    ) -> "DurableStore":
        """Open (or create) durable digest state at ``path``.

        Sharded format: an existing directory recovers (checksum-verified
        bases + WAL replay + stale-file sweep); an existing legacy FILE
        auto-migrates into a directory; a missing path creates a fresh
        directory. Legacy format: the classic single-file open (a directory
        at ``path`` is refused with a pointer at the flag)."""
        fs = fs or FS
        t0 = time.perf_counter()
        if store_format == "legacy":
            if os.path.isdir(path):
                raise ValueError(
                    f"digest state at {path} is a sharded state directory, but "
                    f"--store_format legacy asked for the single-file format; "
                    f"drop the flag (or point at a different path)"
                )
            self = cls(
                DigestStore.open_or_create(path, spec), path, "legacy",
                fs=fs, metrics=metrics, logger=logger,
            )
            self._record_recovery(t0)
            return self
        if store_format != "sharded":
            raise ValueError(f"unknown store format {store_format!r}; one of ['sharded', 'legacy']")

        self = cls(
            DigestStore(spec=spec), path, "sharded",
            shard_rows=shard_rows, compact_wal_ratio=compact_wal_ratio,
            compact_min_bytes=compact_min_bytes, fs=fs, metrics=metrics, logger=logger,
        )
        migrating = path + ".migrating"
        legacy: Optional[DigestStore] = None
        if os.path.isfile(path):
            # Auto-migration, step 1: move the legacy file aside. It stays
            # on disk until the directory's manifest is durable, so a crash
            # anywhere in the migration restarts it from the sidecar.
            legacy = cls._load_legacy(path, spec)
            fs.replace(path, migrating)
            fs.fsync_dir(os.path.dirname(os.path.abspath(path)) or ".")
        if legacy is None and os.path.exists(migrating):
            if not os.path.isfile(os.path.join(path, MANIFEST_NAME)):
                # Crash mid-migration before the manifest committed: the
                # directory (if any) is a partial artifact of OUR migration;
                # rebuild it from the preserved legacy sidecar.
                self._warn(
                    f"resuming interrupted migration of {path} from {migrating}"
                )
                if os.path.isdir(path):
                    shutil.rmtree(path)
                legacy = cls._load_legacy(migrating, spec)
            else:
                # Manifest committed but the sidecar delete was lost.
                os.unlink(migrating)

        if legacy is not None:
            self.store = legacy
            os.makedirs(path, exist_ok=True)
            fs.fsync_dir(os.path.dirname(os.path.abspath(path)) or ".")
            self._compact()  # writes bases + empty WAL + manifest at epoch 0
            if os.path.exists(migrating):
                os.unlink(migrating)
                fs.fsync_dir(os.path.dirname(os.path.abspath(path)) or ".")
            self._note(
                f"migrated legacy digest state into sharded directory {path} "
                f"({len(self.store.keys)} rows, {len(self._shards)} shard(s))"
            )
        elif not os.path.exists(path):
            os.makedirs(path)
            fs.fsync_dir(os.path.dirname(os.path.abspath(path)) or ".")
            self._compact()
        else:
            self._recover()
        self.store.track_deltas = True
        self._record_recovery(t0)
        return self

    @staticmethod
    def _load_legacy(path: str, spec: DigestSpec) -> DigestStore:
        store = DigestStore.open_or_create(path, spec)
        return store

    def _warn(self, message: str) -> None:
        if self.logger is not None:
            self.logger.warning(message)

    def _note(self, message: str) -> None:
        if self.logger is not None:
            self.logger.info(message)

    def _record_recovery(self, t0: float) -> None:
        if self.metrics is not None:
            self.metrics.set("krr_tpu_store_recovery_seconds", time.perf_counter() - t0)
        self._update_gauges()

    def _update_gauges(self) -> None:
        if self.metrics is not None and self.fmt == "sharded":
            self.metrics.set("krr_tpu_store_wal_bytes", self._wal_size)
            self.metrics.set("krr_tpu_store_wal_records", self._wal_records)

    # -------------------------------------------------------------- recovery
    def _manifest_path(self) -> str:
        return os.path.join(self.path, MANIFEST_NAME)

    def _recover(self) -> None:
        """Reconstruct exactly the last durably-published state: verified
        base shards, then WAL replay up to the last valid record (torn or
        corrupt tails truncate), then a sweep of unreferenced files."""
        try:
            with open(self._manifest_path()) as f:
                manifest = json.load(f)
        except FileNotFoundError:
            raise ValueError(
                f"digest state directory {self.path} has no {MANIFEST_NAME} — "
                f"not a krr-tpu state directory (or one corrupted beyond its "
                f"commit point); delete the directory to start fresh"
            ) from None
        except (OSError, ValueError) as e:
            raise ValueError(
                f"digest state manifest at {self._manifest_path()} is unreadable "
                f"({type(e).__name__}: {e}); restore it from backup or delete "
                f"the state directory to start fresh"
            ) from e
        mspec = manifest.get("spec", {})
        spec = self.store.spec
        if (mspec.get("gamma"), mspec.get("min_value"), mspec.get("num_buckets")) != (
            spec.gamma, spec.min_value, spec.num_buckets,
        ):
            raise ValueError(
                f"digest state at {self.path} was built with spec {mspec}, "
                f"incompatible with requested {spec}; delete the state "
                f"directory or match the settings"
            )

        parts: list[DigestStore] = []
        base_bytes = 0
        for shard in manifest.get("shards", ()):
            shard_path = os.path.join(self.path, shard["file"])
            try:
                with open(shard_path, "rb") as f:
                    data = f.read()
            except OSError as e:
                raise ValueError(
                    f"digest base shard {shard_path} is missing or unreadable "
                    f"({e}); restore it from backup or delete the state directory"
                ) from e
            if len(data) != shard["bytes"] or _crc(data) != shard["crc32"]:
                raise ValueError(
                    f"digest base shard {shard_path} is corrupt (checksum "
                    f"mismatch: {len(data)} bytes, crc {_crc(data):#010x}, "
                    f"manifest says {shard['bytes']} bytes, crc "
                    f"{shard['crc32']:#010x}); restore it from backup or "
                    f"delete the state directory"
                )
            part = DigestStore.load(io.BytesIO(data))
            if len(part.keys) != shard["rows"]:
                raise ValueError(
                    f"digest base shard {shard_path} holds {len(part.keys)} "
                    f"rows where the manifest says {shard['rows']}"
                )
            parts.append(part)
            base_bytes += len(data)
        self.store = _concat_stores(self.store.spec, parts)
        self.store.extra_meta = dict(manifest.get("extra", {}))
        self.epoch = int(manifest.get("epoch", 0))
        self._shards = list(manifest.get("shards", ()))
        self._base_bytes = base_bytes
        self._wal_name = manifest["wal"]
        self._replay_wal()
        self._sweep()
        self._open_wal_append()

    def _replay_wal(self) -> None:
        wal_path = os.path.join(self.path, self._wal_name)
        try:
            f = open(wal_path, "rb")
        except FileNotFoundError:
            # The manifest commits only after the WAL is fsynced, so a
            # missing WAL means someone deleted it by hand: treat as empty.
            self._warn(f"WAL {wal_path} is missing — continuing from the base snapshots")
            self._reset_wal_file(wal_path)
            self._wal_size, self._wal_records = len(WAL_MAGIC), 0
            return
        with f:
            size = os.fstat(f.fileno()).st_size
            head = f.read(len(WAL_MAGIC))
            if head != WAL_MAGIC:
                self._warn(
                    f"WAL {wal_path} has an unrecognized header — resetting it; "
                    f"state recovers to the last base snapshot"
                )
                self._reset_wal_file(wal_path)
                self._wal_size, self._wal_records = len(WAL_MAGIC), 0
                return
            good = len(WAL_MAGIC)
            records = 0
            while True:
                header = f.read(_FRAME.size)
                if len(header) < _FRAME.size:
                    break
                length, crc = _FRAME.unpack(header)
                payload = f.read(length)
                if len(payload) < length or _crc(payload) != crc:
                    break
                try:
                    self._apply_record(payload)
                except Exception as e:
                    self._warn(
                        f"WAL {wal_path} record {records} fails to decode "
                        f"({type(e).__name__}: {e}) — truncating from it"
                    )
                    break
                good += _FRAME.size + length
                records += 1
        if good < size:
            self._warn(
                f"WAL {wal_path} ends in {size - good} invalid byte(s) "
                f"(torn or corrupt record) — truncating to the last valid "
                f"record ({records} replayed)"
            )
            os.truncate(wal_path, good)
        self._wal_size = good
        self._wal_records = records

    def _apply_record(self, payload: bytes) -> None:
        """Decode FULLY, then apply (via the public `decode_ops` /
        `apply_ops` seams): a record that fails to decode (an encoder bug —
        the CRC already vouched for the bytes) must leave the store
        untouched so replay can stop cleanly at the previous record, never
        half-applied."""
        meta, parsed = decode_ops(payload)
        apply_ops(self.store, parsed)
        self.store.extra_meta = dict(meta.get("extra", {}))
        self.epoch = int(meta["epoch"])

    def _sweep(self) -> None:
        """Remove files the manifest doesn't reference: superseded bases and
        WALs whose post-compaction delete was lost, plus stale ``*.tmp``
        leftovers from crashed :func:`atomic_write` / ``mkstemp`` calls."""
        keep = {MANIFEST_NAME, self._wal_name} | {s["file"] for s in self._shards}
        swept = 0
        for entry in os.listdir(self.path):
            if entry in keep:
                continue
            if (
                entry.endswith(".tmp")
                or (entry.startswith("base-") and entry.endswith(".npz"))
                or (entry.startswith("wal-") and entry.endswith(".log"))
                or entry.endswith(".lock")
            ):
                with_path = os.path.join(self.path, entry)
                try:
                    os.unlink(with_path)
                    swept += 1
                except OSError:
                    pass
        if swept:
            self._note(f"swept {swept} stale file(s) from state directory {self.path}")

    # --------------------------------------------------------------- persist
    def save_delta(self) -> None:
        """Persist everything since the last persist as ONE appended WAL
        record (sharded) or a full atomic rewrite (legacy). Raises OSError
        on disk faults (ENOSPC/EIO) with the in-memory state untouched and
        the captured ops still queued — the caller degrades and the next
        fault-free persist carries the backlog."""
        if self.fmt == "legacy":
            self.store.save(self.path)
            return
        ops = self.store.pending_ops()
        payload = self._encode_record(ops, epoch=self.epoch + 1)
        frame = _FRAME.pack(len(payload), _crc(payload)) + payload
        f = self._wal_file
        if f is None:
            f = self._open_wal_append()
        # Liveness check: the WAL name must still resolve to OUR open inode.
        # If another process compacted the same state directory (a live
        # server owns its state EXCLUSIVELY; one-shot merges belong before
        # it starts, not beside it), our file was unlinked or replaced —
        # appending would fsync-acknowledge ticks into an orphaned inode
        # that recovery can never see. Fail LOUDLY into the persist-degrade
        # path instead of losing them silently. (Path-vs-fd inode compare,
        # not st_nlink: overlayfs keeps nlink=1 on open-but-unlinked fds.)
        try:
            path_stat = os.stat(os.path.join(self.path, self._wal_name))
            fd_stat = os.fstat(f.fileno())
            live = (path_stat.st_ino, path_stat.st_dev) == (fd_stat.st_ino, fd_stat.st_dev)
        except FileNotFoundError:
            live = False
        if not live:
            raise OSError(
                f"WAL {self._wal_name} in {self.path} was replaced by another "
                f"process — this state directory is not exclusively owned"
            )
        if self._wal_dirty_tail:
            # A previous append failed part-way: cut the torn bytes before
            # appending, or the tail would corrupt every later record.
            self.fs.truncate(f, self._wal_size)
            self._wal_dirty_tail = False
        try:
            self.fs.append(f, frame)
            f.flush()
            self.fs.fsync(f)
        except BaseException:
            self._wal_dirty_tail = True
            raise
        self._wal_size += len(frame)
        self._wal_records += 1
        self.epoch += 1
        self.store.clear_pending(len(ops))
        self._update_gauges()
        self.maybe_compact()

    def _encode_record(self, ops: list, *, epoch: int) -> bytes:
        return encode_ops(
            ops,
            epoch=epoch,
            extra=self.store.extra_meta,
            num_buckets=self.store.spec.num_buckets,
        )

    # ------------------------------------------------------------ compaction
    def maybe_compact(self, force: bool = False) -> bool:
        """Fold the WAL back into base shards once it has grown past the
        threshold (``max(compact_min_bytes, compact_wal_ratio × base
        bytes)``) so replay time stays bounded. Amortized: the per-tick
        persist stays one small append; the full-rewrite cost lands once
        per threshold crossing."""
        if self.fmt != "sharded":
            return False
        threshold = max(self.compact_min_bytes, self.compact_wal_ratio * max(self._base_bytes, 1))
        if not force and self._wal_size < threshold:
            return False
        self._compact()
        return True

    def _compact(self) -> None:
        """Write new epoch-stamped base shards + a fresh WAL, fsync them,
        then flip the manifest atomically. Old files are deleted after the
        flip (and swept at the next open if this process dies first)."""
        fs = self.fs
        store = self.store
        n = len(store.keys)
        old_files = [s["file"] for s in self._shards]
        if self._wal_name:
            old_files.append(self._wal_name)
        shards: list[dict] = []
        for i, lo in enumerate(range(0, n, self.shard_rows)):
            hi = min(lo + self.shard_rows, n)
            buf = io.BytesIO()
            store.row_slice(lo, hi).write_npz(buf)
            data = buf.getvalue()
            fname = f"base-{self.epoch:08d}-{i:04d}.npz"
            with open(os.path.join(self.path, fname), "wb") as f:
                fs.write(f, data)
                f.flush()
                fs.fsync(f)
            shards.append(
                {"file": fname, "rows": hi - lo, "crc32": _crc(data), "bytes": len(data)}
            )
        wal_name = f"wal-{self.epoch:08d}.log"
        self._reset_wal_file(os.path.join(self.path, wal_name))
        manifest = {
            "format": STORE_FORMAT_VERSION,
            "spec": {
                "gamma": store.spec.gamma,
                "min_value": store.spec.min_value,
                "num_buckets": store.spec.num_buckets,
            },
            "epoch": self.epoch,
            "rows": n,
            "shards": shards,
            "wal": wal_name,
            "extra": store.extra_meta,
        }
        with atomic_write(self._manifest_path(), "w", fs=fs) as f:
            json.dump(manifest, f)
        # Committed. Swap handles and clean up the superseded generation.
        if self._wal_file is not None:
            self._wal_file.close()
            self._wal_file = None
        self._shards = shards
        self._wal_name = wal_name
        self._wal_size = len(WAL_MAGIC)
        self._wal_records = 0
        self._wal_dirty_tail = False
        self._base_bytes = sum(s["bytes"] for s in shards)
        self._open_wal_append()
        for fname in old_files:
            if fname == wal_name or any(s["file"] == fname for s in shards):
                continue
            try:
                os.unlink(os.path.join(self.path, fname))
            except OSError:
                pass  # swept at the next open
        if self.metrics is not None:
            self.metrics.inc("krr_tpu_store_compactions_total")
        self._update_gauges()

    def _reset_wal_file(self, wal_path: str) -> None:
        with open(wal_path, "wb") as f:
            self.fs.write(f, WAL_MAGIC)
            f.flush()
            self.fs.fsync(f)

    def _open_wal_append(self):
        self._wal_file = open(os.path.join(self.path, self._wal_name), "ab")
        return self._wal_file

    def close(self) -> None:
        if self._wal_file is not None:
            self._wal_file.close()
            self._wal_file = None


def _concat_stores(spec: DigestSpec, parts: list[DigestStore]) -> DigestStore:
    """Concatenate row-range shards back into one store, in shard order —
    which is key order, so the reconstructed store's key list (and
    therefore every later fold's row layout) is bit-identical to the
    pre-crash store's."""
    if not parts:
        return DigestStore(spec=spec)
    keys: list[str] = []
    for part in parts:
        keys.extend(part.keys)
    return DigestStore(
        spec=spec,
        keys=keys,
        cpu_counts=np.concatenate([p.cpu_counts for p in parts]),
        cpu_total=np.concatenate([p.cpu_total for p in parts]),
        cpu_peak=np.concatenate([p.cpu_peak for p in parts]),
        mem_total=np.concatenate([p.mem_total for p in parts]),
        mem_peak=np.concatenate([p.mem_peak for p in parts]),
    )
