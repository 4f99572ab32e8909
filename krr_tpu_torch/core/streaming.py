"""Incremental digest state: streaming, multi-source merge, checkpoint/resume.

The reference is stateless end-to-end (SURVEY.md §5 "checkpoint/resume:
absent"); its only knob for long histories is a coarser Prometheus step. The
digest's associative merge gives us something stronger for free: persist each
container's digest, and

* **streaming** = merge the new window's digest into the stored one (no
  re-fetch of old history);
* **multi-source** = scan each Prometheus source (cluster, federated shard,
  region) separately against the same store — merges commute, order doesn't
  matter (BASELINE.md config 5);
* **checkpoint/resume** = the store *is* the checkpoint; a killed run loses
  only the unmerged window.

A copy of `krr_tpu/core/streaming.py`: the same arrays, keys and files, so
a state written by either package opens in the other.

State lives in one ``.npz`` (bucket counts / totals / peaks / memory peaks)
plus row keys, keyed by the object identity string, so fleets can grow,
shrink, and reorder between scans.
"""

from __future__ import annotations

import contextlib
import fcntl
import json
import os
import tempfile
from dataclasses import dataclass, field
from typing import Iterator, Optional

import numpy as np

from krr_tpu_torch.models.objects import K8sObjectData
from krr_tpu_torch.ops.digest import DigestSpec


def object_key(obj: K8sObjectData) -> str:
    return f"{obj.cluster or ''}/{obj.namespace}/{obj.name}/{obj.container}/{obj.kind or ''}"


def split_object_key(key: str) -> "tuple[Optional[str], str, str, str, Optional[str]]":
    """The inverse of :func:`object_key`: ``(cluster, namespace, name,
    container, kind)`` with empty segments back to None. Splits from the
    RIGHT: only the cluster segment can itself contain ``/`` (EKS context
    names are ARNs like ``arn:aws:eks:...:cluster/prod``), and a left split
    would shift every field. Lives beside the forward map so every consumer
    (the /history filters, the diff renderer) parses identically."""
    parts = key.rsplit("/", 4)
    if len(parts) < 5:
        parts = [""] * (5 - len(parts)) + parts
    cluster, namespace, name, container, kind = parts
    return cluster or None, namespace, name, container, kind or None


def filter_key_indices(
    keys,
    namespaces=(),
    workloads=(),
    containers=(),
) -> "list[int]":
    """Row indices of ``keys`` (object-key strings, the store/snapshot key
    table) whose namespace / workload name / container match the filter
    sets (an empty set is a wildcard) — the serve read path's filter
    pushdown: ``GET /recommendations?namespace=…`` resolves indices against
    this key table and materializes ONLY the selected rows, instead of
    iterating every rendered scan object per request. Parses through
    :func:`split_object_key` so the HTTP filters and every other key
    consumer (/history, the diff renderer) agree on the key grammar."""
    if not (namespaces or workloads or containers):
        return list(range(len(keys)))
    out: list[int] = []
    for i, key in enumerate(keys):
        _cluster, namespace, name, container, _kind = split_object_key(key)
        if namespaces and namespace not in namespaces:
            continue
        if workloads and name not in workloads:
            continue
        if containers and container not in containers:
            continue
        out.append(i)
    return out


class FsOps:
    """Every durability-critical filesystem syscall behind one injectable
    seam. The durable store (`krr_tpu_torch.core.durastore`), :func:`atomic_write`,
    and the WAL appends all route their fsync/rename/append/write calls
    through an ``FsOps`` instance, so fault-injection harnesses (the chaos
    fakes' disk-fault injector, the crash-point matrix in the durability
    tests) can script ENOSPC/EIO — or a simulated crash — at any single
    fault point without monkeypatching ``os``."""

    def write(self, f, data: bytes) -> None:
        f.write(data)

    def append(self, f, data: bytes) -> None:
        """Same syscall as :meth:`write`, named separately so WAL appends
        are their own fault point (scripts can fail the per-tick delta
        append without also failing base-snapshot writes)."""
        f.write(data)

    def fsync(self, f) -> None:
        os.fsync(f.fileno())

    def replace(self, src: str, dst: str) -> None:
        os.replace(src, dst)

    def fsync_dir(self, path: str) -> None:
        """fsync a DIRECTORY: makes renames/creates/unlinks inside it
        durable. Without it, a crash shortly after ``os.replace`` can lose
        the rename itself — the old name comes back after the reboot even
        though the replace "succeeded"."""
        fd = os.open(path, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)

    def truncate(self, f, size: int) -> None:
        f.truncate(size)


#: The process-default ops. Durable-store instances carry their own
#: reference so tests can fault one store without touching the process.
FS = FsOps()


@contextlib.contextmanager
def atomic_write(path: str, mode: str = "wb", fs: Optional[FsOps] = None) -> Iterator:
    """Crash-safe file replacement: write a temp file in the target's
    directory, FSYNC it, atomically rename over ``path``, then FSYNC the
    parent directory. The file fsync before the rename is load-bearing:
    rename-only guarantees the old OR new *name*, but a crash shortly after
    the rename can land the new name on unwritten data — a truncated
    store/journal, which is strictly worse than the stale-but-complete file
    the rename was meant to preserve. The directory fsync after it makes
    the RENAME itself durable: until the parent's metadata hits disk, a
    crash can resurrect the old file even though ``os.replace`` returned.
    Shared by the digest store (manifest + legacy snapshot), the serve
    window cursor (inside the store's save), and the recommendation
    journal."""
    fs = fs or FS
    directory = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    try:
        with os.fdopen(fd, mode) as f:
            yield f
            f.flush()
            fs.fsync(f)
        fs.replace(tmp, path)
        fs.fsync_dir(directory)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def flatnonzero_f32(counts: np.ndarray) -> np.ndarray:
    """``np.flatnonzero`` over a float32 matrix via its int32 bit view —
    ~3x faster at WAL-record scale (the comparison runs on integers and
    skips float semantics). Only divergence from the float comparison:
    ``-0.0`` reads as occupied; digest counts are sums of non-negative
    values, and an explicit ``-0.0`` entry replays to bit-identical state
    anyway (x + -0.0 == x, 0.0 + -0.0 == +0.0)."""
    return np.flatnonzero(np.ascontiguousarray(counts).view(np.int32))


def csr_encode(counts: np.ndarray, num_buckets: int, rows: int, flat: Optional[np.ndarray] = None):
    """Sparse (CSR) encoding of a ``[rows x num_buckets]`` count matrix —
    ``(vals, cols, indptr)`` with the same dtypes the legacy ``.npz``
    snapshot format uses (byte-compatibility is load-bearing: the sharded
    base snapshots and the legacy single-file format share this encoder).
    ``flat`` injects a precomputed occupied-index array (the WAL encoder
    passes :func:`flatnonzero_f32`'s); default is the exact float scan the
    legacy format has always used."""
    if flat is None:
        flat = np.flatnonzero(counts)
    vals = counts.ravel()[flat]
    col_dtype = np.uint16 if num_buckets <= np.iinfo(np.uint16).max else np.int32
    cols = (flat % num_buckets).astype(col_dtype)
    per_row = np.bincount(flat // num_buckets, minlength=rows)
    indptr = np.zeros(rows + 1, dtype=np.int64)
    np.cumsum(per_row, out=indptr[1:])
    return vals, cols, indptr


def csr_decode(vals, cols, indptr, rows: int, num_buckets: int) -> np.ndarray:
    """Inverse of :func:`csr_encode` back to the dense float32 matrix."""
    cols = np.asarray(cols).astype(np.int64, copy=False)
    counts = np.zeros((rows, num_buckets), dtype=np.float32)
    row_of = np.repeat(np.arange(rows, dtype=np.int64), np.diff(indptr))
    counts.ravel()[row_of * num_buckets + cols] = vals
    return counts


@dataclass
class DigestStore:
    """Host-side persistent digest state for a fleet."""

    spec: DigestSpec
    keys: list[str] = field(default_factory=list)
    cpu_counts: np.ndarray = None  # [N, B] float32
    cpu_total: np.ndarray = None  # [N] float32
    cpu_peak: np.ndarray = None  # [N] float32 (-inf when empty)
    mem_total: np.ndarray = None  # [N] float32
    mem_peak: np.ndarray = None  # [N] float32, in MB (-inf when empty)
    #: Caller-owned JSON-serializable annotations persisted INSIDE the same
    #: atomic save as the arrays (the serve scheduler keeps its window
    #: cursor here — a sidecar file could desync from the store on a crash
    #: between two writes, which is exactly a lost or double-counted
    #: window). Round-trips through save/load; absent in legacy files.
    extra_meta: dict = field(default_factory=dict)

    def __post_init__(self) -> None:
        n, b = len(self.keys), self.spec.num_buckets
        if self.cpu_counts is None:
            self.cpu_counts = np.zeros((n, b), dtype=np.float32)
            self.cpu_total = np.zeros(n, dtype=np.float32)
            self.cpu_peak = np.full(n, -np.inf, dtype=np.float32)
            self.mem_total = np.zeros(n, dtype=np.float32)
            self.mem_peak = np.full(n, -np.inf, dtype=np.float32)
        self._index = {key: i for i, key in enumerate(self.keys)}
        #: Delta capture for the durable WAL (`krr_tpu_torch.core.durastore`):
        #: when enabled, every mutation appends a replayable op — ("fold",
        #: keys, window arrays), ("grow", keys), ("drop", keys) — so a
        #: persist can append ONLY this tick's contribution instead of
        #: rewriting the whole state. Off by default: untracked consumers
        #: (cold CLI scans) must not accumulate window arrays forever.
        self.track_deltas = False
        #: When True, whole-store folds capture their key list EXPLICITLY
        #: instead of eliding it. The elision is only sound when the replay
        #: target holds the identical keys by induction (WAL recovery of
        #: the same store); a capture destined for a DIFFERENT store — a
        #: federation shard streaming its delta ops into the aggregator's
        #: merged fleet store (`krr_tpu/federation` in the JAX package) — must carry keys so
        #: the ops scatter onto the right rows of a store that also holds
        #: other shards' keys.
        self.capture_full_keys = False
        self._pending_ops: list = []

    # ------------------------------------------------------------------ merge
    def _ensure_rows(self, keys: list[str]) -> np.ndarray:
        """Indices for ``keys``, growing the store for unseen objects. A key
        repeated within one call (duplicate-object windows) must grow ONE
        row, not one per occurrence — the dedup here keeps the index and the
        row arrays consistent."""
        new = list(dict.fromkeys(key for key in keys if key not in self._index))
        if new:
            grow = len(new)
            if self.cpu_counts.shape[0] == 0:
                # Fresh store (every first scan at fleet scale): plain zeros —
                # vstack against the empty matrix would pay a full extra copy
                # of the [N x B] state (~0.7 s at 100k x 2560).
                self.cpu_counts = np.zeros((grow, self.spec.num_buckets), np.float32)
            else:
                self.cpu_counts = np.vstack(
                    [self.cpu_counts, np.zeros((grow, self.spec.num_buckets), np.float32)]
                )
            self.cpu_total = np.concatenate([self.cpu_total, np.zeros(grow, np.float32)])
            self.cpu_peak = np.concatenate([self.cpu_peak, np.full(grow, -np.inf, np.float32)])
            self.mem_total = np.concatenate([self.mem_total, np.zeros(grow, np.float32)])
            self.mem_peak = np.concatenate([self.mem_peak, np.full(grow, -np.inf, np.float32)])
            for key in new:
                self._index[key] = len(self.keys)
                self.keys.append(key)
        return np.asarray([self._index[key] for key in keys], dtype=np.int64)

    def merge_window(
        self,
        keys: list[str],
        cpu_counts: np.ndarray,
        cpu_total: np.ndarray,
        cpu_peak: np.ndarray,
        mem_total: np.ndarray,
        mem_peak: np.ndarray,
    ) -> np.ndarray:
        """Fold one scanned window (any source, any order) into the store;
        returns the store row index for each input key."""
        # Checked BEFORE _ensure_rows grows the store: a whole-store fold
        # (the seasoned serve tick — every resident row, in row order, no
        # new keys) can elide its key list from the delta capture, because
        # replay re-derives it from the store, which by induction holds the
        # identical keys at that point. A growing window never elides.
        whole = (
            self.track_deltas
            and not self.capture_full_keys
            and len(keys) == len(self.keys)
            and list(keys) == self.keys
        )
        rows = self._ensure_rows(keys)

        def f32(a: np.ndarray) -> np.ndarray:
            return np.asarray(a).astype(np.float32, copy=False)  # no copy when already f32

        if self.track_deltas:
            # Capture the window's CONTRIBUTION (not the resulting rows):
            # replaying captured windows in order re-applies the same exact
            # integer adds and peak maxes, so WAL replay reconstructs the
            # store bit-identically. References, not copies — callers never
            # mutate a window after folding it.
            self._pending_ops.append(
                (
                    "fold",
                    None if whole else list(keys),
                    f32(cpu_counts),
                    f32(cpu_total),
                    f32(cpu_peak),
                    f32(mem_total),
                    f32(mem_peak),
                )
            )
        window = self._contiguous_slice(rows, len(self.keys))
        if window is not None:
            # The common case — a fleet scanned in a stable order lands on a
            # contiguous row range (fresh stores exactly so): slice ops run
            # at memory bandwidth, ~2.5x faster than the buffered scatter on
            # a [100k x 2560] fold (and ~9x faster than fancy-index +=).
            self.cpu_counts[window] += f32(cpu_counts)
            self.cpu_total[window] += f32(cpu_total)
            np.maximum(self.cpu_peak[window], f32(cpu_peak), out=self.cpu_peak[window])
            self.mem_total[window] += f32(mem_total)
            np.maximum(self.mem_peak[window], f32(mem_peak), out=self.mem_peak[window])
        else:  # arbitrary row order / duplicate keys: accumulate via scatter
            np.add.at(self.cpu_counts, rows, f32(cpu_counts))
            np.add.at(self.cpu_total, rows, f32(cpu_total))
            np.maximum.at(self.cpu_peak, rows, f32(cpu_peak))
            np.add.at(self.mem_total, rows, f32(mem_total))
            np.maximum.at(self.mem_peak, rows, f32(mem_peak))
        return rows

    def merge_window_csr(
        self,
        keys: list[str],
        vals: np.ndarray,
        cols: np.ndarray,
        indptr: np.ndarray,
        cpu_total: np.ndarray,
        cpu_peak: np.ndarray,
        mem_total: np.ndarray,
        mem_peak: np.ndarray,
    ) -> np.ndarray:
        """Sparse twin of :meth:`merge_window`: fold a CSR-encoded window
        (the WAL/federation record form) WITHOUT materializing the dense
        [rows x num_buckets] matrix — the replay hot path for keyed records
        (`krr_tpu_torch.core.durastore.apply_ops`). At delta occupancy the scatter
        touches ~1/250th of the cells the dense fold would, and the delta
        capture stays in CSR form (``fold_csr`` — identical WAL bytes), so
        an aggregator replaying many shards' records never pins dense
        windows. Bit-exactness: the scatter applies the same float32 adds
        to the same cells in the same row-major order the dense fold would
        (untouched cells would have added +0.0 — a no-op: digest counts
        are sums of non-negative values, so ``-0.0`` cannot occur)."""

        def f32(a: np.ndarray) -> np.ndarray:
            return np.asarray(a).astype(np.float32, copy=False)

        rows = self._ensure_rows(keys)
        cpu_total, cpu_peak = f32(cpu_total), f32(cpu_peak)
        mem_total, mem_peak = f32(mem_total), f32(mem_peak)
        if self.track_deltas:
            self._pending_ops.append(
                ("fold_csr", list(keys), vals, cols, indptr,
                 cpu_total, cpu_peak, mem_total, mem_peak)
            )
        cols64 = np.asarray(cols).astype(np.int64, copy=False)
        row_of = np.repeat(rows, np.diff(indptr))
        np.add.at(
            self.cpu_counts.ravel(), row_of * self.spec.num_buckets + cols64, vals
        )
        np.add.at(self.cpu_total, rows, cpu_total)
        np.maximum.at(self.cpu_peak, rows, cpu_peak)
        np.add.at(self.mem_total, rows, mem_total)
        np.maximum.at(self.mem_peak, rows, mem_peak)
        return rows

    def fold_fleet(self, fleet, mem_scale: float = 1.0) -> np.ndarray:
        """Delta-window fold entry point: merge one fetched (digested) window
        into the store. The tdigest ``state_path`` merge and the serve
        scheduler's per-tick fold share this conversion — ``DigestedFleet``
        memory peaks arrive in bytes while the store keeps MB, so callers
        pass ``mem_scale`` (the strategy layer's MEMORY_SCALE). Returns the
        store row index for each fleet object, for the follow-up quantile
        query. Exactness contract: digest bucket counts are integer-valued,
        so folding windows one at a time accumulates bit-identical state to
        folding their union in one window."""
        keys = [object_key(obj) for obj in fleet.objects]
        mem_peak = np.where(np.isfinite(fleet.mem_peak), fleet.mem_peak / mem_scale, -np.inf)
        return self.merge_window(
            keys, fleet.cpu_counts, fleet.cpu_total, fleet.cpu_peak, fleet.mem_total, mem_peak
        )

    def __contains__(self, key: str) -> bool:
        return key in self._index

    def rows_for(self, keys: list[str]) -> np.ndarray:
        """Store row indices for ``keys``, growing empty rows for unseen
        objects (which then query as NaN → UNKNOWN scans) — the serve
        resume path's query-without-fold: recommendations straight from the
        resident state, no new window."""
        if self.track_deltas:
            missing = list(dict.fromkeys(k for k in keys if k not in self._index))
            if missing:
                self._pending_ops.append(("grow", missing))
        return self._ensure_rows(keys)

    def compact(self, keep: "frozenset[str] | set[str]") -> int:
        """Drop rows whose key is not in ``keep``, returning the number
        dropped. A long-lived server re-discovers the fleet on a slow
        cadence; without compaction, workload churn would grow the store
        (and its [N x B] count matrix) without bound. Row indices shift —
        callers re-derive them via the next ``fold_fleet``/``merge_window``."""
        mask = np.fromiter((key in keep for key in self.keys), dtype=bool, count=len(self.keys))
        dropped = int(len(self.keys) - mask.sum())
        if not dropped:
            return 0
        if self.track_deltas:
            self._pending_ops.append(
                ("drop", [key for key, m in zip(self.keys, mask) if not m])
            )
        self.keys = [key for key, m in zip(self.keys, mask) if m]
        self.cpu_counts = self.cpu_counts[mask]
        self.cpu_total = self.cpu_total[mask]
        self.cpu_peak = self.cpu_peak[mask]
        self.mem_total = self.mem_total[mask]
        self.mem_peak = self.mem_peak[mask]
        self._index = {key: i for i, key in enumerate(self.keys)}
        return dropped

    @property
    def nbytes(self) -> int:
        """Resident size of the row arrays (the serve ``/metrics`` gauge)."""
        return sum(
            a.nbytes
            for a in (self.cpu_counts, self.cpu_total, self.cpu_peak, self.mem_total, self.mem_peak)
        )

    # ---------------------------------------------------------- delta capture
    def pending_ops(self) -> list:
        """Snapshot of the captured (unpersisted) mutation ops, oldest
        first. The durable store encodes these into one WAL record; pass
        the snapshot's length to :meth:`clear_pending` only AFTER the
        record is durably on disk — a failed persist keeps the ops queued
        so the next tick's record carries both ticks' deltas."""
        return list(self._pending_ops)

    def clear_pending(self, count: int) -> None:
        del self._pending_ops[:count]

    def compact_pending(self) -> None:
        """Re-encode queued dense fold windows as sparse CSR in place. The
        capture normally holds a REFERENCE to each tick's dense
        [N x num_buckets] window (free on the happy path — the array lives
        until the tick ends anyway, and ``save_delta`` drains it); under a
        SUSTAINED persist failure the backlog would otherwise pin one dense
        matrix per tick (~1 GB each at 100k rows) until the process OOMs —
        turning a survivable disk-full into a kill. Sparse form is ~250x
        smaller at delta-window occupancy and encodes to the identical WAL
        bytes (the encoder accepts both shapes)."""
        for i, op in enumerate(self._pending_ops):
            if op[0] != "fold":
                continue
            _, keys, cpu_counts, cpu_total, cpu_peak, mem_total, mem_peak = op
            vals, cols, indptr = csr_encode(
                cpu_counts, self.spec.num_buckets, len(cpu_total),
                flat=flatnonzero_f32(cpu_counts),
            )
            self._pending_ops[i] = (
                "fold_csr", keys, vals, cols, indptr,
                cpu_total, cpu_peak, mem_total, mem_peak,
            )

    def row_slice(self, lo: int, hi: int) -> "DigestStore":
        """A store VIEW over rows ``[lo, hi)`` (shared array memory) — what
        the durable store writes per-shard base snapshots from."""
        return DigestStore(
            spec=self.spec,
            keys=self.keys[lo:hi],
            cpu_counts=self.cpu_counts[lo:hi],
            cpu_total=self.cpu_total[lo:hi],
            cpu_peak=self.cpu_peak[lo:hi],
            mem_total=self.mem_total[lo:hi],
            mem_peak=self.mem_peak[lo:hi],
        )

    # -------------------------------------------------------------- quantiles
    @staticmethod
    def _contiguous_slice(rows: np.ndarray, n: int) -> Optional[slice]:
        """The equivalent ``slice`` when ``rows`` is a contiguous ascending
        IN-BOUNDS range over an ``n``-row axis, else None. The bounds check
        matters: out-of-range fancy indices raise IndexError, and the slice
        path must not silently truncate instead. One helper for both the
        merge fast path and the query view so the two cannot drift."""
        if rows.size == 0 or rows[0] < 0 or rows[-1] >= n:
            return None
        if np.array_equal(rows, np.arange(rows[0], rows[0] + rows.size)):
            return slice(int(rows[0]), int(rows[0]) + rows.size)
        return None

    def _take(self, rows: np.ndarray, *arrays: np.ndarray) -> list[np.ndarray]:
        """``[a[rows] for a in arrays]``, but zero-copy VIEWS when ``rows`` is
        a contiguous ascending range — the overwhelmingly common whole-fleet
        query, where the fancy-index copy of the [N x B] count matrix costs
        4.5 s at 100k x 2560 (measured) and the view costs nothing. One
        contiguity check covers every array."""
        rows = np.asarray(rows)
        window = self._contiguous_slice(rows, len(self.keys))
        if window is not None:
            return [a[window] for a in arrays]
        return [a[rows] for a in arrays]

    def cpu_percentile(self, rows: np.ndarray, q: float) -> np.ndarray:
        """Quantile estimate from merged counts — the shared host-numpy query
        (`krr_tpu_torch.ops.digest.percentile_host`; that docstring records why the
        host, not the device, serves host-resident digests). NaN where no data."""
        from krr_tpu_torch.ops.digest import percentile_host

        counts, total, peak = self._take(rows, self.cpu_counts, self.cpu_total, self.cpu_peak)
        return percentile_host(self.spec, counts, total, peak, q)

    def memory_peak(self, rows: np.ndarray) -> np.ndarray:
        total, peak = self._take(rows, self.mem_total, self.mem_peak)
        return np.where(total > 0, peak, np.nan).astype(np.float32)

    def query_recommendation(self, rows: np.ndarray, q: float) -> tuple[np.ndarray, np.ndarray]:
        """(CPU percentile, memory peak MB) for ``rows`` — THE digested-store
        recommendation query, shared by ``TDigestStrategy.run_digested``, the
        serve scheduler's publish path, and the journal/diff tooling, so no
        two consumers can drift apart on what a recommendation is."""
        return np.asarray(self.cpu_percentile(rows, q)), np.asarray(self.memory_peak(rows))

    # ------------------------------------------------------------ persistence
    #
    # On-disk format: the count matrix is stored SPARSELY (CSR — concatenated
    # per-row occupied buckets) and UNCOMPRESSED. The dense state is mostly
    # zeros (a series' samples occupy tens of its 2,560 buckets), and pushing
    # the dense 1 GB through zlib cost ~5 s each way at 100k rows (measured
    # round 3); the sparse extraction is one pass over the matrix (~1.5 s)
    # and the write/read run at disk speed. Dense legacy files still load.

    def write_npz(self, f) -> None:
        """The raw ``.npz`` snapshot writer — shared by the legacy
        single-file :meth:`save` and the sharded base-snapshot writer
        (`krr_tpu_torch.core.durastore`), so both formats stay byte-compatible
        down to the CSR dtypes."""
        meta = {
            "gamma": self.spec.gamma,
            "min_value": self.spec.min_value,
            "num_buckets": self.spec.num_buckets,
        }
        if self.extra_meta:
            meta["extra"] = self.extra_meta
        vals, cols, indptr = csr_encode(self.cpu_counts, self.spec.num_buckets, len(self.keys))
        np.savez(
            f,
            meta=json.dumps(meta),
            keys=np.asarray(self.keys),
            csr_vals=vals,
            csr_cols=cols,
            csr_indptr=indptr,
            cpu_total=self.cpu_total,
            cpu_peak=self.cpu_peak,
            mem_total=self.mem_total,
            mem_peak=self.mem_peak,
        )

    def save(self, path: str) -> None:
        """Atomic write (tmp + fsync + rename + parent-dir fsync via
        :func:`atomic_write`): a crash at any point keeps a complete file —
        old state before the rename, fully-written new state after it,
        never a truncated one. This is the LEGACY single-file format
        (``--store_format legacy``); the sharded state-directory format
        lives in `krr_tpu_torch.core.durastore`."""
        with atomic_write(path) as f:
            self.write_npz(f)

    @classmethod
    def load(cls, path) -> "DigestStore":
        """Load a single-file snapshot — a path or an open binary file
        object (the sharded store loads its base shards through here)."""
        with np.load(path, allow_pickle=False) as data:
            meta = json.loads(str(data["meta"]))
            spec = DigestSpec(gamma=meta["gamma"], min_value=meta["min_value"], num_buckets=meta["num_buckets"])
            keys = [str(k) for k in data["keys"]]
            if "cpu_counts" in data:  # legacy dense (zlib) format
                counts = data["cpu_counts"]
            else:
                counts = csr_decode(
                    data["csr_vals"], data["csr_cols"], data["csr_indptr"],
                    len(keys), spec.num_buckets,
                )
            return cls(
                spec=spec,
                keys=keys,
                cpu_counts=counts,
                cpu_total=data["cpu_total"],
                cpu_peak=data["cpu_peak"],
                mem_total=data["mem_total"],
                mem_peak=data["mem_peak"],
                extra_meta=meta.get("extra", {}),
            )

    @staticmethod
    @contextlib.contextmanager
    def locked(path: str) -> Iterator[None]:
        """Advisory exclusive lock for one load-merge-save cycle, so concurrent
        multi-source scans against the same state serialize instead of the
        last save silently discarding the other's merge. The lock file is
        REMOVED on release (state directories used to accumulate ``.lock``
        litter forever); the open/flock/stat loop handles the classic
        unlink race — a waiter that acquired the flock on an already-
        unlinked inode notices the path no longer names its inode and
        retries on the fresh lock file."""
        lock_path = path + ".lock"
        while True:
            lock_file = open(lock_path, "a")
            fcntl.flock(lock_file, fcntl.LOCK_EX)
            try:
                if os.path.samestat(os.fstat(lock_file.fileno()), os.stat(lock_path)):
                    break
            except OSError:
                pass  # unlinked under us — retry on the recreated file
            lock_file.close()
        try:
            yield
        finally:
            # Unlink BEFORE releasing: we still hold the exclusive lock, so
            # no other holder exists; blocked waiters detect the swap above.
            with contextlib.suppress(OSError):
                os.unlink(lock_path)
            fcntl.flock(lock_file, fcntl.LOCK_UN)
            lock_file.close()

    @classmethod
    def open_or_create(cls, path: Optional[str], spec: DigestSpec) -> "DigestStore":
        if path and os.path.isdir(path):
            # A sharded state DIRECTORY (`krr_tpu_torch.core.durastore`): recover
            # it (checksums verified, WAL replayed) and hand back the
            # reconstructed in-memory store — one-shot readers and the
            # tdigest CLI then see a serve-written directory transparently.
            from krr_tpu_torch.core.durastore import DurableStore

            durable = DurableStore.open(path, spec)
            durable.close()
            # This handle has no persistence engine draining the capture:
            # a long-lived reader folding into it must not pin window
            # arrays forever (the track_deltas contract).
            durable.store.track_deltas = False
            durable.store._pending_ops.clear()
            return durable.store
        if path and os.path.exists(path):
            try:
                store = cls.load(path)
            except Exception as e:  # BadZipFile / KeyError / EOFError / ValueError
                raise ValueError(
                    f"digest state at {path} is unreadable ({type(e).__name__}: {e}); "
                    f"delete the file to start fresh"
                ) from e
            if (store.spec.gamma, store.spec.min_value, store.spec.num_buckets) != (
                spec.gamma,
                spec.min_value,
                spec.num_buckets,
            ):
                raise ValueError(
                    f"digest state at {path} was built with spec {store.spec}, "
                    f"incompatible with requested {spec}; delete the state file or match the settings"
                )
            return store
        return cls(spec=spec)
