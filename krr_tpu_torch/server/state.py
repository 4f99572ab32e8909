"""Resident serve state: the digest store + the published result snapshot.

A copy of `krr_tpu/server/state.py`.

The cache is a READ/WRITE-locked published snapshot: HTTP handlers take the
read side for the few microseconds it takes to grab the current
:class:`Snapshot` reference, and the scheduler takes the write side only for
the atomic swap at the END of a scan — so queries keep serving the previous
result for the whole duration of an in-flight scan (fetch, fold, compute all
happen outside the lock, on a private window that only touches the store
once complete). The digest store itself is owned by the scheduler (one scan
in flight at a time, serialized by ``scan_lock``); readers never touch it.
"""

from __future__ import annotations

import asyncio
import contextlib
import dataclasses
import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import TYPE_CHECKING, Optional

from krr_tpu_torch.server.metrics import MetricsRegistry

if TYPE_CHECKING:
    from krr_tpu_torch.core.streaming import DigestStore
    from krr_tpu_torch.history.journal import RecommendationJournal
    from krr_tpu_torch.models.result import Result
    from krr_tpu_torch.obs.health import SloEngine


class ReadWriteLock:
    """Asyncio readers-writer lock: any number of concurrent readers, one
    exclusive writer; a waiting writer blocks new readers (no writer
    starvation under a steady query stream)."""

    def __init__(self) -> None:
        self._cond = asyncio.Condition()
        self._readers = 0
        self._writers_waiting = 0
        self._writing = False

    @contextlib.asynccontextmanager
    async def read(self):
        async with self._cond:
            while self._writing or self._writers_waiting:
                await self._cond.wait()
            self._readers += 1
        try:
            yield
        finally:
            async with self._cond:
                self._readers -= 1
                if self._readers == 0:
                    self._cond.notify_all()

    @contextlib.asynccontextmanager
    async def write(self):
        async with self._cond:
            self._writers_waiting += 1
            try:
                while self._writing or self._readers:
                    await self._cond.wait()
            finally:
                self._writers_waiting -= 1
            self._writing = True
        try:
            yield
        finally:
            async with self._cond:
                self._writing = False
                self._cond.notify_all()


@dataclass(frozen=True)
class Snapshot:
    """One published scan: everything a query needs, immutable by contract.

    ``body_json`` is the whole-fleet JSON rendered AND encoded once at
    publish time (via the machine formatter) — the hot unfiltered response
    is a byte copy, not a per-request model dump or UTF-8 encode (multi-MB
    at fleet scale, and the handler runs on the event loop).

    ``keys`` are the object keys (`krr_tpu_torch.core.streaming.object_key`) in
    scan order — the read path's filter/pagination pushdown resolves row
    indices against this key table instead of iterating the pydantic scan
    objects. ``epoch`` and ``changed_at`` are stamped by
    :meth:`ServerState.publish`: the epoch advances only when ``body_json``
    actually changed bytes (a hysteresis-suppressed tick republishes under
    the SAME epoch, so conditional GETs keep answering 304 and the response
    cache stays warm), and ``changed_at`` is the publish time of that last
    byte change (the ``Last-Modified`` validator).
    """

    result: "Result"
    body_json: bytes
    window_end: float  # unix ts of the scan window's right edge
    published_at: float
    keys: "tuple[str, ...]" = ()
    epoch: int = 0
    changed_at: float = 0.0
    #: BLAKE2b-128 of ``body_json``, computed in the scheduler's render
    #: worker thread so :meth:`ServerState.publish` can decide
    #: changed-vs-identical with an O(1) digest compare under the write
    #: lock instead of a multi-MB memcmp on the event loop. Empty (direct
    #: constructions, tests) falls back to the byte compare.
    body_digest: bytes = b""


class ResponseCache:
    """Epoch-keyed LRU of fully rendered AND encoded response bodies.

    One entry per ``(format, canonicalized filters, limit, offset,
    content-encoding)`` — identity and pre-compressed variants live side by
    side as sibling keys, so a gzip reader and a curl reader never force
    each other's re-render. The WHOLE cache belongs to one publish epoch:
    the first access (get or put) under a newer epoch drops every entry —
    invalidation is wholesale and O(1) decisions, keyed on the same
    monotonic epoch the ETag advertises, so a cached body can never outlive
    the snapshot it was rendered from.

    Bounded two ways (adversarial filter cardinality must not OOM the
    server): at most ``max_entries`` entries and at most ``max_bytes`` of
    body bytes, evicted LRU-first. A single body larger than the byte
    budget is served but not retained.
    """

    def __init__(
        self,
        *,
        max_entries: int = 256,
        max_bytes: int = 64 << 20,
        metrics: Optional[MetricsRegistry] = None,
    ) -> None:
        self.max_entries = max(1, int(max_entries))
        self.max_bytes = max(1, int(max_bytes))
        self.metrics = metrics
        self._epoch: Optional[int] = None
        self._entries: "OrderedDict[tuple, bytes]" = OrderedDict()
        self._bytes = 0

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def nbytes(self) -> int:
        return self._bytes

    def _gauges(self) -> None:
        if self.metrics is not None:
            self.metrics.set("krr_tpu_http_response_cache_entries", len(self._entries))
            self.metrics.set("krr_tpu_http_response_cache_bytes", self._bytes)

    def invalidate(self, epoch: int) -> None:
        """Drop every entry and re-key the cache to ``epoch`` (the publish
        path calls this on a content-changing publish; get/put also detect
        a NEWER epoch lazily, so a direct-constructed state stays safe)."""
        self._entries.clear()
        self._bytes = 0
        self._epoch = int(epoch)
        self._gauges()

    def _sync_epoch(self, epoch: int) -> None:
        # Forward-only: epochs are monotonic, so an OLDER epoch here is a
        # stale in-flight request that read its snapshot before the latest
        # publish — it must neither wipe the fresh entries nor re-key the
        # cache backward (its get misses, its put is dropped).
        if self._epoch is None or epoch > self._epoch:
            self.invalidate(epoch)

    def get(self, epoch: int, key: tuple) -> Optional[bytes]:
        epoch = int(epoch)
        self._sync_epoch(epoch)
        body = self._entries.get(key) if epoch == self._epoch else None
        if self.metrics is not None:
            self.metrics.inc(
                "krr_tpu_http_cache_hits_total" if body is not None
                else "krr_tpu_http_cache_misses_total"
            )
        if body is not None:
            self._entries.move_to_end(key)
        return body

    def peek(self, epoch: int, key: tuple) -> Optional[bytes]:
        """Uncounted sibling probe — the encoded-variant miss path checks
        whether the identity body is already cached (compress-only, no
        re-render) without double-counting hit/miss metrics. Refreshes
        recency; never re-keys the epoch."""
        if int(epoch) != self._epoch:
            return None
        body = self._entries.get(key)
        if body is not None:
            self._entries.move_to_end(key)
        return body

    def put(self, epoch: int, key: tuple, body: bytes) -> None:
        epoch = int(epoch)
        self._sync_epoch(epoch)
        if epoch != self._epoch:
            return  # a stale render must not poison the newer cache
        if len(body) > self.max_bytes:
            # Never retained — and never inserted either: running the LRU
            # loop with an un-fittable MRU entry would evict every OTHER
            # entry first and wipe the warm cache on each oversized request.
            return
        old = self._entries.pop(key, None)
        if old is not None:
            self._bytes -= len(old)
        self._entries[key] = body
        self._bytes += len(body)
        while self._entries and (
            len(self._entries) > self.max_entries or self._bytes > self.max_bytes
        ):
            _evicted_key, evicted = self._entries.popitem(last=False)
            self._bytes -= len(evicted)
        self._gauges()


class ServerState:
    """The serve process's shared mutable state."""

    def __init__(
        self,
        store: "DigestStore",
        journal: "Optional[RecommendationJournal]" = None,
        metrics: Optional[MetricsRegistry] = None,
    ) -> None:
        self.store = store
        #: The recommendation flight recorder (`krr_tpu_torch.history.journal`):
        #: every scheduler recompute appends here; GET /history and
        #: GET /drift read it from worker threads (the journal carries its
        #: own lock). None only for states built without a server.
        self.journal = journal
        #: One scan in flight at a time (scheduler ticks + any manual kicks).
        self.scan_lock = asyncio.Lock()
        self.rwlock = ReadWriteLock()
        #: Injectable so the serve composition root can hand in the scan
        #: session's registry — per-query Prometheus telemetry then lands on
        #: the same /metrics exposition as the scheduler's scan telemetry.
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.started_at = time.time()
        #: Right edge of the last FOLDED window — the next delta starts one
        #: step after it. Advanced only after a fold completes, so a
        #: cancelled scan refetches its window instead of losing it.
        self.last_end: Optional[float] = None
        #: The last publish's hysteresis outcome (None before any publish):
        #: how many workloads' out-of-band changes were withheld, and how
        #: many published values moved — surfaced on /healthz so operators
        #: can tell a quiet fleet from a stuck gate.
        self.last_publish_suppressed: Optional[int] = None
        self.last_publish_changed: Optional[int] = None
        #: Trace id of the last completed scan tick — the join key between
        #: /healthz, structured log lines, and /debug/trace spans.
        self.last_scan_id: Optional[str] = None
        #: Quarantined workloads (degraded ticks): object key → unix time of
        #: the last window actually folded for it. Their published
        #: recommendations carry forward last-good digests; /recommendations
        #: marks each scan with this timestamp (``stale_since``), /healthz
        #: and ``krr_tpu_stale_workloads`` count them. Owned by the
        #: scheduler; handlers only read.
        self.stale_workloads: dict[str, float] = {}
        #: Consecutive failed (aborted) scheduler ticks — 0 while healthy;
        #: visible on /healthz and /statusz so degraded state doesn't
        #: require grepping logs.
        self.consecutive_scan_failures: int = 0
        #: The most recent scan abort's error (survives recovery as a
        #: post-mortem breadcrumb; consecutive_scan_failures == 0 says
        #: whether it is current).
        self.last_scan_error: Optional[str] = None
        #: The SLO engine (`krr_tpu_torch.obs.health`): the scheduler evaluates it
        #: per tick, GET /statusz renders it, /healthz downgrades to
        #: ``degraded`` while it has firing alerts. None for states built
        #: without a server (unit tests, embedders).
        self.slo: "Optional[SloEngine]" = None
        #: The scan flight recorder (`krr_tpu_torch.obs.timeline`): the scheduler
        #: appends one record per completed tick, GET /debug/timeline and
        #: the SIGUSR2 trend artifact read it. None for states built
        #: without a server.
        self.timeline = None
        #: The regression sentinel (`krr_tpu_torch.obs.sentinel`): classifies each
        #: timeline record against rolling baselines; /statusz renders its
        #: trend section. None when --no-sentinel (or no server).
        self.sentinel = None
        #: Persistence posture (durable store saves): True while the last
        #: persist attempt failed (ENOSPC/EIO) — serve keeps publishing
        #: from memory, /healthz downgrades to ``degraded``, and the next
        #: tick retries with the backlog. Owned by the scheduler.
        self.persist_failing: bool = False
        #: Cumulative failed persist attempts this process (the in-process
        #: twin of ``krr_tpu_persist_failures_total``).
        self.persist_failures: int = 0
        #: The most recent persist failure's error (survives recovery as a
        #: breadcrumb; ``persist_failing`` says whether it is current).
        self.last_persist_error: Optional[str] = None
        #: Clusters whose last discovery listing FAILED (fail-soft degraded
        #: to an empty cluster): cluster → error string. Surfaced on
        #: /healthz and /statusz so a silently smaller fleet is visible;
        #: the loader counts them in
        #: ``krr_tpu_discovery_cluster_failures_total``. Owned by the
        #: scheduler's discovery leg.
        self.discovery_failed_clusters: dict[str, str] = {}
        #: The scheduler's per-tick discovery posture (mode, watch event
        #: deltas, inventory/watch freshness ages) — rendered on /healthz
        #: and /statusz so "is the watch inventory fresh?" never needs a
        #: log grep. Empty until the first tick.
        self.discovery: dict = {}
        #: The federation aggregator (`krr_tpu_torch.federation.aggregator`)
        #: when serve runs with ``--federation-listen``: /healthz and
        #: /statusz render its per-shard connected/epoch/lag state. None
        #: otherwise.
        self.federation = None
        #: The epoch-feed client (`krr_tpu_torch.federation.replica`) when
        #: this process is a ``replica``: /healthz and /statusz render its
        #: subscription posture (source, feed epoch, lag). None otherwise.
        self.replica = None
        #: Push-ingest posture (`krr_tpu_torch.ingest`, ``--metrics-mode push``):
        #: the active mode, the listener's bound port, and the scheduler's
        #: per-tick plane stats (series, buffered samples, freshness,
        #: rejection counts) — rendered on /healthz and /statusz so "is the
        #: push plane keeping up?" never needs a log grep.
        self.ingest: dict = {}
        #: The publish epoch — the read path's cache key and the ETag's
        #: leading component. Advances ONLY when a publish changes the
        #: rendered bytes (hysteresis makes that rare, which is what makes
        #: the response cache hit ≈ always). The serve composition root
        #: seeds it from the durable store's persist epoch so the exposed
        #: epoch stays monotonic across restarts; memory-only servers
        #: restart at 0 — safe for validators because the ETag also carries
        #: the content change's millisecond timestamp (see
        #: ``HttpApp._snapshot_validators``), which can't collide across
        #: restarts.
        self.publish_epoch: int = 0
        #: The epoch-keyed rendered-response cache (`ResponseCache`). None =
        #: caching disabled (--no-response-cache, or states built without a
        #: server): every non-fast-path read renders.
        self.response_cache: Optional[ResponseCache] = None
        self._snapshot: Optional[Snapshot] = None

    def seed_epoch(self, epoch: int) -> None:
        """Raise the publish-epoch floor (the composition root passes the
        durable store's persisted epoch) so the epoch exposed on
        ``X-KRR-Epoch`` / ``/healthz`` keeps counting forward across
        restarts instead of replaying values operators already saw."""
        self.publish_epoch = max(self.publish_epoch, int(epoch))

    @staticmethod
    def _same_body(previous: Snapshot, snapshot: Snapshot) -> bool:
        # Digest compare when both sides carry one (the scheduler path —
        # O(1) under the lock); byte compare otherwise (small direct
        # constructions).
        if previous.body_digest and snapshot.body_digest:
            return previous.body_digest == snapshot.body_digest
        return previous.body_json == snapshot.body_json

    async def publish(self, snapshot: Snapshot) -> None:
        async with self.rwlock.write():
            previous = self._snapshot
            if previous is not None and self._same_body(previous, snapshot):
                # Byte-identical republish (the common suppressed tick):
                # same epoch, same Last-Modified — conditional GETs keep
                # 304ing and every cached render stays valid.
                snapshot = dataclasses.replace(
                    snapshot, epoch=previous.epoch, changed_at=previous.changed_at
                )
            else:
                self.publish_epoch += 1
                snapshot = dataclasses.replace(
                    snapshot, epoch=self.publish_epoch, changed_at=snapshot.published_at
                )
                if self.response_cache is not None:
                    self.response_cache.invalidate(self.publish_epoch)
            self._snapshot = snapshot

    async def snapshot(self) -> Optional[Snapshot]:
        async with self.rwlock.read():
            return self._snapshot

    def peek(self) -> Optional[Snapshot]:
        """Lock-free read for logging/tests (reference reads are atomic)."""
        return self._snapshot

    async def install_snapshot(
        self, snapshot: Snapshot, *, variants: "Optional[dict[str, bytes]]" = None
    ) -> bool:
        """Install a snapshot whose epoch/changed_at were decided ELSEWHERE
        — the replica feed path. Unlike :meth:`publish` (which allocates
        the next local epoch), the caller's values install verbatim so the
        replica's validators are byte-identical to its source's; stale
        feeds (epoch at or below the installed one) are dropped, making
        reconnect replays idempotent. ``variants`` pre-warms the response
        cache with the source's rendered encodings under the unfiltered/
        unpaged json key — the replica never re-renders what the feed
        already carries. Returns whether the snapshot installed."""
        async with self.rwlock.write():
            previous = self._snapshot
            if previous is not None and snapshot.epoch <= previous.epoch:
                return False
            self.publish_epoch = max(self.publish_epoch, int(snapshot.epoch))
            self._snapshot = snapshot
            if self.response_cache is not None:
                self.response_cache.invalidate(snapshot.epoch)
                base_key = ("json", (), (), (), None, 0)
                for encoding, body in (variants or {}).items():
                    self.response_cache.put(
                        snapshot.epoch, (*base_key, encoding), body
                    )
            return True
