"""The federation aggregator: replay shard deltas into the fleet store.

A copy of `krr_tpu/federation/aggregator.py` over the port's modules.

Embedded in ``krr-tpu serve`` (``--federation-listen host:port``): accepts
shard connections, handshakes epochs, decodes each arriving DELTA record
fully (`krr_tpu_torch.core.durastore.decode_ops` — nothing half-applies, ever),
and queues it per shard. The serve scheduler's AGGREGATE tick (which
replaces the scan tick in federation mode) drains the queues in epoch
order under the scan lock — `apply_ops` onto the fleet
:class:`~krr_tpu_torch.core.streaming.DigestStore`, exactly the WAL recovery
path — then publishes the merged view through the unchanged pipeline:
store query → hysteresis gate → journal → render → snapshot swap, with the
durable store persisting the replayed ops as its OWN delta-WAL appends.

Exactly-once, end to end:

* receive side — a DELTA is enqueued only when its epoch is exactly
  ``enqueued + 1`` for its shard (reset records re-anchor the watermark);
  an epoch at or below the watermark is a re-send duplicate, discarded
  deterministically and counted; a gap drops the connection so the shard
  re-sends from the ack;
* ack side — epochs are acked only after they are APPLIED and (when serve
  has a state path) DURABLY PERSISTED: the per-shard watermarks ride the
  store's ``extra_meta`` inside the same WAL record as the applied ops, so
  an aggregator crash recovers store + watermarks together and reconnecting
  shards re-send exactly the unproven tail. Memory-only serves ack after
  apply (there is nothing more durable to wait for).

Failure domains: a shard that stops delivering (dead process, partitioned
network) keeps its last-applied rows serving — the aggregate tick marks
its workloads ``stale_since`` once the newest delivered window exceeds the
staleness budget, mirroring the single-scanner quarantine UX — while
healthy shards keep publishing. ``/healthz`` and ``/statusz`` carry the
per-shard connected/epoch/lag state; ``krr_tpu_federation_*`` metrics and
the timeline's ``federation`` block close the observability loop.
"""

from __future__ import annotations

import asyncio
import contextlib
import threading
import time
from collections import OrderedDict, deque
from typing import Optional

from krr_tpu_torch.core.durastore import apply_ops, decode_ops
from krr_tpu_torch.core.streaming import object_key
from krr_tpu_torch.obs.trace import NULL_TRACER, link_remote_parent
from krr_tpu_torch.federation.protocol import (
    FED_MAGIC,
    FRAME_OVERHEAD,
    MSG_ACK,
    MSG_DELTA,
    MSG_EPOCH,
    MSG_HELLO,
    MSG_INVENTORY,
    MSG_WELCOME,
    PROTOCOL_VERSION,
    ProtocolError,
    decode_control,
    decode_inventory,
    encode_control,
    encode_epoch_feed,
    encode_message,
    read_message,
)
from krr_tpu_torch.utils.logging import KrrLogger


class ShardStatus:
    """Everything the aggregator knows about one shard."""

    def __init__(self, shard_id: str) -> None:
        self.shard_id = shard_id
        self.generation: Optional[str] = None
        #: Epoch watermarks: ``enqueued`` ≥ ``applied`` ≥ ``acked``. A
        #: record past ``enqueued`` is fresh, at or below it a duplicate.
        self.enqueued = 0
        self.applied = 0
        self.acked = 0
        self.connected = False
        self.writer: Optional[asyncio.StreamWriter] = None
        #: Decoded-but-unapplied records, epoch order:
        #: (epoch, meta, parsed_ops, payload_bytes).
        self.queue: "deque[tuple[int, dict, list, int]]" = deque()
        self.objects: list = []
        self.clusters: "set[str]" = set()
        #: Every store key this shard has claimed (inventory + applied
        #: fold/grow ops, minus applied drops) — the RESET drop scope. A
        #: reset must clear exactly the shard's own superseded rows: a
        #: cluster-wide drop would destroy sibling shards partitioning the
        #: same cluster by namespace.
        self.owned_keys: "set[str]" = set()
        self.last_window_end: Optional[float] = None
        self.last_delivery: Optional[float] = None
        self.records = 0
        self.duplicates = 0
        self.bytes = 0
        self.drained = asyncio.Event()
        self.drained.set()


class Aggregator:
    """Shard connection handling + the aggregate tick's replay surface."""

    def __init__(
        self,
        state,
        spec,
        *,
        scan_interval: float,
        staleness_seconds: float = 0.0,
        queue_cap: int = 4096,
        inventory_path: Optional[str] = None,
        metrics=None,
        logger: Optional[KrrLogger] = None,
        clock=time.time,
    ) -> None:
        self.state = state
        self.spec = spec
        #: Shard staleness budget: a shard whose newest delivered window is
        #: older than this serves carried-forward rows with stale marks.
        #: 0 = auto: three aggregate cadences (aligned with /healthz).
        self.staleness = float(staleness_seconds) or 3.0 * float(scan_interval)
        self.queue_cap = int(queue_cap)
        #: Sidecar persisting each shard's last delivered INVENTORY (the
        #: rendering metadata beside the digest rows). Without it an
        #: aggregator restart would recover a dead shard's rows but render
        #: NOTHING for them — the documented carried-forward-with-stale-
        #: marks contract needs the objects, and a dead shard never
        #: reconnects to re-send them. Written at discovery cadence (on
        #: inventory receipt), never per tick; None = memory-only serve.
        self.inventory_path = inventory_path
        self._inventory_write_lock = asyncio.Lock()
        self.metrics = metrics
        self.logger = logger
        self.clock = clock
        self._shards: "dict[str, ShardStatus]" = {}
        #: Guards registry mutation against worker-thread readers (the
        #: persist hook exports watermarks from a to_thread save).
        self._registry_lock = threading.Lock()
        self._server: Optional[asyncio.AbstractServer] = None
        self._connections: "set[asyncio.StreamWriter]" = set()
        #: Anything-arrived flag the aggregate tick consumes: inventories,
        #: deltas, and (dis)connects all mark the merged view dirty.
        self.dirty = False
        #: Wire bytes at the last aggregate tick (per-tick deltas for the
        #: timeline record).
        self._bytes_at_tick = 0
        #: Epoch-feed subscribers (``krr-tpu replica`` connections) and the
        #: newest published epoch's pre-built MSG_EPOCH frame — broadcast
        #: on publish, replayed to late subscribers at handshake so a fresh
        #: replica serves immediately instead of waiting for the next
        #: changed publish.
        self._replicas: "set[asyncio.StreamWriter]" = set()
        self._feed_frame: Optional[bytes] = None
        self._feed_epoch = 0
        #: Node identity + tracer, installed by the owning KrrServer (the
        #: aggregator shares the serve session's tracer so its
        #: ``apply_record`` spans land in the same ring as the tick's
        #: aggregate scan span).
        self.node = "aggregator"
        self.tracer = NULL_TRACER
        #: Freshness lineage stamping (mirrors the shard-side knob; the
        #: owning server sets it from ``federation_lineage_enabled``).
        self.lineage_enabled = True
        #: Newest applied lineage fragment per shard (the stage-1/2
        #: timestamps a delta record's ``extra["lineage"]`` carried) —
        #: what `note_epoch` rolls into the published epoch's record.
        self._shard_lineage: "dict[str, dict]" = {}
        #: epoch → {"lineage": record, "trace": propagation ctx} for the
        #: last EPOCH_LINEAGE_KEEP published epochs: the /statusz lineage
        #: block, the feed frame's observability stamp, and the slot a
        #: replica's install ack completes.
        self._epochs: "OrderedDict[int, dict]" = OrderedDict()
        #: Epoch-feed subscriber census keyed by replica id — survives the
        #: connection (a reconnecting replica updates its row), so /fleet
        #: can show a DEAD replica's last posture too.
        self._replica_census: "dict[str, dict]" = {}

    #: Bounded per-epoch lineage memory (epochs advance once per changed
    #: publish, so 64 covers hours of history at production cadence).
    EPOCH_LINEAGE_KEEP = 64

    def seed(self, meta: Optional[dict]) -> None:
        """Restore per-shard watermarks persisted in the store's
        ``extra_meta`` (`export_meta`): after an aggregator restart the
        recovered store holds exactly the ops acked at the last durable
        persist, so every watermark resumes at its acked epoch. Shard
        inventories restore from the sidecar so recovered rows RENDER
        (with stale marks) even for shards that never reconnect."""
        for shard_id, entry in ((meta or {}).get("shards") or {}).items():
            status = ShardStatus(str(shard_id))
            status.generation = entry.get("gen")
            status.acked = status.applied = status.enqueued = int(entry.get("acked", 0))
            if entry.get("window_end") is not None:
                status.last_window_end = float(entry["window_end"])
            with self._registry_lock:
                self._shards[status.shard_id] = status
        self._load_inventories()

    def _load_inventories(self) -> None:
        import json
        import os

        from krr_tpu_torch.models.objects import K8sObjectData

        if not self.inventory_path or not os.path.exists(self.inventory_path):
            return
        try:
            with open(self.inventory_path) as f:
                payload = json.load(f)
            for shard_id, items in (payload.get("shards") or {}).items():
                with self._registry_lock:
                    status = self._shards.setdefault(
                        str(shard_id), ShardStatus(str(shard_id))
                    )
                status.objects = [K8sObjectData(**item) for item in items]
                status.owned_keys |= {object_key(obj) for obj in status.objects}
                status.clusters |= {obj.cluster or "" for obj in status.objects}
        except (OSError, ValueError, TypeError) as e:
            # Rendering metadata only (the digest rows are the durable
            # truth): a corrupt sidecar degrades to empty inventories until
            # shards reconnect, never blocks recovery.
            self._warn(
                f"federation: inventory sidecar {self.inventory_path} is "
                f"unreadable ({e}) — shard inventories restore on reconnect"
            )

    async def _persist_inventories(self) -> None:
        if not self.inventory_path:
            return
        # Snapshot object-list REFERENCES only under the lock (inventories
        # are replaced wholesale, never mutated in place); the fleet-sized
        # model_dump + JSON work runs in the writer thread — the same
        # off-loop discipline as the encode/decode paths.
        with self._registry_lock:
            snapshot = {
                s.shard_id: list(s.objects)
                for s in self._shards.values()
                if s.objects
            }

        def write() -> None:
            import json

            from krr_tpu_torch.core.streaming import atomic_write

            payload = {
                shard_id: [obj.model_dump(mode="json") for obj in objects]
                for shard_id, objects in snapshot.items()
            }
            with atomic_write(self.inventory_path, "w") as f:
                json.dump({"shards": payload}, f)

        async with self._inventory_write_lock:
            try:
                await asyncio.to_thread(write)
            except OSError as e:
                self._warn(
                    f"federation: cannot persist inventory sidecar "
                    f"{self.inventory_path} ({e}) — restart rendering degrades "
                    f"until shards reconnect"
                )

    # ----------------------------------------------------------- listening
    async def serve(self, host: str, port: int) -> None:
        self._server = await asyncio.start_server(self.handle_connection, host, port)

    @property
    def port(self) -> int:
        assert self._server is not None, "aggregator not started"
        return self._server.sockets[0].getsockname()[1]

    async def close(self) -> None:
        if self._server is not None:
            self._server.close()
            for writer in list(self._connections):
                writer.close()
            await self._server.wait_closed()
            self._server = None

    def _warn(self, message: str) -> None:
        if self.logger is not None:
            self.logger.warning(message)

    def _info(self, message: str) -> None:
        if self.logger is not None:
            self.logger.info(message)

    # ------------------------------------------------------------ receiving
    async def handle_connection(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        self._connections.add(writer)
        status: Optional[ShardStatus] = None
        try:
            magic = await reader.readexactly(len(FED_MAGIC))
            if magic != FED_MAGIC:
                raise ProtocolError("bad stream magic — not a krr-tpu shard")
            message = await read_message(reader)
            if message is None or message[0] != MSG_HELLO:
                raise ProtocolError("expected HELLO")
            hello = decode_control(message[1])
            if hello.get("role") == "replica":
                # An epoch-feed subscriber, not a shard: no digest spec, no
                # deltas — it reads the publish stream until it hangs up.
                await self._serve_replica(hello, reader, writer)
                return
            status = await self._handshake(hello, writer)
            while True:
                message = await read_message(reader)
                if message is None:
                    break  # clean close
                kind, body = message
                if kind == MSG_INVENTORY:
                    await self._on_inventory(status, body)
                elif kind == MSG_DELTA:
                    await self._on_delta(status, body, writer)
                else:
                    raise ProtocolError(f"unexpected message type {kind!r}")
        except asyncio.CancelledError:
            raise
        except (ProtocolError, asyncio.IncompleteReadError, OSError, ConnectionError) as e:
            shard = status.shard_id if status is not None else "<handshaking>"
            self._warn(f"federation: shard {shard} connection dropped: {e}")
            if self.metrics is not None and status is not None:
                self.metrics.inc(
                    "krr_tpu_federation_disconnects_total", shard=status.shard_id
                )
        finally:
            self._connections.discard(writer)
            if status is not None and status.writer is writer:
                status.connected = False
                status.writer = None
                self.dirty = True
            writer.close()
            with contextlib.suppress(ConnectionError, OSError):
                await writer.wait_closed()

    async def _handshake(self, hello: dict, writer: asyncio.StreamWriter) -> ShardStatus:
        shard_id = str(hello.get("shard_id") or "")
        if not shard_id:
            raise ProtocolError("HELLO carries no shard_id")
        if int(hello.get("version", 0)) != PROTOCOL_VERSION:
            writer.write(
                encode_control(
                    MSG_WELCOME,
                    error=f"protocol version {hello.get('version')} != {PROTOCOL_VERSION}",
                )
            )
            await writer.drain()
            raise ProtocolError(f"shard {shard_id}: protocol version mismatch")
        spec = hello.get("spec") or {}
        ours = (self.spec.gamma, self.spec.min_value, self.spec.num_buckets)
        theirs = (spec.get("gamma"), spec.get("min_value"), spec.get("num_buckets"))
        if theirs != ours:
            # A mismatched digest spec can never merge bit-exactly: refuse
            # loudly instead of folding incompatible buckets.
            writer.write(
                encode_control(
                    MSG_WELCOME, error=f"digest spec {theirs} != aggregator {ours}"
                )
            )
            await writer.drain()
            raise ProtocolError(f"shard {shard_id}: digest spec mismatch {theirs} vs {ours}")
        with self._registry_lock:
            status = self._shards.setdefault(shard_id, ShardStatus(shard_id))
        if status.writer is not None:
            status.writer.close()  # latest connection wins
        known_generation = status.generation
        generation = hello.get("generation")
        if generation != known_generation:
            # A generation we never met can't resume our watermarks: its
            # first record will be a reset (full snapshot / full backfill)
            # that re-anchors the epoch sequence. The reset happens UNDER
            # the scan lock: an aggregate tick may be mid-apply of this
            # shard's old-generation records in a worker thread, and a
            # concurrent zeroing would let the finishing apply overwrite
            # `applied` with an old-generation epoch — which flush_acks
            # would then ack to the NEW incarnation, pruning records it
            # never delivered.
            async with self.state.scan_lock:
                status.generation = generation
                status.queue.clear()
                status.enqueued = status.applied = status.acked = 0
                status.drained.set()
        status.clusters = {str(c) for c in (hello.get("clusters") or [])}
        status.connected = True
        status.writer = writer
        status.last_delivery = float(self.clock())
        self.dirty = True
        self._update_gauges()
        writer.write(
            encode_control(
                MSG_WELCOME,
                acked_epoch=status.acked,
                generation=known_generation,
                version=PROTOCOL_VERSION,
            )
        )
        await writer.drain()
        self._info(
            f"federation: shard {shard_id} connected "
            f"(generation {str(generation)[:12]}, acked epoch {status.acked})"
        )
        return status

    # ------------------------------------------------------------ epoch feed
    async def _serve_replica(
        self, hello: dict, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        """One epoch-feed subscription: version-checked WELCOME, the newest
        published epoch immediately (the catch-up snapshot — same wire
        format as every later broadcast), then each changed publish until
        the replica hangs up. The feed carries everything a stateless
        replica needs to serve the read path byte-identically: rendered
        body, pre-compressed variants, and the epoch/changed_at pair the
        validators derive from."""
        replica_id = str(hello.get("shard_id") or "replica")
        if int(hello.get("version", 0)) != PROTOCOL_VERSION:
            writer.write(
                encode_control(
                    MSG_WELCOME,
                    error=f"protocol version {hello.get('version')} != {PROTOCOL_VERSION}",
                )
            )
            await writer.drain()
            raise ProtocolError(f"replica {replica_id}: protocol version mismatch")
        if self._feed_frame is None:
            # Published before any replica subscribed (or restored from
            # durable state): build the catch-up frame from the live
            # snapshot so the subscriber doesn't wait for the next publish.
            snapshot = self.state.peek()
            if snapshot is not None and snapshot.epoch > 0:
                self._feed_frame = await asyncio.to_thread(
                    self._build_feed_frame, snapshot
                )
                self._feed_epoch = snapshot.epoch
        writer.write(
            encode_control(
                MSG_WELCOME, version=PROTOCOL_VERSION, epoch=self._feed_epoch
            )
        )
        if self._feed_frame is not None:
            writer.write(self._feed_frame)
            if self.metrics is not None:
                self.metrics.inc(
                    "krr_tpu_replica_feed_bytes_total",
                    len(self._feed_frame) - FRAME_OVERHEAD,
                )
        await writer.drain()
        self._replicas.add(writer)
        census = self._replica_census.setdefault(replica_id, {"acked_epoch": 0})
        census["connected"] = True
        census["subscribed_at"] = float(self.clock())
        if self.metrics is not None:
            self.metrics.set("krr_tpu_replica_subscribers", len(self._replicas))
        self._info(
            f"federation: replica {replica_id} subscribed "
            f"(feed epoch {self._feed_epoch})"
        )
        try:
            while True:
                message = await read_message(reader)
                if message is None:
                    break  # clean unsubscribe
                kind, body = message
                if kind == MSG_ACK:
                    # Install receipt: the replica finished swapping this
                    # epoch in — the census gains its acked watermark and
                    # the epoch's lineage record gains its install stage.
                    self._on_replica_ack(replica_id, decode_control(body))
        finally:
            self._replicas.discard(writer)
            census["connected"] = False
            if self.metrics is not None:
                self.metrics.set("krr_tpu_replica_subscribers", len(self._replicas))

    def _build_feed_frame(self, snapshot) -> bytes:
        """One published epoch as a framed MSG_EPOCH (worker thread: body
        copy + gzip + npz). The gzip variant is built with the SAME encoder
        the serve read path uses (deterministic mtime=0), so a replica
        cache warmed from the feed serves bytes identical to the primary's."""
        from krr_tpu_torch.server.app import encode_body

        # Observability stamp: the publishing tick's trace context (the
        # replica's install joins it as a remote child) and the epoch's
        # lineage so far. Meta-only — the body/variant bytes a replica
        # serves are identical with or without it.
        extra = {}
        entry = self._epochs.get(int(snapshot.epoch)) or {}
        if entry.get("trace"):
            extra["trace"] = dict(entry["trace"])
        if entry.get("lineage"):
            extra["lineage"] = {
                k: v for k, v in entry["lineage"].items() if k != "installs"
            }
        payload = encode_epoch_feed(
            epoch=snapshot.epoch,
            changed_at=snapshot.changed_at,
            window_end=float(snapshot.window_end or 0.0),
            published_at=snapshot.published_at,
            keys=list(snapshot.keys),
            body=snapshot.body_json,
            variants={"gzip": encode_body(snapshot.body_json, "gzip")},
            extra=extra or None,
        )
        return encode_message(MSG_EPOCH, payload)

    async def broadcast_epoch(self) -> None:
        """Push the current published epoch to every subscriber — called by
        the aggregate tick after a publish. Suppressed-epoch publishes
        (byte-identical body) re-use the previous epoch number, so the
        `_feed_epoch` guard makes re-broadcasts free; the frame is built
        once per CHANGED epoch even with zero subscribers, so a late
        subscriber's catch-up frame is always current."""
        snapshot = self.state.peek()
        if snapshot is None or snapshot.epoch <= 0:
            return
        if snapshot.epoch == self._feed_epoch and self._feed_frame is not None:
            return
        frame = await asyncio.to_thread(self._build_feed_frame, snapshot)
        self._feed_epoch = snapshot.epoch
        self._feed_frame = frame
        dead = []
        for writer in list(self._replicas):
            try:
                writer.write(frame)
                await writer.drain()
                if self.metrics is not None:
                    self.metrics.inc(
                        "krr_tpu_replica_feed_bytes_total", len(frame) - FRAME_OVERHEAD
                    )
            except (OSError, ConnectionError):
                dead.append(writer)
        for writer in dead:
            self._replicas.discard(writer)
            writer.close()
        if dead and self.metrics is not None:
            self.metrics.set("krr_tpu_replica_subscribers", len(self._replicas))

    async def _on_inventory(self, status: ShardStatus, body: bytes) -> None:
        # Decoded off the loop: a 100k-object inventory is tens of MB of
        # JSON and pydantic construction.
        objects = await asyncio.to_thread(decode_inventory, body)
        status.objects = objects
        status.clusters |= {obj.cluster or "" for obj in objects}
        status.owned_keys |= {object_key(obj) for obj in objects}
        status.last_delivery = float(self.clock())
        self.dirty = True
        await self._persist_inventories()

    async def _on_delta(
        self, status: ShardStatus, body: bytes, writer: asyncio.StreamWriter
    ) -> None:
        # Decode FULLY before any bookkeeping (np.load + JSON off the
        # loop): an undecodable record must act like a torn frame —
        # connection drops, nothing applied, shard re-sends.
        try:
            meta, parsed = await asyncio.to_thread(decode_ops, body)
        except Exception as e:
            raise ProtocolError(f"undecodable delta record: {e}") from e
        epoch = int(meta.get("epoch", 0))
        reset = bool((meta.get("extra") or {}).get("reset"))
        # Validate-and-enqueue loop: the epoch checks RE-RUN after every
        # backpressure wait — a reconnect can supersede this handler while
        # it is parked on a full queue, and the superseded handler's
        # re-sent record enqueueing after the new connection's would
        # double-apply an epoch (or regress the watermark). The writer
        # identity check kicks the stale handler out instead.
        while True:
            if not reset and epoch <= status.enqueued:
                # A re-send of something we already have (the shard's view
                # of our ack is behind): discard deterministically, re-ack
                # so the sender prunes.
                status.duplicates += 1
                if self.metrics is not None:
                    self.metrics.inc(
                        "krr_tpu_federation_duplicate_records_total",
                        shard=status.shard_id,
                    )
                if status.writer is not None:
                    status.writer.write(encode_control(MSG_ACK, epoch=status.acked))
                    await status.writer.drain()
                return
            if not reset and epoch != status.enqueued + 1:
                raise ProtocolError(
                    f"epoch gap: got {epoch}, expected {status.enqueued + 1} "
                    f"(shard re-syncs from the ack on reconnect)"
                )
            if len(status.queue) < self.queue_cap:
                break
            # Backpressure: a stalled aggregate tick must bound decoded
            # state — stop reading this shard's stream until it drains.
            status.drained.clear()
            await status.drained.wait()
            if status.writer is not writer:
                raise ProtocolError(
                    "connection superseded during backpressure wait"
                )
        status.queue.append((epoch, meta, parsed, len(body)))
        status.enqueued = epoch
        status.records += 1
        status.bytes += len(body)
        status.last_delivery = float(self.clock())
        self.dirty = True
        if self.metrics is not None:
            self.metrics.inc("krr_tpu_federation_records_total", shard=status.shard_id)
            self.metrics.inc(
                "krr_tpu_federation_bytes_total", len(body), shard=status.shard_id
            )
        self._update_gauges()

    # ------------------------------------------------- aggregate-tick surface
    def pending_records(self) -> int:
        return sum(len(s.queue) for s in self._shards.values())

    def _apply_sync(self) -> "tuple[int, int]":
        """Drain every shard queue in epoch order onto the fleet store —
        the WAL replay path (`apply_ops`), run in a worker thread under the
        scan lock. Returns (records applied, payload bytes applied)."""
        store = self.state.store
        applied = 0
        applied_bytes = 0
        with self._registry_lock:
            statuses = list(self._shards.values())
        for status in statuses:
            while status.queue:
                epoch, meta, parsed, nbytes = status.queue.popleft()
                extra = meta.get("extra") or {}
                # One span per replayed record, remote-linked to the shard
                # tick that encoded it: `apply_queued` runs this in a
                # worker thread, where the contextvar carries the tick's
                # ``apply`` span across to_thread — so apply_record nests
                # locally under apply AND joins the shard's scan remotely.
                with self.tracer.span(
                    "apply_record",
                    shard=status.shard_id,
                    epoch=epoch,
                    ops=len(parsed),
                ) as span:
                    link_remote_parent(span, extra.get("trace"))
                    if extra.get("reset"):
                        # The shard restarted (or first contact after an
                        # aggregator wipe): its accumulated rows re-arrive
                        # in full, so the old ones must go first or the
                        # fold would double-count the overlap.
                        dropped = self._drop_shard_rows(store, status, parsed)
                        if dropped:
                            self._info(
                                f"federation: shard {status.shard_id} reset — dropped "
                                f"{dropped} superseded row(s) before the snapshot"
                            )
                    apply_ops(store, parsed)
                # Ownership bookkeeping: the reset drop scope for a FUTURE
                # reset is exactly the keys this shard has claimed.
                for op in parsed:
                    kind, keys = op[0], op[1]
                    if kind in ("fold", "grow") and keys:
                        status.owned_keys.update(keys)
                    elif kind == "drop":
                        status.owned_keys.difference_update(keys)
                status.applied = epoch
                window_end = extra.get("window_end")
                if window_end is not None:
                    status.last_window_end = float(window_end)
                lineage = extra.get("lineage")
                if self.lineage_enabled and isinstance(lineage, dict):
                    self._shard_lineage[status.shard_id] = dict(lineage)
                applied += 1
                applied_bytes += nbytes
        return applied, applied_bytes

    @staticmethod
    def _drop_shard_rows(store, status: ShardStatus, parsed: list) -> int:
        """The reset drop scope: exactly the SHARD'S superseded rows — the
        keys it has claimed (inventory + applied ops) plus every key the
        incoming reset record is about to re-fold. NEVER cluster-wide: two
        shards partitioning one big cluster by namespace share a cluster
        name, and a cluster-scoped drop on one shard's reset would destroy
        its siblings' accumulated history. Keys a previous incarnation
        owned that the new one no longer scans (churn while disconnected)
        can linger as unrendered rows until the next reset claims them —
        a bounded leak, not a correctness hazard (unrendered rows never
        publish, and re-folded keys are always dropped first)."""
        superseded = set(status.owned_keys)
        for op in parsed:
            if op[0] in ("fold", "grow") and op[1]:
                superseded.update(op[1])
        keep = {key for key in store.keys if key not in superseded}
        if len(keep) == len(store.keys):
            return 0
        return store.compact(keep)

    async def apply_queued(self) -> "tuple[int, int]":
        """Apply everything queued (called by the aggregate tick under the
        scan lock) and release the receive-side backpressure."""
        t0 = time.perf_counter()
        applied, applied_bytes = await asyncio.to_thread(self._apply_sync)
        if self.metrics is not None and applied:
            self.metrics.observe(
                "krr_tpu_federation_apply_seconds", time.perf_counter() - t0
            )
        for status in self._shards.values():
            status.drained.set()
        self._update_gauges()
        return applied, applied_bytes

    def fleet_objects(self) -> list:
        """The merged inventory, shard-id order (deterministic render
        order), first shard wins a duplicate key."""
        seen: "set[str]" = set()
        out = []
        with self._registry_lock:
            statuses = [self._shards[sid] for sid in sorted(self._shards)]
        for status in statuses:
            for obj in status.objects:
                key = object_key(obj)
                if key not in seen:
                    seen.add(key)
                    out.append(obj)
        return out

    def newest_window_end(self) -> Optional[float]:
        ends = [
            s.last_window_end
            for s in self._shards.values()
            if s.last_window_end is not None
        ]
        return max(ends) if ends else None

    def stale_marks(self, now: float) -> "dict[str, float]":
        """key → stale_since for every workload of every shard whose newest
        APPLIED window is older than the staleness budget — the federation
        twin of the quarantine's carried-forward marks."""
        marks: "dict[str, float]" = {}
        for status in self._shards.values():
            if status.last_window_end is None:
                continue
            if now - status.last_window_end > self.staleness:
                for obj in status.objects:
                    marks[object_key(obj)] = status.last_window_end
        return marks

    def stale_shard_count(self, now: float) -> int:
        return sum(
            1
            for s in self._shards.values()
            if s.last_window_end is not None
            and now - s.last_window_end > self.staleness
        )

    def export_meta(self) -> dict:
        """The per-shard watermarks persisted INSIDE the store's
        ``extra_meta`` — same WAL record, same fsync as the applied ops, so
        recovery can never observe ops without the watermark that acked
        them (or vice versa). ``acked`` is the APPLIED epoch: by the time
        this persists, every applied op is in the same record."""
        with self._registry_lock:
            statuses = list(self._shards.values())
        return {
            "shards": {
                s.shard_id: {
                    "gen": s.generation,
                    "acked": s.applied,
                    "window_end": s.last_window_end,
                }
                for s in statuses
            }
        }

    async def flush_acks(self) -> None:
        """Ack applied epochs to their shards — called by the aggregate
        tick AFTER a successful persist (or immediately after apply on a
        memory-only serve). A send failure just leaves the ack for the
        reconnect handshake."""
        for status in list(self._shards.values()):
            if status.applied <= status.acked:
                continue
            status.acked = status.applied
            writer = status.writer
            if writer is None:
                continue
            try:
                writer.write(encode_control(MSG_ACK, epoch=status.acked))
                await writer.drain()
            except (OSError, ConnectionError):
                status.connected = False
                status.writer = None

    # ------------------------------------------------------ freshness lineage
    def note_epoch(
        self,
        epoch: int,
        *,
        apply_ts: float,
        publish_ts: float,
        trace_ctx: Optional[dict] = None,
    ) -> Optional[dict]:
        """Stamp one published epoch with its lineage record and trace
        context — called by the aggregate tick after the publish, before
        the broadcast (so the feed frame carries the stamp).

        The record chains every hop's OWN clock: ``newest_sample_ts`` (the
        newest shard window end folded in) → ``fold_ts`` (when the slowest
        contributing shard folded it) → ``apply_ts`` → ``publish_ts``,
        with ``install_ts`` arriving later via replica acks. Suppressed
        publishes re-use the epoch number, so an already-stamped epoch is
        left alone (the FIRST publish of an epoch is its lineage). Fires
        the ``krr_tpu_e2e_freshness_seconds{stage}`` histograms: each
        stage's value is the recommendation's AGE at that stage — how far
        the pipeline had drifted from the newest sample by the time the
        stage finished."""
        if epoch <= 0:
            return None
        entry = self._epochs.get(int(epoch))
        if entry is None:
            entry = {}
            self._epochs[int(epoch)] = entry
            while len(self._epochs) > self.EPOCH_LINEAGE_KEEP:
                self._epochs.popitem(last=False)
        if trace_ctx:
            entry["trace"] = dict(trace_ctx)
        if not self.lineage_enabled or not self._shard_lineage:
            return entry.get("lineage")
        lineage = entry.get("lineage")
        if lineage is None:
            shards = {sid: dict(frag) for sid, frag in self._shard_lineage.items()}
            lineage = {
                "epoch": int(epoch),
                "newest_sample_ts": max(
                    float(f.get("newest_sample_ts") or 0.0) for f in shards.values()
                ),
                "fold_ts": max(
                    float(f.get("fold_ts") or 0.0) for f in shards.values()
                ),
                "apply_ts": float(apply_ts),
                "publish_ts": float(publish_ts),
                "shards": shards,
            }
            entry["lineage"] = lineage
            if self.metrics is not None:
                newest = lineage["newest_sample_ts"]
                for stage in ("fold", "apply", "publish"):
                    self.metrics.observe(
                        "krr_tpu_e2e_freshness_seconds",
                        max(0.0, lineage[f"{stage}_ts"] - newest),
                        stage=stage,
                    )
        return lineage

    def _on_replica_ack(self, replica_id: str, ack: dict) -> None:
        """A replica's install receipt: ``{epoch, install_ts}`` — the
        lineage chain's LAST hop, reported by the only process that knows
        when the swap actually happened (stamped with the REPLICA'S
        clock). Completes the epoch's lineage record and the census row
        /fleet lag derives from. Unknown epochs (rolled out of the ring,
        or lineage disabled) just update the census."""
        epoch = int(ack.get("epoch", 0))
        install_ts = ack.get("install_ts")
        census = self._replica_census.setdefault(replica_id, {"acked_epoch": 0})
        census["acked_epoch"] = max(int(census.get("acked_epoch", 0)), epoch)
        if install_ts is not None:
            census["install_ts"] = float(install_ts)
        lineage = (self._epochs.get(epoch) or {}).get("lineage")
        if lineage is None or install_ts is None:
            return
        installs = lineage.setdefault("installs", {})
        if replica_id in installs:
            return  # duplicate ack (reconnect re-install) — first wins
        installs[replica_id] = float(install_ts)
        lineage["install_ts"] = max(
            float(lineage.get("install_ts") or 0.0), float(install_ts)
        )
        if self.metrics is not None:
            self.metrics.observe(
                "krr_tpu_e2e_freshness_seconds",
                max(0.0, float(install_ts) - float(lineage["newest_sample_ts"])),
                stage="install",
            )

    def epoch_lineage(self, n: int = 1) -> "list[dict]":
        """The newest ``n`` epochs' lineage records, oldest first (the
        /statusz block and the timeline's per-tick lineage)."""
        records = [
            entry["lineage"]
            for entry in self._epochs.values()
            if entry.get("lineage") is not None
        ]
        return [dict(record) for record in records[-max(1, int(n)):]]

    def newest_installed_lineage(self) -> Optional[dict]:
        """The newest epoch whose lineage has at least one replica
        install — the install hop the sentinel bands (acks land after the
        tick that published, so this intentionally trails the current
        epoch)."""
        for entry in reversed(self._epochs.values()):
            lineage = entry.get("lineage")
            if lineage is not None and lineage.get("install_ts") is not None:
                return dict(lineage)
        return None

    # --------------------------------------------------------- fleet topology
    def fleet_census(self, now: Optional[float] = None) -> dict:
        """The ``GET /fleet`` topology census: every node this aggregator
        has met through a HELLO/subscribe handshake (plus itself), with
        per-node health, acked-vs-current epoch lag, and freshness. Built
        entirely from state the handshakes already maintain — no new wire
        traffic."""
        if now is None:
            now = float(self.clock())
        nodes: "list[dict]" = []
        newest = None
        for entry in reversed(self._epochs.values()):
            if entry.get("lineage") is not None:
                newest = entry["lineage"]
                break
        nodes.append(
            {
                "node": self.node,
                "role": "aggregator",
                "connected": True,
                "epoch": self._feed_epoch,
                "acked_epoch": self._feed_epoch,
                "epoch_lag": 0,
                "freshness_seconds": (
                    round(
                        max(
                            0.0, newest["publish_ts"] - newest["newest_sample_ts"]
                        ),
                        3,
                    )
                    if newest is not None
                    else None
                ),
                "health": "ok",
            }
        )
        with self._registry_lock:
            statuses = [self._shards[sid] for sid in sorted(self._shards)]
        for s in statuses:
            stale = (
                s.last_window_end is not None
                and now - s.last_window_end > self.staleness
            )
            nodes.append(
                {
                    "node": s.shard_id,
                    "role": "shard",
                    "connected": s.connected,
                    "epoch": s.enqueued,
                    "acked_epoch": s.acked,
                    "epoch_lag": max(0, s.enqueued - s.acked),
                    "freshness_seconds": (
                        round(max(0.0, now - s.last_window_end), 3)
                        if s.last_window_end is not None
                        else None
                    ),
                    "health": (
                        "stale"
                        if stale
                        else ("ok" if s.connected else "disconnected")
                    ),
                }
            )
        for replica_id in sorted(self._replica_census):
            census = self._replica_census[replica_id]
            acked = int(census.get("acked_epoch", 0))
            connected = bool(census.get("connected"))
            install_ts = census.get("install_ts")
            nodes.append(
                {
                    "node": replica_id,
                    "role": "replica",
                    "connected": connected,
                    "epoch": self._feed_epoch,
                    "acked_epoch": acked,
                    "epoch_lag": max(0, self._feed_epoch - acked),
                    "freshness_seconds": (
                        round(max(0.0, now - float(install_ts)), 3)
                        if install_ts is not None
                        else None
                    ),
                    "health": "ok" if connected else "disconnected",
                }
            )
        return {
            "nodes": nodes,
            "feed_epoch": self._feed_epoch,
            "staleness_seconds": self.staleness,
        }

    def fleet_gauges(self, now: float) -> None:
        """Refresh the fleet metrics from the census — once per aggregate
        tick. The check/unhealthy counter pair is CUMULATIVE (one check
        per node per tick), so the fleet_health SLO rollup burns its error
        budget at exactly the unhealthy-node-ticks rate."""
        if self.metrics is None:
            return
        census = self.fleet_census(now)
        roles: "dict[str, int]" = {}
        for entry in census["nodes"]:
            roles[entry["role"]] = roles.get(entry["role"], 0) + 1
            self.metrics.set(
                "krr_tpu_fleet_epoch_lag", entry["epoch_lag"], node=entry["node"]
            )
            self.metrics.inc("krr_tpu_fleet_node_checks_total")
            if entry["health"] != "ok":
                self.metrics.inc("krr_tpu_fleet_node_unhealthy_total")
        for role, count in roles.items():
            self.metrics.set("krr_tpu_fleet_nodes", count, role=role)

    # ---------------------------------------------------------- observability
    def _update_gauges(self) -> None:
        if self.metrics is None:
            return
        self.metrics.set("krr_tpu_federation_shards", len(self._shards))
        self.metrics.set(
            "krr_tpu_federation_connected_shards",
            sum(1 for s in self._shards.values() if s.connected),
        )
        self.metrics.set("krr_tpu_federation_queue_records", self.pending_records())

    def tick_gauges(self, now: float) -> None:
        """Per-shard gauges refreshed by the aggregate tick."""
        if self.metrics is None:
            return
        self._update_gauges()
        self.metrics.set("krr_tpu_federation_stale_shards", self.stale_shard_count(now))
        for status in self._shards.values():
            self.metrics.set(
                "krr_tpu_federation_shard_epoch", status.applied, shard=status.shard_id
            )
            if status.last_window_end is not None:
                self.metrics.set(
                    "krr_tpu_federation_shard_lag_seconds",
                    max(0.0, now - status.last_window_end),
                    shard=status.shard_id,
                )

    def tick_stats(self, now: float, applied: int) -> dict:
        """The timeline record's ``federation`` block for one aggregate
        tick: shard census + per-tick applied records and wire bytes."""
        total_bytes = sum(s.bytes for s in self._shards.values())
        delta_bytes = max(0, total_bytes - self._bytes_at_tick)
        self._bytes_at_tick = total_bytes
        return {
            "shards": len(self._shards),
            "connected": sum(1 for s in self._shards.values() if s.connected),
            "stale_shards": self.stale_shard_count(now),
            "applied_records": applied,
            "wire_bytes": delta_bytes,
            "replicas": len(self._replicas),
        }

    def status(self, now: Optional[float] = None) -> dict:
        """The /healthz + /statusz federation section."""
        if now is None:
            now = float(self.clock())
        with self._registry_lock:
            statuses = [self._shards[sid] for sid in sorted(self._shards)]
        return {
            "shards": {
                s.shard_id: {
                    "connected": s.connected,
                    "generation": s.generation,
                    "acked_epoch": s.acked,
                    "applied_epoch": s.applied,
                    "enqueued_epoch": s.enqueued,
                    "queued_records": len(s.queue),
                    "objects": len(s.objects),
                    "records": s.records,
                    "duplicates": s.duplicates,
                    "bytes": s.bytes,
                    "last_window_end": s.last_window_end,
                    "lag_seconds": (
                        round(max(0.0, now - s.last_window_end), 3)
                        if s.last_window_end is not None
                        else None
                    ),
                    "stale": (
                        s.last_window_end is not None
                        and now - s.last_window_end > self.staleness
                    ),
                }
                for s in statuses
            },
            "staleness_seconds": self.staleness,
            "replicas": len(self._replicas),
            "feed_epoch": self._feed_epoch,
            "lineage": (self.epoch_lineage(1) or [None])[-1],
        }

