"""The scanner shard: one cluster's discover→fetch→fold, streamed as deltas.

A copy of `krr_tpu/federation/shard.py` over the port's scan session, digest
store and WAL codec: the records a port shard sends are the bytes a JAX
shard sends for the same tick, so either package's aggregator replays them.
A shard's tick is host code (the native digest ingest and a host fold) and
launches no kernel; its strategy still binds ``--device`` (``cuda`` unless
the caller asks for the CPU) like ``serve``'s.

A :class:`FederatedShard` is the serve scheduler's scan half without the
serve half: it owns a private :class:`~krr_tpu_torch.core.streaming.DigestStore`
with delta capture ON, runs the existing discover → fetch → fold pipeline
(`krr_tpu_torch.core.runner.ScanSession`) over ITS clusters on the same
grid-clamped window math the scheduler uses, and after each fold encodes
the tick's captured mutation ops into WAL-format records
(`krr_tpu_torch.core.durastore.encode_ops`) streamed to the aggregation plane
(`krr_tpu_torch.federation.protocol`).

The aggregation plane is one or many: without ``--federation-ring`` the
shard streams every record to the single ``--aggregator`` endpoint;
with a ring (`krr_tpu_torch.federation.ring`) it splits each tick's captured
ops by owning aggregator and streams each partition over its OWN
:class:`Uplink` with independent epoch watermarks — and a ring node that
names standby endpoints gets the same records on every endpoint (a
replicated WAL on the wire), so a standby takes over the key range with
zero lost epochs.

Delivery discipline (the exactly-once half the shard owns), per uplink:

* every tick's record appends to an UNACKED buffer before it is sent; the
  buffer only drops records the aggregator has ACKED (records are already
  sparse-encoded bytes, so the buffer costs roughly one WAL delta per
  unacked tick — and ring endpoints of one node SHARE the frame bytes);
* a lost connection just marks the stream down — ticks keep scanning and
  buffering; the next pump reconnects (capped jittered backoff, so N
  shards don't thundering-herd a restarted aggregator's handshake),
  handshakes, and re-sends everything past that endpoint's acked epoch
  (duplicates on the wire are discarded deterministically by the
  aggregator's epoch watermark);
* an endpoint whose WELCOME acked epoch is BEHIND what the shard already
  pruned (a standby that took over mid-stream, or a restart from older
  durable state) cannot be resumed by deltas — the uplink re-anchors from
  a snapshot of its partition, flagged ``reset``;
* a shard whose GENERATION the aggregator doesn't recognize (first
  contact, or the aggregator met a previous incarnation) cannot replay
  history its store never captured — same re-sync: the partition encodes
  as one snapshot record flagged ``reset``, which makes the aggregator
  drop the shard's old rows before applying (bit-exact: the snapshot IS
  the sum of every window the shard folded).

Failure domain: the whole shard. A failed fetch aborts the tick (nothing
folds, nothing ships, the window refetches next tick) — per-workload
quarantine stays a single-scanner concern; at the aggregator a silent
shard's rows keep serving with ``stale_since`` marks.

``krr-tpu shard`` (:func:`run_shard`) runs one as a process; tests and
``bench.py`` drive ticks in-process with a pinned clock.
"""

from __future__ import annotations

import asyncio
import contextlib
import os
import random
import time
from collections import deque
from typing import Callable, Optional

import numpy as np

from krr_tpu_torch.core.config import Config
from krr_tpu_torch.core.durastore import encode_ops
from krr_tpu_torch.core.runner import ScanSession
from krr_tpu_torch.core.streaming import DigestStore, object_key
from krr_tpu_torch.federation.protocol import (
    FED_MAGIC,
    FRAME_OVERHEAD,
    MSG_ACK,
    MSG_DELTA,
    MSG_HELLO,
    MSG_INVENTORY,
    MSG_WELCOME,
    PROTOCOL_VERSION,
    ProtocolError,
    decode_control,
    encode_control,
    encode_inventory,
    encode_message,
    read_message,
)
from krr_tpu_torch.federation.ring import HashRing, RingNode, parse_ring, partition_ops
from krr_tpu_torch.obs.trace import Tracer, propagation_context
from krr_tpu_torch.utils.logging import KrrLogger


def parse_endpoint(value: str, flag: str) -> "tuple[str, int]":
    """``host:port`` → (host, port), with IPv6 bracket support."""
    host, sep, port = value.rpartition(":")
    if not sep or not port.isdigit():
        raise ValueError(f"{flag} must be host:port, got {value!r}")
    return host.strip("[]") or "127.0.0.1", int(port)


class Uplink:
    """One KRRFED1 stream: buffered, acked, auto-reconnecting delivery of
    already-framed delta records to one aggregator endpoint.

    The shard owns the ENCODING (one record per ring node per tick) and
    each uplink owns the DELIVERY state for one endpoint: the unacked
    buffer, the acked watermark, the connection, and the reconnect
    backoff. Endpoints of the same ring node receive the same ``offer``
    calls with the same frame objects — the replicated WAL costs one set
    of record bytes regardless of standby count. The region→global tier
    reuses this class verbatim: an aggregator-backed server constructs a
    standalone Uplink and offers its own store's captured ops.

    Reconnect backoff mirrors the Prometheus retry ladder's semantics
    (``0.25·2^(n−1)`` capped pre-jitter, ±50% jitter): after an aggregator
    restart, N shards' handshakes decorrelate instead of herding. A
    successful connect — or an explicit endpoint repoint via
    :meth:`reset_backoff` — re-arms immediate attempts.
    """

    def __init__(
        self,
        *,
        stream_id: str,
        host: str,
        port: int,
        generation: str,
        hello_spec: dict,
        snapshot_fn: Callable[[], "Optional[tuple[int, bytes]]"],
        metrics,
        logger: KrrLogger,
        buffer_cap: int,
        backoff_cap: float,
        node: str = "default",
        clusters_fn: Optional[Callable[[], list]] = None,
        inventory_fn: Optional[Callable[[], "Optional[list]"]] = None,
        on_ack: Optional[Callable[[], None]] = None,
    ) -> None:
        self.stream_id = stream_id
        self.node = node
        self.host = host
        self.port = port
        self.generation = generation
        self.hello_spec = dict(hello_spec)
        self.snapshot_fn = snapshot_fn
        self.clusters_fn = clusters_fn
        self.inventory_fn = inventory_fn
        self.metrics = metrics
        self.logger = logger
        #: (epoch, framed DELTA message) awaiting this endpoint's ack.
        #: Bounded: past ``buffer_cap`` records the backlog COLLAPSES into
        #: one snapshot record — a days-long endpoint outage must cost one
        #: partition-sized record, not one delta per tick until OOM.
        self.buffer: "deque[tuple[int, bytes]]" = deque()
        self.buffer_cap = int(buffer_cap)
        self.backoff_cap = float(backoff_cap)
        self.acked = 0
        self._sent_through = 0
        self._inventory_dirty = True
        self._on_ack = on_ack
        self._reader: Optional[asyncio.StreamReader] = None
        self._writer: Optional[asyncio.StreamWriter] = None
        self._recv_task: Optional[asyncio.Task] = None
        self._attempts = 0
        self._next_attempt = 0.0

    # ---------------------------------------------------------------- state
    @property
    def connected(self) -> bool:
        return self._writer is not None

    def reset_backoff(self) -> None:
        """Re-arm immediate connect attempts (endpoint repointed, or the
        caller knows the aggregator just came back)."""
        self._attempts = 0
        self._next_attempt = 0.0

    def mark_inventory_dirty(self) -> None:
        self._inventory_dirty = True

    async def offer(self, epoch: int, frame: bytes) -> None:
        """Buffer one framed record for delivery (shared bytes across the
        node's endpoints — append only, no copy)."""
        self.buffer.append((epoch, frame))
        if len(self.buffer) > self.buffer_cap:
            await self._collapse()

    async def _collapse(self) -> None:
        """Replace the whole unacked backlog with ONE snapshot record at
        the current epoch. The snapshot is flagged ``reset`` (the
        aggregator drops this stream's superseded rows first), so it is
        bit-exact — the partition state IS the sum of every buffered delta
        plus the acked history — and bounded by the partition size instead
        of the outage length. The aggregator accepts reset records at any
        epoch, so the collapsed epoch sequence re-anchors cleanly."""
        dropped = len(self.buffer)
        self.buffer.clear()
        snapshot = await asyncio.to_thread(self.snapshot_fn)
        if snapshot is not None:
            self.buffer.append(snapshot)
            self._sent_through = min(self._sent_through, snapshot[0] - 1)
        self.logger.warning(
            f"[{self.stream_id}] unacked backlog to {self.host}:{self.port} hit "
            f"{dropped} records (--federation-queue-records {self.buffer_cap}) — "
            f"collapsed into one snapshot record; the aggregator re-syncs from it"
        )

    async def _resync(self) -> None:
        """Re-anchor this endpoint from a partition snapshot: buffered
        deltas are useless to it (unknown generation, or an acked epoch
        regressed behind our pruned buffer) and the reset-flagged snapshot
        reconstructs the partition exactly at the current epoch."""
        self.buffer.clear()
        self.acked = 0
        self._sent_through = 0
        snapshot = await asyncio.to_thread(self.snapshot_fn)
        if snapshot is not None:
            self.buffer.append(snapshot)
            self._sent_through = self.acked = snapshot[0] - 1

    # ------------------------------------------------------------ transport
    async def _connect(self) -> None:
        if self._recv_task is not None and not self._recv_task.done():
            self._recv_task.cancel()
        reader, writer = await asyncio.open_connection(self.host, self.port)
        try:
            writer.write(
                FED_MAGIC
                + encode_control(
                    MSG_HELLO,
                    shard_id=self.stream_id,
                    generation=self.generation,
                    version=PROTOCOL_VERSION,
                    spec=self.hello_spec,
                    clusters=self.clusters_fn() if self.clusters_fn else [],
                )
            )
            await writer.drain()
            message = await read_message(reader)
            if message is None or message[0] != MSG_WELCOME:
                raise ProtocolError("aggregator closed the handshake without WELCOME")
            welcome = decode_control(message[1])
            if "error" in welcome:
                raise ProtocolError(
                    f"aggregator refused the handshake: {welcome['error']}"
                )
        except BaseException:
            writer.close()
            raise
        self._inventory_dirty = True
        if welcome.get("generation") != self.generation:
            # The aggregator never met THIS store: nothing it acked maps to
            # our epochs. Re-sync from state — drop the buffered deltas
            # (the snapshot subsumes them) and ship the partition as one
            # reset record.
            await self._resync()
            self.logger.info(
                f"[{self.stream_id}] aggregator at {self.host}:{self.port} does "
                f"not know generation {self.generation} — re-syncing from a snapshot"
            )
        else:
            acked = int(welcome.get("acked_epoch", 0))
            if acked < self.acked:
                # The endpoint REGRESSED (standby takeover, or a restart
                # from older durable state): epochs in (acked, self.acked]
                # are pruned from our buffer, so the next buffered delta
                # would be a gap. The snapshot re-anchors it losslessly.
                await self._resync()
                self.logger.info(
                    f"[{self.stream_id}] aggregator at {self.host}:{self.port} "
                    f"acked epoch {acked} behind our pruned buffer ({self.acked}) "
                    f"— re-syncing from a snapshot"
                )
            else:
                self.acked = max(self.acked, acked)
                self._prune_acked()
                # Re-send everything past the ack (the torn-stream heal):
                # the aggregator discards any duplicate it already enqueued.
                self._sent_through = self.acked
        self._reader, self._writer = reader, writer
        self._recv_task = asyncio.ensure_future(self._recv_loop(reader))
        self.metrics.inc("krr_tpu_federation_reconnects_total")

    def _prune_acked(self) -> None:
        while self.buffer and self.buffer[0][0] <= self.acked:
            self.buffer.popleft()

    async def _recv_loop(self, reader: asyncio.StreamReader) -> None:
        try:
            while True:
                message = await read_message(reader)
                if message is None:
                    break
                kind, body = message
                if kind == MSG_ACK:
                    ack = decode_control(body)
                    self.acked = max(self.acked, int(ack.get("epoch", 0)))
                    self._prune_acked()
                    if self._on_ack is not None:
                        self._on_ack()
        except (ProtocolError, OSError):
            pass  # the connection is dead; the next pump reconnects
        finally:
            # CancelledError propagates (close() owns the suppression —
            # swallowing it here would make the task complete "normally"
            # and break outer cancellation scopes). Only tear down OUR
            # connection: a reconnect may already have installed a fresh
            # reader/writer by the time this loop unwinds.
            if self._reader is reader:
                self._disconnect()

    def _disconnect(self) -> None:
        writer, self._reader, self._writer = self._writer, None, None
        if writer is not None:
            writer.close()

    async def pump(self) -> None:
        """Send whatever is due: (re)connect when the backoff window
        allows, the current inventory when it changed, then every buffered
        record past ``_sent_through``. Send failures just mark the stream
        down — the next pump retries."""
        if self._writer is None:
            if time.monotonic() < self._next_attempt:
                return
            try:
                await self._connect()
            except (OSError, ProtocolError, asyncio.IncompleteReadError) as e:
                self._attempts += 1
                # The Prometheus retry ladder's semantics (`prometheus.py::_retrying`): cap
                # pre-jitter so deep ladders stay bounded, ±50% jitter so a
                # fleet of shards reconnecting to a restarted aggregator
                # decorrelates instead of re-herding every cycle.
                wait = min(
                    0.25 * 2 ** (self._attempts - 1), self.backoff_cap
                ) * random.uniform(0.5, 1.5)
                self._next_attempt = time.monotonic() + wait
                self.metrics.inc("krr_tpu_federation_uplink_retries_total")
                self.logger.warning(
                    f"[{self.stream_id}] cannot reach aggregator at "
                    f"{self.host}:{self.port}: {e} — buffering "
                    f"({len(self.buffer)} unacked record(s)), retrying in {wait:.2f}s"
                )
                return
            self._attempts = 0
        writer = self._writer
        try:
            if self._inventory_dirty and self.inventory_fn is not None:
                objects = self.inventory_fn()
                if objects is not None:
                    # Serialized off the loop (a fleet-scale inventory is
                    # tens of MB of model_dump + JSON — the aggregator
                    # offloads the same-size decode for the same reason).
                    body = await asyncio.to_thread(encode_inventory, objects)
                    if writer is not self._writer:
                        return  # connection turned over under the encode
                    writer.write(encode_message(MSG_INVENTORY, body))
                    self._inventory_dirty = False
            for epoch, frame in list(self.buffer):
                if epoch <= self._sent_through:
                    continue
                writer.write(frame)
                self._sent_through = epoch
                self.metrics.inc(
                    "krr_tpu_federation_sent_bytes_total", len(frame) - FRAME_OVERHEAD
                )
            await writer.drain()
        except (OSError, ConnectionError):
            self.logger.warning(
                f"[{self.stream_id}] connection to {self.host}:{self.port} dropped "
                f"mid-send — re-sending from epoch {self.acked} on reconnect"
            )
            self._disconnect()

    async def wait_acked(self, epoch: int, timeout: float = 30.0) -> bool:
        """Block until this endpoint acked ``epoch``, pumping while waiting
        so a downed connection heals (standalone users — the region tier)."""
        deadline = time.monotonic() + timeout
        while self.acked < epoch:
            if time.monotonic() >= deadline:
                return False
            await self.pump()
            await asyncio.sleep(0.05)
        return True

    def status(self, epoch: int) -> dict:
        """This endpoint's posture for the shard's /healthz ``aggregators``
        block: who it streams to and how far behind the shard's current
        epoch its acks run."""
        return {
            "node": self.node,
            "endpoint": f"{self.host}:{self.port}",
            "connected": self.connected,
            "acked_epoch": self.acked,
            "epoch_lag": max(0, int(epoch) - int(self.acked)),
            "unacked_records": len(self.buffer),
        }

    async def close(self) -> None:
        if self._recv_task is not None:
            self._recv_task.cancel()
            with contextlib.suppress(asyncio.CancelledError):
                await self._recv_task
            self._recv_task = None
        self._disconnect()


class FederatedShard:
    """One scanner shard: local scan state + delta stream uplink(s)."""

    def __init__(
        self,
        config: Config,
        *,
        session: Optional[ScanSession] = None,
        shard_id: Optional[str] = None,
        clock=time.time,
        logger: Optional[KrrLogger] = None,
    ) -> None:
        self.config = config
        self.session = session or ScanSession(config, logger=logger)
        self.logger = logger or self.session.logger
        self.clock = clock
        settings = self.session.strategy.settings
        if not hasattr(settings, "cpu_spec"):
            raise ValueError(
                "krr-tpu shard requires a digest-backed strategy (tdigest): "
                "the delta stream is digest mergeability on the wire"
            )
        self.spec = settings.cpu_spec()
        self.store = DigestStore(spec=self.spec)
        self.store.track_deltas = True
        # Records land in an aggregator's MERGED store (other shards' rows
        # interleave): whole-store folds must carry their key lists — and
        # ring partitioning needs every op's keys to split it.
        self.store.capture_full_keys = True
        if not (shard_id or config.federation_shard_id):
            clusters = config.clusters if isinstance(config.clusters, list) else None
            shard_id = "/".join(clusters) if clusters else "default"
        self.shard_id = shard_id or config.federation_shard_id
        #: Fresh per store lifetime: a restarted shard can't re-send ticks
        #: its in-memory store never captured, so no aggregator may resume
        #: its old epoch watermark against us.
        self.generation = os.urandom(8).hex()
        ring_spec = getattr(config, "federation_ring", None)
        if ring_spec:
            self.nodes = parse_ring(ring_spec)
            #: key → aggregator-name assignment; None in single-aggregator
            #: mode (no partition pass on the tick path).
            self.ring: Optional[HashRing] = HashRing(self.nodes)
        elif config.federation_aggregator:
            host, port = parse_endpoint(config.federation_aggregator, "--aggregator")
            self.nodes = [RingNode(name="default", endpoints=((host, port),))]
            self.ring = None
        else:
            raise ValueError(
                "shard needs --aggregator (federation_aggregator) host:port "
                "or --federation-ring name=host:port[,name=...]"
            )
        self.scan_interval = float(config.scan_interval_seconds)
        self.discovery_interval = float(config.discovery_interval_seconds)
        self.metrics = self.session.metrics
        # Shards always record spans (the ring is bounded): the tick's scan
        # span is the ROOT the aggregator's apply and the replica's install
        # join as remote children, so without it no cross-process trace
        # stitches. The node identity stamps every exported event.
        if self.session.tracer.enabled:
            self.session.tracer.node = self.shard_id
        else:
            self.session.tracer = Tracer(
                ring_scans=getattr(config, "trace_ring_scans", 16), node=self.shard_id
            )
        self.tracer = self.session.tracer
        #: Freshness lineage stamping (metadata-only; the bench's overhead
        #: control turns it off).
        self.lineage_enabled = bool(getattr(config, "federation_lineage_enabled", True))

        self.epoch = 0
        self.last_end: Optional[float] = None
        self._objects = None
        self._discovered_at = -float("inf")
        #: Watch-driven discovery (`--discovery-mode watch`): shards ride
        #: the SAME resident inventory source as the serve scheduler — the
        #: reconcile runs every tick, and churn compaction / inventory
        #: re-sends are gated on the inventory generation so a quiet
        #: fleet's ticks stream no redundant inventory records.
        self.discovery_mode = str(getattr(config, "discovery_mode", "relist"))
        self._inventory_generation = None
        self.buffer_cap = int(getattr(config, "federation_queue_records", 4096))
        self.backoff_cap = float(
            getattr(config, "federation_backoff_cap_seconds", 5.0) or 5.0
        )
        #: Set until the first record is encoded: a fresh shard incarnation
        #: whose aggregators may hold a previous incarnation's rows flags
        #: record 1 ``reset`` so they drop those rows before applying.
        self._needs_reset = True
        #: The newest tick's observability metadata, re-stamped onto
        #: snapshot records: a resync/collapse REPLACES buffered tick
        #: records (on a real first contact the handshake routinely lands
        #: after tick 1 encoded, so the generation mismatch re-syncs and
        #: the snapshot is the only record the aggregator ever sees), and
        #: without these the fleet would lose its lineage chain and the
        #: apply span's remote link to the scan that folded the state.
        self._last_scan_ctx: "Optional[dict]" = None
        self._last_lineage: "Optional[dict]" = None
        self._ack_event = asyncio.Event()
        hello_spec = {
            "gamma": self.spec.gamma,
            "min_value": self.spec.min_value,
            "num_buckets": self.spec.num_buckets,
        }
        #: Delivery streams: one per (ring node × endpoint). In
        #: single-aggregator mode this is exactly one uplink; ring
        #: endpoints of one node share record bytes and differ only in
        #: delivery state. Stream ids are suffixed per node in ring mode so
        #: two nodes' streams never collide at a shared endpoint.
        self._uplinks: "list[Uplink]" = []
        self._node_uplinks: "dict[str, list[Uplink]]" = {}
        for node in self.nodes:
            stream_id = (
                self.shard_id if self.ring is None else f"{self.shard_id}/{node.name}"
            )
            per_node: "list[Uplink]" = []
            for host, port in node.endpoints:
                uplink = Uplink(
                    stream_id=stream_id,
                    node=node.name,
                    host=host,
                    port=port,
                    generation=self.generation,
                    hello_spec=hello_spec,
                    snapshot_fn=(
                        self._snapshot_record
                        if self.ring is None
                        else (lambda name=node.name: self._snapshot_record_for(name))
                    ),
                    clusters_fn=self._hello_clusters,
                    inventory_fn=(lambda name=node.name: self._inventory_for(name)),
                    metrics=self.metrics,
                    logger=self.logger,
                    buffer_cap=self.buffer_cap,
                    backoff_cap=self.backoff_cap,
                    on_ack=self._note_ack,
                )
                per_node.append(uplink)
                self._uplinks.append(uplink)
            self._node_uplinks[node.name] = per_node
        self.consecutive_failures = 0
        self.last_error: Optional[str] = None

    # ---------------------------------------------------- legacy delegation
    # Single-aggregator callers (tests, bench) address the shard's one
    # stream directly: host/port repoints, buffer length asserts, acked
    # reads. They delegate to the uplinks so the attributes keep meaning
    # what they meant before the ring existed.
    @property
    def host(self) -> str:
        return self._uplinks[0].host

    @host.setter
    def host(self, value: str) -> None:
        for uplink in self._uplinks:
            uplink.host = value
            uplink.reset_backoff()

    @property
    def port(self) -> int:
        return self._uplinks[0].port

    @port.setter
    def port(self, value: int) -> None:
        for uplink in self._uplinks:
            uplink.port = int(value)
            uplink.reset_backoff()

    @property
    def acked(self) -> int:
        """The fleet-safe watermark: the SLOWEST endpoint's acked epoch
        (every aggregator holds everything at or below it)."""
        return min(uplink.acked for uplink in self._uplinks)

    @acked.setter
    def acked(self, value: int) -> None:
        for uplink in self._uplinks:
            uplink.acked = int(value)

    @property
    def _buffer(self) -> "deque[tuple[int, bytes]]":
        if len(self._uplinks) == 1:
            return self._uplinks[0].buffer
        raise AttributeError(
            "per-uplink buffers in ring mode — use shard._uplinks[i].buffer"
        )

    @property
    def connected(self) -> bool:
        return all(uplink.connected for uplink in self._uplinks)

    @property
    def unacked_records(self) -> int:
        return sum(len(uplink.buffer) for uplink in self._uplinks)

    def _disconnect(self) -> None:
        """Drop every uplink's connection (tests simulate a mid-stream
        death; the next pump reconnects and re-sends past the acks)."""
        for uplink in self._uplinks:
            uplink._disconnect()

    def _note_ack(self) -> None:
        self.metrics.set("krr_tpu_federation_unacked_records", self.unacked_records)
        self._ack_event.set()

    def _hello_clusters(self) -> list:
        return sorted({obj.cluster or "" for obj in (self._objects or [])}) or (
            self.config.clusters if isinstance(self.config.clusters, list) else []
        )

    def _inventory_for(self, name: str) -> "Optional[list]":
        """The inventory one ring node receives: only the objects whose
        keys it owns (an aggregator renders exactly its partition — full
        inventories would grow empty rows for unowned keys there)."""
        if self._objects is None:
            return None
        if self.ring is None:
            return self._objects
        return [
            obj for obj in self._objects if self.ring.owner(object_key(obj)) == name
        ]

    # ------------------------------------------------------------- scanning
    def _step_seconds(self) -> float:
        from krr_tpu_torch.integrations.prometheus import effective_step_seconds

        return float(
            effective_step_seconds(
                self.session.strategy.settings.timeframe_timedelta.total_seconds()
            )
        )

    async def _discover(self, now: float) -> None:
        objects = await self.session.discover()
        if not objects and self.store.keys:
            # Fail-soft like the scheduler: an empty inventory over a
            # non-empty store is overwhelmingly an apiserver outage, and
            # compacting on it would stream fleet-wide drop ops to the
            # aggregator — destroying accumulated history centrally too.
            self.metrics.inc("krr_tpu_discovery_failures_total")
            self.logger.warning(
                f"[shard {self.shard_id}] discovery returned no objects while the "
                f"local store holds {len(self.store.keys)} rows — keeping the "
                f"previous inventory"
            )
            return
        self._objects = objects
        self._discovered_at = now
        self.metrics.set("krr_tpu_fleet_objects", len(objects))
        # Compaction and the inventory re-send are gated on the inventory
        # generation when the source exposes one (watch mode, where
        # discovery runs every tick): only actual churn pays the store
        # compaction or streams a fresh inventory record. Relist sources
        # (generation None) keep today's per-discovery behavior.
        generation_fn = getattr(
            self.session.get_inventory(), "inventory_generation", None
        )
        generation = generation_fn() if callable(generation_fn) else None
        if generation is not None and generation == self._inventory_generation:
            return
        # Churn compaction: the captured drop ops ride the next delta
        # record, so deleted workloads leave the aggregators' stores too.
        dropped = self.store.compact({object_key(obj) for obj in objects})
        if dropped:
            self.metrics.inc("krr_tpu_store_compacted_rows_total", dropped)
        self._inventory_generation = generation
        for uplink in self._uplinks:
            uplink.mark_inventory_dirty()

    async def tick(self, now: Optional[float] = None) -> bool:
        """One scan tick: (maybe) re-discover, fetch the due window, fold,
        encode the captured deltas as one record per aggregator, buffer +
        send them. Returns False when no new window was due (the pump
        still runs, so a downed connection keeps retrying between due
        windows).

        The whole tick runs under a root ``scan`` span whose propagation
        context rides the tick's delta records — the aggregator's
        ``apply_record`` span and (transitively) the replica's ``install``
        span join it as remote children, so one stitched trace covers the
        epoch's full shard→aggregator→replica journey."""
        if now is None:
            now = float(self.clock())
        with self.tracer.span("scan", kind="shard", shard=self.shard_id) as scan_span:
            did_scan = await self._tick_traced(scan_span, now)
            if not did_scan:
                scan_span.set(kind="skipped")
        if not did_scan:
            self.tracer.discard(scan_span.trace_id)
        return did_scan

    async def _tick_traced(self, scan_span, now: float) -> bool:
        settings = self.session.strategy.settings
        step = self._step_seconds()
        self.session.begin_scan()

        if (
            self._objects is None
            or now - self._discovered_at >= self.discovery_interval
            or self.discovery_mode == "watch"
        ):
            await self._discover(now)
        objects = self._objects or []

        if self.last_end is None:
            start = now - settings.history_timedelta.total_seconds()
            if getattr(self.config, "fetch_downsample", "off") != "off":
                # Same grid alignment as the serve scheduler: downsampling
                # is only exact on the absolute step grid.
                start -= start % step
            kind = "full"
        else:
            start = self.last_end + step
            kind = "delta"
            if start > now:
                self.metrics.inc("krr_tpu_scans_skipped_total")
                await self._pump()
                return False
        end = start + ((now - start) // step) * step

        # Leg split, mirroring the scheduler: workloads that appeared since
        # the last tick get a full-window backfill beside the fleet delta
        # (a delta-width fetch would lose their pre-discovery history).
        backfill_start = end - (settings.history_timedelta.total_seconds() // step) * step
        fresh = []
        seasoned = []
        if kind == "delta":
            for obj in objects:
                (fresh if object_key(obj) not in self.store else seasoned).append(obj)
        else:
            seasoned = objects

        legs = []
        if seasoned or not fresh:
            legs.append((seasoned, start, kind))
        if fresh:
            legs.append((fresh, backfill_start, "backfill"))
        step_seconds = settings.timeframe_timedelta.total_seconds()
        # Whole-shard failure domain: raise_on_failure aborts the tick on
        # any terminal fetch failure — nothing folds, nothing ships, the
        # window refetches next tick, and the AGGREGATOR's staleness marks
        # cover the serving side.
        fleets = await asyncio.gather(
            *[
                self.session.gather_fleet_digests(
                    leg_objects,
                    history_seconds=end - w_start,
                    step_seconds=step_seconds,
                    end_time=end,
                    raise_on_failure=True,
                )
                for leg_objects, w_start, _ in legs
                if leg_objects
            ],
            return_exceptions=True,
        )
        for fleet in fleets:
            if isinstance(fleet, BaseException):
                raise fleet

        from krr_tpu_torch.strategies.window import MEMORY_SCALE

        for fleet in fleets:
            self.store.fold_fleet(fleet, MEMORY_SCALE)
        self.last_end = end

        extra = {"window_end": end, "window_start": start, "kind": kind}
        ctx = propagation_context(scan_span, node=self.shard_id)
        if ctx is not None:
            extra["trace"] = ctx
        self._last_scan_ctx = ctx
        if self.lineage_enabled:
            # Lineage stage 1: the tick's newest sample is the window end;
            # the fold finished "now" by THIS process's clock. Metadata
            # only — the record's ops and the stores they build are
            # bit-identical with lineage off.
            extra["lineage"] = {
                "shard": self.shard_id,
                "newest_sample_ts": float(end),
                "fold_ts": float(now),
            }
            self._last_lineage = extra["lineage"]
        await self._encode_tick(extra=extra)
        scan_span.set(
            window_start=round(start, 3),
            window_end=round(end, 3),
            objects=len(objects),
            epoch=self.epoch,
        )
        self.metrics.inc("krr_tpu_scans_total", kind="shard")
        self.metrics.set("krr_tpu_scan_window_seconds", end - start)
        self.metrics.set("krr_tpu_last_scan_timestamp_seconds", end)
        self.metrics.set("krr_tpu_digest_store_rows", len(self.store.keys))
        if fresh:
            self.metrics.inc("krr_tpu_backfilled_objects_total", len(fresh))
        await self._pump()
        return True

    async def _encode_tick(self, *, extra: dict) -> None:
        """Capture → partition → record per aggregator → buffer: one epoch
        per tick, shared by every node's record (and every endpoint's
        delivery), so ``wait_acked(self.epoch)`` means "the whole tick
        landed everywhere". The partition split and CSR encodes run off the
        loop (fleet-scale records are real numpy + zip work that would
        stall ack processing). Nodes with no ops this tick still get an
        empty record — it carries the window metadata their staleness
        accounting rides on, and keeps the per-node epoch sequence gapless.
        """
        ops = self.store.pending_ops()
        if self._needs_reset:
            extra = {**extra, "reset": True}
            self._needs_reset = False
        if self.ring is None:
            parts = {"default": ops}
        else:
            parts = await asyncio.to_thread(partition_ops, ops, self.ring.owner)
        epoch = self.epoch + 1
        for name, uplinks in self._node_uplinks.items():
            payload = await asyncio.to_thread(
                encode_ops,
                parts.get(name, []),
                epoch=epoch,
                extra=extra,
                num_buckets=self.spec.num_buckets,
            )
            frame = encode_message(MSG_DELTA, payload)
            for uplink in uplinks:
                await uplink.offer(epoch, frame)
        self.epoch = epoch
        self.store.clear_pending(len(ops))
        if self.ring is not None:
            spread = self.ring.spread(self.store.keys)
            self.metrics.set("krr_tpu_federation_ring_nodes", len(spread))
            for name, count in spread.items():
                self.metrics.set("krr_tpu_federation_ring_keys", count, node=name)
        self.metrics.set("krr_tpu_federation_unacked_records", self.unacked_records)

    def _snapshot_record(self) -> "Optional[tuple[int, bytes]]":
        """The whole store as ONE reset record at the current epoch — the
        single-aggregator resync path."""
        return self._snapshot_record_for(None)

    def _snapshot_record_for(self, owner: "Optional[str]") -> "Optional[tuple[int, bytes]]":
        """One ring node's partition (or the whole store for ``None``) as
        ONE reset record at the current epoch — the resync path. Applying
        it to fresh aggregator rows reconstructs the partition exactly (the
        store IS the sum of its folded windows). An EMPTY partition at a
        live epoch still yields a record: its reset drops whatever stale
        rows the endpoint holds for this stream, and it re-anchors the
        epoch sequence. Only at epoch 0 (nothing ever encoded — record 1's
        ``reset`` flag covers first contact) is there nothing to say."""
        store = self.store
        if owner is None or self.ring is None:
            keys = list(store.keys)
            arrays = (
                store.cpu_counts,
                store.cpu_total,
                store.cpu_peak,
                store.mem_total,
                store.mem_peak,
            )
        else:
            rows = [
                i for i, key in enumerate(store.keys) if self.ring.owner(key) == owner
            ]
            idx = np.asarray(rows, dtype=np.int64)
            keys = [store.keys[i] for i in rows]
            arrays = (
                store.cpu_counts[idx],
                store.cpu_total[idx],
                store.cpu_peak[idx],
                store.mem_total[idx],
                store.mem_peak[idx],
            )
        ops = [("fold", keys, *arrays)] if keys else []
        if not ops and self.epoch <= 0:
            return None
        extra: dict = {"reset": True, "window_end": self.last_end, "kind": "snapshot"}
        # The snapshot IS the last tick's folded state, so it carries that
        # tick's trace context and lineage fragment: the aggregator's
        # apply span still joins the scan that produced the data, and the
        # freshness chain reports the fold's real age, not the resync's.
        if self._last_scan_ctx is not None:
            extra["trace"] = dict(self._last_scan_ctx)
        if self.lineage_enabled and self._last_lineage is not None:
            extra["lineage"] = dict(self._last_lineage)
        payload = encode_ops(
            ops,
            epoch=self.epoch,
            extra=extra,
            num_buckets=self.spec.num_buckets,
        )
        return self.epoch, encode_message(MSG_DELTA, payload)

    async def run_once(self, now: Optional[float] = None) -> "Optional[bool]":
        """One guarded tick (the shard loop's unit): failures count and
        degrade — the stream pump still runs so the uplinks heal while the
        backend is down."""
        try:
            did_scan = await self.tick(now)
        except asyncio.CancelledError:
            raise
        except Exception as e:
            self.metrics.inc("krr_tpu_scan_failures_total")
            self.consecutive_failures += 1
            self.last_error = f"{type(e).__name__}: {e}"[:300]
            self.logger.warning(
                f"[shard {self.shard_id}] scan failed: {e} — the window refetches next tick"
            )
            self.logger.debug_exception()
            with contextlib.suppress(Exception):
                await self._pump()
            return None
        else:
            self.consecutive_failures = 0
            return did_scan

    # ------------------------------------------------------------- transport
    async def _pump(self) -> None:
        for uplink in self._uplinks:
            await uplink.pump()

    async def wait_acked(self, epoch: int, timeout: float = 30.0) -> bool:
        """Block until EVERY endpoint has acked ``epoch`` (tests, graceful
        shutdown). Pumps while waiting so downed connections heal."""
        deadline = time.monotonic() + timeout
        while self.acked < epoch:
            if time.monotonic() >= deadline:
                return False
            await self._pump()
            self._ack_event.clear()
            with contextlib.suppress(asyncio.TimeoutError):
                await asyncio.wait_for(self._ack_event.wait(), timeout=0.1)
        return True

    def status(self) -> dict:
        """The shard's /healthz body: scan posture plus a per-aggregator
        delivery block (which node/endpoint each stream feeds and its
        acked-vs-current epoch lag), so ring placement is debuggable from
        the SHARD side."""
        return {
            "status": (
                "ok"
                if self.connected and self.consecutive_failures == 0
                else "degraded"
            ),
            "shard_id": self.shard_id,
            "generation": self.generation,
            "connected": self.connected,
            "epoch": self.epoch,
            "acked_epoch": self.acked,
            "unacked_records": self.unacked_records,
            "aggregators": [uplink.status(self.epoch) for uplink in self._uplinks],
            "ring": (
                {"nodes": sorted(self._node_uplinks)} if self.ring is not None else None
            ),
            "last_window_end": self.last_end,
            "consecutive_scan_failures": self.consecutive_failures,
            "last_scan_error": self.last_error,
            "objects": len(self._objects or []),
        }

    async def close(self) -> None:
        for uplink in self._uplinks:
            await uplink.close()
        await self.session.close()


class ShardStatusServer:
    """A minimal HTTP surface for a shard process: ``GET /healthz`` (the
    shard's scan + uplink posture as JSON), ``GET /metrics`` (the shared
    registry's exposition — the shard-side ``krr_tpu_federation_*`` family
    would otherwise be write-only: `krr_tpu_federation_unacked_records` is
    the signal that a shard is silently buffering through an aggregator
    outage, and it manifests on the SHARD), and ``GET /debug/trace``
    (the tick ring as Chrome trace JSON, node-stamped — what ``analyze
    --stitch`` fetches to join this shard's lane into the fleet trace)."""

    def __init__(self, shard: FederatedShard) -> None:
        self.shard = shard
        self._server: Optional[asyncio.AbstractServer] = None
        self._connections: "set[asyncio.StreamWriter]" = set()
        from krr_tpu_torch.obs.metrics import record_build_info

        record_build_info(self.shard.metrics, str(self.shard.session.strategy.device))

    async def serve(self, host: str, port: int) -> None:
        self._server = await asyncio.start_server(self._handle, host, port)

    @property
    def port(self) -> int:
        assert self._server is not None, "status server not started"
        return self._server.sockets[0].getsockname()[1]

    async def _handle(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        import json

        self._connections.add(writer)
        try:
            request_line = await reader.readline()
            while (await reader.readline()) not in (b"\r\n", b"\n", b""):
                pass  # drain headers; GET carries no body
            parts = request_line.decode("latin-1", "replace").split()
            target = parts[1] if len(parts) >= 2 else ""
            path, _, query = target.partition("?")
            if path == "/metrics":
                from krr_tpu_torch.obs.metrics import refresh_process_metrics

                refresh_process_metrics(self.shard.metrics)
                status, content_type = 200, "text/plain; version=0.0.4; charset=utf-8"
                body = self.shard.metrics.render().encode()
            elif path == "/healthz":
                status, content_type = 200, "application/json"
                body = (json.dumps(self.shard.status()) + "\n").encode()
            elif path == "/debug/trace":
                n = None
                for part in query.split("&"):
                    key, _, value = part.partition("=")
                    if key == "n" and value.isdigit() and int(value) > 0:
                        n = int(value)
                payload = await asyncio.to_thread(self.shard.tracer.export_chrome, n)
                status, content_type = 200, "application/json"
                body = (json.dumps(payload) + "\n").encode()
            else:
                status, content_type = 404, "application/json"
                body = (
                    b'{"error": "no route (shard serves /healthz, /metrics'
                    b' and /debug/trace)"}\n'
                )
            reason = {200: "OK", 404: "Not Found"}[status]
            writer.write(
                (
                    f"HTTP/1.1 {status} {reason}\r\n"
                    f"Content-Type: {content_type}\r\n"
                    f"Content-Length: {len(body)}\r\nConnection: close\r\n\r\n"
                ).encode("latin-1")
                + body
            )
            await writer.drain()
        except (ConnectionError, asyncio.IncompleteReadError, OSError):
            pass
        finally:
            self._connections.discard(writer)
            writer.close()

    async def close(self) -> None:
        if self._server is not None:
            self._server.close()
            for writer in list(self._connections):
                writer.close()
            await self._server.wait_closed()
            self._server = None


async def run_shard(config: Config, *, logger: Optional[KrrLogger] = None) -> None:
    """The ``krr-tpu shard`` entry point: scan + stream until SIGINT/SIGTERM."""
    import signal

    shard = FederatedShard(config, logger=logger)
    status_server = ShardStatusServer(shard)
    await status_server.serve(config.server_host, config.server_port)
    targets = ", ".join(
        f"{uplink.stream_id}→{uplink.host}:{uplink.port}"
        for uplink in shard._uplinks
    )
    shard.logger.info(
        f"Shard {shard.shard_id} scanning every {shard.scan_interval:.0f}s, "
        f"streaming deltas to {targets}; status on "
        f"http://{config.server_host}:{status_server.port} (/healthz, /metrics)"
    )
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        try:
            loop.add_signal_handler(sig, stop.set)
        except NotImplementedError:  # non-unix event loops
            pass
    # kill -USR2 <pid> dumps the tick trace ring + a metrics snapshot to
    # timestamped files without stopping the shard — the same escape hatch
    # serve has (`krr_tpu_torch.obs.dump`).
    from krr_tpu_torch.obs.dump import install_signal_dump

    install_signal_dump(
        shard.tracer,
        shard.metrics,
        device=str(shard.session.strategy.device),
        trace_target=config.trace_path,
        metrics_target=config.metrics_dump_path,
        logger=shard.logger,
        loop=loop,
    )
    try:
        while not stop.is_set():
            await shard.run_once()
            with contextlib.suppress(asyncio.TimeoutError):
                await asyncio.wait_for(stop.wait(), timeout=shard.scan_interval)
    finally:
        shard.logger.info("Shard shutting down")
        # Best-effort drain: give in-flight records a moment to ack so a
        # rolling restart doesn't force a re-send of the whole tail.
        if shard.epoch > shard.acked:
            with contextlib.suppress(Exception):
                await shard.wait_acked(shard.epoch, timeout=5.0)
        await status_server.close()
        await shard.close()
        if config.trace_path:
            from krr_tpu_torch.obs.trace import write_chrome_trace

            write_chrome_trace(shard.tracer, config.trace_path)
        if config.profile_path:
            from krr_tpu_torch.obs.profile import write_profile_report

            write_profile_report(shard.tracer, config.profile_path)
