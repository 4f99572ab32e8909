"""Stateless read replicas: epoch-subscribed copies of the serve read path.

A copy of `krr_tpu/federation/replica.py`. A replica computes nothing: it
owns no strategy and no device, so its build info carries the backend
``none`` and the ``replica`` command takes no ``--device``.

A ``krr-tpu replica`` process scales READS horizontally without scaling
anything else: it runs the full HTTP read path (`krr_tpu_torch.server.app` —
response cache, conditional GETs, filter/pagination pushdown,
pre-compressed variants) but owns no scheduler, no metric backend, no
durable store, and no digest math. Its published snapshot comes off the
wire: it subscribes to an aggregator (or any serve process with
``--federation-listen``) over the federation protocol
(`krr_tpu_torch.federation.protocol`) with ``role="replica"`` in its HELLO, and
the source pushes one ``MSG_EPOCH`` frame per *published* epoch — the
rendered fleet JSON, its pre-compressed variants, and the exact publish
metadata (epoch, ``changed_at``) the validators are built from.

Byte fidelity is the contract: the replica installs the frame's body and
epoch/``changed_at`` VERBATIM (`ServerState.install_snapshot`), so the
body bytes, the ETag, the ``Last-Modified``, and the gzip variant it
serves are identical to the source's — a load balancer can spray
GET /recommendations across N replicas and every client sees one origin.
Conditional GETs revalidate correctly across replicas for the same
reason: the validators are copies, not reinventions.

Failure posture: a replica that loses its feed keeps serving the last
installed epoch (reads degrade to stale, never to 5xx) and reconnects
with the same capped jittered backoff the shard uplinks use; on
reconnect the source replays its current epoch, and stale installs
(epoch at or below the installed one) drop idempotently. /healthz
reports the subscription (source, feed epoch, lag) and downgrades to
``degraded`` while disconnected.
"""

from __future__ import annotations

import asyncio
import contextlib
import hashlib
import json
import os
import random
import time
from typing import Optional

from krr_tpu_torch.core.config import Config
from krr_tpu_torch.federation.protocol import (
    FED_MAGIC,
    MSG_ACK,
    MSG_EPOCH,
    MSG_HELLO,
    MSG_WELCOME,
    PROTOCOL_VERSION,
    ProtocolError,
    decode_control,
    decode_epoch_feed,
    encode_control,
    read_message,
)
from krr_tpu_torch.obs.trace import NULL_TRACER, link_remote_parent
from krr_tpu_torch.server.state import ServerState, Snapshot
from krr_tpu_torch.utils.logging import KrrLogger

#: The ``backend`` label of a replica's build info: it runs no strategy.
REPLICA_BACKEND = "none"


class ReplicaClient:
    """The epoch-feed subscription: one long-lived KRRFED1 connection that
    turns ``MSG_EPOCH`` frames into installed snapshots.

    The heavy half of an install — np.load of the frame, the pydantic
    re-validation of the fleet ``Result`` (the pushdown path renders
    filtered subsets from it) — runs off the event loop; only the
    O(1) snapshot swap takes the write lock. The connection loop never
    raises out: every failure marks the feed down, arms the jittered
    backoff (the Prometheus retry ladder's: cap pre-jitter, ±50% jitter), and retries,
    because a replica's job during a source outage is to keep serving
    the epoch it has.
    """

    def __init__(
        self,
        state: ServerState,
        *,
        host: str,
        port: int,
        replica_id: str,
        metrics,
        logger: KrrLogger,
        backoff_cap: float = 5.0,
        clock=time.time,
        tracer=NULL_TRACER,
    ) -> None:
        self.state = state
        self.host = host
        self.port = port
        self.replica_id = replica_id
        self.metrics = metrics
        self.logger = logger
        self.backoff_cap = float(backoff_cap)
        self.clock = clock
        #: Each install records a root ``install`` span remote-linked to
        #: the publishing tick's trace (the frame's ``trace`` meta) — the
        #: last lane of the stitched fleet trace.
        self.tracer = tracer
        self.connected = False
        #: Newest INSTALLED epoch (dropped stale replays don't count).
        self.feed_epoch = 0
        self.epochs_applied = 0
        self.epochs_dropped = 0
        self.reconnects = 0
        #: Source publish time of the newest installed epoch — the lag
        #: gauge's anchor (wall-vs-wall, so clock skew shows up honestly).
        self.last_published_at: Optional[float] = None
        #: When the feed went down (None while subscribed). Seeds "down" at
        #: construction so a replica that can never reach its source goes
        #: stale on schedule. /healthz keys staleness on THIS, not on the
        #: snapshot's window_end: an idle-but-healthy source broadcasts
        #: nothing (epochs only move on changed bytes), so the snapshot
        #: freezing is normal — the feed being down is not.
        self.disconnected_at: Optional[float] = float(clock())
        self.last_error: Optional[str] = None
        self._attempts = 0
        self._task: Optional[asyncio.Task] = None
        #: Set after every install — tests and warm-up waits ride it
        #: instead of polling the state.
        self.installed = asyncio.Event()

    def start(self) -> None:
        self._task = asyncio.ensure_future(self.run())

    async def run(self) -> None:
        """Subscribe, install epochs, reconnect forever."""
        while True:
            try:
                await self._subscribe_once()
            except asyncio.CancelledError:
                raise
            except (OSError, ProtocolError, asyncio.IncompleteReadError) as e:
                self.last_error = f"{type(e).__name__}: {e}"[:300]
            except Exception as e:  # an install bug must not kill serving
                self.last_error = f"{type(e).__name__}: {e}"[:300]
                self.logger.debug_exception()
            self.connected = False
            self._attempts += 1
            wait = min(
                0.25 * 2 ** (self._attempts - 1), self.backoff_cap
            ) * random.uniform(0.5, 1.5)
            self.logger.warning(
                f"[replica {self.replica_id}] feed from {self.host}:{self.port} "
                f"down ({self.last_error}) — serving epoch {self.feed_epoch} "
                f"stale, retrying in {wait:.2f}s"
            )
            await asyncio.sleep(wait)

    async def _subscribe_once(self) -> None:
        reader, writer = await asyncio.open_connection(self.host, self.port)
        try:
            writer.write(
                FED_MAGIC
                + encode_control(
                    MSG_HELLO,
                    shard_id=self.replica_id,
                    role="replica",
                    version=PROTOCOL_VERSION,
                )
            )
            await writer.drain()
            message = await read_message(reader)
            if message is None or message[0] != MSG_WELCOME:
                raise ProtocolError("source closed the handshake without WELCOME")
            welcome = decode_control(message[1])
            if "error" in welcome:
                raise ProtocolError(f"source refused the subscription: {welcome['error']}")
            self.connected = True
            self.disconnected_at = None
            self._attempts = 0
            self.reconnects += 1
            self.metrics.inc("krr_tpu_replica_reconnects_total")
            self.logger.info(
                f"[replica {self.replica_id}] subscribed to "
                f"{self.host}:{self.port} (source epoch "
                f"{welcome.get('epoch', 0)}, installed {self.feed_epoch})"
            )
            while True:
                message = await read_message(reader)
                if message is None:
                    raise ProtocolError("source closed the epoch feed")
                kind, body = message
                if kind == MSG_EPOCH:
                    await self._install(body, writer)
        finally:
            self.connected = False
            if self.disconnected_at is None:
                self.disconnected_at = float(self.clock())
            writer.close()

    async def _install(
        self, payload: bytes, writer: Optional[asyncio.StreamWriter] = None
    ) -> None:
        """One epoch frame → one installed snapshot (or an idempotent drop
        when the feed replays an epoch we already hold).

        An actual install closes the observability loop twice over: the
        root ``install`` span joins the publishing tick's trace as a
        remote child (the frame's ``trace`` meta), the frame's ``lineage``
        stages fire the ``krr_tpu_e2e_freshness_seconds{stage}``
        histograms on THIS registry (every stage, so one replica /metrics
        scrape shows the whole chain), and an ``MSG_ACK {epoch,
        install_ts}`` rides back up the feed connection — the install
        timestamp only this process's clock can stamp."""

        def build() -> "tuple[dict, Snapshot, dict]":
            from krr_tpu_torch.models.result import Result

            meta, body, variants = decode_epoch_feed(payload)
            # The Result re-validates from the SAME bytes the source
            # rendered from its models — pushdown (filtered/paged renders)
            # and /statusz summaries read it; unfiltered responses never
            # touch it (they serve ``body_json`` verbatim).
            result = Result(**json.loads(body))
            snapshot = Snapshot(
                result=result,
                body_json=body,
                window_end=float(meta.get("window_end") or 0.0),
                published_at=float(meta.get("published_at") or 0.0),
                keys=tuple(meta.get("keys") or ()),
                epoch=int(meta.get("epoch") or 0),
                changed_at=float(meta.get("changed_at") or 0.0),
                body_digest=hashlib.blake2b(body, digest_size=16).digest(),
            )
            return meta, snapshot, variants

        with self.tracer.span(
            "install", kind="replica", replica=self.replica_id
        ) as span:
            meta, snapshot, variants = await asyncio.to_thread(build)
            link_remote_parent(span, meta.get("trace"))
            span.set(epoch=snapshot.epoch)
            self.metrics.inc("krr_tpu_replica_feed_bytes_total", len(payload))
            installed = await self.state.install_snapshot(snapshot, variants=variants)
            install_ts = float(self.clock())
            if installed:
                self.feed_epoch = snapshot.epoch
                self.epochs_applied += 1
                self.last_published_at = snapshot.published_at
                self.metrics.set("krr_tpu_replica_epoch", self.feed_epoch)
                self.metrics.inc("krr_tpu_replica_epochs_applied_total")
                self._observe_lineage(meta.get("lineage"), install_ts)
                if writer is not None:
                    with contextlib.suppress(OSError, ConnectionError):
                        writer.write(
                            encode_control(
                                MSG_ACK, epoch=snapshot.epoch, install_ts=install_ts
                            )
                        )
                        await writer.drain()
            else:
                self.epochs_dropped += 1
                span.set(kind="dropped")
        if not installed:
            self.tracer.discard(span.trace_id)
        lag = max(0.0, float(self.clock()) - (self.last_published_at or 0.0))
        if self.last_published_at is not None:
            self.metrics.set("krr_tpu_replica_feed_lag_seconds", lag)
        self.installed.set()

    def _observe_lineage(self, lineage, install_ts: float) -> None:
        """Fire every freshness stage from the frame's lineage record plus
        our own install — each value the recommendation's age (stage ts −
        newest sample ts) when that stage finished. No lineage on the
        frame (source predates it, or stamping is off) fires nothing."""
        if not isinstance(lineage, dict):
            return
        newest = lineage.get("newest_sample_ts")
        if newest is None:
            return
        newest = float(newest)
        for stage in ("fold", "apply", "publish"):
            ts = lineage.get(f"{stage}_ts")
            if ts is not None:
                self.metrics.observe(
                    "krr_tpu_e2e_freshness_seconds",
                    max(0.0, float(ts) - newest),
                    stage=stage,
                )
        self.metrics.observe(
            "krr_tpu_e2e_freshness_seconds",
            max(0.0, install_ts - newest),
            stage="install",
        )

    def status(self, now: float) -> dict:
        """The /healthz + /statusz ``replica`` block: where the feed comes
        from and how fresh it is."""
        return {
            "source": f"{self.host}:{self.port}",
            "connected": self.connected,
            "feed_epoch": self.feed_epoch,
            "epochs_applied": self.epochs_applied,
            "epochs_dropped": self.epochs_dropped,
            "reconnects": self.reconnects,
            "feed_lag_seconds": (
                round(max(0.0, now - self.last_published_at), 3)
                if self.last_published_at is not None
                else None
            ),
            "last_error": self.last_error,
        }

    async def close(self) -> None:
        if self._task is not None:
            self._task.cancel()
            with contextlib.suppress(asyncio.CancelledError):
                await self._task
            self._task = None


class ReplicaServer:
    """Composition root for ``krr-tpu replica``: the serve read path with a
    feed subscription where the scheduler would be.

    Deliberately absent (the point of the tier): no :class:`ScanSession`
    (no metric backend, no kubernetes client), no scheduler, no durable
    store, no journal — a replica is disposable and restarts cold in
    milliseconds, re-warming from the source's catch-up frame. What IS
    here is byte-for-byte the serving surface: :class:`HttpApp` with the
    response cache, render pool, and conditional-GET machinery, fed by
    :meth:`ServerState.install_snapshot`.
    """

    def __init__(
        self,
        config: Config,
        *,
        clock=time.time,
        logger: Optional[KrrLogger] = None,
    ) -> None:
        from krr_tpu_torch.federation.shard import parse_endpoint
        from krr_tpu_torch.obs.metrics import MetricsRegistry
        from krr_tpu_torch.ops.digest import DigestSpec
        from krr_tpu_torch.server.app import HttpApp
        from krr_tpu_torch.core.streaming import DigestStore

        if not getattr(config, "federation_aggregator", None):
            raise ValueError(
                "krr-tpu replica needs --source (federation_aggregator) "
                "host:port — the serve/aggregator publishing the epoch feed"
            )
        self.config = config
        self.logger = logger or config.create_logger()
        self.clock = clock
        host, port = parse_endpoint(config.federation_aggregator, "--source")
        self.metrics = MetricsRegistry()
        # The store is a placeholder (ServerState requires one; /healthz
        # counts its rows — 0, honestly: a replica holds no digests). The
        # spec never shapes anything because nothing ever folds.
        self.state = ServerState(
            DigestStore(spec=DigestSpec()), journal=None, metrics=self.metrics
        )
        if config.response_cache_enabled:
            from krr_tpu_torch.server.state import ResponseCache

            self.state.response_cache = ResponseCache(
                max_entries=config.response_cache_max_entries,
                max_bytes=int(config.response_cache_max_mb * (1 << 20)),
                metrics=self.metrics,
            )
        replica_id = getattr(config, "federation_shard_id", None) or (
            f"replica-{os.urandom(4).hex()}"
        )
        self.replica_id = replica_id
        # Replicas always record install spans (the ring is bounded): the
        # node-stamped /debug/trace export is the replica's lane in the
        # stitched fleet trace.
        from krr_tpu_torch.obs.trace import Tracer

        self.tracer = Tracer(
            ring_scans=getattr(config, "trace_ring_scans", 16), node=replica_id
        )
        self.client = ReplicaClient(
            self.state,
            host=host,
            port=port,
            replica_id=replica_id,
            metrics=self.metrics,
            logger=self.logger,
            backoff_cap=float(
                getattr(config, "federation_backoff_cap_seconds", 5.0) or 5.0
            ),
            clock=clock,
            tracer=self.tracer,
        )
        self.state.replica = self.client
        self.app = HttpApp(
            self.state,
            self.logger,
            # Freshness is the FEED's freshness: three missed publish
            # cadences (the source publishes at scan cadence) = stale.
            stale_after_seconds=3.0 * config.scan_interval_seconds,
            clock=clock,
            drift_dead_band_pct=config.hysteresis_dead_band_pct,
            drift_confirm_ticks=config.hysteresis_confirm_ticks,
            hysteresis_enabled=config.hysteresis_enabled,
            tracer=self.tracer,
            render_concurrency=config.server_render_concurrency,
            render_queue=config.server_render_queue,
        )
        self._server: Optional[asyncio.AbstractServer] = None

    @property
    def port(self) -> int:
        assert self._server is not None, "replica not started"
        return self._server.sockets[0].getsockname()[1]

    async def start(self) -> None:
        from krr_tpu_torch.obs.metrics import record_build_info

        record_build_info(self.metrics, REPLICA_BACKEND)
        self._server = await asyncio.start_server(
            self.app.handle_connection, self.config.server_host, self.config.server_port
        )
        self.client.start()
        self.logger.info(
            f"Replica serving on http://{self.config.server_host}:{self.port}, "
            f"subscribed to epoch feed at {self.client.host}:{self.client.port}"
        )

    async def shutdown(self) -> None:
        await self.client.close()
        if self._server is not None:
            self._server.close()
            self.app.abort_connections()
            await self._server.wait_closed()
            self._server = None


async def run_replica(config: Config, *, logger: Optional[KrrLogger] = None) -> None:
    """The ``krr-tpu replica`` entry point: serve until SIGINT/SIGTERM."""
    import signal

    replica = ReplicaServer(config, logger=logger)
    await replica.start()
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        try:
            loop.add_signal_handler(sig, stop.set)
        except NotImplementedError:  # non-unix event loops
            pass
    # kill -USR2 <pid> dumps the install trace ring + a metrics snapshot
    # without stopping the replica — serve/shard parity (`krr_tpu_torch.obs.dump`).
    from krr_tpu_torch.obs.dump import install_signal_dump

    install_signal_dump(
        replica.tracer,
        replica.metrics,
        device=REPLICA_BACKEND,
        trace_target=config.trace_path,
        metrics_target=config.metrics_dump_path,
        logger=replica.logger,
        loop=loop,
    )
    try:
        await stop.wait()
    finally:
        replica.logger.info("Replica shutting down")
        await replica.shutdown()
        if config.trace_path:
            from krr_tpu_torch.obs.trace import write_chrome_trace

            write_chrome_trace(replica.tracer, config.trace_path)
        if config.profile_path:
            from krr_tpu_torch.obs.profile import write_profile_report

            write_profile_report(replica.tracer, config.profile_path)
