"""The port's federation (`krr_tpu_torch.federation`) against the JAX package's.

Every class of ``tests/test_federation.py`` has its counterpart here, run on
the port and, where the two packages can meet, side by side with the JAX
package on the same seeded fleet (`tests/fakes/federation.py`
``MultiClusterFleet``) and the same pinned clock:

* the wire: ``encode_message``, the control and inventory codecs and the
  WAL records a shard sends are the JAX package's BYTES;
* the ring: the same owner for every key, the same partitions;
* the merged store: port shards into a port aggregator give a store
  bit-exact by key to the port's single-process control AND to the JAX
  aggregator's; the served ``/recommendations`` bytes equal the JAX
  aggregator's; JAX shards feed a port aggregator and port shards feed a
  JAX aggregator, each bit-exact to the control (the two packages hold each
  other to account on the wire);
* exactly-once through torn records, disconnects, restarts and a standby
  takeover; the replica's bodies and validators are its source's bytes.

Tolerances are exact throughout. The JAX fakes build the JAX package's
``K8sObjectData``; the port's sessions get the same objects converted to the
port's model (``model_dump(mode="json")`` → ``K8sObjectData(**...)``) and
the same series keyed by the port's ``ResourceType``. Clocks are pinned: the
injected clock drives every window, and both schedulers' ``time.time()``
(the snapshot's ``published_at``, the ETag's millisecond stamp) reads it
too; ``zipfile``'s clock is pinned where record bytes are compared
(``np.savez`` stamps zip entries with the wall clock). Lineage and trace
timestamps are compared by presence, monotonicity and hop order, never by
value. Every listener binds ``127.0.0.1:0``.
"""

from __future__ import annotations

import asyncio
import contextlib
import gzip
import importlib
import json
import time
import types
import zipfile

import numpy as np
import pytest

from .fakes.federation import (
    ORIGIN,
    FleetInventory,
    MultiClusterFleet,
    WindowedHistory,
    stores_bitexact_by_key,
)

TICK = 300.0
START = ORIGIN + 3600.0


# ------------------------------------------------------------------ packages
class Side:
    """One package's federation entry points, by module name."""

    def __init__(self, package: str) -> None:
        def module(name: str):
            return importlib.import_module(f"{package}.{name}")

        self.package = package
        self.is_port = package == "krr_tpu_torch"
        self.Config = module("core.config").Config
        self.ScanSession = module("core.runner").ScanSession
        self.app = module("server.app")
        self.scheduler = module("server.scheduler")
        self.streaming = module("core.streaming")
        self.durastore = module("core.durastore")
        self.protocol = module("federation.protocol")
        self.ring = module("federation.ring")
        self.shard = module("federation.shard")
        self.replica = module("federation.replica")
        self.metrics = module("obs.metrics")
        self.trace = module("obs.trace")
        self.sentinel = module("obs.sentinel")
        self.objects = module("models.objects")
        self.allocations = module("models.allocations")

    def __repr__(self) -> str:
        return self.package

    # The port's strategy computes on the CPU here (no card): the same
    # plain versions its kernels are held to.
    def config(self, **overrides):
        other_args = {"history_duration": 1, "timeframe_duration": 1}
        other_args.update(overrides.pop("other_args", {}))
        defaults = dict(
            strategy="tdigest",
            quiet=True,
            server_port=0,
            scan_interval_seconds=TICK,
            hysteresis_enabled=False,
            other_args=other_args,
        )
        if self.is_port:
            defaults["device"] = "cpu"
        defaults.update(overrides)
        return self.Config(**defaults)

    def convert(self, obj):
        """A JAX fake's object as this package's model."""
        if not self.is_port:
            return obj
        return self.objects.K8sObjectData(**obj.model_dump(mode="json"))

    def inventory(self, fleet, clusters=None, namespaces=None):
        return _Inventory(self, fleet, clusters, namespaces)

    def history_factory(self, fleet):
        return lambda cluster: _History(self, fleet, cluster)

    def object_key(self, obj) -> str:
        return self.streaming.object_key(obj)

    def spec(self):
        return self.config().create_strategy().settings.cpu_spec()


class _Inventory(FleetInventory):
    """``FleetInventory`` in a package's model, optionally one namespace set
    of one cluster (the ``shard -n`` topology)."""

    def __init__(self, side: Side, fleet, clusters, namespaces) -> None:
        super().__init__(fleet, clusters=clusters)
        self.side = side
        self.namespaces = set(namespaces) if namespaces is not None else None

    async def list_scannable_objects(self, clusters):
        objects = await super().list_scannable_objects(clusters)
        if self.namespaces is not None:
            objects = [obj for obj in objects if obj.namespace in self.namespaces]
        return [self.side.convert(obj) for obj in objects]


class _History(WindowedHistory):
    """``WindowedHistory`` whose result is keyed by the package's
    ``ResourceType`` (the series are the fleet's, sliced alike)."""

    def __init__(self, side: Side, fleet, cluster) -> None:
        super().__init__(fleet, cluster)
        self.side = side

    async def gather_fleet(self, objects, history_seconds, step_seconds, end_time=None):
        out = await super().gather_fleet(objects, history_seconds, step_seconds, end_time)
        resource = self.side.allocations.ResourceType
        return {resource(key.value): value for key, value in out.items()}


JAX = Side("krr_tpu")
PORT = Side("krr_tpu_torch")


@pytest.fixture(autouse=True)
def pinned_clocks(monkeypatch):
    """The injected clock (the returned one-element list), which both
    schedulers' ``time.time()`` reads too, so snapshots' ``published_at`` —
    and with it the ETags — compare exactly; ``zipfile`` stamps a fixed
    time."""
    now = [START]
    for side in (JAX, PORT):
        monkeypatch.setattr(side.scheduler, "time", types.SimpleNamespace(
            time=lambda: now[0], perf_counter=time.perf_counter, monotonic=time.monotonic,
        ))
    monkeypatch.setattr(zipfile, "time", types.SimpleNamespace(
        time=lambda: 1_700_000_000.0, localtime=time.localtime,
    ))
    return now


# ------------------------------------------------------------------ harness
def control_server(side: Side, fleet, clock, **overrides):
    config = side.config(**overrides)
    session = side.ScanSession(
        config,
        inventory=side.inventory(fleet),
        history_factory=side.history_factory(fleet),
        logger=config.create_logger(),
    )
    return side.app.KrrServer(config, session=session, clock=clock)


def aggregator_server(side: Side, fleet, clock, listen: str = "127.0.0.1:0", **overrides):
    config = side.config(federation_listen=listen, **overrides)
    session = side.ScanSession(
        config,
        inventory=side.inventory(fleet, clusters=[]),
        history_factory=side.history_factory(fleet),
        logger=config.create_logger(),
    )
    return side.app.KrrServer(config, session=session, clock=clock)


def make_shard(side: Side, fleet, cluster: str, port: int, clock, **overrides):
    config = side.config(
        clusters=[cluster], federation_aggregator=f"127.0.0.1:{port}", **overrides
    )
    session = side.ScanSession(
        config,
        inventory=side.inventory(fleet, clusters=[cluster]),
        history_factory=side.history_factory(fleet),
        logger=config.create_logger(),
    )
    return side.shard.FederatedShard(config, session=session, clock=clock, shard_id=cluster)


def make_namespace_shard(side: Side, fleet, cluster: str, namespace: str, port: int, clock):
    config = side.config(
        clusters=[cluster], namespaces=[namespace],
        federation_aggregator=f"127.0.0.1:{port}",
    )
    session = side.ScanSession(
        config,
        inventory=side.inventory(fleet, clusters=[cluster], namespaces=[namespace]),
        history_factory=side.history_factory(fleet),
        logger=config.create_logger(),
    )
    return side.shard.FederatedShard(config, session=session, clock=clock, shard_id=namespace)


def make_ring_shard(side: Side, fleet, cluster: str, ring_spec: str, clock, **overrides):
    config = side.config(clusters=[cluster], federation_ring=ring_spec, **overrides)
    session = side.ScanSession(
        config,
        inventory=side.inventory(fleet, clusters=[cluster]),
        history_factory=side.history_factory(fleet),
        logger=config.create_logger(),
    )
    return side.shard.FederatedShard(config, session=session, clock=clock, shard_id=cluster)


async def wait_for(predicate, timeout: float = 10.0, message: str = "condition"):
    deadline = time.monotonic() + timeout
    while not predicate():
        assert time.monotonic() < deadline, f"timed out waiting for {message}"
        await asyncio.sleep(0.01)


async def federated_round(server, shards, now: float) -> None:
    """Every shard ticks, the aggregator enqueues every record, one
    aggregate tick applies and publishes, the acks flow back."""
    for shard in shards:
        await shard.tick(now)
    agg = server.aggregator
    await wait_for(
        lambda: all(
            shard.shard_id in agg._shards and agg._shards[shard.shard_id].enqueued >= shard.epoch
            for shard in shards
        ),
        message="aggregator to enqueue every shard's tick",
    )
    await server.scheduler.run_once()
    for shard in shards:
        assert await shard.wait_acked(shard.epoch, timeout=5.0), (
            f"shard {shard.shard_id} never got its ack past epoch {shard.acked}"
        )


async def ring_round(servers_by_port, shards, now: float) -> None:
    """One round across a partitioned aggregation plane."""
    for shard in shards:
        await shard.tick(now)

    def all_enqueued():
        for shard in shards:
            for uplink in shard._uplinks:
                status = servers_by_port[uplink.port].aggregator._shards.get(uplink.stream_id)
                if status is None or status.enqueued < shard.epoch:
                    return False
        return True

    await wait_for(all_enqueued, message="every aggregator to enqueue every stream")
    for server in servers_by_port.values():
        await server.scheduler.run_once()
    for shard in shards:
        assert await shard.wait_acked(shard.epoch, timeout=5.0)


_CONTROLS: dict = {}


async def control_store(side: Side, fleet_args: dict, ticks: int, clock: list):
    """The single-process control's store after ``ticks`` ticks (cached per
    package, fleet and tick count: the store is read, never written)."""
    key = (side.package, tuple(sorted(fleet_args.items())), ticks)
    if key not in _CONTROLS:
        fleet = MultiClusterFleet(**fleet_args)
        server = control_server(side, fleet, lambda: clock[0])
        try:
            for t in range(ticks):
                clock[0] = START + t * TICK
                assert await server.scheduler.run_once()
        finally:
            await server.shutdown()
        _CONTROLS[key] = server.state.store
    return _CONTROLS[key]


async def run_federated(side_agg: Side, side_shards: Side, fleet, ticks: int, clock: list, **agg_overrides):
    """``side_shards`` shards (one per cluster) into a ``side_agg``
    aggregator over ``ticks`` rounds; returns the started server and the
    shards (the caller closes them)."""
    clock[0] = START
    server = aggregator_server(side_agg, fleet, lambda: clock[0], **agg_overrides)
    await server.start(run_scheduler=False)
    shards = [
        make_shard(side_shards, fleet, c, server.aggregator.port, lambda: clock[0])
        for c in fleet.clusters
    ]
    for t in range(ticks):
        clock[0] = START + t * TICK
        await federated_round(server, shards, clock[0])
    return server, shards


async def close_all(server, shards) -> None:
    for shard in shards:
        with contextlib.suppress(Exception):
            await shard.close()
    await server.shutdown()


async def raw_get(port: int, path: str, headers: "dict | None" = None):
    """Exact-bytes HTTP GET (no client-side decompression)."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    request = f"GET {path} HTTP/1.1\r\nHost: x\r\nConnection: close\r\n"
    for name, value in (headers or {}).items():
        request += f"{name}: {value}\r\n"
    writer.write((request + "\r\n").encode())
    await writer.drain()
    data = await reader.read()
    writer.close()
    head, _, body = data.partition(b"\r\n\r\n")
    lines = head.split(b"\r\n")
    hdrs = {}
    for line in lines[1:]:
        name, _, value = line.decode("latin-1").partition(":")
        hdrs[name.strip().lower()] = value.strip()
    return int(lines[0].split()[1]), hdrs, body


async def dead_port() -> int:
    probe = await asyncio.start_server(lambda r, w: None, "127.0.0.1", 0)
    port = probe.sockets[0].getsockname()[1]
    probe.close()
    await probe.wait_closed()
    return port


#: Response headers that must agree byte for byte between two servers.
VALIDATORS = ("etag", "x-krr-epoch", "last-modified", "content-type", "content-encoding", "content-length")


# ------------------------------------------------------------------ protocol
class TestProtocolFraming:
    def _blob(self, side: Side, n: int = 5):
        p = side.protocol
        messages, blob = [], b""
        for i in range(n):
            body = json.dumps({"i": i, "pad": "x" * (17 * (i + 1))}).encode()
            kind = [p.MSG_HELLO, p.MSG_DELTA, p.MSG_ACK, p.MSG_INVENTORY, p.MSG_WELCOME][i % 5]
            messages.append((kind, body))
            blob += p.encode_message(kind, body)
        return blob, messages

    def test_wire_bytes_equal_jax(self):
        """Frames, control messages and inventories: the port's bytes are
        the JAX package's, and each package decodes the other's."""
        blob_j, messages = self._blob(JAX)
        blob_p, messages_p = self._blob(PORT)
        assert blob_p == blob_j and messages_p == messages
        assert (JAX.protocol.FED_MAGIC, JAX.protocol.PROTOCOL_VERSION, JAX.protocol.FRAME_OVERHEAD) == (
            PORT.protocol.FED_MAGIC, PORT.protocol.PROTOCOL_VERSION, PORT.protocol.FRAME_OVERHEAD)
        controls = [
            ("MSG_HELLO", dict(shard_id="c0", generation="abc", version=1,
                               spec={"gamma": 1.01, "min_value": 1e-4, "num_buckets": 2560},
                               clusters=["c0"])),
            ("MSG_WELCOME", dict(acked_epoch=7, generation=None, version=1)),
            ("MSG_WELCOME", dict(error="spec mismatch")),
            ("MSG_ACK", dict(epoch=12)),
            ("MSG_ACK", dict(epoch=3, install_ts=1_700_000_123.25)),
        ]
        for kind, fields in controls:
            jb = JAX.protocol.encode_control(getattr(JAX.protocol, kind), **fields)
            pb = PORT.protocol.encode_control(getattr(PORT.protocol, kind), **fields)
            assert pb == jb, kind
            assert PORT.protocol.decode_control(jb[PORT.protocol.FRAME_OVERHEAD:]) == fields
        fleet = MultiClusterFleet(clusters=2, seed=9)
        objects = fleet.all_objects()
        jb = JAX.protocol.encode_inventory(objects)
        pb = PORT.protocol.encode_inventory([PORT.convert(o) for o in objects])
        assert pb == jb
        decoded = PORT.protocol.decode_inventory(jb)
        assert [PORT.object_key(o) for o in decoded] == [JAX.object_key(o) for o in objects]
        assert [o.model_dump(mode="json") for o in decoded] == [o.model_dump(mode="json") for o in objects]

    def test_epoch_feed_decodes_across_packages(self):
        kwargs = dict(
            epoch=4, changed_at=1_700_000_000.5, window_end=START, published_at=START + 1.0,
            keys=["c0/ns/a/main/Deployment"], body=b'{"scans": []}',
            variants={"gzip": gzip.compress(b'{"scans": []}', mtime=0)},
            extra={"trace": {"trace_id": "t", "span_id": "s", "node": "aggregator"}},
        )
        jb = JAX.protocol.encode_epoch_feed(**kwargs)
        pb = PORT.protocol.encode_epoch_feed(**kwargs)
        assert pb == jb
        assert PORT.protocol.decode_epoch_feed(jb) == JAX.protocol.decode_epoch_feed(pb)

    def test_round_trip(self):
        blob, messages = self._blob(PORT)
        decoded, good = PORT.protocol.scan_messages(blob)
        assert decoded == messages and good == len(blob)

    @staticmethod
    def _boundaries(messages) -> list:
        boundaries, pos = [0], 0
        for _kind, body in messages:
            pos += 8 + 1 + len(body)
            boundaries.append(pos)
        return boundaries

    def test_torn_tail_matrix(self):
        """Every cut offset keeps exactly the whole frames before it, and
        the port's verdict equals the JAX package's."""
        blob, messages = self._blob(PORT)
        boundaries = self._boundaries(messages)
        for cut in range(len(blob) + 1):
            decoded, good = PORT.protocol.scan_messages(blob[:cut])
            whole = max(i for i, b in enumerate(boundaries) if b <= cut)
            assert len(decoded) == whole and good == boundaries[whole], f"cut at {cut}"
            assert decoded == messages[:whole]
            assert (decoded, good) == JAX.protocol.scan_messages(blob[:cut])

    def test_bit_flip_matrix(self):
        blob, messages = self._blob(PORT)
        boundaries = self._boundaries(messages)
        for offset in range(0, len(blob), 7):
            corrupt = bytearray(blob)
            corrupt[offset] ^= 0x40
            decoded, good = PORT.protocol.scan_messages(bytes(corrupt))
            hit = max(i for i, b in enumerate(boundaries) if b <= offset)
            assert len(decoded) <= hit and decoded == messages[: len(decoded)]
            assert good <= boundaries[hit]
            assert (decoded, good) == JAX.protocol.scan_messages(bytes(corrupt))

    def test_stream_reader_clean_eof_and_torn(self):
        async def main():
            blob, messages = self._blob(PORT, 2)
            reader = asyncio.StreamReader()
            reader.feed_data(blob)
            reader.feed_eof()
            got = []
            while (message := await PORT.protocol.read_message(reader)) is not None:
                got.append(message)
            assert got == messages
            reader = asyncio.StreamReader()
            reader.feed_data(blob[: len(blob) - 3])
            reader.feed_eof()
            assert await PORT.protocol.read_message(reader) == messages[0]
            with pytest.raises(PORT.protocol.ProtocolError):
                await PORT.protocol.read_message(reader)

        asyncio.run(main())

    def test_crc_mismatch_raises(self):
        async def main():
            frame = bytearray(PORT.protocol.encode_message(PORT.protocol.MSG_ACK, b'{"epoch": 3}'))
            frame[-1] ^= 0x01
            reader = asyncio.StreamReader()
            reader.feed_data(bytes(frame))
            reader.feed_eof()
            with pytest.raises(PORT.protocol.ProtocolError):
                await PORT.protocol.read_message(reader)

        asyncio.run(main())


class TestDeclarations:
    def test_federation_config_fields_equal_jax(self):
        """Every ``federation_*`` field: the JAX package's name, type,
        default and constraints."""
        def fields(side: Side) -> dict:
            return {
                name: (repr(field.annotation), field.default, repr(field.metadata))
                for name, field in side.Config.model_fields.items() if name.startswith("federation_")
            }

        assert fields(PORT) == fields(JAX)
        assert len(fields(PORT)) == 9

    def test_federation_metric_families_equal_jax(self):
        """The families federation fires are declared as in the JAX package
        (name, kind, help, buckets): the port's registry raises on an
        undeclared name."""
        prefixes = ("krr_tpu_federation_", "krr_tpu_replica_", "krr_tpu_fleet_", "krr_tpu_e2e_freshness")

        def families(side: Side) -> list:
            return [d for d in side.metrics.SERVER_METRICS if d[0].startswith(prefixes)]

        assert families(PORT) == families(JAX)
        assert len(families(PORT)) == 29  # krr_tpu_fleet_objects included


# ----------------------------------------------------------------- hash ring
def _node(side: Side, name: str):
    return side.ring.RingNode(name=name, endpoints=(("127.0.0.1", 1),))


def _ring_keys(n: int = 800) -> list:
    return [f"c{i % 4}/ns-{i % 7}/app-{i}/main/Deployment" for i in range(n)]


def _random_ops(side: Side, spec, keys, seed: int):
    """A capture holding dense folds, CSR folds, grows and drops."""
    rng = np.random.default_rng(seed)
    store = side.streaming.DigestStore(spec=spec)
    store.track_deltas = True
    store.capture_full_keys = True

    def fold(subset):
        counts = rng.integers(0, 4, size=(len(subset), spec.num_buckets)).astype(np.float32)
        store.merge_window(
            subset, counts, counts.sum(axis=1),
            rng.uniform(0.1, 2.0, len(subset)).astype(np.float32),
            rng.uniform(1.0, 8.0, len(subset)).astype(np.float32),
            rng.uniform(64.0, 512.0, len(subset)).astype(np.float32),
        )

    fold(keys[:8])
    store.compact_pending()
    fold(keys)
    extra = [f"cx/ns9/extra-{i}/main/Deployment" for i in range(2)]
    store.rows_for(extra)
    store.compact({*keys[:10], *extra})
    return store.pending_ops()


class TestHashRing:
    def test_owners_equal_jax_for_10000_keys(self):
        keys = [f"c{i % 5}/ns-{i % 13}/app-{i}/c{i % 3}/Deployment" for i in range(10_000)]
        for names in ("ab", "abcd", "xyz"):
            jax_ring = JAX.ring.HashRing([_node(JAX, n) for n in names])
            port_ring = PORT.ring.HashRing([_node(PORT, n) for n in names])
            assert [port_ring.owner(k) for k in keys] == [jax_ring.owner(k) for k in keys]
            assert port_ring.spread(keys) == jax_ring.spread(keys)

    def test_owner_deterministic_and_spread_balanced(self):
        keys = _ring_keys()
        ring = PORT.ring.HashRing([_node(PORT, n) for n in "abcd"])
        reordered = PORT.ring.HashRing([_node(PORT, n) for n in "dcba"])
        assert all(reordered.owner(k) == ring.owner(k) for k in keys)
        spread = ring.spread(keys)
        assert set(spread) == set("abcd") and sum(spread.values()) == len(keys)
        assert all(0 < count < 2 * len(keys) / 4 for count in spread.values()), spread

    def test_join_and_leave_move_only_the_changed_nodes_keys(self):
        keys = _ring_keys()
        before = {k: PORT.ring.HashRing([_node(PORT, n) for n in "abc"]).owner(k) for k in keys}
        joined = PORT.ring.HashRing([_node(PORT, n) for n in "abcd"])
        moved = [k for k in keys if joined.owner(k) != before[k]]
        assert all(joined.owner(k) == "d" for k in moved)
        assert 0 < len(moved) < len(keys) // 2
        left = PORT.ring.HashRing([_node(PORT, n) for n in "ab"])
        assert all(before[k] == "c" for k in keys if left.owner(k) != before[k])

    def test_parse_ring_specs_and_errors(self):
        spec = "a=127.0.0.1:9001, b=10.0.0.2:9002|10.0.0.3:9003"
        nodes = PORT.ring.parse_ring(spec)
        assert [(n.name, n.endpoints) for n in nodes] == [
            (n.name, n.endpoints) for n in JAX.ring.parse_ring(spec)
        ] == [("a", (("127.0.0.1", 9001),)), ("b", (("10.0.0.2", 9002), ("10.0.0.3", 9003)))]
        for bad in ("a=1.2.3.4:1,a=1.2.3.4:2", "just-a-host:9001", "a=", "", "a=nocolon"):
            with pytest.raises(ValueError) as port_error:
                PORT.ring.parse_ring(bad)
            with pytest.raises(ValueError) as jax_error:
                JAX.ring.parse_ring(bad)
            assert str(port_error.value) == str(jax_error.value)

    @pytest.mark.parametrize("side", [PORT, JAX], ids=["port", "jax"])
    def test_partition_ops_union_bitexact_vs_unsplit(self, side):
        """Split by owner → encode → decode → apply per node: the union is
        bit-exact to the unsplit apply, on each package, and the port's
        partition records are the JAX package's bytes."""
        spec = side.spec()
        keys = [f"cx/ns{i % 3}/app-{i}/main/Deployment" for i in range(12)]
        ops = _random_ops(side, spec, keys, 23)
        assert {"fold_csr", "fold", "grow", "drop"} <= {op[0] for op in ops}
        ring = side.ring.HashRing([_node(side, n) for n in "xyz"])
        parts = side.ring.partition_ops(ops, ring.owner)
        assert len(parts) > 1
        d = side.durastore
        whole = side.streaming.DigestStore(spec=spec)
        d.apply_ops(whole, d.decode_ops(d.encode_ops(ops, epoch=1, extra={}, num_buckets=spec.num_buckets))[1])
        merged = {}
        for name, node_ops in parts.items():
            node_store = side.streaming.DigestStore(spec=spec)
            d.apply_ops(node_store, d.decode_ops(
                d.encode_ops(node_ops, epoch=1, extra={}, num_buckets=spec.num_buckets))[1])
            for key in node_store.keys:
                assert key not in merged and ring.owner(key) == name, key
                merged[key] = node_store
        assert sorted(merged) == sorted(whole.keys)
        index = {k: i for i, k in enumerate(whole.keys)}
        for key, node_store in merged.items():
            i = node_store.keys.index(key)
            for attr in ("cpu_counts", "cpu_total", "cpu_peak", "mem_total", "mem_peak"):
                assert np.array_equal(getattr(node_store, attr)[i], getattr(whole, attr)[index[key]]), (key, attr)
        # The other package partitions the same capture into the same bytes.
        other = JAX if side.is_port else PORT
        other_ops = _random_ops(other, other.spec(), keys, 23)
        other_ring = other.ring.HashRing([_node(other, n) for n in "xyz"])
        other_parts = other.ring.partition_ops(other_ops, other_ring.owner)
        assert sorted(other_parts) == sorted(parts)
        for name in parts:
            assert d.encode_ops(parts[name], epoch=2, extra={"k": 1}, num_buckets=spec.num_buckets) == \
                other.durastore.encode_ops(other_parts[name], epoch=2, extra={"k": 1}, num_buckets=spec.num_buckets)


# ---------------------------------------------------------------- acceptance
#: Per-shard fields of the /healthz ``federation`` block that differ run to
#: run in EITHER package: ``generation`` is a random id per shard store,
#: and ``bytes`` counts record payloads whose meta carries the tick's trace
#: context (trace and span ids are drawn from the wall clock and a counter).
SHARD_RUN_FIELDS = ("generation", "bytes")


def _healthz_federation(payload: dict) -> dict:
    """The ``federation`` block of /healthz minus ``SHARD_RUN_FIELDS``."""
    block = json.loads(json.dumps(payload["federation"]))
    for entry in block.get("shards", {}).values():
        for name in SHARD_RUN_FIELDS:
            entry.pop(name)
    return block


class TestFederatedScan:
    """N in-process shards against the single-process control."""

    def test_merged_store_bitexact_vs_control_and_jax(self, pinned_clocks):
        """3 port shards into a port aggregator, 4 ticks: the merged store
        is bit-exact by key to the port's control and to the JAX
        aggregator's store for the same fleet and clock; the recommendation
        query agrees; the served ``/recommendations`` bytes and validators
        equal the JAX aggregator's."""

        async def main():
            now = pinned_clocks
            fleet_args = dict(clusters=3, seed=11)
            control = await control_store(PORT, fleet_args, 4, now)
            jax_control = await control_store(JAX, fleet_args, 4, now)
            served = {}
            stores = {}
            for side in (JAX, PORT):
                fleet = MultiClusterFleet(**fleet_args)
                server, shards = await run_federated(side, side, fleet, 4, now)
                try:
                    stores[side.package] = server.state.store
                    served[side.package] = [
                        await raw_get(server.port, "/recommendations"),
                        await raw_get(server.port, "/recommendations", {"Accept-Encoding": "gzip"}),
                        await raw_get(server.port, "/recommendations?format=yaml"),
                    ]
                    snapshot = server.state.peek()
                    assert len(snapshot.result.scans) == len(fleet.all_objects())
                    metrics = server.state.metrics
                    assert metrics.value("krr_tpu_federation_connected_shards") == 3
                    assert metrics.total("krr_tpu_federation_records_total") >= 12
                    assert metrics.total("krr_tpu_federation_bytes_total") > 0
                    status, _ct, body, _hdrs = await server.app.route("GET", "/healthz", {})
                    payload = json.loads(body)
                    assert status == 200
                    assert sorted(payload["federation"]["shards"]) == ["c0", "c1", "c2"]
                    for entry in payload["federation"]["shards"].values():
                        assert entry["connected"] and not entry["stale"]
                    served[side.package].append(_healthz_federation(payload))
                    served[side.package].append(
                        {name: metrics.value(name) for name in (
                            "krr_tpu_federation_connected_shards", "krr_tpu_federation_shards",
                            "krr_tpu_federation_stale_shards", "krr_tpu_digest_store_rows")}
                        | {"records": metrics.total("krr_tpu_federation_records_total")}
                    )
                finally:
                    await close_all(server, shards)
            port_store = stores["krr_tpu_torch"]
            for other in (control, stores["krr_tpu"], jax_control):
                equal, detail = stores_bitexact_by_key(port_store, other)
                assert equal, detail
            keys = list(port_store.keys)
            cpu_f, mem_f = port_store.query_recommendation(port_store.rows_for(keys), 95.0)
            jax_store = stores["krr_tpu"]
            cpu_j, mem_j = jax_store.query_recommendation(jax_store.rows_for(keys), 95.0)
            np.testing.assert_array_equal(cpu_f, cpu_j)
            np.testing.assert_array_equal(mem_f, mem_j)
            cpu_c, mem_c = control.query_recommendation(control.rows_for(keys), 95.0)
            np.testing.assert_array_equal(cpu_f, cpu_c)
            np.testing.assert_array_equal(mem_f, mem_c)
            for (pj, pp) in zip(served["krr_tpu"][:3], served["krr_tpu_torch"][:3]):
                assert pp[0] == pj[0] == 200
                assert pp[2] == pj[2]
                for name in VALIDATORS:
                    assert pp[1].get(name) == pj[1].get(name), name
            assert served["krr_tpu_torch"][3:] == served["krr_tpu"][3:]

        asyncio.run(main())

    def test_mid_stream_disconnect_reconnect_exactly_once(self, pinned_clocks):
        async def main():
            now = pinned_clocks
            fleet_args = dict(clusters=2, seed=23)
            control = await control_store(PORT, fleet_args, 5, now)
            fleet = MultiClusterFleet(**fleet_args)
            server, shards = await run_federated(PORT, PORT, fleet, 2, now)
            try:
                victim = shards[0]
                now[0] = START + 2 * TICK
                victim._disconnect()

                async def pump_noop():
                    return None

                original_pump = victim._pump
                victim._pump = pump_noop  # swallow this tick's send
                try:
                    await victim.tick(now[0])
                finally:
                    victim._pump = original_pump
                assert len(victim._buffer) == 1 and not victim.connected
                await shards[1].tick(now[0])
                agg = server.aggregator
                await wait_for(lambda: agg._shards["c1"].enqueued >= shards[1].epoch)
                assert await server.scheduler.run_once()
                for t in (3, 4):
                    now[0] = START + t * TICK
                    await federated_round(server, shards, now[0])
                assert agg._shards["c0"].applied == agg._shards["c1"].applied == 5
                equal, detail = stores_bitexact_by_key(server.state.store, control)
                assert equal, detail
            finally:
                await close_all(server, shards)

        asyncio.run(main())

    def test_dead_shard_serves_stale_while_healthy_publish(self, pinned_clocks):
        async def main():
            now = pinned_clocks
            fleet = MultiClusterFleet(clusters=2, seed=31)
            server, shards = await run_federated(
                PORT, PORT, fleet, 2, now, federation_staleness_seconds=TICK + 1.0
            )
            try:
                dead = shards[0]
                dead_keys = {JAX.object_key(obj) for obj in fleet.objects["c0"]}
                dead_window_end = dead.last_end
                await dead.close()
                for t in (2, 3):
                    now[0] = START + t * TICK
                    await federated_round(server, [shards[1]], now[0])
                snapshot = server.state.peek()
                assert len(snapshot.result.scans) == len(fleet.all_objects())
                marks = {
                    PORT.object_key(scan.object): scan.stale_since
                    for scan in snapshot.result.scans
                    if scan.stale_since is not None
                }
                assert set(marks) == dead_keys
                assert all(since == dead_window_end for since in marks.values())
                status, _ct, body, _hdrs = await server.app.route("GET", "/healthz", {})
                fed = json.loads(body)["federation"]["shards"]
                assert fed["c0"]["stale"] and not fed["c0"]["connected"]
                assert fed["c1"]["connected"] and not fed["c1"]["stale"]
                metrics = server.state.metrics
                assert metrics.value("krr_tpu_federation_stale_shards") == 1
                assert metrics.value("krr_tpu_stale_workloads") == len(dead_keys)
            finally:
                await close_all(server, shards)

        asyncio.run(main())

    def test_aggregator_restart_resumes_epoch_watermarks(self, tmp_path, pinned_clocks):
        async def main():
            now = pinned_clocks
            fleet_args = dict(clusters=2, seed=43)
            control = await control_store(PORT, fleet_args, 4, now)
            fleet = MultiClusterFleet(**fleet_args)
            durable = {"other_args": {"history_duration": 1, "timeframe_duration": 1,
                                      "state_path": str(tmp_path / "state")}}
            server, shards = await run_federated(PORT, PORT, fleet, 2, now, **durable)
            try:
                assert all(shard.acked == 2 for shard in shards)
                await server.shutdown()
                server = aggregator_server(PORT, fleet, lambda: now[0], **durable)
                await server.start(run_scheduler=False)
                restored = server.aggregator._shards
                assert restored["c0"].acked == 2 and restored["c1"].acked == 2
                for shard in shards:
                    shard.host, shard.port = "127.0.0.1", server.aggregator.port
                for t in (2, 3):
                    now[0] = START + t * TICK
                    await federated_round(server, shards, now[0])
                equal, detail = stores_bitexact_by_key(server.state.store, control)
                assert equal, detail
            finally:
                await close_all(server, shards)

        asyncio.run(main())


class TestCrossPackageWire:
    """The two packages hold each other to account on the wire: JAX shards
    feed a port aggregator and port shards feed a JAX aggregator, through
    the full window and the deltas; each merged store is bit-exact to the
    single-process control, and the served bytes equal the same-package
    federation's."""

    @pytest.mark.parametrize(
        "agg_side,shard_side", [(PORT, JAX), (JAX, PORT)], ids=["jax_shards_port_aggregator", "port_shards_jax_aggregator"]
    )
    def test_cross_package_federation_bitexact(self, agg_side, shard_side, pinned_clocks):
        async def main():
            now = pinned_clocks
            fleet_args = dict(clusters=3, seed=11)
            control = await control_store(agg_side, fleet_args, 4, now)
            fleet = MultiClusterFleet(**fleet_args)
            server, shards = await run_federated(agg_side, shard_side, fleet, 4, now)
            try:
                assert all(shard.acked == 4 for shard in shards)
                equal, detail = stores_bitexact_by_key(server.state.store, control)
                assert equal, detail
                cross = await raw_get(server.port, "/recommendations")
            finally:
                await close_all(server, shards)
            server, shards = await run_federated(agg_side, agg_side, MultiClusterFleet(**fleet_args), 4, now)
            try:
                same = await raw_get(server.port, "/recommendations")
            finally:
                await close_all(server, shards)
            assert cross[2] == same[2]
            assert cross[1]["etag"] == same[1]["etag"]

        asyncio.run(main())


# -------------------------------------------------------- raw-wire exactly-once
def _delta_records(side: Side, keys: list, n: int):
    spec = side.spec()
    store = side.streaming.DigestStore(spec=spec)
    store.track_deltas = True
    store.capture_full_keys = True
    rng = np.random.default_rng(5)
    records = []
    for epoch in range(1, n + 1):
        counts = rng.integers(0, 4, size=(len(keys), spec.num_buckets)).astype(np.float32)
        store.merge_window(
            keys, counts, counts.sum(axis=1),
            rng.uniform(0.1, 2.0, len(keys)).astype(np.float32),
            rng.uniform(1.0, 8.0, len(keys)).astype(np.float32),
            rng.uniform(64.0, 512.0, len(keys)).astype(np.float32),
        )
        ops = store.pending_ops()
        extra = {"window_end": START + epoch * TICK, "kind": "delta"}
        records.append(side.durastore.encode_ops(ops, epoch=epoch, extra=extra, num_buckets=spec.num_buckets))
        store.clear_pending(len(ops))
    return records, store


def _hello(side: Side, shard_id: str, generation: str, **spec_override) -> bytes:
    spec = side.spec()
    fields = {"gamma": spec.gamma, "min_value": spec.min_value, "num_buckets": spec.num_buckets}
    fields.update(spec_override)
    p = PORT.protocol
    return p.FED_MAGIC + p.encode_control(
        p.MSG_HELLO, shard_id=shard_id, generation=generation,
        version=p.PROTOCOL_VERSION, spec=fields, clusters=["cx"],
    )


class TestRawWireExactlyOnce:
    @pytest.mark.parametrize("encoder", [PORT, JAX], ids=["port_records", "jax_records"])
    def test_torn_record_resend_duplicates_discarded(self, encoder, pinned_clocks):
        """A torn second record, a reconnect at the acked epoch, a re-sent
        duplicate: applied exactly once, the merged rows bit-exact to the
        sender's store — with records encoded by either package."""

        async def main():
            p = PORT.protocol
            server = aggregator_server(PORT, MultiClusterFleet(clusters=1, seed=3), lambda: START)
            await server.start(run_scheduler=False)
            keys = ["cx/ns/app/main/Deployment", "cx/ns/db/main/StatefulSet"]
            records, expected = _delta_records(encoder, keys, 3)
            try:
                port = server.aggregator.port
                reader, writer = await asyncio.open_connection("127.0.0.1", port)
                writer.write(_hello(PORT, "raw", "gen-1"))
                await writer.drain()
                kind, body = await p.read_message(reader)
                assert kind == p.MSG_WELCOME
                assert p.decode_control(body) == {
                    "acked_epoch": 0, "generation": None, "version": p.PROTOCOL_VERSION,
                }
                frame2 = p.encode_message(p.MSG_DELTA, records[1])
                writer.write(p.encode_message(p.MSG_DELTA, records[0]) + frame2[: len(frame2) // 2])
                await writer.drain()
                writer.close()
                agg = server.aggregator
                await wait_for(
                    lambda: agg._shards.get("raw") is not None
                    and agg._shards["raw"].enqueued == 1 and not agg._shards["raw"].connected,
                    message="torn connection to drop with record 1 enqueued",
                )
                await server.scheduler.run_once()
                assert agg._shards["raw"].applied == 1
                reader, writer = await asyncio.open_connection("127.0.0.1", port)
                writer.write(_hello(PORT, "raw", "gen-1"))
                await writer.drain()
                _kind, body = await p.read_message(reader)
                welcome = p.decode_control(body)
                assert welcome["acked_epoch"] == 1 and welcome["generation"] == "gen-1"
                for payload in records:
                    writer.write(p.encode_message(p.MSG_DELTA, payload))
                await writer.drain()
                await wait_for(lambda: agg._shards["raw"].enqueued == 3, message="records 2 and 3")
                assert agg._shards["raw"].duplicates == 1
                assert server.state.metrics.value(
                    "krr_tpu_federation_duplicate_records_total", shard="raw"
                ) == 1.0
                await server.scheduler.run_once()
                equal, detail = stores_bitexact_by_key(server.state.store, expected)
                assert equal, detail
                kind, body = await p.read_message(reader)
                assert kind == p.MSG_ACK and p.decode_control(body)["epoch"] >= 1
                writer.close()
            finally:
                await server.shutdown()

        asyncio.run(main())

    def test_epoch_gap_drops_connection(self):
        async def main():
            p = PORT.protocol
            server = aggregator_server(PORT, MultiClusterFleet(clusters=1, seed=3), lambda: START)
            await server.start(run_scheduler=False)
            records, _ = _delta_records(PORT, ["cx/ns/a/m/Deployment"], 3)
            try:
                reader, writer = await asyncio.open_connection("127.0.0.1", server.aggregator.port)
                writer.write(_hello(PORT, "gappy", "g"))
                await writer.drain()
                assert (await p.read_message(reader))[0] == p.MSG_WELCOME
                writer.write(p.encode_message(p.MSG_DELTA, records[0]))
                writer.write(p.encode_message(p.MSG_DELTA, records[2]))
                await writer.drain()
                agg = server.aggregator
                await wait_for(
                    lambda: "gappy" in agg._shards and not agg._shards["gappy"].connected,
                    message="gap to drop the connection",
                )
                assert agg._shards["gappy"].enqueued == 1
            finally:
                await server.shutdown()

        asyncio.run(main())

    def test_spec_mismatch_refused_with_the_jax_error(self):
        async def main():
            errors = {}
            for side in (JAX, PORT):
                server = aggregator_server(side, MultiClusterFleet(clusters=1, seed=3), lambda: START)
                await server.start(run_scheduler=False)
                try:
                    reader, writer = await asyncio.open_connection("127.0.0.1", server.aggregator.port)
                    writer.write(_hello(side, "alien", "g", gamma=2.0, min_value=1.0, num_buckets=4))
                    await writer.drain()
                    kind, body = await PORT.protocol.read_message(reader)
                    assert kind == PORT.protocol.MSG_WELCOME
                    errors[side.package] = PORT.protocol.decode_control(body)
                    writer.close()
                finally:
                    await server.shutdown()
            assert "spec" in errors["krr_tpu_torch"]["error"]
            assert errors["krr_tpu_torch"] == errors["krr_tpu"]

        asyncio.run(main())


# ------------------------------------------------------------- shard details
class TestShardBehavior:
    def test_inventory_round_trips_through_protocol(self):
        fleet = MultiClusterFleet(clusters=1, seed=9)
        objects = [PORT.convert(o) for o in fleet.all_objects()]
        decoded = PORT.protocol.decode_inventory(PORT.protocol.encode_inventory(objects))
        assert [PORT.object_key(o) for o in decoded] == [PORT.object_key(o) for o in objects]
        assert decoded[0].pods == objects[0].pods
        assert decoded[0].allocations.requests == objects[0].allocations.requests

    def test_shard_buffers_while_aggregator_down(self, pinned_clocks):
        async def main():
            now = pinned_clocks
            fleet_args = dict(clusters=1, seed=17)
            control = await control_store(PORT, fleet_args, 3, now)
            fleet = MultiClusterFleet(**fleet_args)
            shard = make_shard(PORT, fleet, "c0", await dead_port(), lambda: now[0])
            for t in range(3):
                now[0] = START + t * TICK
                assert await shard.tick(now[0])
            assert len(shard._buffer) == 3 and not shard.connected
            server = aggregator_server(PORT, fleet, lambda: now[0])
            await server.start(run_scheduler=False)
            try:
                shard.host, shard.port = "127.0.0.1", server.aggregator.port
                await shard._pump()
                agg = server.aggregator
                await wait_for(lambda: "c0" in agg._shards and agg._shards["c0"].enqueued >= shard.epoch)
                await server.scheduler.run_once()
                assert await shard.wait_acked(shard.epoch, timeout=5.0)
                equal, detail = stores_bitexact_by_key(server.state.store, control)
                assert equal, detail
            finally:
                await close_all(server, [shard])

        asyncio.run(main())

    def test_backlog_collapses_to_snapshot_past_the_buffer_cap(self, pinned_clocks):
        async def main():
            now = pinned_clocks
            fleet_args = dict(clusters=1, seed=71)
            ticks = 6
            control = await control_store(PORT, fleet_args, ticks, now)
            fleet = MultiClusterFleet(**fleet_args)
            shard = make_shard(PORT, fleet, "c0", await dead_port(), lambda: now[0],
                               federation_queue_records=2)
            assert shard.buffer_cap == 2
            for t in range(ticks):
                now[0] = START + t * TICK
                assert await shard.tick(now[0])
            assert len(shard._buffer) <= shard.buffer_cap < ticks
            server = aggregator_server(PORT, fleet, lambda: now[0])
            await server.start(run_scheduler=False)
            try:
                shard.host, shard.port = "127.0.0.1", server.aggregator.port
                await shard._pump()
                agg = server.aggregator
                await wait_for(lambda: "c0" in agg._shards and agg._shards["c0"].enqueued >= shard.epoch)
                await server.scheduler.run_once()
                assert await shard.wait_acked(shard.epoch, timeout=5.0)
                equal, detail = stores_bitexact_by_key(server.state.store, control)
                assert equal, detail
            finally:
                await close_all(server, [shard])

        asyncio.run(main())

    def test_shard_status_server_serves_health_and_metrics(self, pinned_clocks):
        async def main():
            now = pinned_clocks
            fleet = MultiClusterFleet(clusters=1, seed=73)
            server = aggregator_server(PORT, fleet, lambda: now[0])
            await server.start(run_scheduler=False)
            shard = make_shard(PORT, fleet, "c0", server.aggregator.port, lambda: now[0])
            status_server = PORT.shard.ShardStatusServer(shard)
            await status_server.serve("127.0.0.1", 0)
            try:
                await federated_round(server, [shard], now[0])
                status, _h, body = await raw_get(status_server.port, "/healthz")
                payload = json.loads(body)
                assert status == 200
                assert payload["status"] == "ok" and payload["connected"]
                assert payload["epoch"] == 1 and payload["acked_epoch"] == 1
                status, _h, body = await raw_get(status_server.port, "/metrics")
                text = body.decode()
                assert status == 200
                assert "krr_tpu_federation_unacked_records 0" in text
                assert 'krr_tpu_scans_total{kind="shard"} 1' in text
                assert 'backend="cpu"' in text  # the shard's strategy device
                status, _h, _body = await raw_get(status_server.port, "/nope")
                assert status == 404
            finally:
                await status_server.close()
                await close_all(server, [shard])

        asyncio.run(main())

    def test_failed_fetch_aborts_tick_and_refetches(self, pinned_clocks):
        async def main():
            now = pinned_clocks
            fleet_args = dict(clusters=1, seed=29)
            control = await control_store(PORT, fleet_args, 3, now)
            fleet = MultiClusterFleet(**fleet_args)
            server, shards = await run_federated(PORT, PORT, fleet, 1, now)
            shard = shards[0]
            try:
                source = shard.session.get_history_source("c0")
                original = source.gather_fleet

                async def boom(*args, **kwargs):
                    raise RuntimeError("injected fetch failure")

                source.gather_fleet = boom
                now[0] = START + TICK
                assert await shard.run_once(now[0]) is None
                assert shard.epoch == 1
                source.gather_fleet = original
                now[0] = START + 2 * TICK
                await federated_round(server, [shard], now[0])
                equal, detail = stores_bitexact_by_key(server.state.store, control)
                assert equal, detail
            finally:
                await close_all(server, shards)

        asyncio.run(main())


class TestResetScope:
    def test_namespace_partition_reset_spares_sibling_rows(self, pinned_clocks):
        """Two shards split one cluster by namespace; restarting one (a new
        generation, a snapshot reset) drops only ITS rows: the sibling's
        rows stay bit-exact to the control, the restarted one's to its own
        store."""

        async def main():
            now = pinned_clocks
            fleet_args = dict(clusters=1, namespaces_per_cluster=2, seed=61)
            control = await control_store(PORT, fleet_args, 4, now)
            fleet = MultiClusterFleet(**fleet_args)
            ns_a, ns_b = "c0-ns0", "c0-ns1"
            server = aggregator_server(PORT, fleet, lambda: now[0])
            await server.start(run_scheduler=False)
            port = server.aggregator.port
            shard_a = make_namespace_shard(PORT, fleet, "c0", ns_a, port, lambda: now[0])
            shard_b = make_namespace_shard(PORT, fleet, "c0", ns_b, port, lambda: now[0])
            shards = [shard_a, shard_b]
            try:
                for t in range(2):
                    now[0] = START + t * TICK
                    await federated_round(server, shards, now[0])
                await shard_a.close()
                restarted = make_namespace_shard(PORT, fleet, "c0", ns_a, port, lambda: now[0])
                shards = [restarted, shard_b]
                for t in (2, 3):
                    now[0] = START + t * TICK
                    await federated_round(server, shards, now[0])
                store = server.state.store
                for namespace, truth in ((ns_b, control), (ns_a, restarted.store)):
                    index = {key: i for i, key in enumerate(truth.keys)}
                    rows = [(i, key) for i, key in enumerate(store.keys) if f"/{namespace}/" in key]
                    assert rows
                    for i, key in rows:
                        j = index[key]
                        assert np.array_equal(store.cpu_counts[i], truth.cpu_counts[j]), key
                        assert store.cpu_total[i] == truth.cpu_total[j], key
            finally:
                await close_all(server, shards)

        asyncio.run(main())


class TestInventoryPersistence:
    def test_dead_shard_rows_render_after_aggregator_restart(self, tmp_path, pinned_clocks):
        async def main():
            now = pinned_clocks
            fleet = MultiClusterFleet(clusters=2, seed=67)
            durable = dict(
                federation_staleness_seconds=TICK + 1.0,
                other_args={"history_duration": 1, "timeframe_duration": 1,
                            "state_path": str(tmp_path / "state")},
            )
            server, shards = await run_federated(PORT, PORT, fleet, 2, now, **durable)
            dead = shards[0]
            try:
                dead_keys = {JAX.object_key(obj) for obj in fleet.objects["c0"]}
                dead_window_end = dead.last_end
                await dead.close()
                await server.shutdown()
                assert (tmp_path / "state" / "federation-inventory.json").exists()
                server = aggregator_server(PORT, fleet, lambda: now[0], **durable)
                await server.start(run_scheduler=False)
                shards[1].host, shards[1].port = "127.0.0.1", server.aggregator.port
                for t in (2, 3):
                    now[0] = START + t * TICK
                    await federated_round(server, [shards[1]], now[0])
                snapshot = server.state.peek()
                assert len(snapshot.result.scans) == len(fleet.all_objects())
                marks = {
                    PORT.object_key(scan.object): scan.stale_since
                    for scan in snapshot.result.scans
                    if scan.stale_since is not None
                }
                assert set(marks) == dead_keys
                assert all(since == dead_window_end for since in marks.values())
            finally:
                await close_all(server, shards)

        asyncio.run(main())


class TestFederationObservability:
    def test_aggregate_tick_lands_on_timeline(self, pinned_clocks):
        """The timeline's newest record is the aggregate tick, its
        ``federation`` block equal to the JAX aggregator's but for the wire
        bytes (the records' meta carries trace ids, ``SHARD_RUN_FIELDS``)."""

        async def main():
            now = pinned_clocks
            blocks = {}
            for side in (JAX, PORT):
                server, shards = await run_federated(side, side, MultiClusterFleet(clusters=2, seed=37), 2, now)
                try:
                    records = server.state.timeline.records()
                    assert records and records[-1]["kind"] == "aggregate"
                    fed = dict(records[-1]["federation"])
                    assert fed["shards"] == 2 and fed["connected"] == 2
                    assert fed["applied_records"] == 2 and fed["wire_bytes"] > 0
                    fed.pop("wire_bytes")
                    fed.pop("apply_seconds", None)
                    blocks[side.package] = fed
                finally:
                    await close_all(server, shards)
            assert blocks["krr_tpu_torch"] == blocks["krr_tpu"]

        asyncio.run(main())


# -------------------------------------------------- ring-partitioned plane
def _scans_by_key(state) -> dict:
    body = json.loads(state.peek().body_json.decode())
    return {
        "{cluster}/{namespace}/{name}/{container}/{kind}".format(**scan["object"]): scan
        for scan in body["scans"]
    }


class TestRingFederation:
    @pytest.mark.parametrize("n_nodes", [2, 3])
    def test_partitioned_plane_merged_view_bitexact(self, n_nodes, pinned_clocks):
        async def main():
            now = pinned_clocks
            fleet_args = dict(clusters=2, seed=101 + n_nodes)
            control = await control_store(PORT, fleet_args, 3, now)
            fleet = MultiClusterFleet(**fleet_args)
            now[0] = START
            servers, by_port, shards = {}, {}, []
            try:
                for i in range(n_nodes):
                    server = aggregator_server(PORT, fleet, lambda: now[0])
                    await server.start(run_scheduler=False)
                    servers[f"a{i}"] = server
                    by_port[server.aggregator.port] = server
                ring_spec = ",".join(f"{n}=127.0.0.1:{s.aggregator.port}" for n, s in servers.items())
                shards = [make_ring_shard(PORT, fleet, c, ring_spec, lambda: now[0]) for c in fleet.clusters]
                for t in range(3):
                    now[0] = START + t * TICK
                    await ring_round(by_port, shards, now[0])
                ring = JAX.ring.HashRing(JAX.ring.parse_ring(ring_spec))
                control_index = {k: i for i, k in enumerate(control.keys)}
                merged = []
                for name, server in servers.items():
                    store = server.state.store
                    for i, key in enumerate(store.keys):
                        assert ring.owner(key) == name, (key, name)  # the JAX ring's owner
                        merged.append(key)
                        j = control_index[key]
                        for attr in ("cpu_counts", "cpu_total", "cpu_peak", "mem_total", "mem_peak"):
                            assert np.array_equal(getattr(store, attr)[i], getattr(control, attr)[j]), (key, attr)
                assert sorted(merged) == sorted(control.keys)
                served = {}
                for server in servers.values():
                    for key, scan in _scans_by_key(server.state).items():
                        assert key not in served
                        served[key] = scan
                assert sorted(served) == sorted(control.keys)
                status = shards[0].status()
                assert status["ring"] == {"nodes": sorted(servers)}
                assert len(status["aggregators"]) == n_nodes
                for entry in status["aggregators"]:
                    assert entry["connected"] is True and entry["epoch_lag"] == 0
                    assert entry["acked_epoch"] == shards[0].epoch
                    assert int(entry["endpoint"].rsplit(":", 1)[1]) in by_port
            finally:
                for shard in shards:
                    await shard.close()
                for server in servers.values():
                    await server.shutdown()

        asyncio.run(main())


class TestAggregatorFailover:
    def test_standby_takes_over_with_zero_lost_epochs(self, pinned_clocks):
        async def main():
            now = pinned_clocks
            fleet_args = dict(clusters=1, seed=83)
            ticks = 5
            control = await control_store(PORT, fleet_args, ticks, now)
            fleet = MultiClusterFleet(**fleet_args)
            now[0] = START
            primary = aggregator_server(PORT, fleet, lambda: now[0])
            standby = aggregator_server(PORT, fleet, lambda: now[0])
            await primary.start(run_scheduler=False)
            await standby.start(run_scheduler=False)
            p_port, s_port = primary.aggregator.port, standby.aggregator.port
            shard = make_ring_shard(PORT, fleet, "c0", f"a=127.0.0.1:{p_port}|127.0.0.1:{s_port}", lambda: now[0])
            by_port = {p_port: primary, s_port: standby}
            stream = "c0/a"
            try:
                for t in range(2):
                    now[0] = START + t * TICK
                    await ring_round(by_port, [shard], now[0])
                equal, detail = stores_bitexact_by_key(primary.state.store, standby.state.store)
                assert equal, detail
                standby_uplink = shard._node_uplinks["a"][1]
                assert standby_uplink.port == s_port
                now[0] = START + 2 * TICK
                await shard.tick(now[0])
                agg_s = standby.aggregator
                await wait_for(lambda: agg_s._shards[stream].enqueued == 3)
                standby_uplink._disconnect()
                await shard._pump()
                await wait_for(lambda: agg_s._shards[stream].duplicates >= 1)
                await wait_for(lambda: primary.aggregator._shards[stream].enqueued == 3)
                await primary.scheduler.run_once()
                await standby.scheduler.run_once()
                assert await shard.wait_acked(3, timeout=5.0)
                assert agg_s._shards[stream].duplicates == 1
                assert agg_s._shards[stream].applied == 3
                assert standby.state.metrics.value(
                    "krr_tpu_federation_duplicate_records_total", shard=stream) == 1.0
                await primary.shutdown()
                for t in (3, 4):
                    now[0] = START + t * TICK
                    await shard.tick(now[0])
                    await wait_for(lambda: agg_s._shards[stream].enqueued >= shard.epoch)
                    await standby.scheduler.run_once()
                    await wait_for(lambda: standby_uplink.acked >= shard.epoch)
                assert shard.epoch == standby_uplink.acked == agg_s._shards[stream].applied == ticks
                equal, detail = stores_bitexact_by_key(standby.state.store, control)
                assert equal, detail
                entries = {e["endpoint"]: e for e in shard.status()["aggregators"]}
                dead = entries[f"127.0.0.1:{p_port}"]
                alive = entries[f"127.0.0.1:{s_port}"]
                assert not dead["connected"] and dead["epoch_lag"] == 2
                assert alive["connected"] and alive["epoch_lag"] == 0
            finally:
                await shard.close()
                await standby.shutdown()
                await primary.shutdown()

        asyncio.run(main())


# ------------------------------------------------------------- read replicas
async def start_replica(side: Side, agg_port: int, clock, **overrides):
    config = side.config(
        federation_aggregator=f"127.0.0.1:{agg_port}",
        federation_shard_id=overrides.pop("replica_id", "replica-0"),
        federation_backoff_cap_seconds=0.2,
        **overrides,
    )
    replica = side.replica.ReplicaServer(config, clock=clock)
    await replica.start()
    return replica


async def same_response(source_port: int, replica_port: int, path: str, headers=None):
    src = await raw_get(source_port, path, headers)
    rep = await raw_get(replica_port, path, headers)
    assert rep[0] == src[0], (path, rep[0], src[0])
    assert rep[2] == src[2], path
    for name in VALIDATORS:
        assert rep[1].get(name) == src[1].get(name), (path, name)
    return src


class TestReadReplica:
    @pytest.mark.parametrize("source_side", [PORT, JAX], ids=["port_source", "jax_source"])
    def test_replica_serves_byte_identical_responses(self, source_side, pinned_clocks):
        """A port replica of a port (or JAX) aggregator: the catch-up frame
        and each broadcast install the source's bodies and validators
        verbatim — identity, gzip and filtered renders, 304s."""

        async def main():
            now = pinned_clocks
            fleet = MultiClusterFleet(clusters=1, seed=91)
            server, shards = await run_federated(source_side, source_side, fleet, 2, now)
            replica = None
            try:
                replica = await start_replica(PORT, server.aggregator.port, lambda: now[0])
                await wait_for(lambda: replica.state.publish_epoch == server.state.publish_epoch,
                               message="catch-up epoch")
                status, headers, body = await same_response(server.port, replica.port, "/recommendations")
                assert status == 200 and headers["x-krr-epoch"] == "2"
                etag = headers["etag"]
                _s, gz_headers, gz_body = await same_response(
                    server.port, replica.port, "/recommendations", {"Accept-Encoding": "gzip"})
                assert gz_headers.get("content-encoding") == "gzip"
                assert gzip.decompress(gz_body) == body
                await same_response(server.port, replica.port, "/recommendations?format=yaml")
                await same_response(server.port, replica.port, "/recommendations?limit=3&offset=1")
                status, hdrs, not_modified = await raw_get(
                    replica.port, "/recommendations", {"If-None-Match": etag})
                assert status == 304 and not_modified == b"" and hdrs["etag"] == etag
                now[0] = START + 2 * TICK
                await federated_round(server, shards, now[0])
                await wait_for(lambda: replica.state.publish_epoch == 3, message="broadcast epoch")
                _s, headers, _b = await same_response(server.port, replica.port, "/recommendations")
                assert headers["x-krr-epoch"] == "3"
                _s, _h, body = await raw_get(replica.port, "/healthz")
                payload = json.loads(body)
                assert payload["replica"]["feed_epoch"] == 3 and payload["epoch"] == 3
                assert payload["replica"]["connected"] is True
                assert payload["replica"]["epochs_applied"] == 2
                assert replica.client.status(now[0])["source"] == f"127.0.0.1:{server.aggregator.port}"
                assert server.state.metrics.value("krr_tpu_replica_subscribers") == 1.0
            finally:
                if replica is not None:
                    await replica.shutdown()
                await close_all(server, shards)

        asyncio.run(main())

    def test_port_and_jax_replicas_serve_the_same_bytes(self, pinned_clocks):
        """Both packages' replicas of one port aggregator serve the same
        bytes and validators, and the same /healthz replica block."""

        async def main():
            now = pinned_clocks
            server, shards = await run_federated(PORT, PORT, MultiClusterFleet(clusters=1, seed=91), 2, now)
            replicas = []
            try:
                for side in (JAX, PORT):
                    replicas.append(await start_replica(side, server.aggregator.port, lambda: now[0]))
                await wait_for(lambda: all(r.state.publish_epoch == 2 for r in replicas))
                for path, headers in (("/recommendations", None),
                                      ("/recommendations", {"Accept-Encoding": "gzip"})):
                    jax_reply = await raw_get(replicas[0].port, path, headers)
                    port_reply = await same_response(server.port, replicas[1].port, path, headers)
                    assert jax_reply[2] == port_reply[2]
                    assert all(jax_reply[1].get(n) == port_reply[1].get(n) for n in VALIDATORS)
                blocks = [json.loads((await raw_get(r.port, "/healthz"))[2])["replica"] for r in replicas]
                assert blocks[0] == blocks[1]
            finally:
                for replica in replicas:
                    await replica.shutdown()
                await close_all(server, shards)

        asyncio.run(main())

    def test_replica_survives_source_outage_and_resubscribes(self, pinned_clocks):
        async def main():
            now = pinned_clocks
            fleet = MultiClusterFleet(clusters=1, seed=93)
            server, shards = await run_federated(PORT, PORT, fleet, 1, now)
            agg_port = server.aggregator.port
            replica = None
            try:
                replica = await start_replica(PORT, agg_port, lambda: now[0])
                await wait_for(lambda: replica.state.publish_epoch == 1)
                now[0] = START + 4 * TICK
                status, _h, body = await raw_get(replica.port, "/healthz")
                assert status == 200 and json.loads(body)["status"] == "ok", body
                await close_all(server, shards)
                status, headers, _b = await raw_get(replica.port, "/recommendations")
                assert status == 200 and headers["x-krr-epoch"] == "1"
                await wait_for(lambda: not replica.client.connected, message="feed down")
                status, _h, body = await raw_get(replica.port, "/healthz")
                assert status == 200, body
                now[0] = START + 8 * TICK
                status, _h, body = await raw_get(replica.port, "/healthz")
                assert status == 503 and json.loads(body)["status"] == "stale", body
                server = aggregator_server(PORT, fleet, lambda: now[0], listen=f"127.0.0.1:{agg_port}")
                await server.start(run_scheduler=False)
                shards = [make_shard(PORT, fleet, "c0", agg_port, lambda: now[0])]
                for t in (9, 10):
                    now[0] = START + t * TICK
                    await federated_round(server, shards, now[0])
                await wait_for(lambda: replica.state.publish_epoch == server.state.publish_epoch,
                               message="re-subscribe", timeout=15.0)
                src = await raw_get(server.port, "/recommendations")
                rep = await raw_get(replica.port, "/recommendations")
                assert rep[2] == src[2] and rep[1]["etag"] == src[1]["etag"]
                assert replica.client.reconnects >= 2
                status, _h, body = await raw_get(replica.port, "/healthz")
                assert status == 200 and json.loads(body)["status"] == "ok", body
            finally:
                if replica is not None:
                    await replica.shutdown()
                await close_all(server, shards)

        asyncio.run(main())


# ------------------------------------------------------------ uplink backoff
class TestUplinkBackoff:
    def test_capped_jitter_ladder_and_reset(self, monkeypatch):
        """0.25·2^(n−1) capped at the backoff cap, jitter pinned to 1.0 in
        both packages: the port's ladder is the JAX package's, step by
        step."""
        for side in (JAX, PORT):
            monkeypatch.setattr(side.shard.random, "uniform", lambda a, b: 1.0)

        async def ladder(side: Side) -> list:
            config = side.config()
            spec = side.spec()
            metrics = side.metrics.MetricsRegistry()
            uplink = side.shard.Uplink(
                stream_id="t", host="127.0.0.1", port=await dead_port(), generation="g",
                hello_spec={"gamma": spec.gamma, "min_value": spec.min_value, "num_buckets": spec.num_buckets},
                snapshot_fn=lambda: None, metrics=metrics, logger=config.create_logger(),
                buffer_cap=4, backoff_cap=2.0,
            )
            waits = []
            for _ in range(6):
                uplink._next_attempt = 0.0
                await uplink.pump()
                assert not uplink.connected
                waits.append(uplink._next_attempt - time.monotonic())
            assert metrics.value("krr_tpu_federation_uplink_retries_total") == 6.0
            attempts = uplink._attempts
            await uplink.pump()
            assert uplink._attempts == attempts
            if side.is_port:
                server = aggregator_server(PORT, MultiClusterFleet(clusters=1, seed=7), lambda: START)
                await server.start(run_scheduler=False)
                try:
                    uplink.host, uplink.port = "127.0.0.1", server.aggregator.port
                    uplink.reset_backoff()
                    assert uplink._next_attempt == 0.0
                    await uplink.pump()
                    assert uplink.connected and uplink._attempts == 0
                finally:
                    await uplink.close()
                    await server.shutdown()
            return waits

        async def main():
            expected = [0.25, 0.5, 1.0, 2.0, 2.0, 2.0]
            for side in (JAX, PORT):
                waits = await ladder(side)
                for got, want in zip(waits, expected):
                    assert want - 0.15 <= got <= want + 0.01, (side, waits)

        asyncio.run(main())


# ------------------------------------------------------ fleet observability
def _lineage_chain(lineage: dict) -> list:
    return [float(lineage[k]) for k in ("newest_sample_ts", "fold_ts", "apply_ts", "publish_ts")]


async def _install_acked(agg, epoch: int) -> None:
    await wait_for(
        lambda: (agg._epochs.get(epoch) or {}).get("lineage", {}).get("install_ts") is not None,
        message=f"replica install ack on epoch {epoch}",
    )


class TestFleetObservability:
    def test_trace_join_and_stitch_e2e(self, pinned_clocks):
        async def main():
            now = pinned_clocks
            server, shards = await run_federated(PORT, PORT, MultiClusterFleet(clusters=1, seed=71), 1, now)
            shard = shards[0]
            replica = None
            try:
                replica = await start_replica(PORT, server.aggregator.port, lambda: now[0])
                await wait_for(lambda: replica.state.publish_epoch == server.state.publish_epoch)
                now[0] = START + TICK
                await federated_round(server, shards, now[0])
                await wait_for(lambda: replica.state.publish_epoch == 2)
                await _install_acked(server.aggregator, 2)
                shard_scans = {spans[0].trace_id for spans in shard.tracer.traces() if spans}
                agg_traces = server.session.tracer.traces()
                applies = [s for spans in agg_traces for s in spans if s.name == "apply_record"]
                assert shard_scans and applies
                assert {s.attributes.get("remote_trace_id") for s in applies} & shard_scans
                assert all(s.parent_id is not None for s in applies)
                agg_ticks = {spans[0].trace_id for spans in agg_traces if spans}
                installs = [s for spans in replica.tracer.traces() for s in spans if s.name == "install"]
                assert installs
                assert {s.attributes.get("remote_trace_id") for s in installs} & agg_ticks
                assert (shard.tracer.node, server.session.tracer.node, replica.tracer.node) == (
                    "c0", "aggregator", "replica-0")
                payloads = [t.export_chrome() for t in (shard.tracer, server.session.tracer, replica.tracer)]
                stitched = PORT.trace.stitch_chrome(payloads)
                events = [e for e in stitched["traceEvents"] if e.get("ph") == "X"]
                by_name = {}
                for event in events:
                    by_name.setdefault(event["name"], []).append(event)
                assert {"scan", "apply_record", "install"} <= set(by_name)
                pids = ({e["pid"] for e in by_name["install"]} & {e["pid"] for e in by_name["apply_record"]}
                        & {e["pid"] for e in by_name["scan"]})
                assert pids
                span_ids = {e["args"].get("span_id") for e in events}
                remote = [e for e in by_name["install"] if e["args"].get("remote")]
                assert remote and all(e["args"]["parent_id"] in span_ids for e in remote)
                for event in events:
                    parent = event["args"].get("parent_id")
                    assert parent is None or parent in span_ids, event["name"]
                for pid in pids:
                    lanes = {}
                    for event in events:
                        if event["pid"] == pid:
                            lanes.setdefault(event["args"]["span_id"].split(":", 1)[0], set()).add(event["tid"])
                    assert len(lanes) == 3
                    assert all(not (lanes[a] & lanes[b]) for a in lanes for b in lanes if a != b)
                assert PORT.trace.traces_from_chrome(stitched)
                # The JAX package stitches the port's three rings alike.
                assert JAX.trace.stitch_chrome(payloads)["traceEvents"] == stitched["traceEvents"]
            finally:
                if replica is not None:
                    await replica.shutdown()
                await close_all(server, shards)

        asyncio.run(main())

    def test_snapshot_record_carries_lineage_and_trace(self, pinned_clocks):
        async def main():
            now = pinned_clocks
            fleet = MultiClusterFleet(clusters=1, seed=91)
            server = aggregator_server(PORT, fleet, lambda: now[0])
            await server.start(run_scheduler=False)
            port = server.aggregator.port
            shard = make_shard(PORT, fleet, "c0", port, lambda: now[0])
            off = make_shard(PORT, fleet, "c0", port, lambda: now[0], federation_lineage_enabled=False)
            overhead = PORT.protocol.FRAME_OVERHEAD
            try:
                await shard.tick(now[0])
                epoch, framed = shard._snapshot_record()
                assert epoch == shard.epoch == 1
                # The JAX package decodes the port's snapshot record.
                meta, ops = JAX.durastore.decode_ops(framed[overhead:])
                extra = meta["extra"]
                assert extra["reset"] is True and extra["kind"] == "snapshot"
                lineage = extra["lineage"]
                assert lineage["shard"] == "c0" and lineage["newest_sample_ts"] <= lineage["fold_ts"]
                assert extra["trace"]["node"] == "c0" and extra["trace"]["trace_id"]
                assert ops[0][1] == list(shard.store.keys)
                await off.tick(now[0])
                _e, framed2 = off._snapshot_record()
                assert "lineage" not in PORT.durastore.decode_ops(framed2[overhead:])[0]["extra"]
                fresh = make_shard(PORT, fleet, "c0", port, lambda: now[0])
                try:
                    assert fresh._snapshot_record() is None
                finally:
                    await fresh.close()
            finally:
                await off.close()
                await close_all(server, [shard])

        asyncio.run(main())

    def test_lineage_monotonic_survives_restart_and_takeover(self, pinned_clocks):
        async def main():
            now = pinned_clocks
            fleet = MultiClusterFleet(clusters=1, seed=73)
            server, shards = await run_federated(PORT, PORT, fleet, 2, now)
            agg_port = server.aggregator.port
            replica = None
            try:
                replica = await start_replica(PORT, agg_port, lambda: now[0])
                await wait_for(lambda: replica.state.publish_epoch == 2)
                agg = server.aggregator
                await _install_acked(agg, 2)
                for lineage in agg.epoch_lineage(2):
                    assert _lineage_chain(lineage) == sorted(_lineage_chain(lineage)), lineage
                installed = agg.newest_installed_lineage()
                assert installed["install_ts"] >= installed["publish_ts"]
                await close_all(server, [])
                server = aggregator_server(PORT, fleet, lambda: now[0], listen=f"127.0.0.1:{agg_port}")
                await server.start(run_scheduler=False)
                shard2 = make_shard(PORT, fleet, "c0", agg_port, lambda: now[0])
                shards.append(shard2)
                for t in (2, 3):
                    now[0] = START + t * TICK
                    await federated_round(server, [shard2], now[0])
                await wait_for(lambda: replica.client.reconnects >= 2 and replica.client.connected,
                               message="re-subscribe", timeout=15.0)
                records = server.aggregator.epoch_lineage(4)
                assert records
                for lineage in records:
                    assert _lineage_chain(lineage) == sorted(_lineage_chain(lineage)), lineage
            finally:
                if replica is not None:
                    await replica.shutdown()
                await close_all(server, shards)

            now[0] = START
            primary = aggregator_server(PORT, fleet, lambda: now[0])
            standby = aggregator_server(PORT, fleet, lambda: now[0])
            await primary.start(run_scheduler=False)
            await standby.start(run_scheduler=False)
            ring_spec = f"a=127.0.0.1:{primary.aggregator.port}|127.0.0.1:{standby.aggregator.port}"
            ring_shard = make_ring_shard(PORT, fleet, "c0", ring_spec, lambda: now[0])
            by_port = {primary.aggregator.port: primary, standby.aggregator.port: standby}
            try:
                for t in range(2):
                    now[0] = START + t * TICK
                    await ring_round(by_port, [ring_shard], now[0])
                await primary.shutdown()
                agg_s = standby.aggregator
                for t in (2, 3):
                    now[0] = START + t * TICK
                    await ring_shard.tick(now[0])
                    await wait_for(lambda: agg_s._shards["c0/a"].enqueued >= ring_shard.epoch)
                    await standby.scheduler.run_once()
                records = agg_s.epoch_lineage(4)
                assert records
                for lineage in records:
                    assert _lineage_chain(lineage) == sorted(_lineage_chain(lineage)), lineage
            finally:
                await ring_shard.close()
                await standby.shutdown()
                with contextlib.suppress(Exception):
                    await primary.shutdown()

        asyncio.run(main())

    def test_freshness_histograms_and_fleet_route_equal_jax(self, pinned_clocks):
        """The aggregator's and the replica's freshness histograms, the
        /statusz lineage block, and ``GET /fleet`` (JSON and text): the
        census equals the JAX aggregator's on the same fleet and clock,
        whole — under the pinned clock no field of it reads wall time."""

        async def scenario(side: Side) -> dict:
            now = pinned_clocks
            server, shards = await run_federated(side, side, MultiClusterFleet(clusters=1, seed=79), 1, now)
            replica = None
            out = {}
            try:
                replica = await start_replica(side, server.aggregator.port, lambda: now[0])
                await wait_for(lambda: replica.state.publish_epoch == 1)
                now[0] = START + TICK
                await federated_round(server, shards, now[0])
                agg = server.aggregator
                await _install_acked(agg, 2)
                metrics = server.state.metrics
                for registry in (metrics, replica.metrics):
                    for stage in ("fold", "apply", "publish", "install"):
                        count = registry.value("krr_tpu_e2e_freshness_seconds_count", stage=stage)
                        assert count and count >= 1.0, stage
                status, _h, body = await raw_get(replica.port, "/metrics")
                text = body.decode()
                assert status == 200 and "krr_tpu_build_info{" in text
                assert "krr_tpu_process_resident_bytes" in text
                assert 'krr_tpu_e2e_freshness_seconds_count{stage="install"}' in text
                _s, _h, body = await raw_get(server.port, "/statusz")
                lineage = json.loads(body)["federation"]["lineage"]
                assert lineage["epoch"] == 2
                assert _lineage_chain(lineage) == sorted(_lineage_chain(lineage))
                _s, _h, body = await raw_get(server.port, "/debug/timeline?n=1")
                assert json.loads(body)["records"][-1]["lineage"]["epoch"] == 2
                now[0] = START + TICK + 1.0
                status, _h, body = await raw_get(server.port, "/fleet")
                assert status == 200
                census = json.loads(body)
                out["census"] = census
                nodes = {entry["node"]: entry for entry in census["nodes"]}
                assert census["feed_epoch"] == 2
                assert [nodes[n]["role"] for n in ("aggregator", "c0", "replica-0")] == [
                    "aggregator", "shard", "replica"]
                assert all(e["health"] == "ok" and e["epoch_lag"] == 0 for e in nodes.values())
                assert census["slo"]["name"] == "fleet_health"
                status, headers, body = await raw_get(server.port, "/fleet?format=text")
                assert status == 200 and "text/plain" in headers["content-type"]
                out["text"] = body
                assert b"NODE" in body and b"replica-0" in body
                status, _h, _b = await raw_get(server.port, "/fleet?format=bogus")
                assert status == 400
                assert metrics.value("krr_tpu_fleet_nodes", role="shard") == 1.0
                assert metrics.value("krr_tpu_fleet_epoch_lag", node="replica-0") is not None
                assert metrics.total("krr_tpu_fleet_node_checks_total") >= 3.0
                assert "fleet_health" in [o["name"] for o in server.state.slo.status(now[0])["objectives"]]
                await replica.shutdown()
                replica = None
                await wait_for(lambda: not any(c.get("connected") for c in agg._replica_census.values()))
                now[0] = START + 2 * TICK
                await federated_round(server, shards, now[0])
                _s, _h, body = await raw_get(server.port, "/fleet")
                out["after"] = json.loads(body)
                dead = {e["node"]: e for e in out["after"]["nodes"]}["replica-0"]
                assert dead["health"] == "disconnected" and dead["epoch_lag"] >= 1
                assert metrics.total("krr_tpu_fleet_node_unhealthy_total") >= 1.0
            finally:
                if replica is not None:
                    await replica.shutdown()
                await close_all(server, shards)
            return out

        async def main():
            port = await scenario(PORT)
            jax = await scenario(JAX)
            assert port == jax
            control = control_server(PORT, MultiClusterFleet(clusters=1, seed=79), lambda: START)
            await control.start(run_scheduler=False)
            try:
                status, _h, body = await raw_get(control.port, "/fleet")
                assert status == 404 and b"not an aggregator" in body
            finally:
                await control.shutdown()

        asyncio.run(main())

    def test_lineage_off_is_bitexact_and_unstamped(self, pinned_clocks):
        async def main():
            now = pinned_clocks
            stores, bodies = {}, {}
            for on in (True, False):
                fleet = MultiClusterFleet(clusters=1, seed=83)
                now[0] = START
                server = aggregator_server(PORT, fleet, lambda: now[0], federation_lineage_enabled=on)
                await server.start(run_scheduler=False)
                shards = [make_shard(PORT, fleet, "c0", server.aggregator.port, lambda: now[0],
                                     federation_lineage_enabled=on)]
                try:
                    for t in range(2):
                        now[0] = START + t * TICK
                        await federated_round(server, shards, now[0])
                    stores[on] = server.state.store
                    bodies[on] = server.state.peek().body_json
                    assert bool(server.aggregator.epoch_lineage(1)) is on
                    if not on:
                        assert server.state.metrics.value(
                            "krr_tpu_e2e_freshness_seconds_count", stage="fold") is None
                finally:
                    await close_all(server, shards)
            equal, detail = stores_bitexact_by_key(stores[True], stores[False])
            assert equal, detail
            assert bodies[True] == bodies[False]

        asyncio.run(main())

    def test_sentinel_names_guilty_freshness_hop(self):
        def record(i: int, install_delta: float = 2.0) -> dict:
            base = 1_000_000.0 + i * 300.0
            categories = dict.fromkeys(
                ("fetch_transport", "fetch_decode", "fetch_backoff", "fetch_other",
                 "discover", "other", "idle"), 0.0)
            categories.update(fold=0.4, compute=0.4, publish=0.2)
            return {
                "v": 1, "ts": base, "scan_id": f"scan-{i}", "kind": "aggregate", "wall": 1.0,
                "categories": categories, "rows": 8, "failed_rows": 0, "stale_workloads": 0,
                "lineage": {
                    "epoch": i + 1, "newest_sample_ts": base - 300.0, "fold_ts": base - 295.0,
                    "apply_ts": base - 290.0, "publish_ts": base - 288.0,
                    "install": {"epoch": i, "publish_ts": base - 588.0,
                                "install_ts": base - 588.0 + install_delta, "replicas": 1},
                },
            }

        verdicts = {}
        for side in (JAX, PORT):
            sentinel = side.sentinel.RegressionSentinel(warmup_scans=4)
            rng = np.random.default_rng(5)
            for i in range(12):
                verdict = sentinel.observe(
                    record(i, install_delta=2.0 * float(1.0 + rng.normal(0, 0.04))), fire=False)
                assert verdict["status"] in ("warming", "nominal"), verdict
            verdicts[side.package] = sentinel.observe(record(12, install_delta=240.0), fire=False)
        verdict = verdicts["krr_tpu_torch"]
        assert verdict["status"] == "regressed" and verdict["dominant"] == "freshness_install"
        assert verdict["excess_unit"] == "s" and "REPLICA" in verdict["suspect"]
        assert verdict == verdicts["krr_tpu"]
