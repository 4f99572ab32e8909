"""The port's push ingest against the JAX package's, on the same bytes.

Every layer of `krr_tpu_torch/ingest/` and its remote-write decoder is held
to its JAX counterpart on identical inputs made from a seed:

- the decoders (the port's native scanner and its pure-Python twin) against
  `krr_tpu`'s ``decode_remote_write``: the same decoded bytes, or the same
  exception class, over sender frames, edge shapes, copy-tag snappy streams,
  every truncation and a seeded bit-flip sweep;
- the series router over fixed label sets and a seeded fuzz of records;
- both packages' ``IngestPlane`` fed the same bodies: equal counters,
  rejections, tombstones, watermarks and ``fold_fleet`` arrays, bit for bit;
- the two remote-write listeners: the same response bytes, request by
  request, down one kept-alive connection;
- three serve stacks over one fake fleet — a port push server, a JAX push
  server and a port pull control: seed, audit and steady ticks publish the
  same ``/recommendations`` bytes, ETag and epoch, keep bit-identical
  stores, and the steady push tick sends Prometheus nothing.

The snapshot's ``published_at`` (the ETag's millisecond stamp) reads
``time.time()`` in each package's ``server/scheduler.py``; the serve tests
pin it to the injected clock, as ``tests/test_torch_serve.py`` does.
"""

from __future__ import annotations

import asyncio
import json
import math
import struct
import time
import types

import numpy as np
import pytest
import yaml

import krr_tpu.ingest as jax_ingest
import krr_tpu.ingest.plane as jax_plane_mod
import krr_tpu.integrations.native as jax_native
import krr_tpu.server.app as jax_app
import krr_tpu.server.scheduler as jax_scheduler
import krr_tpu_torch.ingest as port_ingest
import krr_tpu_torch.ingest.plane as port_plane_mod
import krr_tpu_torch.integrations.native as port_native
import krr_tpu_torch.server.app as port_app
import krr_tpu_torch.server.scheduler as port_scheduler
from krr_tpu.core.config import Config as JaxConfig
from krr_tpu.models.allocations import ResourceAllocations as JaxAllocations
from krr_tpu.models.allocations import ResourceType as JaxResourceType
from krr_tpu.models.objects import K8sObjectData as JaxObject
from krr_tpu.obs.metrics import MetricsRegistry as JaxRegistry
from krr_tpu.obs.timeline import build_scan_record as jax_build_scan_record
from krr_tpu_torch.core.config import Config as PortConfig
from krr_tpu_torch.models.allocations import ResourceAllocations as PortAllocations
from krr_tpu_torch.models.allocations import ResourceType as PortResourceType
from krr_tpu_torch.models.objects import K8sObjectData as PortObject
from krr_tpu_torch.obs.metrics import MetricsRegistry as PortRegistry
from krr_tpu_torch.obs.timeline import build_scan_record as port_build_scan_record

from .fakes.remote_write import (
    CPU_METRIC,
    MEM_METRIC,
    RemoteWriteSender,
    build_body,
    cpu_labels,
    encode_write_request,
    mem_labels,
    post_body,
    snappy_compress,
    uvarint,
)
from .fakes.servers import FakeBackend, FakeCluster, FakeMetrics, ServerThread

ORIGIN = FakeBackend.SERIES_ORIGIN

needs_native = pytest.mark.skipif(
    port_native._load_library() is None or jax_native._load_library() is None,
    reason="native library not built (no g++)",
)

#: The port's two decoders and its dispatcher, each held to the JAX
#: package's dispatcher.
PORT_DECODERS = {
    "native": port_native.decode_remote_write_native,
    "python": port_native.decode_remote_write_python,
    "dispatch": port_native.decode_remote_write,
}


def _decoded_bytes(decoded):
    """Canonical byte image of a decoded tuple: NaN payloads and signed
    zeros compare exactly."""
    names, values, timestamps, lens = decoded
    return (names, values.tobytes(), timestamps.tobytes(), lens.tobytes(),
            str(values.dtype), str(timestamps.dtype), str(lens.dtype))


def _outcome(fn, body: bytes, *args):
    """The decoded byte image, or the exception's class name. The native
    decoder's ``None`` (library absent, capacity short) is its own outcome:
    the dispatcher then runs the Python twin."""
    try:
        decoded = fn(body, *args)
    except Exception as e:  # noqa: BLE001 — the class is the outcome
        return ("raise", type(e).__name__)
    return ("none",) if decoded is None else ("ok", _decoded_bytes(decoded))


def _assert_decoders_agree(body: bytes, *args) -> tuple:
    expected = _outcome(jax_native.decode_remote_write, body, *args)
    for name in ("python", "dispatch"):
        assert _outcome(PORT_DECODERS[name], body, *args) == expected, (name, body)
    native = _outcome(port_native.decode_remote_write_native, body, *args)
    # The native scanner answers alone or hands over; what it answers, the
    # JAX dispatcher answers too.
    assert native == ("none",) or native == expected, body
    assert native == _outcome(jax_native.decode_remote_write_native, body, *args), body
    return expected


def _sample_series():
    """Normal samples, a NaN, a negative value, a negative timestamp and a
    labels-only series with no samples."""
    return [
        (cpu_labels("default", "web-0", "main"),
         [(0.25, 1_700_000_000_000), (float("nan"), 1_700_000_060_000), (-1.5, 1_700_000_120_000)]),
        (mem_labels("prod", "db-0", "main"), [(2.0e8, -5_000)]),
        ([("__name__", "labels_only"), ("job", "x")], []),
    ]


def _sender_body(seed: int = 7) -> bytes:
    metrics = FakeMetrics()
    rng = np.random.default_rng(seed)
    metrics.set_series("default", "main", "web-0", cpu=rng.gamma(2.0, 0.05, 24), memory=rng.uniform(5e7, 2e8, 24))
    metrics.set_series("prod", "main", "db-0", cpu=rng.gamma(2.0, 0.2, 24), memory=rng.uniform(1e8, 4e8, 24))
    return RemoteWriteSender(metrics).frames(0, 23)


def _copy_tag_bodies() -> list[bytes]:
    """Hand-built snappy streams over one WriteRequest: 2-byte-offset
    copies (one overlapping, offset < length), then a 1-byte-offset and a
    4-byte-offset copy. The fake sender writes literals only."""
    wire = encode_write_request(
        [([("__name__", CPU_METRIC), ("container", "main"), ("namespace", "ns"), ("pod", "a" * 70)],
          [(1.0, 1_700_000_000_000)])]
    )
    run = wire.index(b"a" * 70)

    def literal(data: bytes) -> bytes:
        if len(data) <= 60:
            return bytes([(len(data) - 1) << 2]) + data
        assert len(data) <= 256
        return bytes([60 << 2, len(data) - 1]) + data

    head, tail = wire[: run + 1], wire[run + 70:]
    two_byte = (bytes([((64 - 1) << 2) | 2]) + struct.pack("<H", 1)
                + bytes([((5 - 1) << 2) | 2]) + struct.pack("<H", 1))
    one_byte = bytes([((7 - 4) << 2) | 1, 1])
    four_byte = bytes([((62 - 1) << 2) | 3]) + struct.pack("<I", 8)
    return [
        snappy_compress(wire),
        uvarint(len(wire)) + literal(head) + two_byte + literal(tail),
        uvarint(len(wire)) + literal(head) + one_byte + four_byte + literal(tail),
    ]


# ------------------------------------------------------------ decoder parity
class TestDecoderParity:
    @needs_native
    @pytest.mark.parametrize("decoder", sorted(PORT_DECODERS))
    def test_sender_frames_equal_jax(self, decoder):
        body = _sender_body()
        port = PORT_DECODERS[decoder](body)
        assert port is not None
        assert _decoded_bytes(port) == _decoded_bytes(jax_native.decode_remote_write(body))
        assert _decoded_bytes(port) == _decoded_bytes(jax_native.decode_remote_write_python(body))

    @needs_native
    @pytest.mark.parametrize("decoder", sorted(PORT_DECODERS))
    def test_edge_shapes_equal_jax(self, decoder):
        body = build_body(_sample_series())
        port = PORT_DECODERS[decoder](body)
        assert port is not None
        assert _decoded_bytes(port) == _decoded_bytes(jax_native.decode_remote_write(body))
        _names, values, timestamps, lens = port
        assert list(lens) == [3, 1, 0]
        assert math.isnan(values[1]) and timestamps[3] == -5_000

    @needs_native
    @pytest.mark.parametrize("decoder", sorted(PORT_DECODERS))
    def test_copy_tag_snappy_equal_jax(self, decoder):
        bodies = _copy_tag_bodies()
        reference = _decoded_bytes(jax_native.decode_remote_write_python(bodies[0]))
        for body in bodies:
            port = PORT_DECODERS[decoder](body)
            assert port is not None
            assert _decoded_bytes(port) == reference
            assert _decoded_bytes(jax_native.decode_remote_write(body)) == reference

    def test_the_native_library_carries_the_decoder(self):
        lib = port_native._load_library()
        if lib is None:
            pytest.skip("native library not built (no g++)")
        assert lib.krr_rw_decode.restype is not None
        assert port_native.library_loaded()


# ------------------------------------------------------- malformed hardening
class TestMalformedAgainstJax:
    @pytest.mark.parametrize("shape", ["edge", "sender", "copy_tags"])
    def test_every_truncation_agrees(self, shape):
        body = {"edge": build_body(_sample_series()), "sender": _sender_body(11),
                "copy_tags": _copy_tag_bodies()[2]}[shape]
        outcomes = {_assert_decoders_agree(body[:cut])[0] for cut in range(len(body))}
        assert "raise" in outcomes  # the sweep reaches the error arms

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_seeded_bitflips_agree(self, seed):
        """Every byte XOR 0xFF, then 300 single-bit and random-mask flips at
        seeded positions: the same tuple or the same exception class."""
        body = build_body(_sample_series()) if seed != 2 else _copy_tag_bodies()[1]
        rng = np.random.default_rng(seed)
        flips = [(pos, 0xFF) for pos in range(len(body))]
        flips += [(int(rng.integers(len(body))), 1 << int(rng.integers(8))) for _ in range(150)]
        flips += [(int(rng.integers(len(body))), int(rng.integers(1, 256))) for _ in range(150)]
        for pos, mask in flips:
            flipped = bytearray(body)
            flipped[pos] ^= mask
            _assert_decoders_agree(bytes(flipped))

    def test_oversized_preamble_is_too_large(self):
        body = b"\xff\xff\xff\xff\xff\xff garbage"
        assert _assert_decoders_agree(body) == ("raise", "RemoteWriteTooLarge")
        for fn in (port_native.decode_remote_write_python, port_native.decode_remote_write):
            with pytest.raises(port_native.RemoteWriteTooLarge):
                fn(body)

    @pytest.mark.parametrize("cap", [0, 8, 64])
    def test_decoded_cap_enforced(self, cap):
        body = build_body(_sample_series())
        assert _assert_decoders_agree(body, cap) == ("raise", "RemoteWriteTooLarge")

    @pytest.mark.parametrize("poison", ["with\ttab", "with\nnewline"])
    def test_separator_bytes_inside_labels_rejected(self, poison):
        body = build_body([([("__name__", poison)], [(1.0, 0)])])
        assert _assert_decoders_agree(body) == ("raise", "RemoteWriteError")

    @pytest.mark.parametrize("shape", ["timestamp", "field_number", "preamble"])
    def test_overlong_varints_wrap_as_the_native_scanner(self, shape):
        """A 10-byte varint with high bits set: the native scanner wraps it
        at 64 bits (field numbers at 32), and so does the port's Python
        twin. The JAX package's twin keeps the unbounded integer — an
        ``OverflowError`` on the timestamp, another field, another class on
        the preamble — so these bodies are held to the JAX dispatcher."""
        labels = b"\n\x0c\n\x08__name__\x12\x00"  # one Label{__name__: ""}
        if shape == "timestamp":
            sample = b"\t" + struct.pack("<d", 1.5) + b"\x10" + b"\xff" * 9 + b"\x7f"
            body = snappy_compress(b"\n" + uvarint(len(labels) + 2 + len(sample)) + labels
                                   + b"\x12" + uvarint(len(sample)) + sample)
        elif shape == "field_number":
            # Field (1 << 32) | 1, wire type 2: field 1 once truncated.
            key = uvarint((((1 << 32) | 1) << 3) | 2 | (1 << 63))
            body = snappy_compress(key + uvarint(len(labels)) + labels)
        else:
            body = uvarint(1 << 63) + b"\x00"
        expected = _assert_decoders_agree(body)
        if _outcome(port_native.decode_remote_write_native, body) != ("none",):
            assert _outcome(port_native.decode_remote_write_python, body) == expected
        if shape == "timestamp" and expected[0] == "ok":
            assert port_native.decode_remote_write_python(body)[2][0] == -1

    def test_error_classes_mirror_jax(self):
        assert issubclass(port_native.RemoteWriteTooLarge, port_native.RemoteWriteError)
        assert issubclass(port_native.RemoteWriteError, ValueError)


# ------------------------------------------------------------------- router
FIXED_RECORDS = [
    [b"__name__", CPU_METRIC.encode(), b"container", b"main", b"namespace", b"ns", b"pod", b"p"],
    [b"__name__", MEM_METRIC.encode(), b"container", b"main", b"image", b"img", b"job", b"kubelet",
     b"metrics_path", b"/metrics/cadvisor", b"namespace", b"ns", b"pod", b"p"],
    [b"__name__", b"up"],
    [b"__name__", MEM_METRIC.encode(), b"container", b"main", b"image", b"img", b"job", b"node",
     b"metrics_path", b"/metrics/cadvisor", b"namespace", b"ns", b"pod", b"p"],
    [b"__name__", MEM_METRIC.encode(), b"container", b"main", b"image", b"img", b"job", b"kubelet",
     b"metrics_path", b"/metrics", b"namespace", b"ns", b"pod", b"p"],
    [b"__name__", MEM_METRIC.encode(), b"container", b"main", b"image", b"", b"job", b"kubelet",
     b"metrics_path", b"/metrics/cadvisor", b"namespace", b"ns", b"pod", b"p"],
    [b"__name__", CPU_METRIC.encode(), b"container", b"", b"namespace", b"ns", b"pod", b"p"],
    [b"odd", b"count", b"fields"],
    [b"\xff\xfe", b"x"],
    [],
]


class TestRouter:
    @pytest.mark.parametrize("i", range(len(FIXED_RECORDS)))
    def test_fixed_label_sets_route_as_jax(self, i):
        record = b"\t".join(FIXED_RECORDS[i])
        assert port_ingest.route_record(record) == jax_ingest.route_record(record)

    def test_fixed_label_sets_cover_every_reason(self):
        routes = {port_ingest.route_record(b"\t".join(r)) for r in FIXED_RECORDS}
        assert {"unknown_metric", "filtered", "missing_labels", "malformed_labels"} <= routes
        assert ("cpu", "ns", "p", "main") in routes and ("mem", "ns", "p", "main") in routes

    @pytest.mark.parametrize("seed", range(4))
    def test_seeded_fuzz_routes_as_jax(self, seed):
        rng = np.random.default_rng(seed)
        names = [b"__name__", b"container", b"namespace", b"pod", b"job", b"metrics_path", b"image", b"x"]
        values = [CPU_METRIC.encode(), MEM_METRIC.encode(), b"", b"main", b"ns", b"p", b"kubelet",
                  b"/metrics/cadvisor", b"img", b"\xc3\xa9", b"\xff", b"node"]
        seen = set()
        for _ in range(500):
            fields = []
            for _ in range(int(rng.integers(0, 9))):
                fields.append(names[int(rng.integers(len(names)))])
                fields.append(values[int(rng.integers(len(values)))])
            if rng.random() < 0.1:
                fields.append(b"dangling")
            record = b"\t".join(fields)
            port = port_ingest.route_record(record)
            assert port == jax_ingest.route_record(record), record
            assert port_plane_mod.route_record is port_ingest.route_record
            seen.add(port if isinstance(port, str) else port[0])
        assert len(seen) >= 4


# ----------------------------------------------------------------- the plane
def _objects(pods_by_name: dict) -> tuple[list, list]:
    """The same workloads as each package's ``K8sObjectData``."""
    out = []
    for object_type, allocations_type, resource_type in (
        (JaxObject, JaxAllocations, JaxResourceType),
        (PortObject, PortAllocations, PortResourceType),
    ):
        objs = []
        for (namespace, name), pods in pods_by_name.items():
            objs.append(object_type(
                cluster="c", namespace=namespace, name=name, kind="Deployment", container="main",
                pods=list(pods),
                allocations=allocations_type(
                    requests={resource_type.CPU: None, resource_type.Memory: None},
                    limits={resource_type.CPU: None, resource_type.Memory: None},
                ),
            ))
        out.append(objs)
    return out[0], out[1]


class PlanePair:
    """One JAX and one port ``IngestPlane`` on the same settings, each with
    its own package's metrics registry."""

    def __init__(self, **settings):
        self.jax_metrics, self.port_metrics = JaxRegistry(), PortRegistry()
        self.jax = jax_ingest.IngestPlane(metrics=self.jax_metrics, **settings)
        self.port = port_ingest.IngestPlane(metrics=self.port_metrics, **settings)

    def ingest(self, body: bytes):
        outcomes = []
        for plane in (self.jax, self.port):
            try:
                outcomes.append(("ok", plane.ingest_body(body)))
            except Exception as e:  # noqa: BLE001
                outcomes.append(("raise", type(e).__name__))
        assert outcomes[0] == outcomes[1], body
        return outcomes[1]

    def assert_same(self, pods_by_name: dict, windows, fold_params=(60.0, 1.02, 1e-7, 256)) -> None:
        assert self.port.stats() == self.jax.stats()
        assert self.port.rejected == self.jax.rejected
        assert self.port.tombstones_total == self.jax.tombstones_total
        assert set(self.port._series) == set(self.jax._series)
        for route, series in self.jax._series.items():
            mine = self.port._series[route]
            assert (mine.ts, mine.joined_ms, mine.last_ts) == (series.ts, series.joined_ms, series.last_ts)
            assert np.array_equal(np.asarray(mine.values), np.asarray(series.values), equal_nan=True)
        for family in ("krr_tpu_ingest_tombstones_total",):
            assert self.port_metrics.value(family) == self.jax_metrics.value(family)
        for reason in self.jax.rejected:
            family = "krr_tpu_ingest_rejected_samples_total"
            assert self.port_metrics.value(family, reason=reason) == self.jax_metrics.value(family, reason=reason)
        jax_objs, port_objs = _objects(pods_by_name)
        rows = list(range(len(jax_objs)))
        for start, end in windows:
            ready = [self.jax.push_ready(o, start, end) for o in jax_objs]
            assert [self.port.push_ready(o, start, end) for o in port_objs] == ready
            step, gamma, min_value, buckets = fold_params
            jax_fleet = self.jax.fold_fleet(jax_objs, rows, start, end, step, gamma, min_value, buckets)
            port_fleet = self.port.fold_fleet(port_objs, rows, start, end, step, gamma, min_value, buckets)
            for field in ("cpu_counts", "cpu_total", "cpu_peak", "mem_total", "mem_peak"):
                mine, theirs = getattr(port_fleet, field), getattr(jax_fleet, field)
                assert mine.dtype == theirs.dtype and mine.tobytes() == theirs.tobytes(), (field, start, end)
        for now in (0.0, 100.0, 1e6):
            assert self.port.freshness_seconds(now) == self.jax.freshness_seconds(now)


def _cpu_body(pod, samples, namespace="default", container="main"):
    return build_body([(cpu_labels(namespace, pod, container), samples)])


WEB = {("default", "web"): ("web-0",)}


class TestPlaneAgainstJax:
    def test_out_of_order_and_duplicates(self):
        pair = PlanePair()
        assert pair.ingest(_cpu_body("web-0", [(1.0, 1000), (2.0, 2000), (3.0, 2000), (4.0, 1500), (5.0, 3000)])) == ("ok", 3)
        assert pair.port.rejected == {port_plane_mod.DUPLICATE: 1, port_plane_mod.OUT_OF_ORDER: 1}
        reasons = ("OUT_OF_ORDER", "DUPLICATE", "SERIES_LIMIT", "BUFFER_OVERFLOW")
        assert [getattr(port_plane_mod, r) for r in reasons] == [getattr(jax_plane_mod, r) for r in reasons]
        pair.assert_same(WEB, [(0.0, 3.0), (1.0, 2.0)])

    def test_nonfinite_tombstones_advance_the_watermark(self):
        pair = PlanePair()
        pair.ingest(build_body([
            (cpu_labels("default", "web-0", "main"), [(1.0, 0), (float("nan"), 60_000), (float("inf"), 120_000)]),
            (mem_labels("default", "web-0", "main"), [(5.0, 0), (-float("inf"), 60_000), (7.0, 120_000)]),
        ]))
        assert pair.port.stats()["tombstones_total"] == 3
        pair.assert_same(WEB, [(0.0, 120.0), (60.0, 120.0), (0.0, 0.0)])

    def test_unroutable_series_rejected(self):
        pair = PlanePair()
        body = build_body([
            ([("__name__", "up"), ("job", "x")], [(1.0, 1000), (1.0, 2000)]),
            (cpu_labels("default", "", "main"), [(1.0, 1000)]),
            ([("__name__", MEM_METRIC), ("job", "node"), ("namespace", "a"), ("pod", "b"), ("container", "c")], [(1.0, 0)]),
        ])
        assert pair.ingest(body) == ("ok", 0)
        assert pair.port.rejected == {"unknown_metric": 2, "missing_labels": 1, "filtered": 1}
        pair.assert_same(WEB, [(0.0, 2.0)])

    def test_series_limit(self):
        pair = PlanePair(max_series=1)
        pair.ingest(_cpu_body("web-0", [(1.0, 1000)]))
        pair.ingest(_cpu_body("web-1", [(1.0, 1000)]))
        pair.ingest(_cpu_body("web-2", []))
        assert pair.port.rejected == {port_plane_mod.SERIES_LIMIT: 2}
        pair.assert_same({("default", "web"): ("web-0", "web-1")}, [(0.0, 1.0)])

    def test_overflow_sheds_oldest_and_stays_honest(self):
        pair = PlanePair(max_samples_per_series=4)
        samples = [(float(i), i * 60_000) for i in range(1, 7)]
        pair.ingest(build_body([
            (cpu_labels("default", "web-0", "main"), samples),
            (mem_labels("default", "web-0", "main"), samples),
        ]))
        assert pair.port.rejected == {port_plane_mod.BUFFER_OVERFLOW: 4}
        pair.assert_same(WEB, [(180.0, 360.0), (120.0, 360.0), (240.0, 300.0)])

    def test_push_ready_needs_both_resources_every_pod(self):
        pair = PlanePair()
        pods = {("default", "web"): ("web-0", "web-1"), ("default", "empty"): ()}
        samples = [(1.0, 0), (1.0, 600_000)]
        windows = [(0.0, 600.0), (0.0, 660.0), (60.0, 600.0)]
        pair.ingest(build_body([(cpu_labels("default", "web-0", "main"), samples),
                                (mem_labels("default", "web-0", "main"), samples)]))
        pair.assert_same(pods, windows)
        pair.ingest(build_body([(cpu_labels("default", "web-1", "main"), samples)]))
        pair.assert_same(pods, windows)
        pair.ingest(build_body([(mem_labels("default", "web-1", "main"), samples)]))
        pair.assert_same(pods, windows)
        jax_objs, port_objs = _objects(pods)
        assert [pair.port.push_ready(o, 0.0, 600.0) for o in port_objs] == [True, True]

    def test_fold_equals_direct_digest_of_both_packages(self):
        pair = PlanePair()
        rng = np.random.default_rng(3)
        cpu, mem = rng.gamma(2.0, 0.05, 11), rng.uniform(5e7, 2e8, 11)
        pair.ingest(build_body([
            (cpu_labels("default", "web-0", "main"), [(float(cpu[i]), i * 60_000) for i in range(11)]),
            (mem_labels("default", "web-0", "main"), [(float(mem[i]), i * 60_000) for i in range(11)]),
        ]))
        pair.assert_same(WEB, [(0.0, 600.0), (30.0, 570.0), (600.0, 1200.0)])
        _, port_objs = _objects(WEB)
        fleet = pair.port.fold_fleet(port_objs, [0], 0.0, 600.0, 60.0, 1.02, 1e-7, 256)
        counts, total, peak = port_native.digest_samples(cpu, 1.02, 1e-7, 256)
        jcounts, jtotal, jpeak = jax_native.digest_samples(cpu, 1.02, 1e-7, 256)
        assert counts.tobytes() == jcounts.tobytes() and (total, peak) == (jtotal, jpeak)
        assert fleet.cpu_counts[0].tobytes() == counts.tobytes()
        assert fleet.cpu_total[0] == total and fleet.cpu_peak[0] == peak
        assert fleet.mem_total[0] == 11.0 and fleet.mem_peak[0] == float(mem.max())

    def test_lookback_drops_stale_grid_points(self):
        pair = PlanePair(lookback_seconds=90.0)
        pair.ingest(build_body([
            (cpu_labels("default", "web-0", "main"), [(1.0, 0), (2.0, 60_000), (3.0, 400_000)]),
            (mem_labels("default", "web-0", "main"), [(9.0, 0), (8.0, 400_000)]),
        ]))
        pair.assert_same(WEB, [(0.0, 420.0), (120.0, 300.0)], fold_params=(30.0, 1.05, 1e-3, 64))

    def test_prune_sheds_history_not_coverage(self):
        pair = PlanePair()
        pair.ingest(_cpu_body("web-0", [(float(i), i * 60_000) for i in range(10)]))
        assert pair.port.prune(300_000) == pair.jax.prune(300_000) == 5
        pair.assert_same(WEB, [(540.0, 540.0), (0.0, 540.0)])
        assert pair.port._series[("cpu", "default", "web-0", "main")].joined_ms == 0

    def test_invalidate_and_freshness(self):
        pair = PlanePair()
        pair.assert_same(WEB, [(0.0, 60.0)])
        pair.ingest(build_body([(cpu_labels("default", "web-0", "main"), [(1.0, 60_000)]),
                                (mem_labels("default", "web-0", "main"), [(1.0, 30_000)])]))
        assert pair.port.freshness_seconds(100.0) == pytest.approx(70.0)
        pair.assert_same(WEB, [(0.0, 60.0)])
        jax_objs, port_objs = _objects(WEB)
        assert pair.port.invalidate_object(port_objs[0]) == pair.jax.invalidate_object(jax_objs[0]) == 2
        pair.assert_same(WEB, [(0.0, 60.0)])

    def test_malformed_body_counted_not_buffered(self):
        pair = PlanePair()
        assert pair.ingest(b"\x0bgarbage-not-snappy-framed") == ("raise", "RemoteWriteError")
        assert pair.ingest(b"\xff\xff\xff\xff\xff garbage") == ("raise", "RemoteWriteTooLarge")
        assert pair.port.stats()["decode_errors_total"] == 2
        pair.assert_same(WEB, [(0.0, 60.0)])

    @pytest.mark.parametrize("seed", range(4))
    def test_seeded_streams_fold_as_jax(self, seed):
        """Seeded bodies over six pods of two workloads plus noise series:
        shuffled, repeated and stale timestamps, NaN and inf values, small
        buffer and series caps, a prune between bodies."""
        rng = np.random.default_rng(100 + seed)
        pair = PlanePair(max_samples_per_series=int(rng.integers(5, 30)), max_series=9,
                         lookback_seconds=float(rng.choice([60.0, 300.0])))
        pods = {("default", "web"): ("web-0", "web-1", "web-2"), ("prod", "db"): ("db-0", "db-1", "db-2")}
        labels = []
        for (namespace, _), names in pods.items():
            for pod in names:
                labels += [cpu_labels(namespace, pod, "main"), mem_labels(namespace, pod, "main")]
        labels += [[("__name__", "up"), ("job", "x")], cpu_labels("default", "", "main")]
        for round_ in range(4):
            series = []
            for label_set in labels:
                if rng.random() < 0.2:
                    continue
                ts = np.sort(rng.integers(round_ * 20, round_ * 20 + 30, int(rng.integers(0, 12)))) * 60_000
                if rng.random() < 0.3:
                    ts = rng.permutation(ts)
                values = rng.gamma(2.0, 0.1, ts.size)
                values[rng.random(ts.size) < 0.1] = float("nan")
                values[rng.random(ts.size) < 0.05] = float("inf")
                series.append((label_set, [(float(v), int(t)) for v, t in zip(values, ts)]))
            pair.ingest(build_body(series))
            pair.assert_same(pods, [(float(a), float(b)) for a, b in (
                (round_ * 1200, round_ * 1200 + 600), (round_ * 1200 + 300, round_ * 1200 + 1500), (0, 60))])
            if round_ == 2:
                assert pair.port.prune(1_800_000) == pair.jax.prune(1_800_000)
        assert pair.port.stats()["samples_total"] > 0


def test_threads_ingesting_and_folding_lose_no_sample():
    """The listener mutates the plane on the event loop while the scheduler
    folds on a worker thread: twelve threads ingesting their own pods' bodies
    and one folding throughout, with a shortened switch interval, end where
    a JAX plane fed the same bodies in order ends."""
    import sys
    import threading

    pods = {("default", "web"): tuple(f"web-{k}" for k in range(12))}
    bodies = {pod: [build_body([(cpu_labels("default", pod, "main"), [(float(r * 10 + i), (r * 10 + i) * 60_000)
                                                                      for i in range(10)]),
                                (mem_labels("default", pod, "main"), [(1.0 + r, r * 600_000)])])
                    for r in range(20)]
              for pod in pods[("default", "web")]}
    pair = PlanePair()
    _, port_objs = _objects(pods)
    stop = threading.Event()
    errors: list = []

    def ingest(pod):
        try:
            for body in bodies[pod]:
                pair.port.ingest_body(body)
        except Exception as e:  # noqa: BLE001 — surfaced below
            errors.append(e)

    def fold():
        try:
            while not stop.is_set():
                pair.port.fold_fleet(port_objs, [0], 0.0, 6_000.0, 60.0, 1.02, 1e-7, 64)
                pair.port.push_ready(port_objs[0], 0.0, 600.0)
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=ingest, args=(pod,)) for pod in bodies]
        folder = threading.Thread(target=fold)
        folder.start()
        for thread in threads:
            thread.start()
        for thread in threads:
            thread.join(timeout=60)
        stop.set()
        folder.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not errors
    assert not folder.is_alive() and not any(thread.is_alive() for thread in threads)
    for pod in bodies:
        for body in bodies[pod]:
            pair.jax.ingest_body(body)
    assert pair.port.stats()["samples_total"] == 12 * 20 * 11
    pair.assert_same(pods, [(0.0, 11_940.0), (600.0, 6_000.0)])


# --------------------------------------------------------- listener protocol
async def _raw_exchange(port: int, raw: bytes) -> bytes:
    """Send ``raw`` on one connection, read until the listener closes it
    (bounded by a timeout)."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(raw)
    await writer.drain()
    if writer.can_write_eof():
        writer.write_eof()
    data = await asyncio.wait_for(reader.read(), timeout=10)
    writer.close()
    return data


def _post(body: bytes, path: str = "/api/v1/write", close: bool = False) -> bytes:
    connection = "Connection: close\r\n" if close else ""
    return f"POST {path} HTTP/1.1\r\nHost: x\r\nContent-Length: {len(body)}\r\n{connection}\r\n".encode() + body


class TestListenerAgainstJax:
    def test_codes_and_keep_alive_equal_jax(self):
        good = _cpu_body("web-0", [(1.0, 1000), (2.0, 2000)])
        exchanges = [
            _post(good),
            _post(good, path="/nope"),
            b"GET /api/v1/write HTTP/1.1\r\nHost: x\r\n\r\n",
            b"POST /api/v1/write HTTP/1.1\r\nHost: x\r\n\r\n",
            b"POST /api/v1/write HTTP/1.1\r\nContent-Length: 999999\r\n\r\n",
            _post(snappy_compress(b"\x99\x98\x97 not protobuf")),
            _post(b"\xff\xff\xff\xff\xff garbage"),
            _post(good) + _post(_cpu_body("web-0", [(3.0, 3000)])),
            _post(good, close=True) + _post(good),
            b"BROKEN\r\n\r\n",
            _post(_cpu_body("web-1", [(1.0, 1000)]), path="/api/v1/write?x=1"),
        ]

        async def run(module, registry_type):
            registry = registry_type()
            plane = module.IngestPlane(metrics=registry)
            listener = module.RemoteWriteListener(plane, host="127.0.0.1", port=0, max_body_bytes=4096,
                                                  metrics=registry)
            await listener.start()
            try:
                responses = [await _raw_exchange(listener.port, raw) for raw in exchanges]
                responses.append(await post_body(listener.port, good))  # still serving
            finally:
                await listener.stop()
            families = {
                (family, code): registry.value(family, **({"code": code} if code else {}))
                for family, codes in (("krr_tpu_ingest_requests_total", ("204", "400", "413", "500")),
                                      ("krr_tpu_ingest_bytes_total", ("",)),
                                      ("krr_tpu_ingest_samples_total", ("",)))
                for code in codes
            }
            return responses, plane.stats(), families

        async def main():
            return await run(jax_ingest, JaxRegistry), await run(port_ingest, PortRegistry)

        (jax_responses, jax_stats, jax_families), (port_responses, port_stats, port_families) = asyncio.run(main())
        assert port_responses == jax_responses
        assert port_stats == jax_stats
        assert port_families == jax_families
        statuses = [r.split(b" ")[1] if isinstance(r, bytes) and r else r for r in port_responses]
        assert statuses[:7] == [b"204", b"404", b"405", b"411", b"413", b"400", b"413"]
        assert port_responses[7].count(b"HTTP/1.1 204") == 2  # keep-alive: both answered
        assert port_responses[8].count(b"HTTP/1.1 204") == 1  # Connection: close honoured
        assert port_responses[-1] == 204


# ----------------------------------------------------- e2e: push serve stack
STORE_FIELDS = ("cpu_counts", "cpu_total", "cpu_peak", "mem_total", "mem_peak")


@pytest.fixture(scope="module")
def fleet_env(tmp_path_factory):
    """One fake apiserver + Prometheus (ranged slicing on) that all three
    serve stacks read: two web pods, one db pod, 3 h on the 60 s grid."""
    cluster = FakeCluster()
    metrics = FakeMetrics()
    metrics.enforce_range = True
    rng = np.random.default_rng(4242)
    for kind, name, namespace, pods, scale in (("Deployment", "web", "default", 2, 0.05),
                                               ("StatefulSet", "db", "prod", 1, 0.2)):
        for pod in cluster.add_workload_with_pods(kind, name, namespace, pod_count=pods):
            metrics.set_series(namespace, "main", pod, cpu=rng.gamma(2.0, scale, 180),
                               memory=rng.uniform(5e7, 4e8, 180))
    server = ServerThread(FakeBackend(cluster, metrics)).start()
    kubeconfig = tmp_path_factory.mktemp("push") / "config"
    kubeconfig.write_text(yaml.dump({
        "current-context": "fake",
        "contexts": [{"name": "fake", "context": {"cluster": "fake", "user": "fake"}}],
        "clusters": [{"name": "fake", "cluster": {"server": server.url}}],
        "users": [{"name": "fake", "user": {"token": "t"}}],
    }))
    yield {"server": server, "metrics": metrics, "kubeconfig": str(kubeconfig)}
    server.stop()


@pytest.fixture
def pinned(monkeypatch):
    """The injected clock, also read by both schedulers' ``time.time()``
    (the snapshot's ``published_at``, the ETag's millisecond stamp)."""
    now = [ORIGIN + 3600.0]
    for module in (jax_scheduler, port_scheduler):
        monkeypatch.setattr(module, "time", types.SimpleNamespace(
            time=lambda: now[0], perf_counter=time.perf_counter, monotonic=time.monotonic,
        ))
    return now


def _settings(env, **overrides) -> dict:
    settings = dict(
        kubeconfig=env["kubeconfig"],
        prometheus_url=env["server"].url,
        strategy="tdigest",
        quiet=True,
        server_port=0,
        prometheus_breaker_cooldown_seconds=0.02,
        hysteresis_enabled=False,
        other_args={"history_duration": 1, "timeframe_duration": 1},
    )
    settings.update(overrides)
    return settings


class Stacks:
    """A port push server, a JAX push server and a port pull control on one
    fleet and one clock."""

    def __init__(self, env, now, **push_overrides):
        self.env, self.now = env, now
        push = _settings(env, metrics_mode="push", ingest_port=0, **push_overrides)
        port_push = json.loads(json.dumps(push))
        port_push["other_args"]["device"] = "cpu"
        control = _settings(env)
        control["other_args"]["device"] = "cpu"
        clock = lambda: now[0]  # noqa: E731
        self.port = port_app.KrrServer(PortConfig(**port_push), clock=clock)
        self.jax = jax_app.KrrServer(JaxConfig(**push), clock=clock)
        self.control = port_app.KrrServer(PortConfig(**control), clock=clock)
        self.servers = (self.port, self.jax, self.control)

    async def start(self) -> None:
        for server in self.servers:
            await server.start(run_scheduler=False)
        assert self.control.ingest is None and self.control.ingest_listener is None

    async def shutdown(self) -> None:
        for server in self.servers:
            await server.shutdown()

    async def push(self, i0: int, i1: int, metrics=None) -> None:
        """The same remote-write body to both push servers' listeners."""
        sender = RemoteWriteSender(metrics or self.env["metrics"])
        for server in (self.port, self.jax):
            assert await sender.push(server.ingest_listener.port, i0, i1) == 204

    async def tick(self, at: float) -> list[int]:
        """One tick on every stack; returns each push server's Prometheus
        request count for its own tick."""
        self.now[0] = at
        requests = []
        for server in self.servers:
            before = self.env["metrics"].request_count
            assert await server.scheduler.tick()
            requests.append(self.env["metrics"].request_count - before)
        jax_ingest_stats = self.jax.scheduler.last_tick_stats["ingest"]
        assert self.port.scheduler.last_tick_stats["ingest"] == jax_ingest_stats
        assert self.control.scheduler.last_tick_stats.get("ingest") is None
        assert (port_build_scan_record(None, self.port.scheduler.last_tick_stats)["ingest"]
                == jax_build_scan_record(None, self.jax.scheduler.last_tick_stats)["ingest"])
        await self.assert_served_equal()
        return requests[:2]

    async def assert_served_equal(self) -> None:
        responses = [await _get(server.port, "/recommendations") for server in self.servers]
        for response in responses:
            assert response.status_code == 200
        for response in responses[1:]:
            assert response.content == responses[0].content
            assert response.headers["etag"] == responses[0].headers["etag"]
            assert response.headers["x-krr-epoch"] == responses[0].headers["x-krr-epoch"]
        for server in self.servers[1:]:
            for field in STORE_FIELDS:
                mine, theirs = getattr(self.port.state.store, field), getattr(server.state.store, field)
                assert mine.dtype == theirs.dtype and mine.tobytes() == theirs.tobytes(), field
        assert self.port.ingest.stats() == self.jax.ingest.stats()

    async def ingest_postures(self) -> list[dict]:
        """/healthz and /statusz ingest blocks of both push servers, the
        listener's (ephemeral) port aside."""
        out = []
        for server in (self.port, self.jax):
            health = (await _get(server.port, "/healthz")).json()["ingest"]
            statusz = (await _get(server.port, "/statusz")).json()["server"]["ingest"]
            assert health["port"] == statusz["port"] == server.ingest_listener.port
            out.append([{k: v for k, v in block.items() if k != "port"} for block in (health, statusz)])
        return out


async def _get(port: int, path: str):
    import httpx

    async with httpx.AsyncClient(base_url=f"http://127.0.0.1:{port}", timeout=30) as client:
        return await client.get(path)


def _default_namespace_only(env) -> FakeMetrics:
    sub = FakeMetrics()
    sub.series = {k: v for k, v in env["metrics"].series.items() if k[0] == "default"}
    return sub


class TestPushServeAgainstJax:
    def test_seed_audit_and_steady_ticks(self, fleet_env, pinned):
        """Seed on the range path; a pushed window folds from the plane and
        audits clean against the range control; the next steady tick folds
        from the plane alone with zero Prometheus requests — all three
        stacks publishing the same bytes."""

        async def main():
            stacks = Stacks(fleet_env, pinned, ingest_verify_interval_seconds=1e9)
            await stacks.start()
            try:
                seed = await stacks.tick(ORIGIN + 3600.0)
                assert seed[0] > 0 and seed[0] == seed[1]
                assert stacks.port.scheduler.last_tick_stats["ingest"]["push_objects"] == 0

                await stacks.push(61, 70)
                audit = await stacks.tick(ORIGIN + 4200.0)
                ingest = stacks.port.scheduler.last_tick_stats["ingest"]
                assert ingest["push_objects"] == 2
                assert ingest["verify"] == {"audited": 2, "divergent": 0}
                assert audit[0] > 0 and audit[0] == audit[1]  # the audit's control round

                await stacks.push(71, 80)
                steady = await stacks.tick(ORIGIN + 4800.0)
                assert steady == [0, 0], "steady-state push tick issued range queries"
                ingest = stacks.port.scheduler.last_tick_stats["ingest"]
                assert ingest["push_objects"] == 2 and ingest["verify"] is None
                assert ingest["rejected"] == {}

                port_posture, jax_posture = await stacks.ingest_postures()
                assert port_posture == jax_posture
                assert port_posture[0]["mode"] == "push" and port_posture[0]["push_objects"] == 2
                control_health = (await _get(stacks.control.port, "/healthz")).json()
                assert control_health["ingest"] == {"mode": "pull"}
                metrics_text = (await _get(stacks.port.port, "/metrics")).text
                for family in ("krr_tpu_ingest_push_objects_total", "krr_tpu_ingest_freshness_seconds",
                               "krr_tpu_ingest_samples_total", "krr_tpu_ingest_verify_total"):
                    assert family in metrics_text
                for family in ("krr_tpu_ingest_push_objects_total", "krr_tpu_ingest_verify_total",
                               "krr_tpu_ingest_samples_total", "krr_tpu_ingest_series",
                               "krr_tpu_ingest_buffered_samples", "krr_tpu_ingest_freshness_seconds"):
                    assert stacks.port.state.metrics.value(family) == stacks.jax.state.metrics.value(family), family
            finally:
                await stacks.shutdown()

        asyncio.run(main())

    def test_gap_falls_back_to_range_as_jax_does(self, fleet_env, pinned):
        """Nothing pushed: every object rides the range legs. One namespace
        pushed: the legs split. Everything pushed again: no range queries."""

        async def main():
            stacks = Stacks(fleet_env, pinned, ingest_verify_interval_seconds=1e9)
            await stacks.start()
            try:
                await stacks.tick(ORIGIN + 3600.0)
                gap = await stacks.tick(ORIGIN + 4200.0)
                assert gap[0] > 0 and gap[0] == gap[1]
                assert stacks.port.scheduler.last_tick_stats["ingest"]["push_objects"] == 0

                await stacks.push(71, 80, metrics=_default_namespace_only(fleet_env))
                partial = await stacks.tick(ORIGIN + 4800.0)
                assert partial[0] > 0 and partial[0] == partial[1]
                assert stacks.port.scheduler.last_tick_stats["ingest"]["push_objects"] == 1

                await stacks.push(81, 90)
                assert await stacks.tick(ORIGIN + 5400.0) == [0, 0]
                assert stacks.port.scheduler.last_tick_stats["ingest"]["push_objects"] == 2
            finally:
                await stacks.shutdown()

        asyncio.run(main())

    def test_audit_counts_and_repairs_as_jax_does(self, fleet_env, pinned):
        """One buffered series poisoned the same way on both push servers:
        each audit counts one divergence, publishes the range ground truth
        and drops the object's buffers, so the next window range-backfills
        it."""

        async def main():
            stacks = Stacks(fleet_env, pinned, ingest_verify_interval_seconds=1e-6)
            await stacks.start()
            try:
                await stacks.tick(ORIGIN + 3600.0)
                await stacks.push(61, 70)
                route = ("cpu", "prod", "db-0", "main")
                for server in (stacks.port, stacks.jax):
                    series = server.ingest._series[route]
                    series.values = [v * 2.0 for v in series.values]
                series_before = stacks.port.ingest.stats()["series"]
                await stacks.tick(ORIGIN + 4200.0)
                ingest = stacks.port.scheduler.last_tick_stats["ingest"]
                assert ingest["verify"] == {"audited": 2, "divergent": 1}
                family = "krr_tpu_ingest_verify_divergences_total"
                assert stacks.port.state.metrics.value(family) == stacks.jax.state.metrics.value(family) == 1
                assert stacks.port.ingest.stats()["series"] == series_before - 2
                assert route not in stacks.port.ingest._series and route not in stacks.jax.ingest._series

                await stacks.push(71, 80, metrics=_default_namespace_only(fleet_env))
                await stacks.tick(ORIGIN + 4800.0)
                assert stacks.port.scheduler.last_tick_stats["ingest"]["push_objects"] == 1
            finally:
                await stacks.shutdown()

        asyncio.run(main())

    def test_rejected_samples_surface_on_both_expositions(self, fleet_env, pinned):
        async def main():
            stacks = Stacks(fleet_env, pinned)
            await stacks.start()
            try:
                body = build_body([
                    (cpu_labels("default", "web-0", "main"), [(1.0, 2_000_000), (1.0, 1_000_000)]),
                    ([("__name__", "up")], [(1.0, 1_000_000)]),
                ])
                texts = []
                for server in (stacks.port, stacks.jax):
                    assert await post_body(server.ingest_listener.port, body) == 204
                    text = (await _get(server.port, "/metrics")).text
                    texts.append(sorted(line for line in text.splitlines()
                                        if line.startswith("krr_tpu_ingest_")))
                assert texts[0] == texts[1]
                assert 'krr_tpu_ingest_rejected_samples_total{reason="out_of_order"} 1' in texts[0]
                assert 'krr_tpu_ingest_rejected_samples_total{reason="unknown_metric"} 1' in texts[0]
            finally:
                await stacks.shutdown()

        asyncio.run(main())
