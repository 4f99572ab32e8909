"""The port's durable digest store held against the JAX package's.

`krr_tpu_torch/core/streaming.py` and `krr_tpu_torch/core/durastore.py` are
copies of the JAX package's modules. Every test here runs the same seeded
operations through both packages and compares what they leave: the resident
arrays exactly, and every file of the state byte for byte (manifest, base
shards, WAL frames with their CRC-32s, the legacy ``.npz``). Recovery is
held the same way: torn WAL tails, bit flips, corrupt bases and the
crash-point matrix of `tests/test_durastore.py` recover to the same state
in either package, and a state written by one package is opened, merged and
saved by the other and read back bit for bit.

``np.savez`` stamps each zip entry with the wall clock (2-second DOS
resolution), so the autouse fixture pins the clock ``zipfile`` reads: two
writes of the same arrays then give the same bytes whenever they run.

Both packages take ``fcntl`` locks on the same lock files, which are per
open file description: the tests never hold one package's lock while the
other opens the same path.
"""

from __future__ import annotations

import json
import os
import struct
import subprocess
import sys
import time
import types
import zipfile

import numpy as np
import pytest

import krr_tpu.core.durastore as jax_durastore
import krr_tpu.core.streaming as jax_streaming
import krr_tpu.models.objects as jax_objects
import krr_tpu.models.series as jax_series
import krr_tpu.ops.digest as jax_digest
import krr_tpu_torch.core.durastore as port_durastore
import krr_tpu_torch.core.streaming as port_streaming
import krr_tpu_torch.models.objects as port_objects
import krr_tpu_torch.models.series as port_series
import krr_tpu_torch.ops.digest as port_digest

from .fakes.chaos import CrashPointFs, FaultyFs, SimulatedCrash

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _package(durastore, streaming, series, digest, objects) -> types.SimpleNamespace:
    return types.SimpleNamespace(
        K8sObjectData=objects.K8sObjectData,
        DurableStore=durastore.DurableStore,
        DigestStore=streaming.DigestStore,
        FsOps=streaming.FsOps,
        FS=streaming.FS,
        atomic_write=streaming.atomic_write,
        durastore=durastore,
        streaming=streaming,
        DigestedFleet=series.DigestedFleet,
        spec=digest.DigestSpec(gamma=1.01, min_value=1e-7, num_buckets=64),
        DigestSpec=digest.DigestSpec,
    )


PKGS = {
    "jax": _package(jax_durastore, jax_streaming, jax_series, jax_digest, jax_objects),
    "port": _package(port_durastore, port_streaming, port_series, port_digest, port_objects),
}
PAIRS = [("jax", "port"), ("port", "jax"), ("port", "port")]
FIELDS = ("cpu_counts", "cpu_total", "cpu_peak", "mem_total", "mem_peak")


#: ``zipfile``'s view of the ``time`` module, with a fixed wall clock.
PINNED_CLOCK = types.SimpleNamespace(time=lambda: 1_700_000_000.0, localtime=time.localtime)


@pytest.fixture(autouse=True)
def pinned_zip_clock(monkeypatch):
    monkeypatch.setattr(zipfile, "time", PINNED_CLOCK)


# ---------------------------------------------------------------- helpers
def window(keys: "list[str]", seed: int, num_buckets: int = 64) -> tuple:
    """One seeded sparse window (counts, totals, peaks, memory totals and
    peaks) for ``keys``, as a real delta tick contributes."""
    rng = np.random.default_rng(seed)
    n = len(keys)
    counts = np.zeros((n, num_buckets), np.float32)
    occupied = rng.integers(0, num_buckets, size=(n, 4))
    for i in range(n):
        counts[i, occupied[i]] += rng.integers(1, 5, size=4)
    return (
        counts,
        counts.sum(axis=1),
        rng.gamma(2.0, 0.3, n).astype(np.float32),
        counts.sum(axis=1),
        rng.uniform(50, 400, n).astype(np.float32),
    )


def fold_window(store, keys: "list[str]", seed: int):
    return store.merge_window(keys, *window(keys, seed, store.spec.num_buckets))


def snapshot(store) -> dict:
    return {
        "keys": list(store.keys),
        **{f: getattr(store, f).copy() for f in FIELDS},
        "extra": dict(store.extra_meta),
    }


def assert_matches(store, snap: dict) -> None:
    assert list(store.keys) == snap["keys"]
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(store, f), snap[f], err_msg=f)
    assert store.extra_meta == snap["extra"]


def files(path: str) -> "dict[str, bytes]":
    """Every file under ``path`` (a state directory or one legacy file) by
    relative name → bytes."""
    if os.path.isfile(path):
        return {"": open(path, "rb").read()}
    out = {}
    for root, _dirs, names in os.walk(path):
        for name in names:
            full = os.path.join(root, name)
            out[os.path.relpath(full, path)] = open(full, "rb").read()
    return out


def assert_same_files(a: str, b: str) -> None:
    fa, fb = files(a), files(b)
    assert sorted(fa) == sorted(fb)
    for name in fa:
        assert fa[name] == fb[name], name


def wal_offsets(blob: bytes, magic: bytes) -> "list[int]":
    """End offsets of the WAL's records, parsed independently of either
    package: ``[u32 LE len][u32 LE crc][payload]`` frames after the magic."""
    offsets = [len(magic)]
    pos = len(magic)
    while pos < len(blob):
        length, _crc = struct.unpack_from("<II", blob, pos)
        pos += 8 + length
        offsets.append(pos)
    return offsets


def build_ticks(pkg, path: str, ticks: int = 5, *, compact_min_bytes: int = 1 << 30) -> "list[dict]":
    """``ticks`` delta records (compaction held off); the per-epoch
    snapshots, the epoch-0 base first."""
    durable = pkg.DurableStore.open(path, pkg.spec, shard_rows=3, compact_min_bytes=compact_min_bytes)
    snaps = [snapshot(durable.store)]
    for t in range(ticks):
        fold_window(durable.store, [f"w{i}" for i in range(t + 2)], seed=t)
        durable.store.extra_meta["serve_last_end"] = 1000.0 + t
        durable.save_delta()
        snaps.append(snapshot(durable.store))
    durable.close()
    return snaps


def wal_path(pkg, path: str) -> str:
    manifest = json.load(open(os.path.join(path, pkg.durastore.MANIFEST_NAME)))
    return os.path.join(path, manifest["wal"])


# ------------------------------------------------ same operations, same bytes
def _ticks(pkg, path):
    build_ticks(pkg, path, ticks=5)


def _elided_whole_store_folds(pkg, path):
    durable = pkg.DurableStore.open(path, pkg.spec, shard_rows=3, compact_min_bytes=1 << 30)
    for t in range(3):  # the first grows (keys carried), then seasoned folds elide them
        fold_window(durable.store, ["a", "b", "c"], seed=t)
        durable.save_delta()
    durable.close()


def _drop_and_grow(pkg, path):
    durable = pkg.DurableStore.open(path, pkg.spec, shard_rows=2, compact_min_bytes=1 << 30)
    fold_window(durable.store, ["a", "b", "c", "d"], seed=1)
    durable.save_delta()
    durable.store.compact({"a", "c"})
    durable.store.rows_for(["e"])
    durable.save_delta()
    durable.close()


def _forced_compaction(pkg, path):
    build_ticks(pkg, path, ticks=4)
    durable = pkg.DurableStore.open(path, pkg.spec, shard_rows=2)
    assert durable.maybe_compact(force=True)
    durable.close()


def _threshold_compaction(pkg, path):
    durable = pkg.DurableStore.open(path, pkg.spec, shard_rows=4, compact_min_bytes=1, compact_wal_ratio=0.01)
    fold_window(durable.store, ["a", "b"], seed=0)
    durable.save_delta()
    fold_window(durable.store, ["b", "c"], seed=1)
    durable.save_delta()
    durable.close()


def _backlog_after_enospc(pkg, path):
    durable = pkg.DurableStore.open(path, pkg.spec, shard_rows=3, compact_min_bytes=1 << 30)
    fold_window(durable.store, ["a", "b"], seed=0)
    durable.save_delta()
    durable.fs = FaultyFs(("append", "fsync"))
    for t in (1, 2):
        fold_window(durable.store, ["a", "b"], seed=t)
        durable.store.extra_meta["serve_last_end"] = 100.0 + t
        with pytest.raises(OSError):
            durable.save_delta()
    durable.store.compact_pending()
    assert [op[0] for op in durable.store.pending_ops()] == ["fold_csr", "fold_csr"]
    durable.fs = pkg.FS
    durable.save_delta()
    durable.close()


def _partial_append(pkg, path):
    durable = pkg.DurableStore.open(path, pkg.spec, shard_rows=3, compact_min_bytes=1 << 30)
    fold_window(durable.store, ["a"], seed=0)
    durable.save_delta()

    class HalfWriteFs(pkg.FsOps):
        def append(self, f, data: bytes) -> None:
            f.write(data[: len(data) // 2])
            raise OSError(28, "No space left on device")

    durable.fs = HalfWriteFs()
    fold_window(durable.store, ["a"], seed=1)
    with pytest.raises(OSError):
        durable.save_delta()
    durable.fs = pkg.FS
    durable.save_delta()
    durable.close()


def _fold_fleet(pkg, path):
    durable = pkg.DurableStore.open(path, pkg.spec, shard_rows=2, compact_min_bytes=1 << 30)
    rng = np.random.default_rng(4)
    objects = [
        pkg.K8sObjectData(
            cluster="c" if i % 2 else None, name=f"w{i}", container="main", pods=[f"w{i}-0"],
            namespace="ns", kind="Deployment", allocations={"requests": {}, "limits": {}},
        )
        for i in range(5)
    ]
    fleet = pkg.DigestedFleet.empty(objects, pkg.spec.gamma, pkg.spec.min_value, pkg.spec.num_buckets)
    fleet.cpu_counts[:4] = rng.integers(0, 3, (4, pkg.spec.num_buckets))  # row 4 stays empty
    fleet.cpu_total[:] = fleet.cpu_counts.sum(axis=1)
    fleet.cpu_peak[:4] = rng.gamma(2.0, 0.3, 4)
    fleet.mem_total[:4] = rng.integers(1, 50, 4)
    fleet.mem_peak[:4] = rng.uniform(5e7, 4e8, 4)
    for _ in range(2):
        rows = durable.store.fold_fleet(fleet, mem_scale=1_000_000)
        durable.store.query_recommendation(rows, 95.0)
        durable.save_delta()
    durable.close()


def _legacy_rewrites(pkg, path):
    path = path + ".npz"
    for t in range(2):
        durable = pkg.DurableStore.open(path, pkg.spec, store_format="legacy")
        fold_window(durable.store, ["a", "b", "c"][: t + 2], seed=10 + t)
        durable.store.extra_meta = {"serve_last_end": 777.0 + t}
        durable.save_delta()
        durable.close()


def _legacy_migration(pkg, path):
    path = path + ".npz"
    store = pkg.DigestStore(spec=pkg.spec, keys=["a", "b", "c"])
    fold_window(store, ["a", "b", "c"], seed=9)
    store.extra_meta = {"serve_last_end": 777.0, "serve_quarantine": {"a": 1.0}}
    store.save(path)
    durable = pkg.DurableStore.open(path, pkg.spec, shard_rows=2)
    fold_window(durable.store, ["b", "d"], seed=3)
    durable.save_delta()
    durable.close()


SCENARIOS = {
    "ticks": _ticks,
    "elided_whole_store_folds": _elided_whole_store_folds,
    "drop_and_grow": _drop_and_grow,
    "forced_compaction": _forced_compaction,
    "threshold_compaction": _threshold_compaction,
    "backlog_after_enospc": _backlog_after_enospc,
    "partial_append": _partial_append,
    "fold_fleet": _fold_fleet,
    "legacy_rewrites": _legacy_rewrites,
    "legacy_migration": _legacy_migration,
}


def _state_path(path: str) -> str:
    return path + ".npz" if os.path.exists(path + ".npz") else path


class TestSameOperations:
    @pytest.mark.parametrize("scenario", sorted(SCENARIOS))
    def test_equal_arrays_and_byte_identical_files(self, tmp_path, scenario):
        paths = {}
        for name, pkg in PKGS.items():
            paths[name] = str(tmp_path / name / "state")
            os.makedirs(os.path.dirname(paths[name]))
            SCENARIOS[scenario](pkg, paths[name])
        jax_path, port_path = _state_path(paths["jax"]), _state_path(paths["port"])
        assert_same_files(jax_path, port_path)
        fmt = "legacy" if scenario == "legacy_rewrites" else "sharded"
        reopened = {
            name: PKGS[name].DurableStore.open(p, PKGS[name].spec, store_format=fmt)
            for name, p in (("jax", jax_path), ("port", port_path))
        }
        try:
            assert reopened["port"].epoch == reopened["jax"].epoch
            assert_matches(reopened["port"].store, snapshot(reopened["jax"].store))
        finally:
            for durable in reopened.values():
                durable.close()

    def test_fs_op_sequences_match(self, tmp_path):
        """A persist and a compaction issue the same fs operations, in the
        same order, in both packages — so the crash-point matrix below
        crashes both at the same boundaries."""

        class RecordingFs:
            def __init__(self, fs):
                self.fs, self.ops = fs, []

            def __getattr__(self, name):
                method = getattr(self.fs, name)

                def record(*args):
                    self.ops.append(name)
                    return method(*args)

                return record

        sequences = {}
        for name, pkg in PKGS.items():
            path = str(tmp_path / name)
            build_ticks(pkg, path, ticks=2)
            recorder = RecordingFs(pkg.FS)
            durable = pkg.DurableStore.open(path, pkg.spec, shard_rows=2, fs=recorder, compact_min_bytes=1 << 30)
            fold_window(durable.store, ["a", "w0"], seed=7)
            durable.save_delta()
            durable.maybe_compact(force=True)
            durable.close()
            sequences[name] = recorder.ops
        assert sequences["port"] == sequences["jax"]
        assert sequences["port"].count("fsync") >= 3

    def test_wal_record_codec(self):
        """``encode_ops`` gives the JAX bytes for every op kind, and each
        package decodes the other's record to the same parsed ops."""
        rng = np.random.default_rng(2)
        counts = np.zeros((3, 64), np.float32)
        counts[rng.integers(0, 3, 20), rng.integers(0, 64, 20)] = rng.integers(1, 9, 20)
        peaks = rng.gamma(2.0, 0.3, 3).astype(np.float32)
        mem = rng.uniform(50, 400, 3).astype(np.float32)
        ops = [
            ("fold", ["a", "b", "c"], counts, counts.sum(1), peaks, counts.sum(1), mem),
            ("grow", ["d"]),
            ("drop", ["b"]),
        ]
        encoded = {
            name: pkg.durastore.encode_ops(ops, epoch=7, extra={"serve_last_end": 1.5}, num_buckets=64)
            for name, pkg in PKGS.items()
        }
        assert encoded["port"] == encoded["jax"]
        for reader in PKGS.values():
            meta, parsed = reader.durastore.decode_ops(encoded["jax"])
            assert meta["epoch"] == 7 and meta["extra"] == {"serve_last_end": 1.5}
            stores = {}
            for name, pkg in PKGS.items():
                store = pkg.DigestStore(spec=pkg.spec, keys=["a", "b", "c"])
                pkg.durastore.apply_ops(store, parsed)
                stores[name] = store
            assert_matches(stores["port"], snapshot(stores["jax"]))


# ------------------------------------------------------ across the packages
class TestAcrossPackages:
    @pytest.mark.parametrize("fmt", ["sharded", "legacy"])
    @pytest.mark.parametrize("first,second", [("jax", "port"), ("port", "jax")])
    def test_one_writes_other_merges_first_reads_back(self, tmp_path, fmt, first, second):
        """``first`` writes a state, ``second`` opens, merges and saves it,
        ``first`` reads it back: the arrays and files equal those of a
        control that ``first`` drove alone."""
        a, b = PKGS[first], PKGS[second]

        def drive(path, middle):
            for t, pkg in enumerate((a, middle, a)):
                durable = pkg.DurableStore.open(path, pkg.spec, store_format=fmt, shard_rows=2)
                fold_window(durable.store, ["x", "y", "z"][: t + 1] + ["w"], seed=20 + t)
                durable.store.extra_meta["serve_last_end"] = 50.0 + t
                durable.save_delta()
                if t == 1 and fmt == "sharded":
                    durable.maybe_compact(force=True)
                durable.close()
            final = a.DurableStore.open(path, a.spec, store_format=fmt, shard_rows=2)
            final.close()
            return snapshot(final.store)

        mixed = drive(str(tmp_path / "mixed"), b)
        control = drive(str(tmp_path / "control"), a)
        for snap in (mixed, control):
            assert snap["keys"] == ["x", "w", "y", "z"]
        assert_matches_snap(mixed, control)
        assert_same_files(str(tmp_path / "mixed"), str(tmp_path / "control"))

    @pytest.mark.parametrize("writer,reader", PAIRS)
    def test_open_or_create_reads_the_other_packages_directory(self, tmp_path, writer, reader):
        path = str(tmp_path / "state")
        snaps = build_ticks(PKGS[writer], path, ticks=2)
        store = PKGS[reader].DigestStore.open_or_create(path, PKGS[reader].spec)
        assert_matches(store, snaps[-1])
        assert store.track_deltas is False

    @pytest.mark.parametrize("writer,reader", PAIRS)
    def test_query_recommendation_equal(self, tmp_path, writer, reader):
        path = str(tmp_path / "state")
        build_ticks(PKGS[writer], path, ticks=3)
        answers = []
        for pkg in (PKGS[writer], PKGS[reader]):
            durable = pkg.DurableStore.open(path, pkg.spec)
            rows = durable.store.rows_for(["w0", "w2", "w3", "nope"])
            answers.append(durable.store.query_recommendation(rows, 95.0))
            durable.close()
        for got, want in zip(answers[1], answers[0]):
            np.testing.assert_array_equal(got, want)


def assert_matches_snap(a: dict, b: dict) -> None:
    assert a["keys"] == b["keys"] and a["extra"] == b["extra"]
    for f in FIELDS:
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)


# ---------------------------------------------------------------- recovery
class TestTornTails:
    @pytest.mark.parametrize("writer,reader", PAIRS)
    def test_cut_at_sampled_offsets_recovers_last_valid_record(self, tmp_path, writer, reader):
        path = str(tmp_path / "state")
        snaps = build_ticks(PKGS[writer], path, ticks=5)
        wal = wal_path(PKGS[writer], path)
        blob = open(wal, "rb").read()
        magic = PKGS[reader].durastore.WAL_MAGIC
        offsets = wal_offsets(blob, magic)
        assert len(offsets) == 6
        cuts = set()
        for end in offsets:
            cuts.update({end, end - 1, end + 1, end + 4})
        cuts.update(int(c) for c in np.random.default_rng(3).integers(len(magic), len(blob), 8))
        for cut in sorted(c for c in cuts if len(magic) <= c <= len(blob)):
            with open(wal, "wb") as f:
                f.write(blob[:cut])
            survivors = sum(1 for end in offsets[1:] if end <= cut)
            durable = PKGS[reader].DurableStore.open(path, PKGS[reader].spec, shard_rows=3)
            assert durable.epoch == survivors, f"cut at {cut}"
            assert_matches(durable.store, snaps[survivors])
            assert os.path.getsize(wal) == offsets[survivors]
            durable.close()

    @pytest.mark.parametrize("writer,reader", PAIRS)
    def test_bitflips_truncate_from_corrupt_record(self, tmp_path, writer, reader):
        path = str(tmp_path / "state")
        snaps = build_ticks(PKGS[writer], path, ticks=4)
        wal = wal_path(PKGS[writer], path)
        blob = open(wal, "rb").read()
        magic = PKGS[reader].durastore.WAL_MAGIC
        offsets = wal_offsets(blob, magic)
        for flip in sorted(int(x) for x in np.random.default_rng(5).integers(len(magic), len(blob), 6)):
            corrupted = bytearray(blob)
            corrupted[flip] ^= 0x40
            with open(wal, "wb") as f:
                f.write(corrupted)
            survivors = sum(1 for end in offsets[1:] if end <= flip)
            durable = PKGS[reader].DurableStore.open(path, PKGS[reader].spec, shard_rows=3)
            assert durable.epoch == survivors, f"flip at {flip}"
            assert_matches(durable.store, snaps[survivors])
            durable.close()
            with open(wal, "wb") as f:
                f.write(blob)

    @pytest.mark.parametrize("writer,reader", PAIRS)
    def test_flipped_wal_header_resets_to_base(self, tmp_path, writer, reader):
        path = str(tmp_path / "state")
        snaps = build_ticks(PKGS[writer], path, ticks=3)
        wal = wal_path(PKGS[writer], path)
        blob = bytearray(open(wal, "rb").read())
        blob[2] ^= 0xFF
        with open(wal, "wb") as f:
            f.write(blob)
        durable = PKGS[reader].DurableStore.open(path, PKGS[reader].spec, shard_rows=3)
        assert durable.epoch == 0
        assert_matches(durable.store, snaps[0])
        durable.close()


class TestCorruptBases:
    def _compacted(self, writer, path):
        build_ticks(PKGS[writer], path, ticks=2)
        durable = PKGS[writer].DurableStore.open(path, PKGS[writer].spec, shard_rows=2)
        durable.maybe_compact(force=True)
        shard = durable._shards[0]["file"]
        durable.close()
        return shard

    @pytest.mark.parametrize("writer,reader", PAIRS)
    def test_corrupt_shard_fails_loudly_naming_the_file(self, tmp_path, writer, reader):
        path = str(tmp_path / "state")
        shard = self._compacted(writer, path)
        shard_path = os.path.join(path, shard)
        blob = bytearray(open(shard_path, "rb").read())
        blob[len(blob) // 2] ^= 0xFF
        with open(shard_path, "wb") as f:
            f.write(blob)
        with pytest.raises(ValueError, match=f"(?s){shard}.*checksum"):
            PKGS[reader].DurableStore.open(path, PKGS[reader].spec, shard_rows=2)

    @pytest.mark.parametrize("writer,reader", PAIRS)
    def test_missing_shard_fails_loudly(self, tmp_path, writer, reader):
        path = str(tmp_path / "state")
        shard = self._compacted(writer, path)
        os.unlink(os.path.join(path, shard))
        with pytest.raises(ValueError, match=shard):
            PKGS[reader].DurableStore.open(path, PKGS[reader].spec, shard_rows=2)

    @pytest.mark.parametrize("writer,reader", PAIRS)
    def test_corrupt_manifest_fails_loudly(self, tmp_path, writer, reader):
        path = str(tmp_path / "state")
        build_ticks(PKGS[writer], path, ticks=1)
        with open(os.path.join(path, PKGS[reader].durastore.MANIFEST_NAME), "w") as f:
            f.write("{not json")
        with pytest.raises(ValueError, match="manifest"):
            PKGS[reader].DurableStore.open(path, PKGS[reader].spec)

    @pytest.mark.parametrize("writer,reader", PAIRS)
    def test_spec_mismatch_fails(self, tmp_path, writer, reader):
        path = str(tmp_path / "state")
        build_ticks(PKGS[writer], path, ticks=1)
        other = PKGS[reader].DigestSpec(gamma=1.02, min_value=1e-7, num_buckets=64)
        with pytest.raises(ValueError, match="incompatible"):
            PKGS[reader].DurableStore.open(path, other)


class TestCrashPointMatrix:
    @pytest.mark.parametrize("writer,reader", PAIRS)
    def test_crash_at_every_fs_op_in_a_persist_recovers_durably(self, tmp_path, writer, reader):
        """``writer`` crashes at every fs-op boundary inside a persist;
        ``reader`` recovers the pre- or the post-persist state, never
        anything else, and persists again."""
        w, r = PKGS[writer], PKGS[reader]
        counter = CrashPointFs(crash_at=None)
        durable = w.DurableStore.open(str(tmp_path / "probe"), w.spec, shard_rows=3, fs=counter,
                                      compact_min_bytes=1 << 30)
        fold_window(durable.store, ["a", "b"], seed=0)
        before = counter.calls
        durable.save_delta()
        ops_per_persist = counter.calls - before
        durable.close()
        assert ops_per_persist >= 2
        for crash_at in range(ops_per_persist):
            path = str(tmp_path / f"crash-{crash_at}")
            durable = w.DurableStore.open(path, w.spec, shard_rows=3, compact_min_bytes=1 << 30)
            fold_window(durable.store, ["a", "b"], seed=1)
            durable.store.extra_meta["serve_last_end"] = 111.0
            durable.save_delta()
            pre, pre_epoch = snapshot(durable.store), durable.epoch
            fold_window(durable.store, ["a", "b", "c"], seed=2)
            durable.store.extra_meta["serve_last_end"] = 222.0
            post = snapshot(durable.store)
            durable.fs = CrashPointFs(crash_at=crash_at)
            with pytest.raises(SimulatedCrash):
                durable.save_delta()
            durable.close()
            recovered = r.DurableStore.open(path, r.spec, shard_rows=3)
            assert recovered.epoch in (pre_epoch, pre_epoch + 1), f"crash at {crash_at}"
            assert_matches(recovered.store, pre if recovered.epoch == pre_epoch else post)
            fold_window(recovered.store, ["a", "b", "c"], seed=3)
            recovered.save_delta()
            recovered.close()

    @pytest.mark.parametrize("writer,reader", PAIRS)
    def test_crash_at_every_fs_op_in_a_compaction_preserves_state(self, tmp_path, writer, reader):
        w, r = PKGS[writer], PKGS[reader]
        build_ticks(w, str(tmp_path / "probe"), ticks=3)
        counter = CrashPointFs(crash_at=None)
        durable = w.DurableStore.open(str(tmp_path / "probe"), w.spec, shard_rows=2, fs=counter)
        before = counter.calls
        durable.maybe_compact(force=True)
        ops_per_compact = counter.calls - before
        durable.close()
        assert ops_per_compact >= 5
        for crash_at in range(ops_per_compact):
            path = str(tmp_path / f"compact-crash-{crash_at}")
            snaps = build_ticks(w, path, ticks=3)
            durable = w.DurableStore.open(path, w.spec, shard_rows=2)
            durable.fs = CrashPointFs(crash_at=crash_at)
            with pytest.raises(SimulatedCrash):
                durable.maybe_compact(force=True)
            durable.close()
            recovered = r.DurableStore.open(path, r.spec, shard_rows=2)
            assert_matches(recovered.store, snaps[-1])
            assert recovered.epoch == 3, f"crash at {crash_at}"
            recovered.close()


class TestFaults:
    def test_wal_unlinked_by_another_process_fails_loudly(self, tmp_path):
        pkg = PKGS["port"]
        path = str(tmp_path / "state")
        build_ticks(pkg, path, ticks=2)
        owner = pkg.DurableStore.open(path, pkg.spec, shard_rows=3, compact_min_bytes=1 << 30)
        intruder = PKGS["jax"].DurableStore.open(path, PKGS["jax"].spec, shard_rows=3)
        intruder.maybe_compact(force=True)
        intruder.close()
        fold_window(owner.store, ["a"], seed=0)
        with pytest.raises(OSError, match="exclusively owned"):
            owner.save_delta()
        assert owner.store.pending_ops()
        owner.close()

    def test_interrupted_migration_resumes_from_sidecar(self, tmp_path):
        path = str(tmp_path / "state.npz")
        jax = PKGS["jax"]
        store = jax.DigestStore(spec=jax.spec, keys=["a", "b", "c"])
        fold_window(store, ["a", "b", "c"], seed=9)
        store.save(path)
        legacy = snapshot(store)
        os.replace(path, path + ".migrating")
        os.makedirs(path)
        with open(os.path.join(path, "base-00000000-0000.npz"), "wb") as f:
            f.write(b"partial")
        durable = PKGS["port"].DurableStore.open(path, PKGS["port"].spec, shard_rows=2)
        assert_matches(durable.store, legacy)
        assert not os.path.exists(path + ".migrating")
        durable.close()

    def test_legacy_flag_refuses_a_directory(self, tmp_path):
        path = str(tmp_path / "dir-state")
        PKGS["jax"].DurableStore.open(path, PKGS["jax"].spec).close()
        with pytest.raises(ValueError, match="store_format legacy"):
            PKGS["port"].DurableStore.open(path, PKGS["port"].spec, store_format="legacy")


class TestHygiene:
    def test_sweep_removes_stale_tmp_and_unreferenced_files(self, tmp_path):
        pkg = PKGS["port"]
        path = str(tmp_path / "state")
        build_ticks(PKGS["jax"], path, ticks=1)
        for stray in ("leftover.tmp", "base-99999999-0000.npz", "wal-99999999.log"):
            with open(os.path.join(path, stray), "wb") as f:
                f.write(b"junk")
        with open(os.path.join(path, "operator-notes.txt"), "w") as f:
            f.write("keep me")
        pkg.DurableStore.open(path, pkg.spec).close()
        remaining = set(os.listdir(path))
        assert not {"leftover.tmp", "base-99999999-0000.npz", "wal-99999999.log"} & remaining
        assert "operator-notes.txt" in remaining

    def test_locked_removes_lock_file(self, tmp_path):
        path = str(tmp_path / "state.npz")
        with PKGS["port"].DigestStore.locked(path):
            assert os.path.exists(path + ".lock")
        assert not os.path.exists(path + ".lock")

    def test_atomic_write_fsyncs_file_then_renames_then_fsyncs_dir(self, tmp_path):
        pkg = PKGS["port"]
        events: list = []

        class RecordingFs(pkg.FsOps):
            def fsync(self, f):
                events.append(("fsync",))
                super().fsync(f)

            def replace(self, src, dst):
                events.append(("replace", dst))
                super().replace(src, dst)

            def fsync_dir(self, path):
                events.append(("fsync_dir", path))
                super().fsync_dir(path)

        target = str(tmp_path / "out.bin")
        with pkg.atomic_write(target, fs=RecordingFs()) as f:
            f.write(b"payload")
        assert [e[0] for e in events] == ["fsync", "replace", "fsync_dir"]
        assert events[1][1] == target and events[2][1] == str(tmp_path)

    @pytest.mark.parametrize(
        "key",
        ["c/ns/w/main/Deployment", "/ns/w/main/", "arn:aws:eks:r:1:cluster/prod/ns/w/main/Job", "w/main"],
    )
    def test_object_key_grammar(self, key):
        assert port_streaming.split_object_key(key) == jax_streaming.split_object_key(key)
        keys = [key, "c/other/w/main/Deployment"]
        for filters in ({"namespaces": {"ns"}}, {"workloads": {"w"}}, {"containers": {"main"}}, {}):
            assert port_streaming.filter_key_indices(keys, **filters) == jax_streaming.filter_key_indices(
                keys, **filters
            )

    def test_new_modules_import_neither_jax_nor_the_jax_package(self):
        """The slice's modules, imported alone in a fresh interpreter, pull
        in no ``jax*`` and no ``krr_tpu.*`` module."""
        modules = [
            "krr_tpu_torch.core.streaming", "krr_tpu_torch.core.durastore", "krr_tpu_torch.core.pipeline",
            "krr_tpu_torch.core.runner", "krr_tpu_torch.models.series", "krr_tpu_torch.strategies.tdigest",
            "krr_tpu_torch.integrations.native", "krr_tpu_torch.integrations.prometheus",
            "krr_tpu_torch.integrations.kubernetes",
        ]
        code = (
            "import importlib, sys\n"
            f"for name in {modules!r}:\n"
            "    importlib.import_module(name)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'krr_tpu'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n"
        )
        proc = subprocess.run(
            [sys.executable, "-c", code], cwd=REPO, env={**os.environ, "PYTHONPATH": REPO},
            capture_output=True, text=True, timeout=120,
        )
        assert proc.returncode == 0, proc.stdout + proc.stderr
