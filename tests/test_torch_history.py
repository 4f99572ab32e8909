"""The port's history plane and flight recorder against the JAX package's.

The same operations run through both packages' copies — the hysteresis
gate, the recommendation journal, drift, the journal savings block, the
scan timeline and the regression sentinel — on the same seeded inputs; the
decisions, reports and files must be equal, and each package must read the
files the other wrote, torn tails and bit flips included. No wall clock is
involved: the synthetic timelines carry their own timestamps.
"""

from __future__ import annotations

import copy
import os
import types

import numpy as np
import pytest

import krr_tpu.eval.score as jax_score
import krr_tpu.history.diff as jax_diff
import krr_tpu.history.drift as jax_drift
import krr_tpu.history.journal as jax_journal
import krr_tpu.history.policy as jax_policy
import krr_tpu.obs.sentinel as jax_sentinel
import krr_tpu.obs.timeline as jax_timeline
import krr_tpu_torch.eval.score as port_score
import krr_tpu_torch.history.diff as port_diff
import krr_tpu_torch.history.drift as port_drift
import krr_tpu_torch.history.journal as port_journal
import krr_tpu_torch.history.policy as port_policy
import krr_tpu_torch.obs.sentinel as port_sentinel
import krr_tpu_torch.obs.timeline as port_timeline

PACKAGES = {
    "jax": types.SimpleNamespace(
        journal=jax_journal, policy=jax_policy, drift=jax_drift, score=jax_score,
        diff=jax_diff, timeline=jax_timeline, sentinel=jax_sentinel,
    ),
    "port": types.SimpleNamespace(
        journal=port_journal, policy=port_policy, drift=port_drift, score=port_score,
        diff=port_diff, timeline=port_timeline, sentinel=port_sentinel,
    ),
}
ORDERS = [("jax", "port"), ("port", "jax")]
KEYS = [f"c/ns{i % 3}/wl{i}/main/Deployment" for i in range(7)]
T0 = 1_700_000_000.0


def raw_series(ticks: int, seed: int = 5) -> "list[tuple[np.ndarray, np.ndarray]]":
    """Per-tick raw (cpu, mem) recommendations: a stationary wiggle, a
    regime change at tick 6, NaN holes and a flapping workload."""
    rng = np.random.default_rng(seed)
    base_cpu = rng.uniform(0.05, 2.0, len(KEYS))
    base_mem = rng.uniform(50.0, 900.0, len(KEYS))
    out = []
    for t in range(ticks):
        cpu = (base_cpu * rng.uniform(0.98, 1.02, len(KEYS))).astype(np.float32)
        mem = (base_mem * rng.uniform(0.99, 1.01, len(KEYS))).astype(np.float32)
        if t >= 6:
            cpu[1] *= 1.5
            mem[2] *= 0.6
        if t % 2:
            cpu[3] *= 1.3  # flaps in and out of the band
        if t == 4:
            cpu[4] = np.nan
        if t in (2, 3):
            mem[5] = np.nan
        out.append((cpu, mem))
    return out


def gate_run(pkg, ticks: int = 12, **knobs) -> list:
    gate = pkg.policy.HysteresisGate(**knobs)
    decisions = []
    keys = list(KEYS)
    for t, (cpu, mem) in enumerate(raw_series(ticks)):
        if t == 8:  # churn: one workload leaves, one arrives
            keys = keys[1:] + ["c/ns9/new/main/Deployment"]
        decision = gate.observe(keys, cpu, mem)
        decisions.append(
            {name: np.asarray(getattr(decision, name)).copy()
             for name in ("cpu", "mem", "published", "changed", "suppressed")}
        )
    return decisions


def journal_run(pkg, path, ticks: int = 12, *, retention: float = 7 * 24 * 3600.0, epochs: bool = True):
    """Gate every tick and journal it, as the scheduler does."""
    gate = pkg.policy.HysteresisGate()
    journal = pkg.journal.RecommendationJournal(path, retention_seconds=retention)
    for t, (cpu, mem) in enumerate(raw_series(ticks)):
        decision = gate.observe(KEYS, cpu, mem)
        ts = T0 + 900.0 * t
        journal.append_tick(ts, KEYS, cpu, mem, decision.published, epoch=t + 1 if epochs else None)
        journal.compact(ts)
    return journal


def read_file(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def assert_records_equal(a, b) -> None:
    ra, rb = a.records(), b.records()
    assert ra.dtype == rb.dtype and len(ra) == len(rb)
    assert ra.tobytes() == rb.tobytes()


# ---------------------------------------------------------------- the gate
class TestGate:
    @pytest.mark.parametrize("knobs", [
        {}, {"dead_band_pct": 10.0, "confirm_ticks": 3}, {"dead_band_pct": 0.0, "confirm_ticks": 1},
        {"enabled": False},
    ], ids=["default", "wide", "tight", "disabled"])
    def test_decisions_equal(self, knobs):
        jax_run, port_run = gate_run(PACKAGES["jax"], **knobs), gate_run(PACKAGES["port"], **knobs)
        for a, b in zip(jax_run, port_run):
            for name in a:
                assert a[name].dtype == b[name].dtype
                assert a[name].tobytes() == b[name].tobytes(), name

    def test_seeded_gate_equal(self):
        decisions = []
        for pkg in PACKAGES.values():
            gate = pkg.policy.HysteresisGate()
            gate.seed(KEYS[:4], np.full(4, 0.5, np.float32), np.full(4, 100.0, np.float32))
            cpu, mem = raw_series(1)[0]
            decision = gate.observe(KEYS, cpu, mem)
            decisions.append([np.asarray(getattr(decision, n)).tobytes() for n in ("cpu", "mem", "published", "changed", "suppressed")])
        assert decisions[0] == decisions[1]


# ------------------------------------------------------------- the journal
class TestJournal:
    def test_appends_and_compaction_write_the_same_bytes(self, tmp_path):
        paths = {}
        for name, pkg in PACKAGES.items():
            paths[name] = str(tmp_path / f"{name}.journal")
            # A retention shorter than the run: compaction drops and rewrites.
            journal_run(pkg, paths[name], ticks=14, retention=4 * 900.0).close()
        assert read_file(paths["port"]) == read_file(paths["jax"])
        assert read_file(paths["port"] + ".keys.json") == read_file(paths["jax"] + ".keys.json")

    @pytest.mark.parametrize("writer,reader", ORDERS)
    def test_each_reads_the_others_file(self, tmp_path, writer, reader):
        path = str(tmp_path / "j")
        journal_run(PACKAGES[writer], path).close()
        control = journal_run(PACKAGES[writer], None)
        reopened = PACKAGES[reader].journal.RecommendationJournal(path, readonly=True)
        assert_records_equal(reopened, control)
        assert reopened.last_published() == control.last_published()
        assert reopened.last_epoch == 12
        assert [k for k, _ in reopened.records_by_workload()] == [k for k, _ in control.records_by_workload()]

    @pytest.mark.parametrize("writer,reader", ORDERS)
    def test_torn_tail_recovers_the_same(self, tmp_path, writer, reader):
        source = str(tmp_path / "source")
        journal_run(PACKAGES[writer], source).close()
        blob = read_file(source)
        for cut in (len(blob) - 1, len(blob) - 13, len(blob) // 2 + 3, 70):
            results = []
            for name in (writer, reader):
                path = str(tmp_path / f"{name}-{cut}")
                with open(path, "wb") as f:
                    f.write(blob[:cut])
                with open(path + ".keys.json", "wb") as f:
                    f.write(read_file(source + ".keys.json"))
                journal = PACKAGES[name].journal.RecommendationJournal(path)
                results.append((journal.records().tobytes(), journal.last_epoch))
                journal.close()
                results.append(read_file(path))  # the repaired file
            assert results[2:] == results[:2], cut

    @pytest.mark.parametrize("writer,reader", ORDERS)
    @pytest.mark.parametrize("store_epoch", [12, 9, 5, 14])
    def test_reconcile_epoch_truncates_the_same(self, tmp_path, writer, reader, store_epoch):
        outcomes = []
        for name in (writer, reader):
            path = str(tmp_path / f"{name}.j")
            journal_run(PACKAGES[writer], path).close()
            journal = PACKAGES[name].journal.RecommendationJournal(path)
            verdict = journal.reconcile_epoch(store_epoch)
            outcomes.append((verdict, journal.records().tobytes(), journal.last_epoch))
            journal.close()
            outcomes.append(read_file(path))
        assert outcomes[2:] == outcomes[:2]

    def test_hash_key_equal(self):
        for key in KEYS + ["", "ü/ñ", "x" * 300]:
            assert port_journal.hash_key(key) == jax_journal.hash_key(key)


# ------------------------------------------------- drift, savings and diff
class TestDerived:
    @pytest.mark.parametrize("dead_band_pct,confirm_ticks", [(5.0, 2), (10.0, 3), (0.0, 1)])
    def test_fleet_drift_equal(self, dead_band_pct, confirm_ticks):
        rows = [
            [row.as_dict() for row in pkg.drift.fleet_drift(
                journal_run(pkg, None), dead_band_pct=dead_band_pct, confirm_ticks=confirm_ticks,
            )]
            for pkg in PACKAGES.values()
        ]
        assert rows[0] == rows[1] and rows[1]

    @pytest.mark.parametrize("ticks", [0, 1, 12])
    def test_journal_savings_equal(self, ticks):
        blocks = [pkg.score.journal_savings(journal_run(pkg, None, ticks=ticks)) for pkg in PACKAGES.values()]
        assert blocks[0] == blocks[1]
        assert (blocks[1] is None) == (ticks == 0)

    def test_diff_result_renders_equal(self):
        """Two journal ticks through each package's diff: the same JSON."""
        outputs = []
        for pkg in PACKAGES.values():
            journal = journal_run(pkg, None)
            base_ts, at_ts = pkg.diff.resolve_ticks(journal, at=None, baseline=None)
            result = pkg.diff.build_diff_result(
                pkg.diff.tick_values(journal, base_ts), pkg.diff.tick_values(journal, at_ts),
            )
            outputs.append(result.format("json"))
        assert outputs[0] == outputs[1]


# ------------------------------------------------------ the flight recorder
def synthetic_records(ticks: int, *, inject: bool, seed: int = 47) -> "list[dict]":
    """The bench sentinel leg's timeline: shared noise, and with ``inject``
    a two-tick fetch-transport (ttfb) regression and a compute one."""
    rng = np.random.default_rng(seed)
    base = {
        "fetch_transport": 0.9, "fetch_decode": 0.25, "fetch_backoff": 0.0, "fetch_other": 0.1,
        "fold": 0.2, "compute": 0.35, "discover": 0.05, "publish": 0.05, "other": 0.0, "idle": 0.1,
    }
    records = []
    for i in range(ticks):
        cats = {k: round(v * float(1.0 + rng.normal(0, 0.04)), 6) for k, v in base.items()}
        phases = {
            "ttfb": round(0.5 * float(1.0 + rng.normal(0, 0.05)), 6),
            "body_read": round(0.3 * float(1.0 + rng.normal(0, 0.05)), 6),
            "connect": round(0.05 * float(1.0 + rng.normal(0, 0.05)), 6),
        }
        records.append({
            "v": 1, "ts": 1e9 + i * 300.0, "scan_id": f"synthetic-{i}",
            "kind": "full" if i == 0 else "delta",
            "wall": round(sum(cats.values()), 6), "categories": cats, "phases": phases,
            "rows": 256, "failed_rows": 0, "wire_bytes": 1 << 22, "queries": 16, "retries": 0,
            "publish": {"changed": 3, "suppressed": 1},
            "persist": {"seconds": 0.02, "bytes": 4096, "epoch": i + 1, "failing": False},
            "plan": {"coalesced": 2, "sharded": 1},
            "readpath": {"requests": 40, "p99_ms": round(4.0 * float(1.0 + rng.normal(0, 0.05)), 3)},
        })
    if inject:
        records = copy.deepcopy(records)
        fetch_at, compute_at = int(ticks * 0.6), int(ticks * 0.85)
        for i in (fetch_at, fetch_at + 1):
            records[i]["categories"]["fetch_transport"] = round(records[i]["categories"]["fetch_transport"] + 3.0, 6)
            records[i]["phases"]["ttfb"] = round(records[i]["phases"]["ttfb"] + 2.8, 6)
            records[i]["wall"] = round(records[i]["wall"] + 3.0, 6)
        for i in (compute_at, compute_at + 1):
            records[i]["categories"]["compute"] = round(records[i]["categories"]["compute"] + 2.0, 6)
            records[i]["wall"] = round(records[i]["wall"] + 2.0, 6)
    return records


class TestTrend:
    @pytest.mark.parametrize("inject", [False, True], ids=["clean", "injected"])
    @pytest.mark.parametrize("knobs", [{}, {"warmup_scans": 4, "sigma": 2.5, "baseline_scans": 16}],
                             ids=["default", "tuned"])
    def test_trend_report_and_text_equal(self, inject, knobs):
        records = synthetic_records(60, inject=inject)
        reports = [pkg.sentinel.trend_report(records, **knobs) for pkg in PACKAGES.values()]
        assert reports[0] == reports[1]
        assert (reports[1]["regressed"] > 0) == inject
        if inject:
            dominant = {v["dominant"] for v in reports[1]["regressions"]}
            assert {"fetch_transport", "compute"} <= dominant
        texts = [pkg.sentinel.render_trend_text(r, records[-10:]) for pkg, r in zip(PACKAGES.values(), reports)]
        assert texts[0] == texts[1]

    def test_live_sentinel_status_and_knobs_equal(self):
        statuses = []
        for pkg in PACKAGES.values():
            sentinel = pkg.sentinel.RegressionSentinel(warmup_scans=4)
            seeded = sentinel.seed(synthetic_records(30, inject=False))
            verdicts = [sentinel.observe(r, fire=False) for r in synthetic_records(20, inject=True, seed=3)]
            statuses.append((seeded, verdicts, sentinel.status(), pkg.sentinel.sentinel_knobs(sentinel)))
        assert statuses[0] == statuses[1]


class TestTimeline:
    @pytest.mark.parametrize("retain", [64, 8])
    def test_appends_write_the_same_bytes(self, tmp_path, retain):
        paths = {}
        for name, pkg in PACKAGES.items():
            paths[name] = str(tmp_path / f"{name}.log")
            timeline = pkg.timeline.ScanTimeline.open(paths[name], retain_records=retain)
            for record in synthetic_records(20, inject=True):
                assert timeline.append(record)
            timeline.close()
        assert read_file(paths["port"]) == read_file(paths["jax"])

    @pytest.mark.parametrize("writer,reader", ORDERS)
    def test_torn_tails_and_bit_flips_recover_the_same(self, tmp_path, writer, reader):
        source = str(tmp_path / "source.log")
        timeline = PACKAGES[writer].timeline.ScanTimeline.open(source)
        for record in synthetic_records(6, inject=False):
            timeline.append(record)
        timeline.close()
        blob = read_file(source)
        damaged = [blob[:cut] for cut in (len(blob) - 1, len(blob) - 40, len(blob) // 2, 5)]
        for at in (9, len(blob) // 3, len(blob) - 7):
            flipped = bytearray(blob)
            flipped[at] ^= 0x10
            damaged.append(bytes(flipped))
        for n, data in enumerate(damaged):
            outcomes = []
            for name in (writer, reader):
                path = str(tmp_path / f"{name}-{n}.log")
                with open(path, "wb") as f:
                    f.write(data)
                try:
                    outcomes.append(PACKAGES[name].timeline.ScanTimeline.read_records(path))
                except ValueError as e:  # a flipped magic header: not a timeline
                    outcomes.append(("not a timeline", "bad magic header" in str(e)))
                timeline = PACKAGES[name].timeline.ScanTimeline.open(path)
                outcomes.append(timeline.records())
                timeline.append(synthetic_records(7, inject=False)[-1])
                timeline.close()
                outcomes.append(read_file(path))
            assert outcomes[3:] == outcomes[:3], n

    def test_build_scan_record_equal(self):
        stats = {
            "scan_id": "s-1", "kind": "delta", "window_start": 1e9, "window_end": 1e9 + 900.0,
            "objects": 12, "failed_rows": 1, "backfilled": 2, "stale": 1,
            "discovery": {"mode": "relist", "adds": 0}, "publish_changed": 3, "publish_suppressed": 1,
            "persist_seconds": 0.25, "persist_bytes": 4096, "persist_failing": False, "epoch": 7,
            "readpath": {"requests": 3, "p99_ms": 1.5},
        }
        profile = {
            "wall_seconds": 2.5, "categories": {"fetch_transport": 1.0, "compute": 0.5},
            "fetch": {"phase_seconds": {"ttfb": 0.4}, "queries": 9, "retries": 1,
                      "wire_bytes": 1000, "decoded_bytes": 5000, "encodings": {"gzip": 9}},
        }
        records = [
            pkg.timeline.build_scan_record(p, stats, plan_delta={"coalesced": 1.0})
            for pkg in PACKAGES.values() for p in (profile, None)
        ]
        assert records[:2] == records[2:]


class TestDumpTrendArtifact:
    def test_trend_artifact_equals_jax(self, tmp_path):
        """SIGUSR2's fourth artifact (serve): the timeline's records, the
        sentinel's trend report over them and its live status — the same
        JSON from both packages' ``debug_dump``."""
        import json

        import krr_tpu.obs.dump as jax_dump
        import krr_tpu.obs.metrics as jax_metrics
        import krr_tpu.obs.trace as jax_trace
        import krr_tpu_torch.obs.dump as port_dump
        import krr_tpu_torch.obs.metrics as port_metrics
        import krr_tpu_torch.obs.trace as port_trace

        trends = []
        for name, pkg, dump, metrics, trace in (
            ("jax", PACKAGES["jax"], jax_dump, jax_metrics, jax_trace),
            ("port", PACKAGES["port"], port_dump, port_metrics, port_trace),
        ):
            timeline = pkg.timeline.ScanTimeline.open(None)
            for record in synthetic_records(24, inject=True):
                timeline.append(record)
            sentinel = pkg.sentinel.RegressionSentinel(warmup_scans=4)
            sentinel.seed(timeline.records())
            extra = {"device": "cpu"} if name == "port" else {}
            paths = dump.debug_dump(
                trace.Tracer(), metrics.MetricsRegistry(), trace_target=str(tmp_path / f"{name}.json"),
                metrics_target=str(tmp_path / f"{name}.prom"), timeline=timeline, sentinel=sentinel, **extra,
            )
            assert len(paths) == 4 and paths[3].endswith(".trend.json")
            with open(paths[3]) as f:
                trends.append(json.load(f))
        assert trends[1] == trends[0]
        assert trends[1]["trend"]["regressed"] > 0 and trends[1]["live"]["baselines"]

    def test_event_loop_flavour_dumps_off_the_loop(self, tmp_path):
        """``install_signal_dump(loop=...)``: SIGUSR2 on a running loop writes
        the four artifacts from the loop's executor."""
        import asyncio
        import signal

        from krr_tpu_torch.obs.dump import install_signal_dump
        from krr_tpu_torch.obs.metrics import MetricsRegistry
        from krr_tpu_torch.obs.trace import Tracer

        async def main():
            loop = asyncio.get_running_loop()
            timeline = port_timeline.ScanTimeline.open(None)
            timeline.append(synthetic_records(1, inject=False)[0])
            metrics = MetricsRegistry()
            assert install_signal_dump(
                Tracer(), metrics, device="cpu", trace_target=str(tmp_path / "t.json"),
                metrics_target=str(tmp_path / "m.prom"), loop=loop, timeline=timeline, sentinel=None,
            )
            try:
                os.kill(os.getpid(), signal.SIGUSR2)
                for _ in range(200):
                    if metrics.value("krr_tpu_debug_dumps_total") == 1 and len(os.listdir(tmp_path)) == 4:
                        break
                    await asyncio.sleep(0.05)
            finally:
                loop.remove_signal_handler(signal.SIGUSR2)
            assert metrics.value("krr_tpu_debug_dumps_total") == 1
            assert sorted(p.rsplit(".", 1)[-1] for p in os.listdir(tmp_path)) == ["json", "json", "json", "prom"]

        asyncio.run(main())
