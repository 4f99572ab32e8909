"""The port's ``eval`` (replay, scoring, scoreboard, CLI) against the JAX package's.

The same seeded usage grids and chaos-archetype fleets (`tests/fakes/chaos.py`)
go through both packages. The port runs on the CPU (``device="cpu"``); the
JAX package's scoring reduce runs jitted on XLA's CPU.

What must be equal, and how:

* ``expand_ticks``, ``tick_ends``, the replayed series (``tick_indices``,
  ``rec_cpu``, ``rec_mem``, ``flaps``, ``suppressed``), the incident counts,
  ``samples_scored``, the board's order and every rendered byte but the two
  slack fields: bit for bit. One exception: ``tdigest``'s replayed
  ``rec_cpu`` is held within 2 float32 ulps, the digest estimate's ``exp``
  (ROADMAP Queue 3 item 6).
* The slack (``overprovisioned_core_hours``, ``overprovisioned_gb_hours``):
  the JAX package sums the float32 terms ``rec − usage`` in float32 (x64 is
  off there); the port sums the same float32 terms in float64 (ROADMAP
  Queue 3 item 10). Each port slack is within rtol 1e-12 of ``math.fsum``
  over the float32 terms, and within rtol 1e-5 of the JAX value. On a
  rendered board, rounded to 6 decimals, the tolerance adds the rounding
  quantum 1e-6.
"""

from __future__ import annotations

import json
import math
import os
import re

import numpy as np
import pytest
from click.testing import CliRunner

import krr_tpu.eval as jax_eval
import krr_tpu_torch.eval as port_eval
from krr_tpu import main as jax_main
from krr_tpu.history.journal import RecommendationJournal as JaxJournal
from krr_tpu.strategies.base import BaseStrategy as JaxBaseStrategy
from krr_tpu_torch import main as port_main
from krr_tpu_torch.history.journal import RecommendationJournal as PortJournal
from krr_tpu_torch.strategies.base import BaseStrategy as PortBaseStrategy

from .fakes.chaos import ORIGIN, STEP, ArchetypeSpec, build_fleet, fleet_replay_input

#: The slack tolerances of ROADMAP Queue 3 item 10.
FSUM_RTOL = 1e-12
JAX_RTOL = 1e-5
#: The scoreboard rounds each slack to 6 decimals.
ROUNDING = 1e-6
SLACK_FIELDS = ("overprovisioned_core_hours", "overprovisioned_gb_hours")
#: Static probes for the oom-loop archetype (its incident peaks sit at
#: ~7.4e8–8.5e8 bytes, its baseline under ~7e8).
UNDER = dict(cpu_cores=0.01, mem_bytes=3e8)
OVER = dict(cpu_cores=10.0, mem_bytes=5e9)


# ------------------------------------------------------------------ helpers
def fleet_inputs(workloads: int = 2, samples: int = 120, seed: int = 0, archetypes=("oom-loop",)):
    """A chaos fleet's replay input in each package (the same arrays)."""
    fleet = build_fleet([ArchetypeSpec(a, workloads=workloads, pods=1) for a in archetypes],
                        samples=samples, seed=seed)
    jax_inputs = fleet_replay_input(fleet)
    port_inputs = port_eval.ReplayInput(keys=list(jax_inputs.keys), timestamps=jax_inputs.timestamps,
                                        cpu=jax_inputs.cpu, mem=jax_inputs.mem)
    return fleet, jax_inputs, port_inputs


def strategy(package: str, name: str):
    """A registered strategy of ``package`` with default settings (the
    port's on the CPU), or a static probe."""
    if name in ("under", "over"):
        probe = (jax_eval if package == "jax" else port_eval).StaticReplayStrategy
        return probe(**(UNDER if name == "under" else OVER))
    registry = JaxBaseStrategy if package == "jax" else PortBaseStrategy
    strategy_type = registry.find(name)
    settings = strategy_type.get_settings_type()(**({"device": "cpu"} if package == "port" else {}))
    return strategy_type(settings)


def random_grids(shape: "tuple[int, int]", seed: int, ticks: int = 8):
    """Uniform [0, 2) usage and per-tick recommendations, 10 % NaN usage."""
    rng = np.random.default_rng(seed)
    w, t = shape
    usage_cpu, usage_mem = rng.uniform(0, 2, (w, t)), rng.uniform(0, 2e9, (w, t))
    usage_cpu[rng.random((w, t)) < 0.1] = np.nan
    usage_mem[rng.random((w, t)) < 0.1] = np.nan
    ticks = port_eval.tick_ends(t, ticks)
    rec_cpu = rng.uniform(0, 2, (w, len(ticks)))
    rec_mem = rng.uniform(0, 2e9, (w, len(ticks)))
    rec_cpu[:, 0][rng.random(w) < 0.2] = np.nan  # the gate never published
    return usage_cpu, usage_mem, rec_cpu, rec_mem, ticks


def fsum_slack(usage: np.ndarray, rec: np.ndarray, ticks: np.ndarray) -> float:
    """The exact sum of the float32 terms the reduce adds (the oracle)."""
    full, mask_ticks = port_eval.expand_ticks(ticks, rec, usage.shape[1])
    mask = mask_ticks[None, :] & np.isfinite(usage) & np.isfinite(full)
    u = np.nan_to_num(usage).astype(np.float32)
    r = np.nan_to_num(full).astype(np.float32)
    covered = mask & ~(u > r)
    return math.fsum((r[covered] - u[covered]).astype(np.float64).tolist())


def ulps_apart(a: np.ndarray, b: np.ndarray) -> int:
    """The most float32 ulps between two arrays of float32 values (held in
    float64); NaN must sit at the same places."""
    a32, b32 = a.astype(np.float32), b.astype(np.float32)
    np.testing.assert_array_equal(np.isnan(a32), np.isnan(b32))
    finite = ~np.isnan(a32)
    steps = a32[finite].view(np.int32).astype(np.int64) - b32[finite].view(np.int32)
    return int(np.abs(steps).max(initial=0))


def assert_slack_close(port: float, jax: float, rtol: float = JAX_RTOL, atol: float = 0.0) -> None:
    assert abs(port - jax) <= max(rtol * abs(jax), atol), (port, jax)


def board_rows(package: str, inputs, names, ticks: int = 8) -> list:
    module = jax_eval if package == "jax" else port_eval
    rows = []
    for name in names:
        replayed = module.replay(inputs, strategy(package, name), name=name, ticks=ticks)
        rows.append(module.score_replay(inputs, replayed, **({"device": "cpu"} if package == "port" else {})))
    return rows


def board(package: str, rows, inputs):
    module = jax_eval if package == "jax" else port_eval
    return module.build_scoreboard(rows, samples=len(inputs.timestamps),
                                   window_seconds=float(inputs.timestamps[-1] - inputs.timestamps[0]))


SLACK_PATTERN = re.compile(r"""(["']?(overprovisioned_(?:core|gb)_hours)["']?: )(-?[0-9.e+-]+)""")


def assert_rendered_equal(jax_text: str, port_text: str) -> None:
    """json / yaml / pprint renders equal but for the slack values, which
    follow the rendered tolerance; the rest is compared byte for byte."""
    jax_values = SLACK_PATTERN.findall(jax_text)
    port_values = SLACK_PATTERN.findall(port_text)
    assert [v[1] for v in port_values] == [v[1] for v in jax_values]
    for (_p, _n, jv), (_p2, _n2, pv) in zip(jax_values, port_values):
        assert_slack_close(float(pv), float(jv), atol=ROUNDING)
    assert SLACK_PATTERN.sub(r"\1X", port_text) == SLACK_PATTERN.sub(r"\1X", jax_text)


# ------------------------------------------------------------ the scoring
@pytest.mark.parametrize("samples,ticks", [(1, 1), (10, 3), (120, 16), (121, 7), (1344, 16), (5, 16)])
def test_tick_ends_and_expand_ticks_equal(samples, ticks):
    ends = port_eval.tick_ends(samples, ticks)
    np.testing.assert_array_equal(ends, jax_eval.tick_ends(samples, ticks))
    assert ends.dtype == jax_eval.tick_ends(samples, ticks).dtype
    rec = np.random.default_rng(samples).uniform(0, 1, (3, len(ends)))
    for port_out, jax_out in zip(port_eval.expand_ticks(ends, rec, samples), jax_eval.expand_ticks(ends, rec, samples)):
        np.testing.assert_array_equal(port_out, jax_out)


@pytest.mark.parametrize("shape,seed", [((1, 1), 0), ((6, 240), 1), ((37, 1000), 2), ((1000, 1344), 3)])
def test_score_grids_against_jax_and_the_exact_sum(shape, seed):
    usage_cpu, usage_mem, rec_cpu, rec_mem, ticks = random_grids(shape, seed)
    kwargs = dict(tick_indices=ticks, step_seconds=900.0)
    jax_scores = jax_eval.score_grids(usage_cpu, usage_mem, rec_cpu, rec_mem, **kwargs)
    port_scores = port_eval.score_grids(usage_cpu, usage_mem, rec_cpu, rec_mem, device="cpu", **kwargs)
    for field in ("oom_incidents", "throttle_incidents", "samples_scored"):
        assert port_scores[field] == jax_scores[field], field
        assert type(port_scores[field]) is int
    step_hours = 900.0 / 3600.0
    exact = {
        "overprovisioned_core_hours": fsum_slack(usage_cpu, rec_cpu, ticks) * step_hours,
        "overprovisioned_gb_hours": fsum_slack(usage_mem, rec_mem, ticks) * step_hours / 1e9,
    }
    for field in SLACK_FIELDS:
        assert_slack_close(port_scores[field], exact[field], rtol=FSUM_RTOL)
        assert_slack_close(port_scores[field], jax_scores[field], rtol=JAX_RTOL)


def test_float32_slack_divergence_queue3_item10():
    """ROADMAP Queue 3 item 10, the smallest input: one workload, two
    samples, terms 2^24 and 1. The JAX reduce adds them in float32 and the
    tie rounds to even, 16777216; the port adds them in float64, 16777217,
    the exact sum. The incident counts agree."""
    usage = np.zeros((1, 2))
    rec = np.array([[2.0 ** 24, 1.0]])
    kwargs = dict(tick_indices=np.array([0, 1]), step_seconds=3600.0)
    jax_scores = jax_eval.score_grids(usage, usage, rec, rec, **kwargs)
    port_scores = port_eval.score_grids(usage, usage, rec, rec, device="cpu", **kwargs)
    assert jax_scores["overprovisioned_core_hours"] == 16777216.0
    assert port_scores["overprovisioned_core_hours"] == 16777217.0
    assert port_scores["oom_incidents"] == jax_scores["oom_incidents"] == 0
    assert port_scores["samples_scored"] == jax_scores["samples_scored"] == 2


def test_reduce_keeps_jax_float32_terms():
    """Values that differ only past float32 precision compare equal in both
    packages: the incidents come from the float32 cast, not from float64."""
    usage = np.array([[1.0 + 1e-9, 2.0, 0.5]])
    rec = np.array([[1.0]])
    kwargs = dict(tick_indices=np.array([0]), step_seconds=60.0)
    jax_scores = jax_eval.score_grids(usage, usage, rec, rec, **kwargs)
    port_scores = port_eval.score_grids(usage, usage, rec, rec, device="cpu", **kwargs)
    assert port_scores["throttle_incidents"] == jax_scores["throttle_incidents"] == 1
    assert port_scores["overprovisioned_core_hours"] == jax_scores["overprovisioned_core_hours"]


def test_score_grids_without_a_card_raises(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    usage_cpu, usage_mem, rec_cpu, rec_mem, ticks = random_grids((2, 10), 0)
    with pytest.raises(RuntimeError, match="cuda"):
        port_eval.score_grids(usage_cpu, usage_mem, rec_cpu, rec_mem, tick_indices=ticks, step_seconds=60.0)


# ------------------------------------------------------------- the replay
@pytest.mark.parametrize("name", ["simple", "tdigest", "under", "over"])
@pytest.mark.parametrize("hysteresis", [True, False])
def test_replay_series_equal_jax(name, hysteresis):
    _fleet, jax_inputs, port_inputs = fleet_inputs(
        workloads=2, samples=160, seed=4, archetypes=("oom-loop", "diurnal", "bursty-batch"))
    knobs = dict(name=name, ticks=10, hysteresis=hysteresis)
    jax_series = jax_eval.replay(jax_inputs, strategy("jax", name), **knobs)
    port_series = port_eval.replay(port_inputs, strategy("port", name), **knobs)
    np.testing.assert_array_equal(port_series.tick_indices, jax_series.tick_indices)
    if name == "tdigest":
        # The digest's CPU estimate is an ``exp`` of the bucket midpoint, one
        # or two float32 ulps apart between PyTorch's and XLA's CPU ``exp``
        # (ROADMAP Queue 3 item 6); the gate holds float32 values.
        assert ulps_apart(port_series.rec_cpu, jax_series.rec_cpu) <= 2
    else:
        np.testing.assert_array_equal(port_series.rec_cpu, jax_series.rec_cpu)
    np.testing.assert_array_equal(port_series.rec_mem, jax_series.rec_mem)
    assert (port_series.flaps, port_series.suppressed, port_series.workloads, port_series.strategy) == (
        jax_series.flaps, jax_series.suppressed, jax_series.workloads, jax_series.strategy)
    assert set(port_series.extra["seconds"]) == {"build", "run_batch", "gate"}


@pytest.mark.parametrize("fmt", ["json", "yaml", "pprint", "table"])
def test_scoreboard_renders_equal_jax(fmt):
    _fleet, jax_inputs, port_inputs = fleet_inputs(workloads=2, samples=160, seed=7,
                                                   archetypes=("oom-loop", "diurnal"))
    names = ("simple", "tdigest", "under", "over")
    jax_rows, port_rows = board_rows("jax", jax_inputs, names), board_rows("port", port_inputs, names)
    for jax_row, port_row in zip(jax_rows, port_rows):
        assert {k: v for k, v in port_row.items() if k not in SLACK_FIELDS} == {
            k: v for k, v in jax_row.items() if k not in SLACK_FIELDS}
        for field in SLACK_FIELDS:
            assert_slack_close(port_row[field], jax_row[field])
    jax_board, port_board = board("jax", jax_rows, jax_inputs), board("port", port_rows, port_inputs)
    assert [s.strategy for s in port_board.scores] == [s.strategy for s in jax_board.scores]
    jax_text = jax_eval.render_scoreboard(jax_board, fmt)
    port_text = port_eval.render_scoreboard(port_board, fmt)
    if fmt == "table":
        from rich.console import Console

        def text(table) -> str:
            console = Console(width=160, record=True, file=open(os.devnull, "w"))
            console.print(table)
            return console.export_text()

        assert text(port_text) == text(jax_text)
    else:
        assert_rendered_equal(jax_text, port_text)


def test_unknown_formatter_raises_like_jax():
    _fleet, jax_inputs, port_inputs = fleet_inputs(workloads=1)
    jax_board = board("jax", board_rows("jax", jax_inputs, ["under"]), jax_inputs)
    port_board = board("port", board_rows("port", port_inputs, ["under"]), port_inputs)
    with pytest.raises(ValueError) as jax_error:
        jax_eval.render_scoreboard(jax_board, "no-such-format")
    with pytest.raises(ValueError) as port_error:
        port_eval.render_scoreboard(port_board, "no-such-format")
    assert str(port_error.value) == str(jax_error.value)


# ------------------------------------------- the contracts, on the port alone
class TestLabeledOracle:
    def test_score_reproduces_declared_incident_windows(self):
        fleet, _jax_inputs, inputs = fleet_inputs(workloads=1)
        (declared,) = fleet.incident_windows("oom-loop").values()
        assert declared
        scores = port_eval.score_grids(
            inputs.cpu, inputs.mem, rec_cpu=np.full((1, 1), 10.0), rec_mem=np.full((1, 1), 7.45e8),
            tick_indices=np.array([0]), step_seconds=inputs.step_seconds, device="cpu",
        )
        assert scores["oom_incidents"] == len(declared)
        assert scores["throttle_incidents"] == 0
        assert scores["samples_scored"] == inputs.cpu.shape[1]

    def test_sustained_breach_is_one_incident(self):
        usage = np.zeros((1, 10))
        usage[0, 3:7] = 5.0
        scores = port_eval.score_grids(usage, usage, rec_cpu=np.full((1, 1), 1.0), rec_mem=np.full((1, 1), 1.0),
                                       tick_indices=np.array([0]), step_seconds=60.0, device="cpu")
        assert scores["throttle_incidents"] == scores["oom_incidents"] == 1


class TestRankingContract:
    def test_undersized_scores_incidents_oversized_scores_slack(self):
        _fleet, _jax_inputs, inputs = fleet_inputs()
        under, over = board_rows("port", inputs, ["under", "over"], ticks=16)
        assert under["oom_incidents"] > 0 and under["throttle_incidents"] > 0
        assert over["oom_incidents"] == over["throttle_incidents"] == 0
        assert over["overprovisioned_gb_hours"] > under["overprovisioned_gb_hours"]
        assert over["overprovisioned_core_hours"] > under["overprovisioned_core_hours"]
        ranked = board("port", [under, over], inputs)
        assert [s.strategy for s in ranked.scores] == ["over", "under"]
        assert ranked.scores[0].severity.name == "GOOD"
        assert ranked.scores[1].severity.name == "CRITICAL"

    def test_registered_strategy_replays_through_the_gate(self):
        _fleet, _jax_inputs, inputs = fleet_inputs(workloads=1)
        replayed = port_eval.replay(inputs, strategy("port", "simple"), name="simple", ticks=6)
        row = port_eval.score_replay(inputs, replayed, device="cpu")
        assert row["ticks"] == len(replayed.tick_indices)
        assert np.all(np.isfinite(replayed.rec_mem[:, -1]))
        assert float(replayed.rec_mem[0, -1]) > 1e8


def test_two_replays_render_identical_bytes():
    _fleet, _jax_inputs, inputs = fleet_inputs(archetypes=("oom-loop", "diurnal"))

    def render() -> str:
        rows = board_rows("port", inputs, ("under", "over", "simple", "tdigest"))
        return port_eval.render_scoreboard(board("port", rows, inputs), "json")

    assert render() == render()


# -------------------------------------------------------- inputs and files
@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax"), ("port", "port")])
def test_npz_loads_in_either_package(tmp_path, writer, reader):
    _fleet, jax_inputs, port_inputs = fleet_inputs(workloads=2, archetypes=("oom-loop", "diurnal"))
    path = str(tmp_path / "usage.npz")
    (jax_inputs if writer == "jax" else port_inputs).save_npz(path)
    loaded = (jax_eval if reader == "jax" else port_eval).ReplayInput.load_npz(path)
    assert loaded.keys == port_inputs.keys
    for field in ("timestamps", "cpu", "mem"):
        np.testing.assert_array_equal(getattr(loaded, field), getattr(port_inputs, field))
        assert getattr(loaded, field).dtype == np.float64


def test_scoped_filters_like_jax():
    _fleet, jax_inputs, port_inputs = fleet_inputs(workloads=2, archetypes=("oom-loop", "diurnal"))
    namespace = port_inputs.keys[0].split("/")[1]
    for kwargs in ({"namespaces": (namespace,)}, {"clusters": ("",)}, {"clusters": ("nowhere",)}, {}):
        assert port_inputs.scoped(**kwargs).keys == jax_inputs.scoped(**kwargs).keys


def populated_journal(journal_type, path: str):
    journal = journal_type(path)
    keys = ["/default/web/app/Deployment", "/default/db/pg/StatefulSet", "/prod/api/main/Deployment"]
    for i in range(6):
        present = keys if i != 3 else keys[:2]  # a gap for the forward fill
        journal.append_tick(
            ORIGIN + STEP * i, present,
            np.array([0.5 + 0.01 * i, 1.0, 0.2][: len(present)]),
            np.array([100.0 + 5.0 * i, 800.0, 300.0 + 40.0 * (i % 2)][: len(present)]),
            np.array([i == 0] * len(present)),
        )
    return journal


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_from_journal_reads_a_live_writers_journal_read_only(tmp_path, writer):
    path = str(tmp_path / "server.journal")
    live = populated_journal(PortJournal if writer == "port" else JaxJournal, path)
    with open(path, "rb") as fh:
        before = fh.read()
    inputs = port_eval.ReplayInput.from_journal(path)
    reference = jax_eval.ReplayInput.from_journal(path)
    assert inputs.keys == reference.keys and len(inputs.keys) == 3
    for field in ("timestamps", "cpu", "mem"):
        np.testing.assert_array_equal(getattr(inputs, field), getattr(reference, field))
    assert not os.path.exists(path + ".lock"), "a read-only open must not lock"
    with open(path, "rb") as fh:
        assert fh.read() == before, "a read-only open must not rewrite the journal"
    live.append_tick(ORIGIN + STEP * 6, ["/default/web/app/Deployment"], np.array([0.6]), np.array([130.0]),
                     np.array([True]))
    assert len(port_eval.ReplayInput.from_journal(path).timestamps) == 7


def test_missing_journal_raises_value_error(tmp_path):
    with pytest.raises(ValueError, match="no journal"):
        port_eval.ReplayInput.from_journal(str(tmp_path / "absent.journal"))


# ---------------------------------------------------------------- the CLI
@pytest.fixture(scope="module")
def apps():
    jax_main.load_commands()
    port_main.load_commands()
    return jax_main.app, port_main.app


@pytest.fixture(scope="module")
def usage_npz(tmp_path_factory):
    _fleet, jax_inputs, _port_inputs = fleet_inputs(workloads=2, samples=120, seed=2,
                                                    archetypes=("oom-loop", "diurnal", "mixed-qos"))
    path = str(tmp_path_factory.mktemp("eval") / "usage.npz")
    jax_inputs.save_npz(path)
    return path, jax_inputs


def invoke_both(apps, args: list) -> tuple:
    jax_app, port_app = apps
    jax_result = CliRunner().invoke(jax_app, ["eval", *args])
    port_result = CliRunner().invoke(port_app, ["eval", *args, "--device", "cpu"])
    return jax_result, port_result


@pytest.mark.parametrize("args", [
    ["-f", "json"],
    ["-f", "yaml", "--strategy", "simple", "--replay-ticks", "5"],
    ["-f", "pprint", "--no-hysteresis", "--dead-band-pct", "1", "--confirm-ticks", "1"],
    ["-f", "table"],
    ["-f", "json", "-n", "{NS}"],
    ["-f", "json", "-c", ""],
], ids=["json", "yaml-simple", "pprint-no-gate", "table", "namespace", "cluster"])
def test_eval_usage_prints_the_jax_commands_stdout(apps, usage_npz, args):
    path, inputs = usage_npz
    namespace = inputs.keys[0].split("/")[1]
    argv = ["--usage", path, "-q", *(a.replace("{NS}", namespace) for a in args)]
    jax_result, port_result = invoke_both(apps, argv)
    assert jax_result.exit_code == 0, jax_result.output
    assert port_result.exit_code == 0, port_result.output
    if "table" in args:
        assert port_result.output == jax_result.output
    else:
        assert_rendered_equal(jax_result.output, port_result.output)
    if "json" in args:
        payload = json.loads(port_result.output)
        assert payload["workloads"] == (2 if "-n" in args else 6)
        assert sorted(s["strategy"] for s in payload["scores"]) == ["simple", "tdigest"]


@pytest.mark.parametrize("source", ["journal", "state_path"])
def test_eval_journal_prints_the_jax_commands_stdout(apps, tmp_path, source):
    state_path = str(tmp_path / "state")
    path = f"{state_path}.journal"
    writer = populated_journal(PortJournal, path)
    argv = (["--journal", path] if source == "journal" else ["--state_path", state_path])
    jax_result, port_result = invoke_both(apps, [*argv, "--replay-ticks", "3", "-f", "json", "-q"])
    assert jax_result.exit_code == port_result.exit_code == 0, port_result.output
    assert_rendered_equal(jax_result.output, port_result.output)
    assert json.loads(port_result.output)["workloads"] == 3
    assert not os.path.exists(path + ".lock")
    writer.append_tick(ORIGIN + STEP * 6, ["/default/web/app/Deployment"], np.array([0.5]), np.array([100.0]),
                       np.array([True]))  # the writer survived the eval


@pytest.mark.parametrize("args", [
    ["--usage", "{NPZ}", "--journal", "{NPZ}"],
    [],
    ["--journal", "{ABSENT}"],
    ["--usage", "{NPZ}", "--strategy", "no-such-strategy"],
    ["--usage", "{NPZ}", "-n", "no-such-namespace"],
    ["--usage", "{NPZ}", "--replay-ticks", "0"],
], ids=["two-sources", "no-source", "absent-journal", "unknown-strategy", "scoped-to-nothing", "bad-ticks"])
def test_eval_errors_match_jax(apps, usage_npz, tmp_path, args):
    path, _inputs = usage_npz
    argv = [a.format(NPZ=path, ABSENT=str(tmp_path / "absent.journal")) for a in args] + ["-f", "json", "-q"]
    jax_result, port_result = invoke_both(apps, argv)
    assert jax_result.exit_code != 0
    assert port_result.exit_code == jax_result.exit_code
    assert port_result.output == jax_result.output


def test_eval_without_a_card_exits_naming_cuda(apps, usage_npz, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path, _inputs = usage_npz
    result = CliRunner().invoke(apps[1], ["eval", "--usage", path, "-f", "json", "-q"])
    assert result.exit_code == 1
    assert "cuda" in result.output.lower()
    assert '"scores"' not in result.output


def test_eval_defaults_match_jax_and_the_device_is_cuda(apps):
    """Every flag the two commands share parses to the JAX default with no
    arguments; the port's one addition, ``--device``, defaults to the card.
    (The flag sets are pinned in ``tests/test_torch_cli.py``.)"""
    jax_app, port_app = apps
    ctx = port_app.commands["eval"].make_context("eval", [], resilient_parsing=True)
    jax_ctx = jax_app.commands["eval"].make_context("eval", [], resilient_parsing=True)
    assert ctx.params["device"] == "cuda"
    assert {k: v for k, v in ctx.params.items() if k != "device" and k in jax_ctx.params} == {
        k: v for k, v in jax_ctx.params.items() if k in ctx.params}
    assert set(jax_ctx.params) - set(ctx.params) == {"jax_compilation_cache_dir"}
