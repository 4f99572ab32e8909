"""The benchmark's declarations, found by name.

``BENCHMARK.json`` at the checkout's root names every cell (a configuration
under a traffic mix) and every metric. A configuration is the JSON file its
entry names; a mix is ``benchmark/mixes/<mix>.json`` (with an optional
``<mix>.py`` beside it, see :mod:`benchmark.generate`); a per-layer metric
is read by ``benchmark/metrics/<metric>.py``. Adding a cell, a mix or a
metric adds files and entries: nothing here changes.
"""

from __future__ import annotations

import json
import re
from dataclasses import dataclass
from pathlib import Path

#: The checkout's root: the folder that holds ``BENCHMARK.json``.
ROOT = Path(__file__).resolve().parent.parent

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}\Z")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}\Z")


@dataclass(frozen=True)
class Cell:
    """One entry of ``workloads`` with everything it refers to."""

    name: str
    chips: int
    config: dict
    mix_name: str
    mix: dict
    end_to_end: list
    per_layer: list
    root: Path


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def mix_path(root: Path, mix: str, suffix: str) -> Path:
    return root / "benchmark" / "mixes" / f"{mix}{suffix}"


def metric_path(root: Path, metric: str) -> Path:
    return root / "benchmark" / "metrics" / f"{metric}.py"


def _reported_in(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root``'s ``BENCHMARK.json``; raises
    ``KeyError`` naming the known cells when there is none."""
    bench = load_benchmark(root)
    workloads = {w["name"]: w for w in bench["workloads"]}
    if name not in workloads:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: {sorted(workloads)}")
    workload = workloads[name]
    entry = {c["name"]: c for c in bench["configs"]}[workload["config"]]
    with open(root / entry["file"]) as f:
        config = json.load(f)
    with open(mix_path(root, workload["traffic"], ".json")) as f:
        mix = json.load(f)
    return Cell(
        name=name,
        chips=int(workload["chips"]),
        config=config,
        mix_name=workload["traffic"],
        mix=mix,
        end_to_end=[m for m in bench["end_to_end"] if _reported_in(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reported_in(m, name)],
        root=root,
    )


def samples_per_pod(config: dict) -> int:
    """Samples in a pod alive the whole window: history over step."""
    settings = config["settings"]
    samples = settings["history_duration"] * 60 / settings["timeframe_duration"]
    if samples != int(samples):
        raise ValueError(f"{config['name']}: the history is not a whole number of steps")
    return int(samples)
