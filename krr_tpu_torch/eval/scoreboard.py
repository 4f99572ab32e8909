"""The per-strategy quality scoreboard and its formatter-registry rendering.

A copy of `krr_tpu/eval/scoreboard.py`, rendering through the port's
formatter registry.
A scoreboard row is one strategy's replay verdict: would-have-been OOM and
throttle incidents, the over-provisioned core-hour / GB-hour integrals, and
gate churn. Rows rank safety-first (fewest incidents), then cost (least
over-provisioned area), then stability (fewest flaps) — the order an
operator would promote strategies in, and the order the bench ranking gate
asserts.

Rendering resolves the output format through the SAME registry the scan
result uses (``BaseFormatter.find`` — unknown names fail identically), and
reuses each machine formatter's conventions byte-for-byte: json is
``model_dump_json(indent=2)``, yaml round-trips the json dump with
``sort_keys=False``, pprint is ``pformat`` of the model dump. The table
path mirrors the result table's severity coloring (``Severity.color``).
Nothing here reads a clock: two renders of the same replay are
byte-identical, which the determinism tests and the bench
``eval_deterministic`` gate rely on.
"""

from __future__ import annotations

from typing import Any

import pydantic as pd

from krr_tpu_torch.models.result import Severity


class StrategyScore(pd.BaseModel):
    """One strategy's scoreboard row."""

    strategy: str
    workloads: int
    ticks: int
    oom_incidents: int
    throttle_incidents: int
    flaps: int
    overprovisioned_core_hours: float
    overprovisioned_gb_hours: float
    samples_scored: int = 0
    severity: Severity = Severity.UNKNOWN

    @classmethod
    def from_row(cls, row: "dict[str, Any]") -> "StrategyScore":
        row = dict(row)
        row["overprovisioned_core_hours"] = round(float(row["overprovisioned_core_hours"]), 6)
        row["overprovisioned_gb_hours"] = round(float(row["overprovisioned_gb_hours"]), 6)
        row.setdefault("severity", _severity(row))
        return cls(**row)


def _severity(row: "dict[str, Any]") -> Severity:
    if row.get("oom_incidents", 0) > 0:
        return Severity.CRITICAL
    if row.get("throttle_incidents", 0) > 0:
        return Severity.WARNING
    if row.get("flaps", 0) > row.get("ticks", 0):
        return Severity.OK
    return Severity.GOOD


class Scoreboard(pd.BaseModel):
    """The ranked board: strategy rows over one shared replay input."""

    workloads: int
    samples: int
    window_seconds: float
    scores: "list[StrategyScore]"

    def format(self, formatter: str) -> Any:
        return render_scoreboard(self, formatter)


def build_scoreboard(
    rows: "list[dict[str, Any]]", *, samples: int, window_seconds: float
) -> Scoreboard:
    scores = sorted(
        (StrategyScore.from_row(row) for row in rows),
        key=lambda s: (
            s.oom_incidents + s.throttle_incidents,
            s.overprovisioned_gb_hours + s.overprovisioned_core_hours,
            s.flaps,
            s.strategy,
        ),
    )
    return Scoreboard(
        workloads=max((s.workloads for s in scores), default=0),
        samples=int(samples),
        window_seconds=round(float(window_seconds), 3),
        scores=scores,
    )


_COLUMNS = (
    ("strategy", "Strategy"),
    ("severity", "Severity"),
    ("oom_incidents", "OOM incidents"),
    ("throttle_incidents", "Throttle incidents"),
    ("overprovisioned_core_hours", "Over-prov core-h"),
    ("overprovisioned_gb_hours", "Over-prov GB-h"),
    ("flaps", "Flaps"),
    ("workloads", "Workloads"),
    ("ticks", "Ticks"),
)


def _table(board: Scoreboard) -> Any:
    from rich.table import Table

    table = Table(
        show_header=True,
        header_style="bold",
        title=(
            f"Quality scoreboard — {board.workloads} workload(s), "
            f"{board.samples} samples over {board.window_seconds:.0f}s"
        ),
    )
    for _field, header in _COLUMNS:
        table.add_column(header)
    for score in board.scores:
        color = score.severity.color
        cells = []
        for fld, _header in _COLUMNS:
            value = getattr(score, fld)
            if fld == "severity":
                cells.append(f"[{color}]{value.value}[/{color}]")
            elif isinstance(value, float):
                cells.append(f"{value:.3f}")
            else:
                cells.append(str(value))
        table.add_row(*cells)
    return table


def render_scoreboard(board: Scoreboard, formatter: str) -> Any:
    """Render through the formatter registry: the NAME resolves exactly like
    a scan result's (unknown formatters raise the registry's error), and
    each built-in format reuses that formatter's output conventions."""
    import json

    from krr_tpu_torch.formatters.base import BaseFormatter

    formatter_type = BaseFormatter.find(formatter)
    name = getattr(formatter_type, "__display_name__", formatter).lower()
    if name == "json":
        return board.model_dump_json(indent=2)
    if name == "yaml":
        import yaml

        return yaml.dump(json.loads(board.model_dump_json()), sort_keys=False)
    if name == "pprint":
        from pprint import pformat

        return pformat(board.model_dump())
    return _table(board)


__all__ = ["Scoreboard", "StrategyScore", "build_scoreboard", "render_scoreboard"]
