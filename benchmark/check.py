"""The comparison that decides ``correct``: a scan's rendered JSON against
the plain reference (:mod:`benchmark.reference.recommend`).

Each number compared has its limit:

* ``cpu_mismatches``: containers whose CPU request differs from the
  reference's, or that carry a CPU limit (limit 0: the ``exact``
  guarantee);
* ``cpu_gap``: the widest relative distance between the reference's exact
  percentile and the interval of estimates that the rendered, rounded-up
  request admits (limit: the configuration's stated relative error, for
  the ``relative_error`` guarantee);
* ``memory_mismatches``: containers whose memory request or limit differs
  from the reference's (limit 0; memory is exact under every guarantee).

A container missing from the JSON, or rendered ``"?"``, counts against
every number; a scan that rendered no JSON reads :data:`MISSING` on each.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from decimal import Decimal

import numpy as np

from benchmark.reference.recommend import MILLICORE, Answers

#: The reading of a number that has nothing to compare (a missing JSON or
#: answer): finite, so the result line stays plain JSON.
MISSING = 1e9


@dataclass(frozen=True)
class Reading:
    name: str
    value: float
    limit: float

    @property
    def holds(self) -> bool:
        return self.value <= self.limit


@dataclass(frozen=True)
class Rendered:
    """Per container, in the reference's order: CPU request and limit,
    memory request and limit as the JSON carries them (None when absent),
    and how many containers the JSON holds that the reference does not."""

    cpu_request: list
    cpu_limit: list
    memory_request: list
    memory_limit: list
    extra: int


def parse(text: str, keys: list) -> Rendered:
    """The rendered values of ``keys`` ((namespace, name, container) per
    container) from one scan's JSON."""
    data = json.loads(text, parse_float=Decimal, parse_int=Decimal)
    found = {}
    for scan in data["scans"]:
        obj = scan["object"]
        found[(obj["namespace"], obj["name"], obj["container"])] = scan["recommended"]
    columns = {"cpu_request": [], "cpu_limit": [], "memory_request": [], "memory_limit": []}
    for key in keys:
        recommended = found.get(key)
        for column in columns:
            resource, selector = column.split("_")
            cell = None if recommended is None else recommended[selector + "s"].get(resource)
            columns[column].append(None if cell is None else cell["value"])
    extra = len(found) - sum(1 for key in keys if key in found)
    return Rendered(extra=extra, **columns)


def _is_number(value) -> bool:
    return isinstance(value, Decimal) and value.is_finite()


def cpu_gap(rendered: list, exact: np.ndarray, cpu_floor: Decimal) -> float:
    """The widest relative distance from the exact percentile to the
    estimates that each rendered request admits: a request ``r`` above the
    floor was rounded up from (r - 1 millicore, r]; one at the floor from
    anything up to it. :data:`MISSING` for a missing or non-numeric value."""
    widest = 0.0
    for value, truth in zip(rendered, exact.tolist()):
        if not _is_number(value):
            return MISSING
        high = float(value)
        low = float(value - MILLICORE) if value > cpu_floor else float("-inf")
        distance = max(low - truth, truth - high, 0.0)
        widest = max(widest, distance / truth)
    return widest


def mismatches(rendered: list, expected: list) -> int:
    return sum(1 for got, want in zip(rendered, expected) if not (_is_number(got) and got == want))


def limits(guarantee: dict) -> dict:
    """Each number the guarantee compares, with its limit."""
    if guarantee["kind"] == "exact":
        return {"cpu_mismatches": 0.0, "memory_mismatches": 0.0}
    if guarantee["kind"] == "relative_error":
        return {"cpu_gap": float(guarantee["cpu_relative_error"]), "memory_mismatches": 0.0}
    raise ValueError(f"unknown guarantee {guarantee['kind']!r}")


def failing(guarantee: dict) -> list[Reading]:
    """Every number at its worst: a scan that rendered no JSON to compare."""
    return [Reading(name, MISSING, limit) for name, limit in limits(guarantee).items()]


def compare(rendered: Rendered, reference: Answers, guarantee: dict, cpu_floor: Decimal) -> list[Reading]:
    """The readings of one scan's answers against the reference's."""
    memory = rendered.extra + sum(
        1 for request, limit, want in zip(rendered.memory_request, rendered.memory_limit, reference.memory_request)
        if not (_is_number(request) and _is_number(limit) and request == want and limit == want)
    )
    stray = rendered.extra + sum(1 for value in rendered.cpu_limit if value is not None)
    values = {"memory_mismatches": float(memory)}
    if guarantee["kind"] == "exact":
        values["cpu_mismatches"] = float(stray + mismatches(rendered.cpu_request, reference.cpu_request))
    else:
        values["cpu_gap"] = MISSING if stray else cpu_gap(rendered.cpu_request, reference.cpu_value, cpu_floor)
    return [Reading(name, values[name], limit) for name, limit in limits(guarantee).items()]


def worst(readings: "list[list[Reading]]") -> list[Reading]:
    """Per number, the worst reading of several scans."""
    out = {}
    for group in readings:
        for reading in group:
            if reading.name not in out or reading.value > out[reading.name].value:
                out[reading.name] = reading
    return list(out.values())


def as_rendered(answers: Answers) -> Rendered:
    """Answers worked out by a stand-in for the program (the control), in
    the form a scan's JSON is read into."""
    return Rendered(cpu_request=list(answers.cpu_request), cpu_limit=[None] * len(answers.cpu_request),
                    memory_request=list(answers.memory_request), memory_limit=list(answers.memory_limit), extra=0)
