"""A fake Prometheus of the benchmark's own: a fleet's sample sets served
over the Prometheus HTTP API on ``127.0.0.1``, so that a scan fetches its
histories through the port's own fetch layer.

:func:`served` runs it as a child process of its own
(``python -m benchmark.prometheus``), fed through a pipe. That process
imports numpy and the standard library alone: no JAX, no ``krr_tpu``, no
``torch``, and it never touches the card.

What it holds
-------------
Per pod one series of :data:`CPU_METRIC` (labels ``namespace``, ``pod``,
``container``) and one of :data:`MEMORY_METRIC` (also ``job``,
``metrics_path`` and a non-empty ``image``). Sample set ``k`` is served
under the path prefix ``/set-k`` (a Prometheus behind a route prefix); all
sets share one end timestamp, so that a pod's samples are rendered and
deflated once however many sets read them. A pod alive the whole window
holds its samples at the ``window`` grid points of ``step`` seconds that
end at ``end``; a pod with ``n`` samples holds them at the last ``n``. The
5-minute lookback is shorter than the step, so no other grid point holds a
value.

What it answers
---------------
* ``/api/v1/query_range``: a matrix of a selector or of ``sum by (...)``
  over a selector, evaluated on the sample grid (the grid's step, a start
  on the grid; any other range is refused).
* ``/api/v1/query``: a vector of the same, or of ``count(...)`` over
  either, at ``time``.
* Label matchers ``=``, ``!=``, ``=~`` and ``!~`` (regexes anchored), in
  strings with PromQL's escapes: an escape PromQL does not know, such as
  ``\\-``, is a parse error, as it is in Prometheus.
* Any other PromQL, a ``sum`` over more than one series a group, or a
  range off the grid: ``400`` with ``errorType`` ``bad_data``, so that a new
  query shape fails loudly and never reads as empty data.

Values are written as Prometheus writes them, the shortest decimal that
reads back to the same double and never in exponent form (Go's
``strconv.FormatFloat(v, 'f', -1, 64)``); timestamps are whole seconds.
A request that accepts gzip gets gzip, as from Prometheus's API (zstd is
never offered), and identity otherwise.

What a request costs it
-----------------------
Set-up renders and deflates each pod's samples once, in forked worker
processes that write into shared anonymous memory. A response is then the
selection of its series and a join of pre-deflated pieces, each ending in
a full flush, under one gzip header and trailer whose CRC-32 is combined
from the pieces' own, so their text is not read again. The small
per-series label heads go as stored blocks, made on first use and kept,
and a slice of a piece where a range cuts a pod's samples is deflated on
first use and kept. So the fake does not pace a scan.
"""

from __future__ import annotations

import contextlib
import json
import math
import mmap
import multiprocessing
import os
import pickle
import re
import struct
import subprocess
import sys
import threading
import time
import traceback
import urllib.parse
import zlib
from dataclasses import dataclass
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Optional

import numpy as np

#: The checkout's root, where ``python -m benchmark.prometheus`` runs.
_ROOT = Path(__file__).resolve().parent.parent

CPU_METRIC = "node_namespace_pod_container:container_cpu_usage_seconds_total:sum_irate"
MEMORY_METRIC = "container_memory_working_set_bytes"
#: The labels a memory series carries besides namespace, pod and container
#: (the kubelet's cAdvisor endpoint, as the port's memory query selects it).
MEMORY_LABELS = {"job": "kubelet", "metrics_path": "/metrics/cadvisor", "image": "registry.local/workload:1"}
#: Prometheus's default lookback: an instant reads the last sample within it.
LOOKBACK_SECONDS = 300.0
#: Prometheus refuses range queries past this many points a series.
MAX_POINTS = 11_000
#: gzip at level 1: Go's default level 6 writes about a tenth fewer bytes
#: and takes several times as long to make.
GZIP_LEVEL = 1
#: Planted faults (the benchmark's tests): ``drop_last`` leaves out one
#: pod's last sample (``fault_pod``), ``other_set`` serves each set the
#: next set's samples, ``three_digits`` writes values at three significant
#: digits, bfloat16's precision.
FAULTS = frozenset({"drop_last", "other_set", "three_digits"})


class BadData(Exception):
    """A query the fake refuses: answered 400 with ``errorType`` ``bad_data``."""


# ----------------------------------------------------------------- values
def go_float(value: float) -> str:
    """``value`` as Go's ``strconv.FormatFloat(value, 'f', -1, 64)`` writes
    it: the shortest decimal that reads back to the same double, without an
    exponent (Prometheus writes sample values so, and ``NaN``, ``+Inf``,
    ``-Inf``)."""
    if value != value:
        return "NaN"
    if math.isinf(value):
        return "+Inf" if value > 0 else "-Inf"
    text = repr(float(value))
    if "e" in text:
        mantissa, exponent = text.split("e")
        sign = "-" if mantissa.startswith("-") else ""
        mantissa = mantissa.lstrip("-")
        point = mantissa.find(".")
        digits = mantissa.replace(".", "")
        position = (len(mantissa) if point < 0 else point) + int(exponent)
        if position <= 0:
            return f"{sign}0.{'0' * -position}{digits}"
        if position >= len(digits):
            return sign + digits + "0" * (position - len(digits))
        return f"{sign}{digits[:position]}.{digits[position:]}"
    return text[:-2] if text.endswith(".0") else text


def format_values(values: np.ndarray, digits: Optional[int] = None) -> list:
    """Each of ``values`` as :func:`go_float` writes it (whole numbers by
    the integer path, the rest by ``repr`` and a fix of the few that
    ``repr`` writes with an exponent or a trailing ``.0``); ``digits``
    rounds each to that many significant digits first."""
    if digits is not None:
        return [go_float(float(f"{v:.{digits}g}")) for v in values.tolist()]
    if len(values) and np.all(np.isfinite(values)) and np.all(values == np.floor(values)) and np.all(
            np.abs(values) < 2.0**53) and not np.any(np.signbit(values) & (values == 0)):
        return list(map(str, values.astype(np.int64).tolist()))
    texts = list(map(float.__repr__, values.tolist()))
    magnitude = np.abs(values)
    odd = ~np.isfinite(values) | (magnitude < 1e-4) | (magnitude >= 1e16) | (values == np.floor(values))
    for i in np.flatnonzero(odd).tolist():
        texts[i] = go_float(float(values[i]))
    return texts


def go_time(seconds: float) -> str:
    """A timestamp as Prometheus writes it: seconds, to the millisecond."""
    return go_float(round(seconds * 1000.0) / 1000.0)


def json_time(seconds: float):
    """A timestamp for ``json.dumps``, written as :func:`go_time` writes it."""
    seconds = round(seconds * 1000.0) / 1000.0
    return int(seconds) if seconds == int(seconds) else seconds


# ----------------------------------------------------------------- PromQL
_TOKEN = re.compile(
    r"\s*(?:(?P<name>[A-Za-z_:][A-Za-z0-9_:]*)|(?P<string>\"(?:[^\"\\]|\\.)*\"|'(?:[^'\\]|\\.)*')"
    r"|(?P<op>=~|!~|!=|=)|(?P<punct>[(){},]))",
    re.S,
)
_ESCAPES = {"a": "\a", "b": "\b", "f": "\f", "n": "\n", "r": "\r", "t": "\t", "v": "\v", "\\": "\\"}
_DIGITS = {"x": (2, 16), "u": (4, 16), "U": (8, 16)}


def unquote(text: str) -> str:
    """A PromQL string literal's value. Its escapes are Go's; any other,
    such as ``\\-`` or ``\\.``, raises :class:`BadData` as Prometheus's
    lexer does (``unknown escape sequence``)."""
    quote, body = text[0], text[1:-1]
    out, i = [], 0
    while i < len(body):
        char = body[i]
        if char != "\\":
            out.append(char)
            i += 1
            continue
        escape = body[i + 1]
        if escape in _ESCAPES or escape == quote:
            out.append(_ESCAPES.get(escape, quote))
            i += 2
        elif escape in "01234567" or escape in _DIGITS:
            count, base = (3, 8) if escape in "01234567" else _DIGITS[escape]
            start = i + 1 if base == 8 else i + 2
            digits = body[start:start + count]
            if not re.fullmatch(f"[0-7]{{{count}}}" if base == 8 else f"[0-9a-fA-F]{{{count}}}", digits):
                raise BadData(f"parse error: invalid escape sequence in {text}")
            out.append(chr(int(digits, base)))
            i = start + count
        else:
            raise BadData(f"parse error: unknown escape sequence U+{ord(escape):04X} '{escape}'")
    return "".join(out)


@dataclass(frozen=True)
class Matcher:
    name: str
    op: str
    value: str

    def test(self, labels: dict) -> bool:
        actual = labels.get(self.name, "")
        if self.op == "=":
            return actual == self.value
        if self.op == "!=":
            return actual != self.value
        found = re.fullmatch(self.value, actual) is not None
        return found if self.op == "=~" else not found


@dataclass(frozen=True)
class Selector:
    matchers: tuple  # of Matcher; the metric name is a __name__ matcher


@dataclass(frozen=True)
class Sum:
    by: tuple  # label names
    inner: Selector


@dataclass(frozen=True)
class Count:
    inner: object  # Selector or Sum


class _Parser:
    """Recursive descent over the subset the module docstring names."""

    def __init__(self, text: str) -> None:
        self.tokens, position = [], 0
        text = text.rstrip()
        while position < len(text):
            match = _TOKEN.match(text, position)
            if match is None or match.end() == position:
                raise BadData(f"parse error: unexpected character at position {position}: {text[position:position + 20]!r}")
            kind = match.lastgroup
            self.tokens.append((kind, match.group(kind)))
            position = match.end()
        self.at = 0

    def peek(self, value: Optional[str] = None):
        if self.at >= len(self.tokens):
            return None
        token = self.tokens[self.at]
        return token if value is None or token[1] == value else None

    def take(self, kind: Optional[str] = None, value: Optional[str] = None) -> str:
        token = self.peek()
        if token is None or (kind is not None and token[0] != kind) or (value is not None and token[1] != value):
            raise BadData(f"parse error: unexpected {token[1] if token else 'end of input'!r}, "
                          f"expected {value or kind}")
        self.at += 1
        return token[1]

    def parse(self):
        expression = self.expression()
        if self.peek() is not None:
            raise BadData(f"parse error: unexpected {self.peek()[1]!r} after the expression")
        return expression

    def expression(self):
        token = self.peek()
        if token is not None and token[0] == "name" and token[1] == "count" and self._next_is("("):
            self.take()
            self.take("punct", "(")
            inner = self.expression()
            self.take("punct", ")")
            if isinstance(inner, Count):
                raise BadData("the fake evaluates count() over a selector or sum by alone")
            return Count(inner)
        if token is not None and token[0] == "name" and token[1] == "sum" and self._next_is("by"):
            self.take()
            self.take("name", "by")
            self.take("punct", "(")
            by = []
            while not self.peek(")"):
                by.append(self.take("name"))
                if not self.peek(")"):
                    self.take("punct", ",")
            self.take("punct", ")")
            self.take("punct", "(")
            inner = self.expression()
            self.take("punct", ")")
            if not isinstance(inner, Selector):
                raise BadData("the fake evaluates sum by (...) over a selector alone")
            return Sum(tuple(by), inner)
        return self.selector()

    def _next_is(self, value: str) -> bool:
        return self.at + 1 < len(self.tokens) and self.tokens[self.at + 1][1] == value

    def selector(self) -> Selector:
        matchers = []
        token = self.peek()
        if token is not None and token[0] == "name":
            matchers.append(Matcher("__name__", "=", self.take("name")))
        if self.peek("{"):
            self.take("punct", "{")
            while not self.peek("}"):
                name = self.take("name")
                op = self.take("op")
                value = unquote(self.take("string"))
                if op in ("=~", "!~"):
                    try:
                        re.compile(value)
                    except re.error as e:
                        raise BadData(f"parse error: invalid regular expression {value!r}: {e}") from None
                matchers.append(Matcher(name, op, value))
                if not self.peek("}"):
                    self.take("punct", ",")
            self.take("punct", "}")
        if not matchers:
            raise BadData("parse error: no expression the fake evaluates")
        return Selector(tuple(matchers))


def parse(text: str):
    """The expression ``text``, or :class:`BadData`."""
    try:
        return _Parser(text).parse()
    except BadData as e:
        raise BadData(f'invalid parameter "query": {e}') from None


_DURATION = re.compile(r"(\d+)(ms|s|m|h|d|w|y)")
_UNIT_SECONDS = {"ms": 0.001, "s": 1, "m": 60, "h": 3600, "d": 86400, "w": 604800, "y": 31536000}


def parse_seconds(text: str, what: str) -> float:
    """A step as Prometheus reads it: float seconds or a duration (``15m``)."""
    try:
        return float(text)
    except ValueError:
        pass
    parts = _DURATION.findall(text)
    if not parts or "".join(a + b for a, b in parts) != text:
        raise BadData(f'invalid parameter "{what}": cannot parse "{text}" to a valid duration')
    return float(sum(int(a) * _UNIT_SECONDS[b] for a, b in parts))


def parse_time(text: str, what: str) -> float:
    try:
        return float(text)
    except ValueError:
        raise BadData(f'invalid parameter "{what}": cannot parse "{text}" to a valid timestamp') from None


# ------------------------------------------------------------ the samples
@dataclass(frozen=True)
class Grid:
    """The sample grid: ``points`` timestamps ``end - step * (points - 1)
    .. end``; a pod with ``n`` samples holds the last ``n``, index ``points
    - n`` to ``points - 1``."""

    end: float
    step: float
    points: int

    @property
    def origin(self) -> float:
        return self.end - self.step * (self.points - 1)

    def stamp(self, index: int) -> float:
        return self.origin + self.step * index


class _Rendering:
    """The rendered and deflated pieces of one resource, in shared
    anonymous memory: piece ``p`` holds ``lengths[p]`` samples from
    ``offsets[p]`` of the resource's values, at grid indices up to
    ``lasts[p]``."""

    def __init__(self, values: np.ndarray, offsets: np.ndarray, lengths: np.ndarray, lasts: np.ndarray,
                 grid: Grid, digits: Optional[int]) -> None:
        self.values, self.offsets, self.lengths, self.lasts = values, offsets, lengths, lasts
        self.grid, self.digits = grid, digits
        self.prefixes = [f'[{go_time(grid.stamp(i))},"' for i in range(grid.points)]
        # A pair is '[' time ',"' value '"],' : the bound covers values of up
        # to 27 characters; a longer piece comes back by the pipe instead.
        bound = lengths * (max(map(len, self.prefixes), default=0) + 30) + 64
        self.raw_starts = np.concatenate([[0], np.cumsum(bound)[:-1]]).astype(np.int64)
        self.raw_bounds = bound
        self.gz_starts = np.concatenate([[0], np.cumsum(bound + bound // 500 + 64)[:-1]]).astype(np.int64)
        self.gz_bounds = bound + bound // 500 + 64
        total = int(self.gz_starts[-1] + self.gz_bounds[-1]) if len(bound) else 1
        self.raw_map = mmap.mmap(-1, max(1, int(bound.sum())))
        self.gz_map = mmap.mmap(-1, max(1, total))
        #: Per piece (text, deflated, the text's CRC-32, its length).
        self.parts: list = [None] * len(lengths)

    def render(self, piece: int) -> bytes:
        n, last = int(self.lengths[piece]), int(self.lasts[piece])
        start = int(self.offsets[piece])
        if n == 0:
            return b""
        texts = format_values(self.values[start:start + n], self.digits)
        return ('"],'.join(map(str.__add__, self.prefixes[last - n + 1:last + 1], texts)) + '"]').encode()

    def fill(self, low: int, high: int) -> list:
        """Render and deflate pieces ``low`` to ``high`` into the shared
        maps (in a worker); returns per piece its two lengths, or the bytes
        themselves where a piece outgrew its bound, and its text's CRC-32."""
        out = []
        for piece in range(low, high):
            raw = self.render(piece)
            gz = deflate(raw)
            if len(raw) <= self.raw_bounds[piece] and len(gz) <= self.gz_bounds[piece]:
                r, g = int(self.raw_starts[piece]), int(self.gz_starts[piece])
                self.raw_map[r:r + len(raw)] = raw
                self.gz_map[g:g + len(gz)] = gz
                out.append((len(raw), len(gz), zlib.crc32(raw)))
            else:
                out.append((raw, gz, zlib.crc32(raw)))
        return out

    def keep(self, low: int, results: list) -> None:
        raw_view, gz_view = memoryview(self.raw_map), memoryview(self.gz_map)
        for piece, (raw, gz, crc) in enumerate(results, start=low):
            if isinstance(raw, int):
                r, g = int(self.raw_starts[piece]), int(self.gz_starts[piece])
                raw, gz = raw_view[r:r + raw], gz_view[g:g + gz]
            self.parts[piece] = (raw, gz, crc, len(raw))


def deflate(data) -> bytes:
    """``data`` as a raw deflate run that ends in a full flush, so that runs
    made apart join into one stream."""
    compressor = zlib.compressobj(GZIP_LEVEL, zlib.DEFLATED, -zlib.MAX_WBITS)
    return compressor.compress(data) + compressor.flush(zlib.Z_FULL_FLUSH)


def stored(data: bytes) -> bytes:
    """``data`` as deflate stored blocks: no compressor is made for a head
    of a few dozen bytes, which deflate would not shorten."""
    return b"".join(b"\x00" + struct.pack("<HH", len(chunk), len(chunk) ^ 0xFFFF) + chunk
                    for chunk in (data[i:i + 0xFFFF] for i in range(0, len(data), 0xFFFF)))


_FINAL_BLOCK = zlib.compressobj(GZIP_LEVEL, zlib.DEFLATED, -zlib.MAX_WBITS).flush(zlib.Z_FINISH)
_GZIP_HEADER = b"\x1f\x8b\x08\x00\x00\x00\x00\x00\x00\xff"


class Gzip:
    """Joins parts (text, deflated, the text's CRC-32, its length) into one
    gzip member: their deflate runs under one header, the final block and a
    trailer whose CRC-32 is combined from the parts' own, so the texts are
    never read again: crc(a + b) = crc32(zeros(len(b)), crc(a)) ^ crc(b) ^
    crc(zeros(len(b)))."""

    def __init__(self) -> None:
        self._zeros = bytes(1 << 16)
        self._zero_crcs: dict = {}

    def join(self, parts: list) -> bytes:
        crc, size = 0, 0
        for _raw, _gz, part_crc, length in parts:
            if length > len(self._zeros):
                self._zeros = bytes(2 * length)
            zeros = memoryview(self._zeros)[:length]
            zero_crc = self._zero_crcs.get(length)
            if zero_crc is None:
                zero_crc = self._zero_crcs[length] = zlib.crc32(zeros)
            crc = zlib.crc32(zeros, crc) ^ part_crc ^ zero_crc
            size += length
        trailer = struct.pack("<II", crc, size & 0xFFFFFFFF)
        return b"".join([_GZIP_HEADER, *(gz for _raw, gz, _crc, _length in parts), _FINAL_BLOCK, trailer])


_WORKER_RENDERINGS: dict = {}


def _worker_init(renderings: dict) -> None:
    _WORKER_RENDERINGS.update(renderings)


def _worker_fill(resource: str, low: int, high: int) -> list:
    return _WORKER_RENDERINGS[resource].fill(low, high)


def _part(data: bytes, deflated: Optional[bytes] = None) -> tuple:
    """(text, deflated, CRC-32, length): a part of a response."""
    return data, deflate(data) if deflated is None else deflated, zlib.crc32(data), len(data)


_MATRIX_HEAD = _part(b'{"status":"success","data":{"resultType":"matrix","result":[')
_SERIES_SEP = _part(b"]},")
_MATRIX_END = _part(b"]}]}}")
_EMPTY_END = _part(b"]}}")


class Fake:
    """The series, the pieces and the answers (the child process's state)."""

    def __init__(self, init: dict, values: dict, workers: int) -> None:
        self.grid = Grid(float(init["end"]), float(init["step"]), int(init["window"]))
        self.sets = int(init["sets"])
        series = init["series"]
        lengths = np.asarray(init["pod_samples"], dtype=np.int64)
        starts = np.concatenate([[0], np.cumsum(lengths)[:-1]]).astype(np.int64)
        fault, fault_pod = init.get("fault"), init.get("fault_pod")
        if fault is not None and fault not in FAULTS:
            raise ValueError(f"unknown fault {fault!r}")
        # Each (set, pod) reads a piece: its samples' offset, count and last
        # grid index; sets turned by whole pods share their pieces.
        keys = []
        for k in range(self.sets):
            data = (k + 1) % self.sets if fault == "other_set" else k
            offsets = data * int(init["shift"]) + starts
            ends = np.full(len(lengths), self.grid.points - 1, dtype=np.int64)
            counts = lengths.copy()
            if fault == "drop_last":
                counts[fault_pod] -= 1
                ends[fault_pod] -= 1
            keys.append(np.stack([offsets, counts, ends], axis=1))
        table, inverse = np.unique(np.concatenate(keys), axis=0, return_inverse=True)
        self.piece_of = inverse.reshape(self.sets, len(lengths))
        self.first = table[:, 2] - table[:, 1] + 1  # grid index of each piece's first sample
        self.last = table[:, 2]
        self.values = values
        digits = 3 if fault == "three_digits" else None
        self.renderings = {name: _Rendering(values[name], table[:, 0], table[:, 1], table[:, 2], self.grid, digits)
                           for name in values}
        self._fill(workers)
        self.series = {
            CPU_METRIC: [{"__name__": CPU_METRIC, "container": c, "namespace": ns, "pod": pod} for ns, pod, c in series],
            MEMORY_METRIC: [{"__name__": MEMORY_METRIC, "container": c, "namespace": ns, "pod": pod, **MEMORY_LABELS}
                            for ns, pod, c in series],
        }
        self.resource = {CPU_METRIC: "cpu", MEMORY_METRIC: "memory"}
        self.by_namespace: dict = {}
        for j, (ns, _pod, _c) in enumerate(series):
            self.by_namespace.setdefault(ns, []).append(j)
        self.gzip = Gzip()
        self._selections: dict = {}
        self._heads: dict = {}
        self._slices: dict = {}
        self._offsets: dict = {}

    def _fill(self, workers: int) -> None:
        tasks = []
        for name, rendering in self.renderings.items():
            count = len(rendering.lengths)
            size = max(1, -(-count // (4 * workers)))
            tasks += [(name, low, min(low + size, count)) for low in range(0, count, size)]
        if workers <= 1 or len(tasks) <= 1:
            for name, low, high in tasks:
                self.renderings[name].keep(low, self.renderings[name].fill(low, high))
            return
        # fork shares the values and the output maps without a copy; no
        # thread runs in this process yet, so forking is safe here.
        if threading.active_count() != 1:
            raise RuntimeError("the fake forks its renderers before any thread starts")
        from concurrent.futures import ProcessPoolExecutor

        with ProcessPoolExecutor(max_workers=workers, mp_context=multiprocessing.get_context("fork"),
                                 initializer=_worker_init, initargs=(self.renderings,)) as pool:
            futures = [(name, low, pool.submit(_worker_fill, name, low, high)) for name, low, high in tasks]
            for name, low, future in futures:
                self.renderings[name].keep(low, future.result())

    # ------------------------------------------------------------ select
    def select(self, selector: Selector) -> list:
        """(metric, series index) of every series ``selector`` matches."""
        cached = self._selections.get(selector)
        if cached is not None:
            return cached
        out = []
        for metric, labels in self.series.items():
            if not all(m.test({"__name__": metric}) for m in selector.matchers if m.name == "__name__"):
                continue
            candidates = range(len(labels))
            for m in selector.matchers:
                if m.name == "namespace" and m.op in ("=", "=~"):
                    names = [ns for ns in self.by_namespace if m.test({"namespace": ns})]
                    candidates = sorted(j for ns in names for j in self.by_namespace[ns])
                    break
            others = [m for m in selector.matchers if m.name != "__name__"]
            out += [(metric, j) for j in candidates if all(m.test(labels[j]) for m in others)]
        self._selections[selector] = out
        return out

    def grouped(self, expression) -> list:
        """(output labels, metric, series index) of a selector or a sum by,
        sorted by labels as Prometheus sorts a matrix."""
        key = ("grouped", expression)
        cached = self._selections.get(key)
        if cached is not None:
            return cached
        selector = expression.inner if isinstance(expression, Sum) else expression
        groups: dict = {}
        for metric, j in self.select(selector):
            labels = self.series[metric][j]
            if isinstance(expression, Sum):
                out = tuple(sorted((name, labels[name]) for name in set(expression.by) if labels.get(name, "")))
            else:
                out = tuple(sorted(labels.items()))
            groups.setdefault(out, []).append((metric, j))
        for out, members in groups.items():
            if len(members) > 1:
                raise BadData(f"the fake sums one series a group; {dict(out)} holds {len(members)}")
        result = [(out, *members[0]) for out, members in sorted(groups.items())]
        self._selections[key] = result
        return result

    def head(self, labels: tuple) -> tuple:
        part = self._heads.get(labels)
        if part is None:
            data = ('{"metric":' + json.dumps(dict(labels), separators=(",", ":"), ensure_ascii=False)
                    + ',"values":[').encode()
            part = self._heads[labels] = _part(data, stored(data))
        return part

    def piece_slice(self, resource: str, piece: int, low: int, high: int) -> tuple:
        """The part of grid indices ``low`` to ``high`` of a piece (the whole
        piece, or a slice deflated on first use and kept)."""
        rendering = self.renderings[resource]
        first, last = int(self.first[piece]), int(self.last[piece])
        if low == first and high == last:
            return rendering.parts[piece]
        key = (resource, piece, low, high)
        part = self._slices.get(key)
        if part is None:
            raw = rendering.parts[piece][0]
            offsets = self._offsets.get((resource, piece))
            if offsets is None:
                marks = np.flatnonzero(np.frombuffer(raw, dtype=np.uint8) == ord("["))
                offsets = self._offsets[(resource, piece)] = np.append(marks, len(raw) + 1)
            part = self._slices[key] = _part(bytes(raw[offsets[low - first]:offsets[high - first + 1] - 1]))
        return part

    # ------------------------------------------------------------ answer
    def query_range(self, sample_set: int, params: dict, gzip: bool) -> bytes:
        expression = parse(_param(params, "query"))
        if isinstance(expression, Count):
            raise BadData("the fake evaluates count() as an instant query alone")
        start, end = parse_time(_param(params, "start"), "start"), parse_time(_param(params, "end"), "end")
        step = parse_seconds(_param(params, "step"), "step")
        if end < start:
            raise BadData('invalid parameter "end": end timestamp must not be before start time')
        if step <= 0:
            raise BadData('invalid parameter "step": zero or negative query resolution step widths are not accepted')
        if (end - start) / step >= MAX_POINTS:
            raise BadData("exceeded maximum resolution of 11,000 points per timeseries. "
                          "Try decreasing the query resolution (?step=XX)")
        offset = (start - self.grid.origin) / self.grid.step
        if step != self.grid.step or offset != round(offset):
            raise BadData(f"the fake evaluates ranges on its grid alone: step {self.grid.step:g} s from "
                          f"{go_time(self.grid.origin)}")
        low = int(round(offset))
        high = low + int((end - start) // step)
        parts = [_MATRIX_HEAD]
        for labels, metric, j in self.grouped(expression):
            piece = int(self.piece_of[sample_set, j])
            first, last = max(low, int(self.first[piece])), min(high, int(self.last[piece]))
            if first > last:
                continue
            if len(parts) > 1:
                parts.append(_SERIES_SEP)
            parts.append(self.head(labels))
            parts.append(self.piece_slice(self.resource[metric], piece, first, last))
        parts.append(_MATRIX_END if len(parts) > 1 else _EMPTY_END)
        return self.gzip.join(parts) if gzip else b"".join(part[0] for part in parts)

    def query(self, sample_set: int, params: dict) -> bytes:
        expression = parse(_param(params, "query"))
        at = parse_time(params["time"], "time") if "time" in params else time.time()
        index = math.floor((at - self.grid.origin) / self.grid.step)
        fresh = 0 <= index < self.grid.points and at - self.grid.stamp(index) < LOOKBACK_SECONDS
        inner = expression.inner if isinstance(expression, Count) else expression
        present = []
        for labels, metric, j in self.grouped(inner):
            piece = int(self.piece_of[sample_set, j])
            if fresh and self.first[piece] <= index <= self.last[piece]:
                position = int(self.renderings[self.resource[metric]].offsets[piece]) + index - int(self.first[piece])
                present.append((labels, float(self.values[self.resource[metric]][position])))
        stamp = json_time(at)
        if isinstance(expression, Count):
            result = [{"metric": {}, "value": [stamp, go_float(float(len(present)))]}] if present else []
        else:
            result = [{"metric": dict(labels), "value": [stamp, go_float(value)]} for labels, value in present]
        return json.dumps({"status": "success", "data": {"resultType": "vector", "result": result}},
                          separators=(",", ":")).encode()


def _param(params: dict, name: str) -> str:
    if name not in params:
        raise BadData(f'invalid parameter "{name}": missing')
    return params[name]


def _accepts_gzip(header: Optional[str]) -> bool:
    for item in (header or "").split(","):
        coding, _, quality = item.strip().partition(";")
        if coding.strip().lower() == "gzip":
            q = quality.strip()
            return not (q.startswith("q=") and float(q[2:] or 0) == 0)
    return False


_ROUTE = re.compile(r"/set-(\d+)(/api/v1/query(?:_range)?)\Z")


def _handler(fake: Fake):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, format, *args):  # noqa: A002 - the base class's name
            pass

        def do_GET(self):
            self._answer(None)

        def do_POST(self):
            length = int(self.headers.get("Content-Length") or 0)
            self._answer(self.rfile.read(length).decode())

        def _answer(self, form: Optional[str]) -> None:
            url = urllib.parse.urlsplit(self.path)
            route = _ROUTE.match(url.path)
            if route is None or int(route.group(1)) >= fake.sets:
                self._send(404, b"404 page not found\n", "text/plain; charset=utf-8")
                return
            params = {k: v[-1] for k, v in urllib.parse.parse_qs(url.query, keep_blank_values=True).items()}
            if form:
                params.update({k: v[-1] for k, v in urllib.parse.parse_qs(form, keep_blank_values=True).items()})
            sample_set, gzip = int(route.group(1)), _accepts_gzip(self.headers.get("Accept-Encoding"))
            try:
                if route.group(2).endswith("_range"):
                    body = fake.query_range(sample_set, params, gzip)
                else:
                    body = fake.query(sample_set, params)
                    body = fake.gzip.join([_part(body)]) if gzip else body
            except BadData as e:
                error = {"status": "error", "errorType": "bad_data", "error": str(e)}
                self._send(400, json.dumps(error).encode(), "application/json")
                return
            except Exception:  # a fault of the fake: say so, and keep serving
                traceback.print_exc()
                self._send(500, b'{"status":"error","errorType":"internal","error":"the fake failed"}',
                           "application/json")
                return
            self._send(200, body, "application/json", "gzip" if gzip else None)

        def _send(self, status: int, body: bytes, kind: str, encoding: Optional[str] = None) -> None:
            self.send_response(status)
            self.send_header("Content-Type", kind)
            if encoding is not None:
                self.send_header("Content-Encoding", encoding)
            self.send_header("Vary", "Accept-Encoding")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    return Handler


# -------------------------------------------------------------- processes
def _read_into(stream, buffer: memoryview) -> None:
    """Fill ``buffer`` from ``stream`` (no allocation the size of it)."""
    done = 0
    while done < len(buffer):
        count = stream.readinto(buffer[done:])
        if not count:
            raise EOFError(f"the samples ended after {done} of {len(buffer)} bytes")
        done += count


def main() -> int:
    """The child process (``python -m benchmark.prometheus``): the fleet
    from standard input, then serve until standard input closes (the
    parent stops it, or is gone). One JSON line on standard output says
    where it listens."""
    stdin, stdout = sys.stdin.buffer, sys.stdout.buffer
    alive = time.time()
    init = pickle.load(stdin)  # written by the parent, :func:`served`
    values = {}
    for name, size in init.pop("arrays"):
        values[name] = np.empty(size, dtype=np.float64)
        _read_into(stdin, memoryview(values[name]).cast("B"))
    received = time.time()
    fake = Fake(init, values, render_workers())
    server = ThreadingHTTPServer(("127.0.0.1", 0), _handler(fake))
    server.daemon_threads = True
    thread = threading.Thread(target=server.serve_forever, name="prometheus", daemon=True)
    thread.start()
    stdout.write(json.dumps({"port": server.server_address[1], "times": [alive, received, time.time()]}).encode()
                 + b"\n")
    stdout.flush()
    try:
        stdin.read()
    finally:
        server.shutdown()
        server.server_close()
    return 0


@dataclass
class Served:
    """A running fake: its base URL, its end timestamp, its process, and
    the seconds its set-up took by phase (``start``: the process up,
    ``data``: the samples received, ``render``: rendered and deflated)."""

    base: str
    end: float
    process: subprocess.Popen
    phases: dict

    def url(self, sample_set: int) -> str:
        return f"{self.base}/set-{sample_set}"

    def cpu_seconds(self) -> Optional[float]:
        """The process's user and system CPU seconds so far, from
        ``/proc/<pid>/stat``; None where that cannot be read."""
        try:
            with open(f"/proc/{self.process.pid}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except OSError:
            return None
        return (int(fields[11]) + int(fields[12])) / os.sysconf("SC_CLK_TCK")


def render_workers() -> int:
    """Processes that render the samples: the cores this process may use, at most 8."""
    return max(1, min(8, len(os.sched_getaffinity(0))))


@contextlib.contextmanager
def served(series: list, pod_samples: np.ndarray, values: dict, *, shift: int, sets: int, end: float, step: float,
           window: int, fault: Optional[str] = None, fault_pod: Optional[int] = None):
    """Serve ``values`` (resource → float64 samples of every pod, in pod
    order, ``sets`` sets each turned ``shift`` further along) for the pods
    ``series`` ((namespace, pod, container) each, ``pod_samples`` samples
    each), on a grid of ``window`` points of ``step`` seconds ending at
    ``end``. Yields a :class:`Served`; the process is gone when the block
    ends, on error too. The process is started as a new program and fed
    through a pipe: nothing of this process's memory is copied to it."""
    started = time.time()
    process = subprocess.Popen([sys.executable, "-m", "benchmark.prometheus"], cwd=_ROOT,
                               stdin=subprocess.PIPE, stdout=subprocess.PIPE)
    try:
        pickle.dump({"series": series, "pod_samples": np.asarray(pod_samples), "shift": shift, "sets": sets,
                     "end": end, "step": step, "window": window, "fault": fault, "fault_pod": fault_pod,
                     "arrays": [(name, len(array)) for name, array in values.items()]},
                    process.stdin, protocol=pickle.HIGHEST_PROTOCOL)
        for array in values.values():
            process.stdin.write(memoryview(np.ascontiguousarray(array, dtype=np.float64)).cast("B"))
        process.stdin.flush()
        line = process.stdout.readline()
        if not line:
            raise RuntimeError(f"the fake Prometheus did not start (exit code {process.wait(timeout=30)})")
        ready = json.loads(line)
        alive, received, rendered = ready["times"]
        phases = {"start": alive - started, "data": received - alive, "render": rendered - received}
        yield Served(base=f"http://127.0.0.1:{ready['port']}", end=end, process=process, phases=phases)
    finally:
        with contextlib.suppress(OSError):
            process.stdin.close()
        try:
            process.wait(timeout=30)
        except subprocess.TimeoutExpired:
            process.kill()
            process.wait(timeout=30)
        process.stdout.close()


if __name__ == "__main__":
    sys.exit(main())
