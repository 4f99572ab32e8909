"""Rich-table formatter — the default human-facing output.

Layout-compatible with the reference's table
(`robusta_krr/formatters/table.py:45-92`): rows grouped by
(cluster, namespace, name) with repeated fields blanked, each cell rendered as
``current -> recommended`` in the cell severity's color, values humanized to 4
significant digits, ``none`` for absent values and ``?`` for unknown.

At fleet scale the rich ``Table`` machinery is the bottleneck, not the data:
its per-cell measuring/wrapping pass costs ~14 s at 10 k rows (measured round
3) — ~2.3 minutes at the 100 k-container headline workload, dwarfing the
device compute it reports on. Above :attr:`TableFormatter.FAST_PATH_THRESHOLD`
scans the formatter therefore renders the same columns, grouping, and severity
colors through a plain aligned-text writer (O(cells) string work, no
measuring), returned as a string that ``print_result`` writes raw. Small-scale
output keeps the exact rich rendering. Both renderers consume one shared row
generator (:meth:`TableFormatter._iter_rows`), so the column set, grouping,
and blanking rules cannot diverge between them.
"""

from __future__ import annotations

import functools
import itertools
import sys
from typing import Iterator, Optional, Union

from rich.cells import cell_len
from rich.console import Console
from rich.markup import escape
from rich.style import Style
from rich.table import Table

from krr_tpu_torch.formatters.base import BaseFormatter
from krr_tpu_torch.models.allocations import RecommendationValue, ResourceType
from krr_tpu_torch.models.result import ResourceScan, Result
from krr_tpu_torch.utils import resource_units

NONE_LITERAL = "none"
NAN_LITERAL = "?"
PRECISION = 4


def _humanize(value: RecommendationValue, precision: Optional[int] = None) -> str:
    if value is None:
        return NONE_LITERAL
    if isinstance(value, str):
        return NAN_LITERAL
    return resource_units.format(value, precision)


@functools.lru_cache(maxsize=None)
def _ansi_codes(color: str) -> tuple[str, str]:
    """(prefix, suffix) ANSI escapes for a rich style name, derived from rich
    itself so the fast path's palette can never drift from ``Severity.color``
    — including rich's behavior of rendering unparseable styles unstyled."""
    try:
        rendered = Style.parse(color).render("\x00")
    except Exception:
        return "", ""  # rich renders unknown styles as plain text
    prefix, _, suffix = rendered.partition("\x00")
    return prefix, suffix


class TableFormatter(BaseFormatter):
    """Formatter for rich text-table output."""

    __display_name__ = "table"

    #: Above this many scans, render via the plain fast path (see module
    #: docstring). Class attribute so tests (and plugins) can tune it.
    FAST_PATH_THRESHOLD = 1000

    _HEADERS = ("Number", "Cluster", "Namespace", "Name", "Pods", "Type", "Container")
    _CELL_SELECTORS = tuple(
        (resource, selector) for resource in ResourceType for selector in ("requests", "limits")
    )

    @staticmethod
    def _group_key(pair):
        return (pair[1].object.cluster, pair[1].object.namespace, pair[1].object.name)

    @staticmethod
    def _cell(scan: ResourceScan, resource: ResourceType, selector: str) -> tuple[str, str]:
        allocated = getattr(scan.object.allocations, selector)[resource]
        recommended = getattr(scan.recommended, selector)[resource]
        return (
            f"{_humanize(allocated)} -> {_humanize(recommended.value, PRECISION)}",
            recommended.severity.color,
        )

    def _iter_rows(
        self, result: Result
    ) -> Iterator[tuple[int, str, tuple[str, ...], list[tuple[str, str]], bool]]:
        """The one source of row structure for both renderers: yields
        ``(scan_index, severity_color, object_fields, resource_cells, last)``
        per scan, with repeated group fields already blanked (groups keyed by
        (cluster, namespace, name), reference `table.py:67-69`)."""
        for _, group in itertools.groupby(enumerate(result.scans), key=self._group_key):
            rows = list(group)
            for j, (i, scan) in enumerate(rows):
                first = j == 0
                fields = (
                    (scan.object.cluster or "") if first else "",
                    scan.object.namespace if first else "",
                    scan.object.name if first else "",
                    str(len(scan.object.pods)) if first else "",
                    (scan.object.kind or "") if first else "",
                    scan.object.container,
                )
                cells = [self._cell(scan, resource, selector) for resource, selector in self._CELL_SELECTORS]
                yield i, scan.severity.color, fields, cells, j == len(rows) - 1

    def format(self, result: Result) -> Union[Table, str]:
        if len(result.scans) > self.FAST_PATH_THRESHOLD:
            # The switch changes the output's exact shape (plain aligned text
            # vs rich's console-fitted table, documented in PARITY.md) —
            # surface it once for anyone parsing table output at fleet scale
            # (round-4 advisor note). stderr, so piped stdout stays clean.
            print(
                f"krr-tpu: {len(result.scans)} scans > {self.FAST_PATH_THRESHOLD}: "
                "rendering the fleet-scale plain table (fixed-width, not "
                "console-fitted); use -f json/yaml for machine parsing",
                file=sys.stderr,
            )
            return self._format_plain(result)
        table = Table(show_header=True, header_style="bold magenta", title=f"Scan result ({result.score} points)")
        table.add_column("Number", justify="right", no_wrap=True)
        for column in self._HEADERS[1:]:
            table.add_column(column, style="cyan")
        for resource in ResourceType:
            table.add_column(f"{resource.name} Requests")
            table.add_column(f"{resource.name} Limits")

        for i, severity_color, fields, cells, last in self._iter_rows(result):
            # Object fields are arbitrary user strings (cluster context names
            # especially) — escape them so bracketed text can't be eaten by
            # (or crash) rich markup parsing.
            table.add_row(
                f"[{severity_color}]{i + 1}.[/{severity_color}]",
                *[escape(field) for field in fields],
                *[f"[{color}]{text}[/{color}]" for text, color in cells],
                end_section=last,
            )
        return table

    @staticmethod
    def _use_color() -> bool:
        """Match rich's own color auto-detection (tty-ness, NO_COLOR,
        FORCE_COLOR, TERM=dumb) so the fast path colors exactly when the
        rich path would."""
        console = Console()
        # color_system is None under TERM=dumb even on a tty — rich prints
        # uncolored there, so must we.
        return console.is_terminal and not console.no_color and console.color_system is not None

    def _format_plain(self, result: Result) -> str:
        """Fleet-scale rendering: same columns, grouping, blanking, and
        severity colors as the rich path (shared ``_iter_rows``), emitted as
        one aligned-text string (colored under rich's auto-detection rules,
        so piped output stays clean)."""
        headers = list(self._HEADERS) + [
            f"{resource.name} {selector.title()}" for resource, selector in self._CELL_SELECTORS
        ]

        rows: list[list[tuple[str, str]]] = []
        section_ends: list[bool] = []
        for i, severity_color, fields, cells, last in self._iter_rows(result):
            row = [(f"{i + 1}.", severity_color)]
            row += [(field, "cyan") for field in fields]
            row += cells
            rows.append(row)
            section_ends.append(last)

        # Widths in terminal CELLS (cell_len), not code points — CJK/emoji
        # in cluster names occupy two cells and would shear the borders.
        widths = [cell_len(h) for h in headers]
        for cells in rows:
            for k, (text, _) in enumerate(cells):
                w = cell_len(text)
                if w > widths[k]:
                    widths[k] = w

        colored = self._use_color()

        def paint(text: str, color: str) -> str:
            if not colored:
                return text
            prefix, suffix = _ansi_codes(color)
            return f"{prefix}{text}{suffix}"

        def pad(text: str, width: int, right: bool = False) -> str:
            fill = " " * (width - cell_len(text))
            return fill + text if right else text + fill

        total_width = sum(widths) + 3 * len(widths) + 1
        lines = [f"Scan result ({result.score} points)".center(total_width).rstrip()]
        lines.append("┏" + "┳".join("━" * (w + 2) for w in widths) + "┓")
        lines.append(
            "┃" + "┃".join(f" {paint(pad(h, w), 'bold magenta')} " for h, w in zip(headers, widths)) + "┃"
        )
        header_sep = "┡" + "╇".join("━" * (w + 2) for w in widths) + "┩"
        section_sep = "├" + "┼".join("─" * (w + 2) for w in widths) + "┤"
        bottom = "└" + "┴".join("─" * (w + 2) for w in widths) + "┘"
        lines.append(header_sep)
        for cells, last in zip(rows, section_ends):
            parts = []
            for k, (text, color) in enumerate(cells):
                parts.append(f" {paint(pad(text, widths[k], right=k == 0), color)} ")
            lines.append("│" + "│".join(parts) + "│")
            if last:
                lines.append(section_sep)
        if rows:
            lines[-1] = bottom  # the final section's separator is the border
        else:
            lines.append(bottom)
        return "\n".join(lines)
