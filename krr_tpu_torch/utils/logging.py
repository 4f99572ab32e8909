"""Console / logging surface.

Mirrors the UX contract of the reference's ``Configurable`` mixin
(`robusta_krr/utils/configurable.py:10-96`):

* colored ``[INFO]/[WARNING]/[ERROR]/[DEBUG]`` prefixes via rich;
* ``--quiet`` suppresses echo, ``--verbose`` enables debug (debug messages are
  stamped with the caller's ``file:line``);
* logs go to stderr iff ``--logtostderr``, while the scan *result* is always
  printed to stdout on a fresh console — this separation is what makes
  ``krr simple -f json > out.json`` work.

Unlike the reference we don't force every component to inherit a mixin; a
single :class:`KrrLogger` is constructed from the config and passed (or the
module default used).

``--log-format json`` switches the log channel to STRUCTURED output: one
JSON object per line (``ts``, ``level``, ``message``, plus ``scan_id`` /
``span_id`` from the active trace span — `krr_tpu_torch.obs.trace.current_ids`)
so log lines correlate with ``--trace`` spans and aggregate cleanly. The
result channel (``print_result``) is untouched either way — machine output
stays byte-exact on stdout.
"""

from __future__ import annotations

import inspect
import json
import sys
import time
import traceback
from typing import Any, Literal

from rich.console import Console
from rich.markup import escape

_LEVEL_COLOR = {"INFO": "green", "WARNING": "yellow", "ERROR": "red", "DEBUG": "green"}


class KrrLogger:
    def __init__(
        self,
        quiet: bool = False,
        verbose: bool = False,
        log_to_stderr: bool = False,
        log_format: Literal["console", "json"] = "console",
    ) -> None:
        self.quiet = quiet
        self.verbose = verbose
        self.log_to_stderr = log_to_stderr
        self.log_format = log_format
        self.console = Console(stderr=log_to_stderr)

    # -- result channel ------------------------------------------------------
    def print_result(self, content: Any) -> None:
        """The scan result always goes to stdout, regardless of --logtostderr.

        Machine output (str — json/yaml/pprint) is written RAW: rich's
        ``Console.print`` soft-wraps at the console width and runs its
        highlighter over the payload, which (a) can insert newlines inside a
        fleet-sized JSON line — corrupting ``-f json > out.json`` — and (b)
        costs minutes on multi-MB results (measured: a 9.6 MB single-line
        payload didn't finish in 10 min; a raw write is instant). Rich
        renderables (the table) still render through a fresh stdout console.
        """
        if isinstance(content, str):
            sys.stdout.write(content)
            if not content.endswith("\n"):
                sys.stdout.write("\n")
            sys.stdout.flush()
        else:
            Console().print(content)

    # -- log channel ---------------------------------------------------------
    @property
    def debug_active(self) -> bool:
        return self.verbose and not self.quiet

    def _emit_json(self, level: str, message: str, **extra: Any) -> None:
        """One structured line on the log stream. ``scan_id``/``span_id``
        come from the active trace span (contextvar — valid on the event
        loop, in tasks, and in ``to_thread`` hops alike), so every line a
        scan produces can be joined back to its trace."""
        from krr_tpu_torch.obs.trace import current_ids

        record: dict[str, Any] = {
            "ts": round(time.time(), 3),
            "level": level,
            "message": message,
        }
        scan_id, span_id = current_ids()
        if scan_id is not None:
            record["scan_id"] = scan_id
            record["span_id"] = span_id
        record.update(extra)
        stream = sys.stderr if self.log_to_stderr else sys.stdout
        stream.write(json.dumps(record) + "\n")
        stream.flush()

    def echo(
        self,
        message: str = "",
        *,
        no_prefix: bool = False,
        type: Literal["INFO", "WARNING", "ERROR"] = "INFO",
        markup: bool = False,
    ) -> None:
        """``markup=False`` (the default) escapes the message so interpolated
        content — exception strings, label selectors — can't be eaten by (or
        crash) rich markup parsing; pass ``markup=True`` for trusted styled
        text like the banner."""
        if self.quiet:
            return
        if self.log_format == "json":
            # Console chrome is not a log event: blank separators, and
            # markup=True content (the ASCII banner is the only trusted
            # styled text).
            if message.strip() and not markup:
                self._emit_json(type, message)
            return
        color = _LEVEL_COLOR[type]
        prefix = "" if no_prefix else f"[bold {color}][{type}][/bold {color}] "
        body = message if markup else escape(message)
        self.console.print(f"{prefix}{body}")

    def info(self, message: str = "") -> None:
        self.echo(message, type="INFO")

    def warning(self, message: str = "") -> None:
        self.echo(message, type="WARNING")

    def error(self, message: str = "") -> None:
        self.echo(message, type="ERROR")

    def debug(self, message: str = "") -> None:
        if not self.debug_active:
            return
        frame = inspect.stack()[1]
        if self.log_format == "json":
            self._emit_json("DEBUG", message, caller=f"{frame.filename}:{frame.lineno}")
            return
        self.console.print(
            f"[bold green][DEBUG][/bold green] {escape(message)}\t\t({frame.filename}:{frame.lineno})"
        )

    def debug_exception(self) -> None:
        if not self.debug_active:
            return
        if self.log_format == "json":
            self._emit_json("DEBUG", traceback.format_exc().rstrip())
            return
        self.console.print_exception()


#: Default logger for components constructed without an explicit one.
NULL_LOGGER = KrrLogger(quiet=True)
