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

The JAX package's structured ``--log-format json`` channel, which stamps
each line with the active span's ids (`krr_tpu_torch.obs.trace.current_ids`
is the hook it reads), waits for the port's observability slice (ROADMAP
M8).
"""

from __future__ import annotations

import inspect
import sys
from typing import Any, Literal

from rich.console import Console
from rich.markup import escape

_LEVEL_COLOR = {"INFO": "green", "WARNING": "yellow", "ERROR": "red", "DEBUG": "green"}


class KrrLogger:
    def __init__(self, quiet: bool = False, verbose: bool = False, log_to_stderr: bool = False) -> None:
        self.quiet = quiet
        self.verbose = verbose
        self.log_to_stderr = log_to_stderr
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
        self.console.print(
            f"[bold green][DEBUG][/bold green] {escape(message)}\t\t({frame.filename}:{frame.lineno})"
        )

    def debug_exception(self) -> None:
        if self.debug_active:
            self.console.print_exception()


#: Default logger for components constructed without an explicit one.
NULL_LOGGER = KrrLogger(quiet=True)
