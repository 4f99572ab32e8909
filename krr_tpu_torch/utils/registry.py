"""Shared plugin-registry machinery for strategies and formatters.

Both plugin boundaries follow the same contract (SURVEY.md §1 "plugin
architecture"): defining a subclass registers it under a display name derived
from the class name with a postfix stripped (``SimpleStrategy`` → ``simple``),
overridable via ``__display_name__``; lookups lazily import the built-in
package so defaults are always present.
"""

from __future__ import annotations

from typing import Generic, TypeVar

_T = TypeVar("_T", bound=type)


def strip_postfix(name: str, postfix: str) -> str:
    return name[: -len(postfix)] if name.lower().endswith(postfix.lower()) else name


class PluginRegistry(Generic[_T]):
    def __init__(self, kind: str, postfix: str, builtin_module: str):
        self.kind = kind  # "strategy" / "formatter" — used in error messages
        self.postfix = postfix
        self.builtin_module = builtin_module
        self._entries: dict[str, _T] = {}

    def register(self, cls: _T) -> None:
        """Register a plugin class; called from ``__init_subclass__``.

        Classes opt out with ``__register__ = False`` in their own body
        (intermediate abstract bases).
        """
        name = cls.__dict__.get("__display_name__") or strip_postfix(cls.__name__, self.postfix)
        cls.__display_name__ = name
        self._entries[name.lower()] = cls

    def get_all(self) -> dict[str, _T]:
        __import__(self.builtin_module)  # side effect: registers built-ins
        return dict(self._entries)

    def find(self, name: str) -> _T:
        entries = self.get_all()
        if name.lower() in entries:
            return entries[name.lower()]
        raise ValueError(
            f"Unknown {self.kind} name: {name}. Available {self.kind}s: {', '.join(entries)}"
        )
