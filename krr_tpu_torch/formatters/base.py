"""Formatter plugin boundary — registry mirroring the strategies' design.

Same plugin contract as the reference
(`robusta_krr/core/abstract/formatters.py:19-58`): defining a
``BaseFormatter`` subclass registers a new ``--formatter`` option, named after
the class with the ``Formatter`` postfix stripped (overridable via
``__display_name__``).
"""

from __future__ import annotations

import abc
from typing import TYPE_CHECKING, Any

from krr_tpu_torch.utils.registry import PluginRegistry

if TYPE_CHECKING:
    from krr_tpu_torch.models.result import Result

_FORMATTER_REGISTRY: PluginRegistry = PluginRegistry("formatter", "Formatter", "krr_tpu_torch.formatters")


class BaseFormatter(abc.ABC):
    """Base class for result formatters."""

    __display_name__: str

    def __init_subclass__(cls, **kwargs: object) -> None:
        super().__init_subclass__(**kwargs)
        if cls.format is not BaseFormatter.format and cls.__dict__.get("__register__", True):
            _FORMATTER_REGISTRY.register(cls)

    def __str__(self) -> str:
        return self.__display_name__.title()

    @abc.abstractmethod
    def format(self, result: "Result") -> Any:
        """Render the result (string or rich renderable)."""

    @classmethod
    def get_all(cls) -> dict[str, type["BaseFormatter"]]:
        return _FORMATTER_REGISTRY.get_all()

    @staticmethod
    def find(name: str) -> type["BaseFormatter"]:
        return _FORMATTER_REGISTRY.find(name)


__all__ = ["BaseFormatter"]
