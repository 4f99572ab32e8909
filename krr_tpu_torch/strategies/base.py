"""Strategy plugin boundary: settings, base class, and registry.

Same contract as `krr_tpu/strategies/base.py`: a user script that merely
*defines* a ``BaseStrategy`` subclass registers it by name, and strategies get
a **batched** entry point, ``run_batch(FleetBatch)``, which is where the device
path lives; plugins written against the reference's per-object
``run(history_data, object_data)`` contract still work through the default
``run_batch``.

The port registers into its OWN registry: defining the port's ``simple``
never replaces the JAX package's ``simple`` in that package's registry.
"""

from __future__ import annotations

import abc
import datetime
from dataclasses import dataclass
from decimal import Decimal
from typing import Generic, Optional, TypeVar, get_args, get_origin

import pydantic as pd

from krr_tpu_torch.models.allocations import ResourceType
from krr_tpu_torch.models.objects import K8sObjectData
from krr_tpu_torch.models.series import FleetBatch
from krr_tpu_torch.utils.registry import PluginRegistry


@dataclass
class ResourceRecommendation:
    """Raw (pre-rounding) recommendation for one resource of one object."""

    request: Optional[Decimal]
    limit: Optional[Decimal]


#: Reference-shaped history: resource → pod → samples.
HistoryData = dict[ResourceType, dict[str, list[Decimal]]]
RunResult = dict[ResourceType, ResourceRecommendation]


class StrategySettings(pd.BaseModel):
    """Base settings every strategy inherits.

    Defaults match the reference: two weeks of history at a 15-minute step
    (`robusta_krr/core/abstract/strategies.py:20-23`).
    """

    history_duration: float = pd.Field(24 * 7 * 2, ge=1, description="The duration of the history data to use (in hours).")
    timeframe_duration: float = pd.Field(15, ge=1, description="The step for the history data (in minutes).")

    @property
    def history_timedelta(self) -> datetime.timedelta:
        return datetime.timedelta(hours=self.history_duration)

    @property
    def timeframe_timedelta(self) -> datetime.timedelta:
        return datetime.timedelta(minutes=self.timeframe_duration)


_S = TypeVar("_S", bound=StrategySettings)

_STRATEGY_REGISTRY: PluginRegistry = PluginRegistry("strategy", "Strategy", "krr_tpu_torch.strategies")


class BaseStrategy(abc.ABC, Generic[_S]):
    """Base class for recommendation strategies.

    Class attributes:
        __display_name__: registry name; defaults to the class name with the
            ``Strategy`` postfix stripped, lowercased (``SimpleStrategy`` →
            ``simple``).
        row_chunkable: whether the Runner may split the fleet into row chunks
            (`run_batch_row_chunks`). Set False on a plugin whose
            ``run_batch`` looks across objects.
        stats_only_resources: resources this strategy consumes only through
            each pod's exact MAX (plus sample presence). Sources that support
            it ingest those resources through the cheaper stats route and the
            ragged history carries ONE synthetic sample per pod: its exact
            max. True per-pod sample COUNTS are NOT preserved — a plugin that
            consumes them for such a resource MUST override this back to
            ``frozenset()``.
    """

    __display_name__: str
    row_chunkable: bool = True
    stats_only_resources: "frozenset[ResourceType]" = frozenset()

    settings: _S

    def __init_subclass__(cls, **kwargs: object) -> None:
        super().__init_subclass__(**kwargs)
        # Register only concrete strategies (ones that implement `run`);
        # intermediate bases opt out with `__register__ = False`.
        if cls.run is not BaseStrategy.run and cls.__dict__.get("__register__", True):
            _STRATEGY_REGISTRY.register(cls)

    def __init__(self, settings: _S):
        self.settings = settings

    def __str__(self) -> str:
        return self.__display_name__.title()

    # ------------------------------------------------------------------ API
    @abc.abstractmethod
    def run(self, history_data: HistoryData, object_data: K8sObjectData) -> RunResult:
        """Per-object recommendation (reference-compatible plugin contract)."""

    def run_batch(self, batch: FleetBatch) -> list[RunResult]:
        """Fleet-wide recommendation. Device strategies override this with a
        batched kernel; the default loops ``run`` per object."""
        return [self.run(batch.history_for(i), obj) for i, obj in enumerate(batch.objects)]

    # ----------------------------------------------------------- reflection
    @classmethod
    def find(cls, name: str) -> type["BaseStrategy"]:
        return _STRATEGY_REGISTRY.find(name)

    @classmethod
    def get_all(cls) -> dict[str, type["BaseStrategy"]]:
        return _STRATEGY_REGISTRY.get_all()

    @classmethod
    def get_settings_type(cls) -> type[StrategySettings]:
        """Recover the settings model from the generic parameter
        (``class MyStrategy(BaseStrategy[MySettings])``)."""
        for klass in cls.__mro__:
            for base in getattr(klass, "__orig_bases__", ()):
                origin = get_origin(base)
                if isinstance(origin, type) and issubclass(origin, BaseStrategy):
                    for arg in get_args(base):
                        if isinstance(arg, type) and issubclass(arg, StrategySettings):
                            return arg
        return StrategySettings


class BatchedStrategy(BaseStrategy[_S]):
    """Base for device strategies whose primary entry point is the batched
    kernel: subclasses implement ``run_batch`` and inherit a ``run`` that wraps
    one object into a singleton batch."""

    __register__ = False  # intermediate base — not a strategy itself

    def run(self, history_data: HistoryData, object_data: K8sObjectData) -> RunResult:
        return self.run_batch(FleetBatch.from_history(history_data, object_data))[0]

    @abc.abstractmethod
    def run_batch(self, batch: FleetBatch) -> list[RunResult]:
        ...


def run_batch_row_chunks(
    strategy: "BaseStrategy", batch: FleetBatch, max_rows: int
) -> list[RunResult]:
    """Run ``strategy.run_batch`` over row chunks of at most ``max_rows``.

    Every built-in strategy is row-local (each object's recommendation
    depends only on its own samples), so chunked == unbatched exactly, while
    the packed [rows × T] copy is bounded to ``max_rows`` rows at a time.
    Sub-batches pin the parent's packed capacity (`FleetBatch.row_slice`);
    a strategy that is NOT row-local sets ``row_chunkable = False`` to
    receive the whole fleet in one call.
    """
    if len(batch) <= max_rows or not getattr(strategy, "row_chunkable", True):
        return strategy.run_batch(batch)
    results: list[RunResult] = []
    for start in range(0, len(batch), max_rows):
        results.extend(strategy.run_batch(batch.row_slice(start, start + max_rows)))
    return results


AnyStrategy = BaseStrategy[StrategySettings]

__all__ = [
    "AnyStrategy",
    "BaseStrategy",
    "BatchedStrategy",
    "StrategySettings",
    "HistoryData",
    "RunResult",
    "ResourceRecommendation",
    "K8sObjectData",
    "ResourceType",
    "run_batch_row_chunks",
]
