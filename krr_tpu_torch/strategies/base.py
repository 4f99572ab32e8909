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
import contextlib
import datetime
import itertools
import os
import time
from dataclasses import dataclass
from decimal import Decimal
from typing import Generic, Optional, TypeVar, get_args, get_origin

import pydantic as pd

from krr_tpu_torch.models.allocations import ResourceType
from krr_tpu_torch.models.objects import K8sObjectData
from krr_tpu_torch.models.series import FleetBatch
from krr_tpu_torch.obs.device import NULL_DEVICE_OBS, DeviceObs
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

    #: Device-compute instrumentation (`krr_tpu_torch.obs.device`): staged
    #: pack/digest/quantile/round sub-spans, compile attribution, padding
    #: and memory gauges. The scan session swaps in its own wired instance
    #: (`ScanSession._wire_obs`); the class default keeps strategies built
    #: outside a session (plugins, unit tests) inert.
    obs: DeviceObs = NULL_DEVICE_OBS

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

    def profile_span(self):
        """Context manager tracing the device compute with
        ``torch.profiler`` (CPU and CUDA activities, no shapes, no stacks)
        when the strategy's settings carry a ``profile_dir``: on exit a
        Chrome trace of the hand-written kernels as CUPTI saw them, plus the
        copies and host ops, lands in that directory
        (:func:`profiled`)."""
        import contextlib

        profile_dir = getattr(self.settings, "profile_dir", None)
        if not profile_dir:
            return contextlib.nullcontext()
        return profiled(profile_dir, getattr(self, "device", None))

    @abc.abstractmethod
    def run_batch(self, batch: FleetBatch) -> list[RunResult]:
        ...


_PROFILE_SEQUENCE = itertools.count(1)

#: Host seconds the profiler's window stays open before and after the body
#: on a CUDA device. The profiler keeps a device record only when it lies
#: inside that window on the host clock, and its mapping of the card's
#: clock onto the host's can be off by milliseconds in a trace
#: (``profiler_window_probe.py`` measures both): without the margin
#: the body's last kernels, which end a fraction of a millisecond before
#: the body does, can fall outside the window and vanish from the trace.
PROFILE_MARGIN_SECONDS = 0.1


@contextlib.contextmanager
def profiled(profile_dir: str, device=None):
    """Run the body under ``torch.profiler.profile`` and write its Chrome
    trace to ``<profile_dir>/krr-tpu-torch.<stamp>-<pid>-<n>.pt.trace.json``
    (a fresh name per call). CUDA activity is recorded when ``device`` is a
    CUDA device; the body's device work is then fenced and held
    :data:`PROFILE_MARGIN_SECONDS` inside the window on each side."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    cuda = device is not None and torch.device(device).type == "cuda"
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    stamp = time.strftime("%Y%m%dT%H%M%S", time.gmtime())
    path = os.path.join(
        profile_dir, f"krr-tpu-torch.{stamp}-{os.getpid()}-{next(_PROFILE_SEQUENCE)}.pt.trace.json"
    )
    with profile(activities=activities, record_shapes=False, with_stack=False) as prof:
        if cuda:
            torch.cuda.synchronize(device)
            time.sleep(PROFILE_MARGIN_SECONDS)
        yield
        if cuda:
            torch.cuda.synchronize(device)
            time.sleep(PROFILE_MARGIN_SECONDS)
    prof.export_chrome_trace(path)


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
    "profiled",
    "run_batch_row_chunks",
]
