"""The orchestrator: discover → bulk-fetch → batched compute → round → render.

Port of the one-shot raw scan of `krr_tpu/core/runner.py`: the runner
bulk-fetches the whole fleet into a ``FleetBatch`` and makes ONE batched
strategy call per row chunk, instead of per-object tasks and per-object
strategy calls. The inventory and the per-cluster history sources are
injected (``inventory=``, ``history_factory=``); the Kubernetes and
Prometheus loaders, digest ingest, the scan pipeline, tracing and metrics
arrive with later slices.

Failure semantics: a cluster whose history source fails degrades to empty
histories for its objects — their scans render as UNKNOWN (``?``) instead of
aborting the run.
"""

from __future__ import annotations

import asyncio
import inspect
import time
from typing import Callable, Optional, Protocol, Union

from krr_tpu_torch import __version__
from krr_tpu_torch.core.config import Config
from krr_tpu_torch.core.rounding import round_value
from krr_tpu_torch.models.allocations import ResourceAllocations, ResourceType
from krr_tpu_torch.models.objects import K8sObjectData
from krr_tpu_torch.models.result import ResourceScan, Result
from krr_tpu_torch.models.series import FleetBatch, RaggedHistory
from krr_tpu_torch.strategies.base import RunResult, run_batch_row_chunks
from krr_tpu_torch.utils.logging import KrrLogger
from krr_tpu_torch.utils.logo import ASCII_LOGO


class HistorySource(Protocol):
    """What the runner needs from a metrics backend (real or fake).

    ``end_time`` pins the scan window's right edge; the runner OMITS the
    argument when unpinned, so sources written without the parameter keep
    working for ordinary scans. Sources may also accept ``stats_resources``
    and ``failed_rows`` (signature-probed, see ``gather_fleet_history``).
    """

    async def gather_fleet(
        self,
        objects: list[K8sObjectData],
        history_seconds: float,
        step_seconds: float,
        end_time: Optional[float] = None,
    ) -> dict[ResourceType, list[RaggedHistory]]:
        ...


class InventorySource(Protocol):
    """What the runner needs from a cluster inventory (real or fake)."""

    async def list_clusters(self) -> Optional[list[str]]:
        ...

    async def list_scannable_objects(self, clusters: Optional[list[str]]) -> list[K8sObjectData]:
        ...


def _empty_histories(objects: list[K8sObjectData]) -> dict[ResourceType, list[RaggedHistory]]:
    return {resource: [{} for _ in objects] for resource in ResourceType}


def round_allocations(
    raw: RunResult, *, cpu_min_value: int, memory_min_value: int
) -> ResourceAllocations:
    """A strategy's raw per-object result, rounded to servable allocations."""
    return ResourceAllocations(
        requests={
            resource: round_value(
                raw[resource].request,
                resource,
                cpu_min_value=cpu_min_value,
                memory_min_value=memory_min_value,
            )
            for resource in ResourceType
        },
        limits={
            resource: round_value(
                raw[resource].limit,
                resource,
                cpu_min_value=cpu_min_value,
                memory_min_value=memory_min_value,
            )
            for resource in ResourceType
        },
    )


class ScanSession:
    """Scan state: strategy + inventory + per-cluster history sources.

    History sources are cached per cluster (failures too — one broken
    cluster fails fast instead of retrying per call)."""

    def __init__(
        self,
        config: Config,
        *,
        inventory: InventorySource,
        history_factory: Callable[[Optional[str]], HistorySource],
        logger: Optional[KrrLogger] = None,
    ) -> None:
        self.config = config
        self.logger = logger or config.create_logger()
        self.strategy = config.create_strategy()
        self._inventory = inventory
        self._history_factory = history_factory
        self._history_sources: dict[Optional[str], Union[HistorySource, Exception]] = {}

    def get_history_source(self, cluster: Optional[str]) -> HistorySource:
        if cluster not in self._history_sources:
            try:
                self._history_sources[cluster] = self._history_factory(cluster)
            except Exception as e:  # cache the failure: fail fast per cluster
                self._history_sources[cluster] = e
        source = self._history_sources[cluster]
        if isinstance(source, Exception):
            raise source
        return source

    def _end_time_kwargs(self, end_time: Optional[float]) -> dict:
        """``{"end_time": ...}`` when the scan window's right edge is pinned,
        else {} — so sources without the parameter keep working unpinned."""
        if end_time is None:
            end_time = self.config.scan_end_timestamp
        if end_time is None:
            return {}
        return {"end_time": end_time}

    async def discover(self) -> list[K8sObjectData]:
        """List clusters + scannable objects (one inventory round)."""
        clusters = await self._inventory.list_clusters()
        self.logger.debug(f"Using clusters: {clusters if clusters is not None else 'inner cluster'}")
        return await self._inventory.list_scannable_objects(clusters)

    async def gather_fleet_history(
        self, objects: list[K8sObjectData], *, end_time: Optional[float] = None
    ) -> FleetBatch:
        """Bulk-fetch usage history for every object, grouped per cluster.

        Clusters fetch concurrently; a failing cluster degrades to empty
        histories (scans become UNKNOWN) with a logged warning.
        """
        settings = self.strategy.settings
        history_seconds = settings.history_timedelta.total_seconds()
        step_seconds = settings.timeframe_timedelta.total_seconds()
        stats_resources = frozenset(getattr(self.strategy, "stats_only_resources", ()) or ())

        by_cluster: dict[Optional[str], list[int]] = {}
        for i, obj in enumerate(objects):
            by_cluster.setdefault(obj.cluster, []).append(i)

        histories = _empty_histories(objects)
        failed: set[int] = set()

        def source_kwargs(source, cluster_failed: "set[int]") -> dict:
            """end_time plus, for sources whose signature accepts them, the
            strategy's stats-only resources (one synthetic max-sample per
            pod; see ``BaseStrategy.stats_only_resources``) and the per-row
            failed-fetch out-channel (subset-local indices)."""
            kwargs = self._end_time_kwargs(end_time)
            try:
                parameters = inspect.signature(source.gather_fleet).parameters
            except (TypeError, ValueError):
                parameters = {}
            if stats_resources and "stats_resources" in parameters:
                kwargs["stats_resources"] = stats_resources
            if "failed_rows" in parameters:
                kwargs["failed_rows"] = cluster_failed
            return kwargs

        async def fetch_cluster(cluster: Optional[str], indices: list[int]) -> None:
            subset = [objects[i] for i in indices]
            cluster_failed: set[int] = set()
            try:
                source = self.get_history_source(cluster)
                fetched = await source.gather_fleet(
                    subset, history_seconds, step_seconds, **source_kwargs(source, cluster_failed)
                )
                failed.update(indices[local_i] for local_i in cluster_failed)
            except Exception as e:
                failed.update(indices)
                self.logger.warning(
                    f"Failed to gather history for cluster {cluster or 'default'}: {e} — "
                    f"marking {len(subset)} objects as unknown"
                )
                self.logger.debug_exception()
                return
            for resource in ResourceType:
                for local_i, global_i in enumerate(indices):
                    histories[resource][global_i] = fetched[resource][local_i]

        await asyncio.gather(*[fetch_cluster(c, idx) for c, idx in by_cluster.items()])
        batch = FleetBatch.build(objects, histories)
        batch.failed_rows.update(failed)
        return batch


class Runner:
    """One-shot end-to-end scan orchestration over a :class:`ScanSession`."""

    def __init__(
        self,
        config: Config,
        *,
        inventory: InventorySource,
        history_factory: Callable[[Optional[str]], HistorySource],
        logger: Optional[KrrLogger] = None,
    ) -> None:
        self.config = config
        self.session = ScanSession(config, inventory=inventory, history_factory=history_factory, logger=logger)
        self.logger = self.session.logger
        self.stats: dict[str, float] = {}

    @property
    def _strategy(self):
        return self.session.strategy

    def _greet(self) -> None:
        self.logger.echo(ASCII_LOGO, no_prefix=True, markup=True)
        self.logger.echo(
            f"Running krr-tpu-torch (Kubernetes Resource Recommender, PyTorch/CUDA port) {__version__}",
            no_prefix=True,
        )
        self.logger.echo(f"Using strategy: {self._strategy}", no_prefix=True)
        self.logger.echo(f"Using formatter: {self.config.format}", no_prefix=True)
        self.logger.echo(no_prefix=True)

    # ------------------------------------------------------------- the scan
    def _round_result(self, raw: RunResult) -> ResourceAllocations:
        return round_allocations(
            raw,
            cpu_min_value=self.config.cpu_min_value,
            memory_min_value=self.config.memory_min_value,
        )

    async def _collect_result(self) -> Result:
        # Cyclic GC off for the scan: a fleet build keeps 100k+ tracked
        # objects live at once, and each threshold-triggered full collection
        # scans that whole heap. Scans create no cyclic garbage worth
        # collecting mid-flight; the deferred collection runs after re-enable.
        import gc

        gc_was_enabled = gc.isenabled()
        gc.disable()
        try:
            return await self._collect_result_inner()
        finally:
            if gc_was_enabled:
                gc.enable()

    async def _collect_result_inner(self) -> Result:
        t0, c0 = time.perf_counter(), time.process_time()
        objects = await self.session.discover()
        t1, c1 = time.perf_counter(), time.process_time()
        self.logger.info(f"Found {len(objects)} scannable objects")
        batch = await self.session.gather_fleet_history(objects)
        failed_rows = len(batch.failed_rows)
        t2, c2 = time.perf_counter(), time.process_time()
        # The batched strategy call is device bound; keep the loop
        # responsive. Row-chunked so the packed copy never exceeds
        # max_fleet_rows_per_device rows at a time.
        raw_results = await asyncio.to_thread(
            run_batch_row_chunks, self._strategy, batch, self.config.max_fleet_rows_per_device
        )
        t3, c3 = time.perf_counter(), time.process_time()

        scans = [
            ResourceScan.calculate(obj, self._round_result(raw))
            for obj, raw in zip(objects, raw_results)
        ]
        self.stats = {
            "discover_seconds": t1 - t0,
            "fetch_seconds": t2 - t1,
            "compute_seconds": t3 - t2,
            # process_time spans every thread of this process, so the CPU
            # legs split each phase's wall between our own work and waiting
            # on the outside world (server, device, disk).
            "discover_cpu_seconds": c1 - c0,
            "fetch_cpu_seconds": c2 - c1,
            "compute_cpu_seconds": c3 - c2,
            "objects": float(len(objects)),
            "objects_per_second": len(objects) / (t3 - t2) if t3 > t2 and objects else 0.0,
            "failed_rows": float(failed_rows),
        }
        end_to_end = (len(objects) / (t3 - t0)) if t3 > t0 and objects else 0.0
        self.logger.info(
            f"Scanned {len(objects)} objects: discover {self.stats['discover_seconds']:.2f}s, "
            f"fetch {self.stats['fetch_seconds']:.2f}s, compute {self.stats['compute_seconds']:.2f}s "
            f"({end_to_end:.1f} objects/s end-to-end)"
        )
        if failed_rows:
            self.logger.warning(
                f"Fetch health: {failed_rows} of {len(objects)} object fetches failed (rendered UNKNOWN)"
            )
        return Result(scans=scans)

    def _process_result(self, result: Result) -> None:
        formatted = result.format(self.config.format)
        self.logger.echo("\n", no_prefix=True)
        self.logger.print_result(formatted)

    async def run(self) -> Result:
        self._greet()
        result = await self._collect_result()
        self._process_result(result)
        return result
