"""The orchestrator: discover → bulk-fetch → batched compute → round → render.

Port of the one-shot raw scan of `krr_tpu/core/runner.py`: the runner
bulk-fetches the whole fleet into a ``FleetBatch`` and makes ONE batched
strategy call per row chunk, instead of per-object tasks and per-object
strategy calls. The inventory and the per-cluster history sources default
to the real Kubernetes and Prometheus loaders (`krr_tpu_torch.integrations`)
and may be injected instead (``inventory=``, ``history_factory=``) — fakes
and third-party backends. Digest ingest and the streamed scan pipeline wait
for the digest-ingest slice.

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
from krr_tpu_torch.obs.metrics import MetricsRegistry
from krr_tpu_torch.obs.trace import NullTracer
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

    ``inventory`` / ``history_factory`` are injectable so tests (and
    alternative backends) can swap the cluster/metrics integrations; the
    defaults build the real Kubernetes and Prometheus loaders. Sources are
    cached per cluster (failures too — one broken cluster fails fast instead
    of retrying per call)."""

    def __init__(
        self,
        config: Config,
        *,
        inventory: Optional[InventorySource] = None,
        history_factory: Optional[Callable[[Optional[str]], HistorySource]] = None,
        logger: Optional[KrrLogger] = None,
        tracer: Optional[NullTracer] = None,
        metrics: Optional[MetricsRegistry] = None,
    ) -> None:
        self.config = config
        self.logger = logger or config.create_logger()
        #: The tracer defaults to the no-op unless --trace asked for
        #: recording; the metrics registry is ALWAYS real — it is just
        #: labeled dicts — and shared with the loaders, so per-query
        #: telemetry lands in one place.
        self.tracer = tracer if tracer is not None else config.create_tracer()
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.strategy = config.create_strategy()
        self._inventory = inventory
        self._history_factory = history_factory
        self._history_sources: dict[Optional[str], Union[HistorySource, Exception]] = {}
        #: Per-scan retry deadline pool shared by every Prometheus loader of
        #: this session (`krr_tpu_torch.integrations.prometheus.RetryBudget`)
        #: — built lazily alongside the first real loader, so fake-injected
        #: sessions never import the transport stack.
        self._retry_budget = None

    def begin_scan(self) -> None:
        """Reset the per-scan fetch budgets at each scan's start, so one
        scan's retry spending can't starve the next."""
        if self._retry_budget is not None:
            self._retry_budget.reset()

    def get_inventory(self) -> InventorySource:
        if self._inventory is None:
            from krr_tpu_torch.integrations.kubernetes import KubernetesLoader

            self._inventory = KubernetesLoader(self.config, logger=self.logger, metrics=self.metrics)
        return self._inventory

    def get_history_source(self, cluster: Optional[str]) -> HistorySource:
        if cluster not in self._history_sources:
            try:
                if self._history_factory is not None:
                    self._history_sources[cluster] = self._history_factory(cluster)
                else:
                    from krr_tpu_torch.integrations.prometheus import PrometheusLoader, RetryBudget

                    if self._retry_budget is None:
                        self._retry_budget = RetryBudget(self.config.prometheus_retry_deadline_seconds)
                    self._history_sources[cluster] = PrometheusLoader(
                        self.config,
                        cluster=cluster,
                        logger=self.logger,
                        tracer=self.tracer,
                        metrics=self.metrics,
                        retry_budget=self._retry_budget,
                    )
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
        with self.tracer.span("discover") as span:
            inventory = self.get_inventory()
            clusters = await inventory.list_clusters()
            self.logger.debug(f"Using clusters: {clusters if clusters is not None else 'inner cluster'}")
            objects = await inventory.list_scannable_objects(clusters)
            span.set(objects=len(objects))
            return objects

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
            with self.tracer.span("fetch", cluster=cluster or "default", rows=len(subset)):
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

    async def close(self) -> None:
        """Close every successfully-built history source that supports it,
        and the inventory (pooled apiserver clients)."""
        for source in self._history_sources.values():
            close = getattr(source, "close", None)
            if close is not None and not isinstance(source, Exception):
                try:
                    await close()
                except Exception:
                    self.logger.debug_exception()
        inventory_close = getattr(self._inventory, "close", None)
        if inventory_close is not None:
            try:
                await inventory_close()
            except Exception:
                self.logger.debug_exception()


class Runner:
    """One-shot end-to-end scan orchestration over a :class:`ScanSession`."""

    def __init__(
        self,
        config: Config,
        *,
        inventory: Optional[InventorySource] = None,
        history_factory: Optional[Callable[[Optional[str]], HistorySource]] = None,
        logger: Optional[KrrLogger] = None,
        tracer: Optional[NullTracer] = None,
        metrics: Optional[MetricsRegistry] = None,
    ) -> None:
        self.config = config
        self.session = ScanSession(
            config,
            inventory=inventory,
            history_factory=history_factory,
            logger=logger,
            tracer=tracer,
            metrics=metrics,
        )
        self.logger = self.session.logger
        self.stats: dict[str, float] = {}

    @property
    def tracer(self) -> NullTracer:
        return self.session.tracer

    @property
    def metrics(self) -> MetricsRegistry:
        return self.session.metrics

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
        with self.tracer.span("scan", kind="cli") as scan_span:
            return await self._collect_result_traced(scan_span)

    async def _collect_result_traced(self, scan_span) -> Result:
        self.session.begin_scan()
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
        with self.tracer.span("compute", rows=len(objects)):
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
            # The fetch-health legs the CLI summary (and --strict) surfaces:
            # rows whose fetch failed terminally, and how many Prometheus
            # retry attempts the scan burned getting what it got.
            "failed_rows": float(failed_rows),
            "fetch_retries": float(self.metrics.value("krr_tpu_prom_query_retries_total") or 0.0),
            # What crossed the network (compressed where negotiated) and what
            # it decoded to, summed over the scan's range queries.
            "wire_bytes": self.metrics.total("krr_tpu_prom_wire_bytes_total"),
            "decoded_bytes": self.metrics.total("krr_tpu_prom_decoded_bytes_total"),
        }
        end_to_end = (len(objects) / (t3 - t0)) if t3 > t0 and objects else 0.0
        retries = int(self.stats["fetch_retries"])
        self.logger.info(
            f"Scanned {len(objects)} objects: discover {self.stats['discover_seconds']:.2f}s, "
            f"fetch {self.stats['fetch_seconds']:.2f}s, compute {self.stats['compute_seconds']:.2f}s "
            f"({end_to_end:.1f} objects/s end-to-end)"
        )
        if failed_rows or retries:
            # A half-fetched fleet renders UNKNOWN rows, and --strict turns
            # this line into a nonzero exit.
            self.logger.warning(
                f"Fetch health: {failed_rows} of {len(objects)} object fetches failed "
                f"(rendered UNKNOWN), {retries} Prometheus retr{'y' if retries == 1 else 'ies'}"
            )
        scan_span.set(objects=len(objects), failed_rows=failed_rows, fetch_retries=retries)
        self.metrics.set("krr_tpu_scan_failed_rows", failed_rows)
        if objects:
            self.metrics.inc("krr_tpu_fetch_rows_total", len(objects))
        if failed_rows:
            self.metrics.inc("krr_tpu_fetch_failed_rows_total", failed_rows)
        self.metrics.inc("krr_tpu_scans_total", kind="cli")
        for phase in ("discover", "fetch", "compute"):
            self.metrics.set("krr_tpu_scan_duration_seconds", self.stats[f"{phase}_seconds"], phase=phase)
        self.metrics.set(
            "krr_tpu_last_scan_timestamp_seconds",
            self.config.scan_end_timestamp or time.time(),
        )
        return Result(scans=scans)

    def _process_result(self, result: Result) -> None:
        formatted = result.format(self.config.format)
        self.logger.echo("\n", no_prefix=True)
        self.logger.print_result(formatted)

    async def run(self) -> Result:
        self._greet()
        try:
            result = await self._collect_result()
        except Exception:
            self.metrics.inc("krr_tpu_scan_failures_total")
            raise
        self._process_result(result)
        return result
