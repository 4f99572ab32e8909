"""The orchestrator: discover → bulk-fetch → batched compute → round → render.

Port of the one-shot raw scan of `krr_tpu/core/runner.py`: the runner
bulk-fetches the whole fleet into a ``FleetBatch`` and makes ONE batched
strategy call per row chunk, instead of per-object tasks and per-object
strategy calls. The inventory and the per-cluster history sources default
to the real Kubernetes and Prometheus loaders (`krr_tpu_torch.integrations`)
and may be injected instead (``inventory=``, ``history_factory=``) — fakes
and third-party backends. With ``digest_ingest`` the fleet arrives as
per-object digests instead (``gather_fleet_digests``, or, at
``pipeline_depth`` > 0, ``stream_fleet_digests``: discovery, fetch and fold
overlap through `krr_tpu_torch.core.pipeline`), and the strategy's
``run_digested`` recommends from them.

Failure semantics: a cluster whose history source fails degrades to empty
histories for its objects — their scans render as UNKNOWN (``?``) instead of
aborting the run.
"""

from __future__ import annotations

import asyncio
import inspect
import time
from typing import Callable, Optional, Protocol, Union

import numpy as np

from krr_tpu_torch import __version__
from krr_tpu_torch.core.config import Config
from krr_tpu_torch.core.pipeline import PipelineStats, ScanPipeline
from krr_tpu_torch.core.rounding import round_value
from krr_tpu_torch.models.allocations import ResourceAllocations, ResourceType
from krr_tpu_torch.models.objects import K8sObjectData
from krr_tpu_torch.models.result import ResourceScan, Result
from krr_tpu_torch.models.series import FleetBatch, RaggedHistory
from krr_tpu_torch.obs.device import DeviceObs, install_compile_hooks
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


def fold_histories(
    fleet, indices: "list[int] | range", fetched: dict[ResourceType, list[RaggedHistory]], spec
) -> None:
    """Digest raw fetched histories into ``fleet`` rows ``indices`` on host —
    the fallback fold for sources without a fused parse+digest path (fakes,
    third-party backends). A failure mid-fold UNWINDS every row the batch
    touched before re-raising: the caller's failure handling marks the batch
    failed/UNKNOWN, and a partially-written row surviving under that marking
    would quietly serve a recommendation computed from half a window (or
    double-count the half on a refetch)."""
    from krr_tpu_torch.integrations.native import _digest_python

    try:
        for local_i, global_i in enumerate(indices):
            for samples in fetched[ResourceType.CPU][local_i].values():
                counts, total, peak = _digest_python(samples, spec.gamma, spec.min_value, spec.num_buckets)
                fleet.merge_cpu_row(global_i, counts, total, peak)
            for samples in fetched[ResourceType.Memory][local_i].values():
                if samples.size:
                    fleet.merge_mem_row(global_i, float(samples.size), float(samples.max()))
    except BaseException:
        rows = list(indices)
        fleet.clear_cpu_rows(rows)
        fleet.clear_mem_rows(rows)
        raise


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
        # Kernel builds (the port's compile) report into this session's
        # registry: krr_tpu_compile_* and the stages' compile split.
        install_compile_hooks(self.metrics)
        self.strategy = config.create_strategy()
        self._wire_obs()
        self._inventory = inventory
        self._history_factory = history_factory
        self._history_sources: dict[Optional[str], Union[HistorySource, Exception]] = {}
        #: Per-scan retry deadline pool shared by every Prometheus loader of
        #: this session (`krr_tpu_torch.integrations.prometheus.RetryBudget`)
        #: — built lazily alongside the first real loader, so fake-injected
        #: sessions never import the transport stack.
        self._retry_budget = None
        #: Adaptive fetch-plan telemetry to seed per-cluster loaders with
        #: (`seed_fetch_plans`): the serve scheduler persists the previous
        #: scan's per-namespace series/bytes observations beside the window
        #: cursor and restores them here on restart, so the first tick plans
        #: from real telemetry instead of cold routed counts.
        self._plan_seeds: dict[str, dict] = {}

    @property
    def tracer(self) -> NullTracer:
        return self._tracer

    @tracer.setter
    def tracer(self, value: NullTracer) -> None:
        # Swapping the tracer mid-lifecycle (serve installs its recording
        # ring after session construction) must re-wire the strategy's
        # device instrumentation, or compute sub-spans would keep feeding
        # the old tracer.
        self._tracer = value
        if getattr(self, "strategy", None) is not None:
            self._wire_obs()

    def _wire_obs(self) -> None:
        """Give the strategy its device-compute instrumentation
        (`krr_tpu_torch.obs.device`): stage spans into THIS session's
        tracer, padding/memory gauges into its registry."""
        self.strategy.obs = DeviceObs(self._tracer, self.metrics)

    def begin_scan(self) -> None:
        """Reset the per-scan fetch budgets — called by the scan owners
        (the one-shot Runner, the serve scheduler tick) at each scan's
        start, so one scan's retry spending can't starve the next."""
        if self._retry_budget is not None:
            self._retry_budget.reset()

    def seed_fetch_plans(self, seeds: Optional[dict]) -> None:
        """Install persisted fetch-plan telemetry (cluster key → planner
        snapshot, as returned by :meth:`fetch_plan_states`) for loaders
        built later. Must run before the first fetch — loaders are cached,
        and an already-built loader keeps its live telemetry."""
        if seeds:
            self._plan_seeds = {
                str(k): v for k, v in seeds.items() if isinstance(v, dict)
            }

    def fetch_plan_states(self) -> dict:
        """Snapshot every built loader's fetch-plan telemetry (cluster key →
        planner state), for persistence beside the serve window cursor.
        Sources without a planner (fakes, third-party backends) contribute
        nothing."""
        states: dict[str, dict] = {}
        for cluster, source in self._history_sources.items():
            planner = getattr(source, "planner", None)
            if planner is not None and getattr(planner, "telemetry", None):
                states[cluster or "default"] = planner.state()
        return states

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
                        plan_seed=self._plan_seeds.get(cluster or "default"),
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

    async def gather_fleet_digests(
        self,
        objects: list[K8sObjectData],
        *,
        history_seconds: Optional[float] = None,
        step_seconds: Optional[float] = None,
        end_time: Optional[float] = None,
        raise_on_failure: bool = False,
    ) -> "DigestedFleet":
        """Digest-ingest fetch (tdigest ``--digest_ingest`` and the serve
        scheduler): per cluster, use the source's fused parse+digest path when
        it has one; otherwise fetch raw and digest on host — so fakes and
        third-party sources keep working. The window defaults to the strategy
        settings; an explicit ``history_seconds``/``end_time`` narrows it to a
        delta window (``[end_time - history_seconds, end_time]``). Default
        failure semantics match the raw path (cluster failure → empty digests
        → UNKNOWN scans); with ``raise_on_failure`` a cluster failure raises
        instead — the serve scheduler needs the distinction, because folding
        an empty window and moving on would silently LOSE that window's
        samples from the accumulated store, where a one-shot scan merely
        renders one run's objects as UNKNOWN. Coverage caveat:
        ``raise_on_failure`` sees cluster-level failures plus per-query
        failures a source reports via ``fleet.failed_rows`` (the bundled
        PrometheusLoader does); a third-party source that swallows its own
        query errors into empty histories is indistinguishable from a
        genuinely idle fleet and cannot be caught here."""
        from krr_tpu_torch.models.series import DigestedFleet

        settings = self.strategy.settings
        spec = settings.cpu_spec()
        if history_seconds is None:
            history_seconds = settings.history_timedelta.total_seconds()
        if step_seconds is None:
            step_seconds = settings.timeframe_timedelta.total_seconds()

        by_cluster: dict[Optional[str], list[int]] = {}
        for i, obj in enumerate(objects):
            by_cluster.setdefault(obj.cluster, []).append(i)

        fleet = DigestedFleet.empty(objects, spec.gamma, spec.min_value, spec.num_buckets)

        async def fetch_cluster(cluster: Optional[str], indices: list[int]) -> None:
            subset = [objects[i] for i in indices]
            try:
                with self.tracer.span("fetch", cluster=cluster or "default", rows=len(subset)):
                    source = self.get_history_source(cluster)
                    if hasattr(source, "gather_fleet_digests"):
                        sub_fleet = await source.gather_fleet_digests(
                            subset, history_seconds, step_seconds,
                            spec.gamma, spec.min_value, spec.num_buckets,
                            **self._end_time_kwargs(end_time),
                        )
                    else:
                        sub_fleet = None
                        fetched = await source.gather_fleet(
                            subset, history_seconds, step_seconds, **self._end_time_kwargs(end_time)
                        )
                with self.tracer.span("fold", rows=len(subset)):
                    if sub_fleet is not None:
                        fleet.merge_from(sub_fleet, indices)
                    else:
                        fold_histories(fleet, indices, fetched, spec)
            except Exception as e:
                if raise_on_failure:
                    raise
                # Unwind before marking: a mid-merge failure (fold_histories
                # unwinds its own rows; a partial merge_from does not) must
                # not leave half a batch's samples behind a failed marker —
                # each cluster owns a disjoint row set, so the clear cannot
                # touch another fetch's work.
                fleet.clear_cpu_rows(indices)
                fleet.clear_mem_rows(indices)
                fleet.failed_rows.update(indices)
                self.logger.warning(
                    f"Failed to gather digests for cluster {cluster or 'default'}: {e} — "
                    f"marking {len(subset)} objects as unknown"
                )
                self.logger.debug_exception()

        # return_exceptions so sibling clusters' fetches settle before a
        # failure surfaces (raising early would orphan their downloads).
        results = await asyncio.gather(
            *[fetch_cluster(c, idx) for c, idx in by_cluster.items()], return_exceptions=True
        )
        for r in results:
            if isinstance(r, BaseException):
                raise r
        if raise_on_failure and fleet.failed_rows:
            # Per-QUERY terminal failures inside a reachable source degrade
            # to empty rows and are only recorded (fleet.failed_rows) — for
            # an incremental caller that is still a lost window, so surface
            # it as loudly as a cluster failure.
            raise RuntimeError(
                f"{len(fleet.failed_rows)} of {len(objects)} object fetches failed terminally"
            )
        return fleet

    # ------------------------------------------------------- streamed pipeline
    async def discover_stream(self):
        """Yield ``(cluster_ordinal, positions, objects)`` inventory batches
        as they complete (`KubernetesLoader.stream_scannable_objects`) — the
        discovery producer of the scan pipeline. Inventories without a
        streaming API degrade to one staged batch, so injected fakes and
        third-party sources keep working."""
        inventory = self.get_inventory()
        clusters = await inventory.list_clusters()
        self.logger.debug(f"Using clusters: {clusters if clusters is not None else 'inner cluster'}")
        stream = getattr(inventory, "stream_scannable_objects", None)
        if stream is None:
            objects = await inventory.list_scannable_objects(clusters)
            if objects:
                yield 0, list(range(len(objects))), objects
            return
        async for item in stream(clusters):
            yield item

    @staticmethod
    def _digest_batches(objects: list[K8sObjectData], depth: int) -> "list[list[int]]":
        """Partition a staged inventory into pipeline fetch batches: whole
        namespaces of one cluster, coalesced to ~``2 × depth`` batches per
        cluster. A namespace never splits across batches — each batch's
        namespace-batched query would refetch the whole namespace response
        per batch otherwise — and batches never mix clusters (one history
        source per batch)."""
        by_cluster: dict[Optional[str], list[int]] = {}
        for i, obj in enumerate(objects):
            by_cluster.setdefault(obj.cluster, []).append(i)
        batches: list[list[int]] = []
        for indices in by_cluster.values():
            by_namespace: dict[str, list[int]] = {}
            for i in indices:
                by_namespace.setdefault(objects[i].namespace, []).append(i)
            target = max(1, len(indices) // (2 * depth))
            current: list[int] = []
            for namespace_indices in by_namespace.values():
                current.extend(namespace_indices)
                if len(current) >= target:
                    batches.append(current)
                    current = []
            if current:
                batches.append(current)
        return batches

    async def stream_fleet_digests(
        self,
        objects: Optional[list[K8sObjectData]] = None,
        *,
        history_seconds: Optional[float] = None,
        step_seconds: Optional[float] = None,
        end_time: Optional[float] = None,
        raise_on_failure: bool = False,
        pipeline_depth: Optional[int] = None,
    ) -> "tuple[list[K8sObjectData], DigestedFleet, PipelineStats]":
        """The streamed twin of :meth:`gather_fleet_digests`: fetch the fleet
        as per-namespace batches and FOLD each batch concurrently with the
        remaining fetches through a bounded pipeline (`krr_tpu_torch.core.pipeline`)
        instead of gathering everything and folding after.

        With ``objects`` (the serve scheduler's staged inventory) the batches
        are namespace groups of the given fleet and each arriving batch folds
        straight into the preallocated aggregate. Without it, DISCOVERY
        streams too: each namespace starts fetching as soon as its inventory
        resolves (`discover_stream`), batches buffer as they fold, and the
        aggregate assembles once the fleet's size is known — returned objects
        are sorted back to the exact staged discovery order, so streamed and
        staged scans agree on everything including list order.

        Backpressure: at most ``pipeline_depth`` batch fetches run at once
        and at most ``pipeline_depth`` fetched batches queue unfolded, so
        fetched-but-unfolded host state stays bounded at ``2 × depth + 1``
        batches no matter how wide the fleet is (HTTP-level concurrency
        within a batch is still the loader's ``prometheus_max_connections``).
        Exactness: batch folds are digest merges (integer-valued count adds,
        peak maxes), so arrival-order folding is bit-identical to the staged
        path — asserted in tests, not assumed. Failure semantics match
        :meth:`gather_fleet_digests` batch-wise: a failed batch degrades to
        empty rows marked in ``failed_rows`` (→ UNKNOWN scans), or aborts
        the whole call under ``raise_on_failure`` — after sibling fetches
        settle, and with the same terminal ``failed_rows`` check."""
        from krr_tpu_torch.models.series import DigestedFleet

        settings = self.strategy.settings
        spec = settings.cpu_spec()
        if history_seconds is None:
            history_seconds = settings.history_timedelta.total_seconds()
        if step_seconds is None:
            step_seconds = settings.timeframe_timedelta.total_seconds()
        if pipeline_depth is None:
            pipeline_depth = self.config.pipeline_depth
        depth = max(1, int(pipeline_depth))

        staged_inventory = objects is not None
        fleet: Optional[DigestedFleet] = None
        if staged_inventory:
            fleet = DigestedFleet.empty(objects, spec.gamma, spec.min_value, spec.num_buckets)
        #: Discovery-streamed batches buffer here until the fleet size is
        #: known; their digest state sums to exactly the final aggregate's,
        #: so the buffer is bounded by the product itself, not the fetch.
        folded: list = []

        def digest_payload(subset: list[K8sObjectData], payload) -> "DigestedFleet":
            """One batch's payload → a sub-fleet (runs on the fold thread):
            an already-digested sub-fleet passes through; raw histories
            digest on host here, overlapped with the remaining fetches; a
            failed fetch (None) degrades to empty rows, all marked failed."""
            if isinstance(payload, DigestedFleet):
                return payload
            sub = DigestedFleet.empty(subset, spec.gamma, spec.min_value, spec.num_buckets)
            if payload is None:
                sub.failed_rows.update(range(len(subset)))
                return sub
            try:
                fold_histories(sub, range(len(subset)), payload, spec)
            except Exception as e:
                if raise_on_failure:
                    raise
                # fold_histories already unwound the partial rows.
                sub.failed_rows.update(range(len(subset)))
                self.logger.warning(
                    f"Failed to digest a fetched batch of {len(subset)} objects: {e} — "
                    f"marking them as unknown"
                )
                self.logger.debug_exception()
            return sub

        failed_batch_count = [0]

        def fold(batch) -> None:
            key, subset, payload = batch
            sub = digest_payload(subset, payload)
            if sub.failed_rows:
                failed_batch_count[0] += 1
            if fleet is not None:
                fleet.merge_from(sub, key)
            else:
                folded.append((key, subset, sub))

        fetch_semaphore = asyncio.Semaphore(depth)

        async def fetch_batch(pipeline: ScanPipeline, key, subset: list[K8sObjectData]) -> None:
            # The fetch slot is held THROUGH the put: releasing it before
            # enqueueing would let completed payloads pile up blocked at the
            # queue without bound while fresh fetches keep starting — exactly
            # the unbounded host state the depth cap exists to prevent.
            async with fetch_semaphore:
                cluster = subset[0].cluster
                with self.tracer.span(
                    "fetch",
                    namespace=",".join(sorted({obj.namespace for obj in subset})),
                    cluster=cluster or "default",
                    rows=len(subset),
                ):
                    try:
                        source = self.get_history_source(cluster)
                        if hasattr(source, "gather_fleet_digests"):
                            payload = await source.gather_fleet_digests(
                                subset, history_seconds, step_seconds,
                                spec.gamma, spec.min_value, spec.num_buckets,
                                **self._end_time_kwargs(end_time),
                            )
                        else:
                            payload = await source.gather_fleet(
                                subset, history_seconds, step_seconds, **self._end_time_kwargs(end_time)
                            )
                    except Exception as e:
                        if raise_on_failure:
                            raise
                        self.logger.warning(
                            f"Failed to gather digests for cluster {cluster or 'default'}: {e} — "
                            f"marking {len(subset)} objects as unknown"
                        )
                        self.logger.debug_exception()
                        payload = None
                await pipeline.put((key, subset, payload))

        async with ScanPipeline(
            fold, depth=depth, tracer=self.tracer, metrics=self.metrics
        ) as pipeline:
            if staged_inventory:
                results = await asyncio.gather(
                    *[
                        fetch_batch(
                            pipeline,
                            np.asarray(indices, dtype=np.int64),
                            [objects[i] for i in indices],
                        )
                        for indices in self._digest_batches(objects, depth)
                    ],
                    return_exceptions=True,
                )
            else:
                discover_started = time.perf_counter()
                # start/finish (not a ``with`` block): activating the span
                # here would make every fetch task launched in the loop body
                # a CHILD of discover instead of a sibling under the scan.
                discover_span = self.tracer.start_span("discover")
                fetch_tasks: list[asyncio.Task] = []
                try:
                    async for ordinal, positions, subset in self.discover_stream():
                        fetch_tasks.append(
                            asyncio.ensure_future(
                                fetch_batch(pipeline, (ordinal, positions), subset)
                            )
                        )
                    pipeline.stats.discover_seconds = time.perf_counter() - discover_started
                finally:
                    discover_span.set(batches=len(fetch_tasks))
                    self.tracer.finish_span(discover_span)
                    # Settle every launched fetch even when discovery raises —
                    # orphaned downloads would outlive the scan.
                    results = await asyncio.gather(*fetch_tasks, return_exceptions=True)
        # Pipeline closed: every accepted batch has folded. Surface fetch
        # failures only now, after siblings settled (the fan-out contract).
        pipeline.stats.failed_batches = failed_batch_count[0]
        for r in results:
            if isinstance(r, BaseException):
                raise r

        if not staged_inventory:
            objects, fleet = await asyncio.to_thread(
                self._assemble_streamed, folded, spec, DigestedFleet
            )
        assert fleet is not None
        if raise_on_failure and fleet.failed_rows:
            raise RuntimeError(
                f"{len(fleet.failed_rows)} of {len(objects)} object fetches failed terminally"
            )
        return objects, fleet, pipeline.stats

    @staticmethod
    def _assemble_streamed(folded: list, spec, fleet_type):
        """Assemble discovery-streamed batches into the final aggregate in
        the exact staged order: every row's ``(cluster ordinal, staged
        position)`` key defines its rank, batches merge at their ranks
        (vectorized — contiguous batches hit the slice fast path), and each
        sub-fleet frees as soon as it lands so peak memory stays ~one fleet
        plus the batch in flight."""
        pairs = [
            (ordinal, position, j, local_i)
            for j, ((ordinal, positions), _subset, _sub) in enumerate(folded)
            for local_i, position in enumerate(positions)
        ]
        pairs.sort()
        final_objects = [folded[j][1][local_i] for (_o, _p, j, local_i) in pairs]
        ranks = [np.empty(len(subset), dtype=np.int64) for (_key, subset, _sub) in folded]
        for rank, (_o, _p, j, local_i) in enumerate(pairs):
            ranks[j][local_i] = rank
        fleet = fleet_type.empty(final_objects, spec.gamma, spec.min_value, spec.num_buckets)
        for j in range(len(folded)):
            fleet.merge_from(folded[j][2], ranks[j])
            folded[j] = None  # free the sub-fleet's arrays as we go
        return final_objects, fleet

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
        digest_ingest = bool(getattr(self._strategy.settings, "digest_ingest", False)) and hasattr(
            self._strategy, "run_digested"
        )
        pipeline_stats = None
        if digest_ingest and self.config.pipeline_depth > 0:
            # Streamed scan pipeline: discovery, fetch, and fold overlap
            # (`ScanSession.stream_fleet_digests`). Discovery has no distinct
            # wall phase anymore; its span is reported from inside the
            # pipeline and its CPU rides the fetch leg.
            objects, fleet, pipeline_stats = await self.session.stream_fleet_digests()
            failed_rows = len(fleet.failed_rows)
            t1, c1 = t0 + pipeline_stats.discover_seconds, c0
            self.logger.info(f"Found {len(objects)} scannable objects")
            t2, c2 = time.perf_counter(), time.process_time()
            with self.tracer.span("compute", rows=len(objects)):
                raw_results = await asyncio.to_thread(self._strategy.run_digested, fleet)
        else:
            objects = await self.session.discover()
            t1, c1 = time.perf_counter(), time.process_time()
            self.logger.info(f"Found {len(objects)} scannable objects")
            if digest_ingest:  # staged digest path (pipeline_depth=0)
                fleet = await self.session.gather_fleet_digests(objects)
                failed_rows = len(fleet.failed_rows)
                t2, c2 = time.perf_counter(), time.process_time()
                with self.tracer.span("compute", rows=len(objects)):
                    raw_results = await asyncio.to_thread(self._strategy.run_digested, fleet)
            else:
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
        if pipeline_stats is not None:
            self.stats.update(
                {
                    "pipeline_fetch_seconds": pipeline_stats.fetch_seconds,
                    "pipeline_fold_seconds": pipeline_stats.fold_seconds,
                    "pipeline_overlap_seconds": pipeline_stats.overlap_seconds,
                    "pipeline_overlap_pct": pipeline_stats.overlap_pct,
                    "pipeline_batches": float(pipeline_stats.batches),
                    # Bottleneck attribution: producers blocked in put =
                    # fold-bound, consumer starved in get = fetch-bound.
                    "pipeline_put_blocked_seconds": pipeline_stats.put_blocked_seconds,
                    "pipeline_get_starved_seconds": pipeline_stats.get_starved_seconds,
                    "pipeline_peak_queue_depth": float(pipeline_stats.peak_queue_depth),
                    "pipeline_mean_queue_depth": pipeline_stats.mean_queue_depth,
                }
            )
            self.metrics.set(
                "krr_tpu_scan_pipeline_wait_seconds",
                pipeline_stats.put_blocked_seconds, side="producer_blocked",
            )
            self.metrics.set(
                "krr_tpu_scan_pipeline_wait_seconds",
                pipeline_stats.get_starved_seconds, side="consumer_starved",
            )
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
