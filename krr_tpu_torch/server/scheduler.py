"""The background scan scheduler: incremental delta folds + slow re-discovery.

A port of `krr_tpu/server/scheduler.py` for the single-process serve plane.
The JAX scheduler's federation (aggregate ticks, the region uplink) and
push-ingest seams belong to a later slice of the port (ROADMAP M10b):
asking for one raises ``NotImplementedError`` naming its item, here and in
the composition root. Watch discovery (``--discovery-mode watch``) is
ported: its reconcile runs every tick.

Tick semantics (the amortization contract):

* The FIRST scan fetches the strategy's full history window
  ``[now - history, now]`` and folds it into the resident digest store.
* Every later tick fetches only the DELTA window ``[last_end + step, now]``
  — the samples Prometheus's evaluation grid adds after the last folded
  window — and folds it in. Digest bucket counts are integer-valued and
  merge by exact addition (peaks by max), so the accumulated store is
  bit-identical to a cold scan over the union window; nothing is ever
  re-fetched or double-counted.
* Discovery (apiserver inventory) runs on its own slower cadence; a
  re-discovery compacts the store to the currently-discovered fleet so
  workload churn can't grow it without bound.

A scan runs entirely OUTSIDE the state's read/write lock — fetch and fold
build a private window, the recommendation compute reads the store from a
worker thread — and publishes with one atomic snapshot swap at the end, so
queries serve the previous result throughout. ``state.last_end`` advances
only after a fold completes: a scan cancelled mid-fetch (shutdown, restart)
simply refetches its window on the next tick.

Failure domains (fault-isolated degraded ticks): a workload whose fetch
fails TERMINALLY this tick is QUARANTINED — its rows stay unfolded (the
one-shot CLI's degrade-to-UNKNOWN would here fold an empty window and
advance past it, silently losing those samples from the accumulated store),
its last-good digests keep serving with a ``stale_since`` mark, and on a
later tick a CATCH-UP leg refetches the union of every window it missed
from its own cursor — digest mergeability makes the recovered store
bit-identical to one that never missed a window. The quarantine cursor
persists in the store's extra_meta (same atomic save as the window cursor),
a workload stale past ``--max-staleness`` drops its row and re-enters as
fresh (full backfill), and a tick whose fetch-success fraction falls below
``--min-fetch-success-pct`` still hard-aborts — folding and publishing a
mostly-empty fleet would be worse than serving the previous result. The
whole tick also still aborts on infrastructure errors (cancellation,
discovery failures mid-flight), which leave store, cursor, and quarantine
untouched for a clean refetch.

Window edges are clamped to the Prometheus evaluation grid: a range query
evaluates at ``start, start + step, …``, so the fetched window's true right
edge is the last grid point ≤ now. ``last_end`` records THAT point — with a
wall-clock right edge, tick jitter (a 90 s sleep on a 60 s grid) would skip
the grid samples between the last evaluated point and the clock reading.

The publish leg runs through `krr_tpu_torch.history`: every recompute's raw
recommendations append to the journal (the flight recorder behind
``GET /history`` / ``GET /drift`` / ``krr-tpu diff``), and the values that
reach the published snapshot are filtered by the hysteresis gate — they only
move when drift exceeds the dead band for the confirmation window, so the
snapshot the fleet consumes is stable by construction while the journal
retains the raw series (``--no-hysteresis`` restores verbatim publishing).
"""

from __future__ import annotations

import asyncio
import contextlib
import time
from typing import Callable, Optional

import numpy as np

from krr_tpu_torch.core.runner import ScanSession, round_allocations
from krr_tpu_torch.core.streaming import object_key
from krr_tpu_torch.history.policy import HysteresisGate
from krr_tpu_torch.models.objects import K8sObjectData
from krr_tpu_torch.models.result import ResourceScan, Result
from krr_tpu_torch.server.state import ServerState, Snapshot
from krr_tpu_torch.utils.logging import KrrLogger


def check_ported(config) -> None:
    """Refuse the serve modes whose modules belong to later slices of the
    port, naming the ROADMAP item — never a silent fallback to the default
    mode."""
    if getattr(config, "metrics_mode", "pull") == "push":
        raise NotImplementedError(
            "--metrics-mode push is not ported yet (ROADMAP M10b: federation "
            "and push ingest); use the default --metrics-mode pull"
        )


class ScanScheduler:
    """Drives a :class:`ScanSession` incrementally against a :class:`ServerState`."""

    def __init__(
        self,
        session: ScanSession,
        state: ServerState,
        *,
        scan_interval: float,
        discovery_interval: float,
        clock: Callable[[], float] = time.time,
        logger: Optional[KrrLogger] = None,
        durable=None,
        aggregator=None,
        ingest=None,
        uplink=None,
    ) -> None:
        if aggregator is not None or ingest is not None or uplink is not None:
            raise NotImplementedError(
                "the federation aggregator, the region uplink and the push "
                "ingest plane are not ported yet (ROADMAP M10b)"
            )
        check_ported(session.config)
        self.session = session
        self.state = state
        #: The durable persistence engine (`krr_tpu_torch.core.durastore`) when
        #: the serve composition opened one for state_path — per-tick delta
        #: WAL appends, threshold compaction, and the publish epoch the
        #: journal reconciles against. None (direct construction, no
        #: state_path) falls back to the legacy whole-file save.
        self.durable = durable
        self.scan_interval = float(scan_interval)
        self.discovery_interval = float(discovery_interval)
        self.clock = clock
        self.logger = logger or session.logger
        self._objects: Optional[list[K8sObjectData]] = None
        self._discovered_at: float = -float("inf")
        self._task: Optional[asyncio.Task] = None
        #: The state file (tdigest ``state_path``) the resident store syncs
        #: to after each fold, when configured — restarts resume the digests.
        #: A RUNNING server owns its state file exclusively: each tick saves
        #: the resident store over it, so a concurrent one-shot
        #: ``tdigest --state_path`` merge against the same file would be
        #: silently overwritten — run backfills before starting the server.
        self.state_path: Optional[str] = getattr(session.strategy.settings, "state_path", None)
        # Resume the window cursor alongside the digests: without it a
        # restart's first scan would fold the FULL history window into a
        # store that already contains it — double-counting every overlap
        # sample. The cursor lives in the store's OWN extra_meta (one atomic
        # save covers arrays + cursor; a sidecar could desync on a crash
        # between two writes, losing or double-counting a window).
        if self.state_path and self.state.store.keys and self.state.last_end is None:
            cursor = self.state.store.extra_meta.get("serve_last_end")
            if cursor is not None:
                self.state.last_end = float(cursor)
            else:
                self.logger.warning(
                    f"Digest state at {self.state_path} carries no serve window cursor — "
                    f"the first scan re-folds the full window on top of the resumed store"
                )
        # Degraded-tick policy (fault isolation): failed workload fetches
        # QUARANTINE — their windows stay unfolded, their last-good digests
        # carry forward with stale marks — instead of aborting the whole
        # tick, unless the fetch-success fraction falls below the floor.
        config = session.config
        self.min_fetch_success_pct = float(getattr(config, "min_fetch_success_pct", 100.0))
        #: Staleness budget: past it a quarantined workload's accumulated
        #: row drops and it re-enters as fresh (full-window backfill).
        self.max_staleness = (
            float(getattr(config, "max_staleness_seconds", 0.0)) or 10.0 * self.scan_interval
        )
        #: Last completed tick's distillables for the flight recorder
        #: (`krr_tpu_torch.obs.timeline`): window, rows, publish verdict, persist
        #: outcome — consumed by :meth:`_observe_timeline` in run_once.
        self.last_tick_stats: "Optional[dict]" = None
        #: Cumulative fetch-plan counter totals at the last recorded tick,
        #: so the timeline record carries per-TICK coalesced/sharded/
        #: downsampled deltas instead of process-lifetime sums.
        self._plan_totals: "dict[str, float]" = {
            "coalesced": 0.0, "sharded": 0.0, "downsampled": 0.0,
        }
        #: Read-path counter totals (and /recommendations latency-histogram
        #: cumulative buckets) at the last recorded tick — the timeline
        #: record carries per-TICK served/hit/miss/shed/bytes deltas and a
        #: per-tick p99, the same delta discipline as the plan counters.
        self._read_totals: "dict[str, float]" = {}
        self._read_buckets: "Optional[dict[float, float]]" = None
        #: Watch-driven discovery (``--discovery-mode watch``): the
        #: reconcile runs EVERY tick (it is O(churn) in-memory work), and
        #: churn compaction only runs when the inventory generation moved —
        #: watch deletes feed the existing store drop ops, and a quiet
        #: fleet's ticks skip the fleet-sized masked copy entirely.
        self.discovery_mode = str(getattr(config, "discovery_mode", "relist"))
        self._compacted_generation: "Optional[int]" = None
        #: Cumulative discovery counter totals at the last recorded tick —
        #: the timeline's ``discovery`` block carries per-TICK event/relist
        #: deltas, the same delta discipline as the plan counters.
        self._discovery_totals: "dict[str, float]" = {}
        #: key → grid-aligned start of the first window its fetch missed:
        #: the catch-up fetch's left edge. Persisted in the store's
        #: extra_meta (same atomic save as the cursor) — a restart must
        #: refetch the missed windows, not silently skip them.
        self._quarantine: dict[str, float] = {}
        if self.state_path and self.state.store.keys and self.state.last_end is not None:
            saved = self.state.store.extra_meta.get("serve_quarantine")
            if saved:
                self._quarantine = {str(k): float(v) for k, v in saved.items()}
        # Adaptive fetch-plan telemetry rides the same atomic save: a restart
        # seeds the per-cluster planners with the previous scan's observed
        # series/bytes so the first tick's query shapes match the last one's
        # instead of re-deriving from cold routed counts.
        session.seed_fetch_plans(self.state.store.extra_meta.get("serve_fetch_plan"))
        self._publish_stale_state()
        if (
            getattr(config, "fetch_downsample", "off") != "off"
            and self.state.last_end is not None
            and float(self.state.last_end) % self._step_seconds() != 0
        ):
            # A pre-downsample deployment restored its cursor: the window
            # grid was anchored before alignment existed, every later edge
            # inherits the misalignment (realigning mid-stream would skip
            # or double-count a partial step), and eligibility will decline
            # every query — a forever-zero krr_tpu_fetch_downsampled_total.
            if getattr(config, "realign_window_grid", False) or not self.state.store.keys:
                # The one-shot --realign-window-grid escape (or a store with
                # nothing to lose): drop the cursor AND the accumulated rows
                # so the next tick runs a grid-ALIGNED full backfill — the
                # only realignment that neither skips nor double-counts a
                # partial step. The drop op rides the next durable persist.
                dropped = self.state.store.compact(frozenset())
                self.state.store.extra_meta.pop("serve_last_end", None)
                self.state.last_end = None
                self._quarantine.clear()
                self._publish_stale_state()
                self.logger.warning(
                    f"--fetch-downsample window grid realignment: dropped the "
                    f"persisted cursor and {dropped} accumulated row(s) — the "
                    f"next tick runs a grid-aligned full backfill and "
                    f"downsampling engages from it"
                )
            else:
                self.logger.warning(
                    "--fetch-downsample is on but the persisted window grid is "
                    "not aligned to the step grid (the state predates the "
                    "flag); downsampling stays disengaged until the window "
                    "grid is rebuilt — restart once with --realign-window-grid "
                    "to trade one full backfill for an aligned grid"
                )
        # The hysteresis gate on the publish path (`krr_tpu_torch.history.policy`).
        # A resumed journal re-seeds the trailing published baselines, so a
        # restart keeps gating against the pre-restart published values
        # instead of re-publishing the whole fleet as "new".
        self.gate = HysteresisGate(
            dead_band_pct=config.hysteresis_dead_band_pct,
            confirm_ticks=config.hysteresis_confirm_ticks,
            enabled=config.hysteresis_enabled,
        )
        journal = state.journal
        if journal is not None and journal.record_count:
            published = journal.last_published()
            if published:
                keys = list(published)
                self.gate.seed(
                    keys,
                    np.asarray([published[k][0] for k in keys], np.float32),
                    np.asarray([published[k][1] for k in keys], np.float32),
                )

    # ----------------------------------------------------------- one tick
    def _step_seconds(self) -> float:
        from krr_tpu_torch.integrations.prometheus import effective_step_seconds

        return float(
            effective_step_seconds(self.session.strategy.settings.timeframe_timedelta.total_seconds())
        )

    async def _discover(self, now: float) -> None:
        objects = await self.session.discover()
        metrics = self.state.metrics
        inventory = self.session.get_inventory()
        # Per-cluster discovery failures (fail-soft listings degraded to an
        # empty cluster): surface the FAILING CLUSTERS on /healthz instead
        # of silently scanning a smaller fleet (the loader also counts them
        # in krr_tpu_discovery_cluster_failures_total).
        failed_clusters = getattr(inventory, "last_failed_clusters", None)
        self.state.discovery_failed_clusters = dict(failed_clusters or {})
        if not objects and self.state.store.keys:
            # Discovery is fail-soft per cluster (a listing error degrades to
            # an empty list) — an empty fleet under a non-empty resident
            # store is overwhelmingly an inventory outage, not real churn,
            # and compacting on it would destroy the accumulated digest
            # history (beyond Prometheus retention, unrecoverable). Keep the
            # previous inventory and leave the discovery timestamp stale so
            # the next tick retries.
            metrics.inc("krr_tpu_discovery_failures_total")
            self.logger.warning(
                f"Discovery returned no objects while the digest store holds "
                f"{len(self.state.store.keys)} rows — keeping the previous inventory "
                f"and skipping churn compaction (transient inventory failure?)"
            )
            return
        self._objects = objects
        self._discovered_at = now
        metrics.set("krr_tpu_fleet_objects", len(objects))
        # Churn compaction: deleted workloads' rows leave the store. Done at
        # every discovery (including a state_path-resumed first one, whose
        # store may carry rows for long-gone workloads). Off the loop: at
        # fleet scale the masked copy of the [N x B] matrix is enough numpy
        # work to stall every in-flight query. In watch mode discovery runs
        # EVERY tick, so the compaction is gated on the inventory
        # generation: only churn (watch deletes included) pays it.
        generation_fn = getattr(inventory, "inventory_generation", None)
        generation = generation_fn() if callable(generation_fn) else None
        if generation is not None and generation == self._compacted_generation:
            return
        dropped = await asyncio.to_thread(
            self.state.store.compact, {object_key(obj) for obj in objects}
        )
        self._compacted_generation = generation
        if dropped:
            metrics.inc("krr_tpu_store_compacted_rows_total", dropped)
            self.logger.info(f"Compacted {dropped} stale rows out of the digest store")

    def _save_store(self) -> None:
        from krr_tpu_torch.core.streaming import DigestStore

        self.state.store.extra_meta["serve_last_end"] = self.state.last_end
        # The quarantine rides the same atomic save as the cursor: a restart
        # that resumed the cursor without it would fold plain deltas for
        # quarantined workloads and silently lose their missed windows.
        if self._quarantine:
            self.state.store.extra_meta["serve_quarantine"] = dict(self._quarantine)
        else:
            self.state.store.extra_meta.pop("serve_quarantine", None)
        # Planner telemetry persists beside the cursor so the NEXT process's
        # first scan plans from this one's observations.
        plan_states = self.session.fetch_plan_states()
        if plan_states:
            self.state.store.extra_meta["serve_fetch_plan"] = plan_states
        else:
            self.state.store.extra_meta.pop("serve_fetch_plan", None)
        with DigestStore.locked(self.state_path):
            if self.durable is not None:
                # Sharded: one appended delta record carrying this tick's
                # folded windows + the extra_meta above (cursor, quarantine,
                # fetch plan) — the same atomicity contract as the
                # monolithic save, at a fraction of the bytes. Legacy
                # format: the classic full rewrite, unchanged on disk.
                self.durable.save_delta()
            else:
                self.state.store.save(self.state_path)

    async def _persist(self) -> None:
        """Persist the store, degrading instead of killing the tick on disk
        faults: ENOSPC/EIO leaves serve publishing from memory with
        /healthz degraded and a retry (carrying the backlog of captured
        deltas) on the next tick."""
        metrics = self.state.metrics
        try:
            await asyncio.to_thread(self._save_store)
        except OSError as e:
            metrics.inc("krr_tpu_persist_failures_total")
            self.state.persist_failures += 1
            self.state.persist_failing = True
            self.state.last_persist_error = f"{type(e).__name__}: {e}"[:300]
            # Bound the backlog: queued fold captures reference each tick's
            # DENSE window matrix — a disk that stays full must not pin one
            # per tick until the degradation it survived becomes an OOM
            # kill. Sparse re-encode is ~250x smaller and WAL-identical.
            await asyncio.to_thread(self.state.store.compact_pending)
            self.logger.warning(
                f"Persisting digest state to {self.state_path} failed ({e}) — "
                f"serving from memory; the next tick retries with the backlog"
            )
        else:
            if self.state.persist_failing:
                self.logger.info(
                    f"Digest state persistence to {self.state_path} recovered"
                )
            self.state.persist_failing = False

    # ------------------------------------------------- degraded-tick helpers
    def _step(self) -> float:
        return float(self._step_seconds())

    def _publish_stale_state(self) -> None:
        """Reflect the quarantine into the read side: ``stale_since`` per
        key (the last grid point actually folded) and the gauge."""
        step = self._step()
        self.state.stale_workloads = {
            key: start - step for key, start in self._quarantine.items()
        }
        self.state.metrics.set("krr_tpu_stale_workloads", len(self._quarantine))

    async def _expire_quarantine(self, now: float) -> None:
        """Drop quarantined workloads whose staleness exceeded the budget:
        their accumulated rows leave the store, so they re-enter as FRESH
        (full-window backfill on the next successful fetch) instead of
        carrying an incremental catch-up window the operator no longer
        trusts as "last known good". The compaction copies the [N x B]
        matrix — off the loop, like the discovery compaction."""
        step = self._step()
        expired = [
            key for key, start in self._quarantine.items()
            if now - (start - step) > self.max_staleness
        ]
        if not expired:
            return
        for key in expired:
            del self._quarantine[key]
        dropped = await asyncio.to_thread(
            self.state.store.compact,
            frozenset(self.state.store.keys) - frozenset(expired),
        )
        # Refresh the read side NOW: if this tick later aborts, /healthz and
        # the gauge must not keep counting workloads whose rows are gone.
        self._publish_stale_state()
        self.state.metrics.inc("krr_tpu_quarantine_expired_total", len(expired))
        self.logger.warning(
            f"{len(expired)} quarantined workload(s) exceeded the "
            f"{self.max_staleness:.0f}s staleness budget — dropped {dropped} "
            f"store row(s); they re-enter with a full-window backfill"
        )

    async def _recompute_and_publish(
        self,
        objects: list[K8sObjectData],
        rows: np.ndarray,
        window_end: float,
        *,
        record: bool = True,
    ) -> None:
        """Query the store, gate through hysteresis, journal the raw tick,
        render, publish. ``record=False`` on the resume re-publish (the tick
        was already journaled before the restart)."""
        from krr_tpu_torch.strategies.simple import finalize_fleet

        metrics = self.state.metrics
        journal = self.state.journal

        def render() -> "tuple[Result, bytes, bytes, object, list[str]]":
            # Query + gate + journal + recommend + render + encode in ONE
            # worker-thread hop: the whole-fleet JSON is multi-MB at scale,
            # and any leg of it on the event loop stalls every in-flight
            # query. The store query is the shared
            # `DigestStore.query_recommendation` — the same path the tdigest
            # strategy's run_digested uses, queried exactly once per tick.
            # The quantile/round sub-spans (the serve legs of the compute
            # taxonomy, `krr_tpu_torch.obs.device`) parent to the compute span via
            # the contextvar copied into this worker thread.
            settings = self.session.strategy.settings
            config = self.session.config
            with tracer.span("quantile", rows=len(objects), path="store"):
                cpu_raw, mem_raw = self.state.store.query_recommendation(
                    rows, float(settings.cpu_percentile)
                )
            # The card's memory gauges (`DeviceObs.record_device_memory`,
            # nothing on a CPU strategy): the query above is host numpy, so
            # there is no device work to fence — the read is a snapshot of
            # the allocator's counters.
            strategy = self.session.strategy
            strategy.obs.record_device_memory(strategy.device)
            keys = [object_key(obj) for obj in objects]
            decision = self.gate.observe(keys, cpu_raw, mem_raw)
            # The instantaneous over-provision snapshot (`krr_tpu_torch.eval`):
            # what the gate-HELD values publish above this tick's raw
            # demand, fleet-summed. The /statusz savings block integrates
            # the same slack over the journal window; this pair is the
            # per-tick spot reading. Raw memory is journal-unit MB → GB.
            held_cpu = np.asarray(decision.cpu, np.float64)
            held_mem = np.asarray(decision.mem, np.float64)
            cpu_slack = np.where(
                np.isfinite(held_cpu) & np.isfinite(cpu_raw),
                np.maximum(held_cpu - cpu_raw, 0.0), 0.0,
            )
            mem_slack = np.where(
                np.isfinite(held_mem) & np.isfinite(mem_raw),
                np.maximum(held_mem - mem_raw, 0.0), 0.0,
            )
            metrics.set("krr_tpu_eval_overprovision_cores", round(float(cpu_slack.sum()), 6))
            metrics.set("krr_tpu_eval_overprovision_gb", round(float(mem_slack.sum()) / 1000.0, 6))
            # The shared publish epoch: this tick's journal batch is marked
            # with the epoch its store persist WILL commit as, so a crash
            # between the two is detectable (and reconciled by truncation)
            # at restart instead of heuristically.
            pending_epoch = (
                self.durable.epoch + 1
                if self.durable is not None and self.durable.fmt == "sharded"
                else None
            )
            if journal is not None:
                if record:
                    journal.append_tick(
                        window_end, keys, cpu_raw, mem_raw, decision.published,
                        epoch=pending_epoch,
                    )
                    dropped = journal.compact(window_end)
                    if dropped:
                        metrics.inc("krr_tpu_journal_compacted_records_total", dropped)
                elif self.gate.enabled:
                    # The resume re-publish normally journals nothing (the
                    # window was journaled before the restart) — but rows the
                    # gate publishes FIRST-TIME here (workloads the journal
                    # seed couldn't cover: flagged records aged out, lost
                    # sidecar) must gain a FLAG_PUBLISHED record, or the
                    # journal's forward-filled published series (drift, the
                    # next restart's seed) diverges from what the gate holds.
                    # Excluded: seed-covered rows whose gate happened to open
                    # (published & changed), and any key that ALREADY has a
                    # record at this window_end (its raw tick survived
                    # retention even though its published flag didn't) — a
                    # duplicate same-timestamp record would distort the
                    # /history tick counts and the drift/flap series.
                    first = decision.published & ~decision.changed
                    if bool(np.any(first)):
                        from krr_tpu_torch.history.journal import hash_key

                        recs = journal.records()
                        at_tick = {int(h) for h in recs["key_hash"][recs["ts"] == window_end]}
                        if at_tick:
                            first &= np.fromiter(
                                (hash_key(k) not in at_tick for k in keys), bool, len(keys)
                            )
                    if bool(np.any(first)):
                        idx = np.flatnonzero(first)
                        journal.append_tick(
                            window_end,
                            [keys[i] for i in idx],
                            cpu_raw[idx],
                            mem_raw[idx],
                            np.ones(len(idx), bool),
                            # The resume re-publish persists nothing after:
                            # these records belong to the CURRENT durable
                            # epoch, not a pending one.
                            epoch=(
                                self.durable.epoch
                                if self.durable is not None and self.durable.fmt == "sharded"
                                else None
                            ),
                        )
            with tracer.span("round", rows=len(objects)):
                raw_results = finalize_fleet(
                    decision.cpu, decision.mem, settings.memory_buffer_percentage
                )
                scans = [
                    ResourceScan.calculate(
                        obj,
                        round_allocations(
                            raw,
                            cpu_min_value=config.cpu_min_value,
                            memory_min_value=config.memory_min_value,
                        ),
                    )
                    for obj, raw in zip(objects, raw_results)
                ]
                # Degraded-tick stale marks: a quarantined workload's scan
                # carries the age of its last folded window, so consumers
                # of /recommendations can tell a carried-forward value
                # from a fresh one.
                stale = self.state.stale_workloads
                if stale:
                    for key, scan in zip(keys, scans):
                        since = stale.get(key)
                        if since is not None:
                            scan.stale_since = since
                result = Result(scans=scans)
            body = result.format("json").encode()
            # Digested here, in the worker thread: publish() then decides
            # changed-vs-identical with an O(1) compare under the write
            # lock instead of a fleet-sized memcmp on the event loop.
            import hashlib

            digest = hashlib.blake2b(body, digest_size=16).digest()
            return result, body, digest, decision, keys

        tracer = self.session.tracer
        with tracer.span("compute", rows=len(objects)):
            result, body, digest, decision, keys = await asyncio.to_thread(render)
        with tracer.span("publish") as publish_span:
            changed = int(np.count_nonzero(decision.changed))
            suppressed = int(np.count_nonzero(decision.suppressed))
            if changed:
                metrics.inc("krr_tpu_recommendation_churn_total", changed)
            if suppressed:
                metrics.inc("krr_tpu_hysteresis_suppressed_total", suppressed)
            self.state.last_publish_changed = changed
            self.state.last_publish_suppressed = suppressed
            if journal is not None:
                metrics.set("krr_tpu_journal_records", journal.record_count)
                metrics.set("krr_tpu_journal_bytes", journal.nbytes)
                newest, oldest = journal.newest_ts, journal.oldest_ts
                metrics.set(
                    "krr_tpu_journal_span_seconds",
                    (newest - oldest) if newest is not None and oldest is not None else 0.0,
                )
            publish_span.set(changed=changed, suppressed=suppressed)
            # The epoch and changed_at are stamped by the state's publish:
            # byte-identical republishes (suppressed ticks) keep the
            # previous epoch, so the read path's ETags/cache stay warm.
            await self.state.publish(
                Snapshot(
                    result=result,
                    body_json=body,
                    window_end=window_end,
                    published_at=time.time(),
                    keys=tuple(keys),
                    body_digest=digest,
                )
            )

    async def tick(self) -> bool:
        """One scan: (maybe) re-discover, fetch the due window, fold,
        recompute, publish. Returns False when no new window was due."""
        async with self.state.scan_lock:
            # One trace per tick: the root span's trace_id IS the scan id
            # stamped through structured logs (contextvar propagation),
            # /healthz (last_scan_id), and /debug/trace. Ticks that turn
            # out to be pure no-ops are discarded from the ring below so
            # they can't evict real scans.
            tracer = self.session.tracer
            with tracer.span("scan", kind="serve") as scan_span:
                did_scan = await self._tick_traced(scan_span)
            if not did_scan and scan_span.attributes.get("kind") == "skipped":
                tracer.discard(scan_span.trace_id)
            return did_scan

    async def _tick_traced(self, scan_span) -> bool:
        from krr_tpu_torch.strategies.simple import MEMORY_SCALE

        now = float(self.clock())
        metrics = self.state.metrics
        settings = self.session.strategy.settings
        step = self._step_seconds()
        # Fresh per-scan fetch budgets (the Prometheus retry deadline pool).
        self.session.begin_scan()

        t0 = time.perf_counter()
        # Watch mode reconciles EVERY tick — the whole point of the resident
        # inventory is that re-discovery became O(churn) in-memory work, so
        # workload churn lands on the next scan instead of the next
        # discovery interval.
        if (
            self._objects is None
            or now - self._discovered_at >= self.discovery_interval
            or self.discovery_mode == "watch"
        ):
            await self._discover(now)
        objects = self._objects or []
        t1 = time.perf_counter()

        if self.state.last_end is None:
            start = now - settings.history_timedelta.total_seconds()
            if getattr(self.session.config, "fetch_downsample", "off") != "off":
                # Server-side downsampling is only exact on the ABSOLUTE
                # step grid (Prometheus evaluates subquery inner steps at
                # epoch-aligned timestamps): align the first window's origin
                # down to it. Every later edge inherits the alignment —
                # delta starts are last_end + step, backfill/catch-up edges
                # derive from the aligned end. Costs at most one extra step
                # of history on the first full scan.
                start -= start % step
            kind = "full"
        else:
            # One step past the last folded window's right edge: the
            # range query's grid includes its own start point, so
            # starting AT last_end would re-fetch (and double-count)
            # the sample already folded there.
            start = self.state.last_end + step
            kind = "delta"
            if start > now:
                metrics.inc("krr_tpu_scans_skipped_total")
                scan_span.set(kind="skipped")
                if self.state.peek() is None and self.state.store.keys:
                    scan_span.set(kind="resume-publish")
                    # A state_path restart inside one step window: the
                    # resumed store is complete but nothing is published
                    # yet — serve from the resident digests instead of
                    # 503ing until the next window opens. Only objects
                    # ALREADY resident are published: rows_for grows
                    # empty rows for unseen keys, and inserting a
                    # workload discovered while the server was down
                    # would make the next tick see it as seasoned and
                    # skip its full-window backfill forever — it joins
                    # the published result when that tick runs instead.
                    known = [
                        obj for obj in objects if object_key(obj) in self.state.store
                    ]
                    rows = await asyncio.to_thread(
                        self.state.store.rows_for, [object_key(obj) for obj in known]
                    )
                    # record=False: this window's tick was journaled
                    # before the restart — re-appending it would
                    # double-record the same timestamp.
                    await self._recompute_and_publish(
                        known, rows, self.state.last_end, record=False
                    )
                    self.state.last_scan_id = scan_span.trace_id
                return False
        # Clamp the right edge to the last evaluation-grid point ≤ now
        # (see the module docstring): the next delta then starts exactly
        # one step past the last point actually fetched.
        end = start + ((now - start) // step) * step

        # A full scan refetches everything from scratch — any quarantine
        # inherited from stale metadata is covered by it.
        if kind == "full" and self._quarantine:
            self._quarantine.clear()
            self._publish_stale_state()
        # Quarantined workloads past the staleness budget drop their rows
        # and re-enter as fresh (full backfill) — BEFORE the leg split, so
        # they land in `fresh` below.
        await self._expire_quarantine(now)

        # Leg split. Workloads that appeared since the last scan have no
        # store row yet; a delta-width fetch would skip everything between
        # their creation and last_end (startup spikes included — peak-based
        # memory recommendations would miss them forever). They get a
        # FULL-window backfill alongside the fleet's delta. QUARANTINED
        # workloads (an earlier degraded tick lost their window) instead get
        # a CATCH-UP leg from their own cursor — the union of every window
        # they missed plus this delta, which the digest's exact mergeability
        # folds bit-identically to having never missed them.
        backfill_start = end - (settings.history_timedelta.total_seconds() // step) * step
        fresh: list[K8sObjectData] = []
        seasoned: list[K8sObjectData] = []
        catchup: dict[float, list[K8sObjectData]] = {}
        if kind == "delta":
            for obj in objects:
                key = object_key(obj)
                if key in self._quarantine:
                    catchup.setdefault(self._quarantine[key], []).append(obj)
                elif key not in self.state.store:
                    fresh.append(obj)
                else:
                    seasoned.append(obj)
        else:
            seasoned = objects

        use_pipeline = self.session.config.pipeline_depth > 0
        pipeline_stats = []

        async def fetch(objs: list[K8sObjectData], w_start: float) -> "object":
            if use_pipeline:
                # Streamed pipeline: per-namespace batches fold into the
                # tick's PRIVATE window fleet while the rest still fetch
                # (`ScanSession.stream_fleet_digests`). The resident
                # store is only touched by the single fold below — a
                # failed BATCH degrades to empty rows marked in
                # failed_rows (quarantine fodder), and an aborted tick
                # still leaves the store untouched.
                _objs, fleet, stats = await self.session.stream_fleet_digests(
                    objs,
                    history_seconds=end - w_start,
                    step_seconds=settings.timeframe_timedelta.total_seconds(),
                    end_time=end,
                    raise_on_failure=False,
                )
                pipeline_stats.append(stats)
                return fleet
            return await self.session.gather_fleet_digests(
                objs,
                history_seconds=end - w_start,
                step_seconds=settings.timeframe_timedelta.total_seconds(),
                end_time=end,
                raise_on_failure=False,
            )

        legs: list[tuple[list[K8sObjectData], float, str]] = []
        has_seasoned_leg = bool(seasoned) or not (fresh or catchup)
        if has_seasoned_leg:
            legs.append((seasoned, start, kind))
        if fresh:
            legs.append((fresh, backfill_start, "backfill"))
        for q_start in sorted(catchup):
            legs.append((catchup[q_start], q_start, "catchup"))
        # return_exceptions so a failing fetch doesn't orphan its
        # sibling mid-download (same rationale as the session's own
        # cluster fan-out). Only infrastructure errors arrive here now —
        # fetch failures degrade to failed_rows.
        fleets = await asyncio.gather(
            *[fetch(leg_objects, w_start) for leg_objects, w_start, _ in legs],
            return_exceptions=True,
        )
        for fleet in fleets:
            if isinstance(fleet, BaseException):
                raise fleet

        t2 = time.perf_counter()

        # Fault isolation: failed workloads QUARANTINE (their windows stay
        # unfolded; last-good digests carry forward below) — unless the
        # fetch-success fraction falls under the floor, where publishing
        # the mostly-empty remainder would be worse than serving the
        # previous result.
        failed_keys: set[str] = set()
        for fleet in fleets:
            for i in fleet.failed_rows:
                failed_keys.add(object_key(fleet.objects[i]))
        if objects and failed_keys:
            success_pct = 100.0 * (1.0 - len(failed_keys) / len(objects))
            if success_pct < self.min_fetch_success_pct:
                raise RuntimeError(
                    f"{len(failed_keys)} of {len(objects)} object fetches failed "
                    f"terminally (fetch success {success_pct:.0f}% below the "
                    f"--min-fetch-success-pct floor {self.min_fetch_success_pct:g}%)"
                )

        with self.session.tracer.span("fold", rows=len(objects)):
            for fleet in fleets:
                if fleet.failed_rows:
                    # A failed row may still carry ONE resource's successful
                    # samples (its sibling query failed). Zero it entirely:
                    # the catch-up leg refetches BOTH resources over the
                    # missed windows, and a half-folded row would
                    # double-count the surviving half.
                    rows_to_clear = sorted(fleet.failed_rows)
                    fleet.clear_cpu_rows(rows_to_clear)
                    fleet.clear_mem_rows(rows_to_clear)
                await asyncio.to_thread(self.state.store.fold_fleet, fleet, MEMORY_SCALE)
            rows = await asyncio.to_thread(
                self.state.store.rows_for, [object_key(obj) for obj in objects]
            )
        self.state.last_end = end

        # Quarantine bookkeeping: recovered workloads (their catch-up leg
        # folded through `end`) leave; newly failed ones enter at their
        # leg's window start; repeat offenders keep their ORIGINAL cursor —
        # the catch-up window keeps growing until it succeeds or expires.
        for leg_objects, w_start, _ in legs:
            for obj in leg_objects:
                key = object_key(obj)
                if key in failed_keys:
                    self._quarantine.setdefault(key, w_start)
                else:
                    self._quarantine.pop(key, None)
        self._publish_stale_state()
        if failed_keys:
            metrics.inc("krr_tpu_scans_degraded_total")
            metrics.inc("krr_tpu_fetch_failed_rows_total", len(failed_keys))
            self.logger.warning(
                f"Degraded tick: {len(failed_keys)} of {len(objects)} workload "
                f"fetches failed — quarantined with stale marks "
                f"({len(self._quarantine)} total in quarantine)"
            )
        metrics.set("krr_tpu_scan_failed_rows", len(failed_keys))
        if pipeline_stats:
            # Batch-granular failure view (between per-row failed_keys and
            # the per-tick degraded counter): how many namespace batches
            # came back dead this tick.
            metrics.set(
                "krr_tpu_scan_failed_batches",
                sum(s.failed_batches for s in pipeline_stats),
            )
        t3 = time.perf_counter()

        await self._recompute_and_publish(objects, rows, end)
        t4 = time.perf_counter()

        persist_seconds = 0.0
        persist_bytes = 0
        if self.state_path:
            wal_before = self.durable.wal_size if self.durable is not None else 0
            await self._persist()
            persist_seconds = time.perf_counter() - t4
            # Appended WAL bytes (clamped: a threshold compaction inside
            # the persist resets the WAL, which is not a negative append).
            wal_after = self.durable.wal_size if self.durable is not None else 0
            persist_bytes = max(0, wal_after - wal_before)

        metrics.inc("krr_tpu_scans_total", kind=kind)
        # Every object's fetch was ATTEMPTED this tick — the SLO fetch
        # objective's denominator (failed ones landed in
        # krr_tpu_fetch_failed_rows_total above).
        if objects:
            metrics.inc("krr_tpu_fetch_rows_total", len(objects))
        if has_seasoned_leg:
            # Only when the delta/full leg actually fetched: a tick whose
            # every object rode a backfill or catch-up leg counts those
            # windows under their own kinds, not a phantom delta.
            metrics.inc("krr_tpu_fetch_window_seconds_total", end - start, kind=kind)
        if fresh:
            metrics.inc("krr_tpu_backfilled_objects_total", len(fresh))
            metrics.inc(
                "krr_tpu_fetch_window_seconds_total", end - backfill_start, kind="backfill"
            )
        for q_start in catchup:
            metrics.inc(
                "krr_tpu_fetch_window_seconds_total", end - q_start, kind="catchup"
            )
        metrics.set("krr_tpu_scan_window_seconds", end - start)
        metrics.set("krr_tpu_last_scan_timestamp_seconds", end)
        metrics.set("krr_tpu_scan_duration_seconds", t1 - t0, phase="discover")
        metrics.set("krr_tpu_scan_duration_seconds", t2 - t1, phase="fetch")
        metrics.set("krr_tpu_scan_duration_seconds", t3 - t2, phase="fold")
        metrics.set("krr_tpu_scan_duration_seconds", t4 - t3, phase="compute")
        if pipeline_stats:
            # Per-stage overlap of the streamed fetch+fold pipeline —
            # the main (seasoned) leg plus any backfill leg, summed for
            # busy time, max'd for the overlap percentage.
            metrics.set(
                "krr_tpu_scan_pipeline_seconds",
                sum(s.fetch_seconds for s in pipeline_stats),
                stage="fetch",
            )
            metrics.set(
                "krr_tpu_scan_pipeline_seconds",
                sum(s.fold_seconds for s in pipeline_stats),
                stage="fold",
            )
            metrics.set(
                "krr_tpu_scan_overlap_pct",
                max(s.overlap_pct for s in pipeline_stats),
            )
            # Wait attribution: which pipeline side gated this tick
            # (producers blocked in put = fold-bound, consumer starved in
            # get = fetch-bound), summed like the stage busy times.
            metrics.set(
                "krr_tpu_scan_pipeline_wait_seconds",
                sum(s.put_blocked_seconds for s in pipeline_stats),
                side="producer_blocked",
            )
            metrics.set(
                "krr_tpu_scan_pipeline_wait_seconds",
                sum(s.get_starved_seconds for s in pipeline_stats),
                side="consumer_starved",
            )
        metrics.set("krr_tpu_digest_store_rows", len(self.state.store.keys))
        metrics.set("krr_tpu_digest_store_bytes", self.state.store.nbytes)
        scan_span.set(
            kind=kind,
            window_start=start,
            window_end=end,
            objects=len(objects),
            backfilled=len(fresh),
            failed_rows=len(failed_keys),
            quarantined=len(self._quarantine),
        )
        self.state.last_scan_id = scan_span.trace_id
        self.last_tick_stats = {
            "scan_id": scan_span.trace_id,
            "kind": kind,
            "window_start": start,
            "window_end": end,
            "objects": len(objects),
            "failed_rows": len(failed_keys),
            "backfilled": len(fresh),
            "stale": len(self._quarantine),
            "discovery": self._discovery_tick_stats(now),
            "publish_changed": self.state.last_publish_changed,
            "publish_suppressed": self.state.last_publish_suppressed,
            "persist_seconds": persist_seconds,
            "persist_bytes": persist_bytes,
            "persist_failing": self.state.persist_failing,
            "epoch": (
                self.durable.epoch
                if self.durable is not None and self.durable.fmt == "sharded"
                else None
            ),
        }
        self.logger.info(
            f"{kind} scan {scan_span.trace_id or ''} folded window [{start:.0f}, {end:.0f}] "
            f"({len(objects)} objects, {len(self.state.store.keys)} store rows): "
            f"discover {t1 - t0:.2f}s, fetch {t2 - t1:.2f}s, "
            f"fold {t3 - t2:.2f}s, compute {t4 - t3:.2f}s"
        )
        return True

    # ----------------------------------------------- discovery tick stats
    def _discovery_tick_stats(self, now: float) -> dict:
        """Per-tick discovery posture for the timeline record, /healthz, and
        /statusz: the active mode, this tick's watch event deltas
        (adds/updates/drops/bookmarks), watch restarts and relist fallbacks
        since the last tick, and the inventory/watch freshness ages."""
        metrics = self.state.metrics
        inventory = self.session.get_inventory()
        status_fn = getattr(inventory, "discovery_status", None)
        status = status_fn() if callable(status_fn) else {}

        def events_total(type_: str) -> float:
            return sum(
                value
                for series, value in metrics.series(
                    "krr_tpu_discovery_watch_events_total"
                ).items()
                if ("type", type_) in set(series)
            )

        totals = {
            "adds": events_total("added"),
            "updates": events_total("modified"),
            "drops": events_total("deleted"),
            "bookmarks": events_total("bookmark"),
            "watch_restarts": metrics.total("krr_tpu_discovery_watch_restarts_total"),
            "relists": metrics.total("krr_tpu_discovery_relists_total"),
        }
        delta = {
            key: int(max(0.0, value - self._discovery_totals.get(key, 0.0)))
            for key, value in totals.items()
        }
        self._discovery_totals = totals
        stats: dict = {"mode": status.get("mode", self.discovery_mode), **delta}
        if self._discovered_at > -float("inf"):
            stats["inventory_age_seconds"] = round(max(0.0, now - self._discovered_at), 3)
        if status.get("watch_lag_seconds") is not None:
            stats["watch_lag_seconds"] = status["watch_lag_seconds"]
        # The read side (/healthz, /statusz) shows the LIVE posture.
        self.state.discovery = dict(stats)
        return stats

    # ----------------------------------------------- read-path tick stats
    def _readpath_tick_stats(self) -> dict:
        """Per-tick /recommendations serving stats from the shared registry:
        requests/304s/cache hits/misses/sheds/bytes as deltas since the
        last recorded tick, plus the tick's p99 request latency estimated
        from the route's histogram-bucket deltas. Feeds the timeline record
        (so the sentinel can band read latency), the
        ``krr_tpu_http_read_p99_seconds`` gauge (the optional
        ``--slo-read-p99`` objective's value), and the
        ``krr_tpu_http_read_requests`` gauge that gates both on "did this
        tick actually serve reads"."""
        from krr_tpu_torch.obs.metrics import histogram_quantile

        metrics = self.state.metrics
        route = ("route", "/recommendations")

        def route_sum(name: str, **extra: str) -> float:
            want = {route, *((k, v) for k, v in extra.items())}
            return sum(
                value
                for series, value in metrics.series(name).items()
                if want <= set(series)
            )

        totals = {
            "requests": route_sum("krr_tpu_http_requests_total"),
            "not_modified": route_sum("krr_tpu_http_requests_total", code="304"),
            "bytes": route_sum("krr_tpu_http_response_bytes_total"),
            "cache_hits": metrics.total("krr_tpu_http_cache_hits_total"),
            "cache_misses": metrics.total("krr_tpu_http_cache_misses_total"),
            "renders_shed": metrics.total("krr_tpu_http_renders_shed_total"),
        }
        delta = {
            key: max(0.0, value - self._read_totals.get(key, 0.0))
            for key, value in totals.items()
        }
        self._read_totals = totals
        buckets = metrics.histogram_buckets(
            "krr_tpu_http_request_seconds", route="/recommendations"
        )
        p99 = None
        if buckets:
            previous = self._read_buckets or {}
            # Cumulative-minus-cumulative stays cumulative: the diff pairs
            # are this tick's own histogram.
            tick_pairs = [
                (bound, count - previous.get(bound, 0.0)) for bound, count in buckets
            ]
            self._read_buckets = dict(buckets)
            p99 = histogram_quantile(tick_pairs, 0.99)
        stats = {
            "requests": int(delta["requests"]),
            "not_modified": int(delta["not_modified"]),
            "cache_hits": int(delta["cache_hits"]),
            "cache_misses": int(delta["cache_misses"]),
            "shed": int(delta["renders_shed"]),
            "bytes": int(delta["bytes"]),
            "p99_ms": round(p99 * 1e3, 3) if p99 is not None else None,
        }
        metrics.set("krr_tpu_http_read_requests", stats["requests"])
        if stats["requests"] and p99 is not None:
            metrics.set("krr_tpu_http_read_p99_seconds", p99)
        return stats

    # ----------------------------------------------- flight recorder hook
    async def _observe_timeline(self) -> None:
        """Distill the just-completed tick into one timeline record (from
        the trace ring's newest trace + the tick stash), append it to the
        flight recorder, and run the sentinel's classification. Failures
        here degrade — the recorder must never take down the scan loop it
        is recording."""
        timeline = self.state.timeline
        sentinel = self.state.sentinel
        stats = self.last_tick_stats
        if (timeline is None and sentinel is None) or stats is None:
            return
        if stats.get("scan_id") != self.state.last_scan_id:
            return  # stale stash (defensive: the tick aborted after stashing)
        from krr_tpu_torch.obs.profile import profile_trace
        from krr_tpu_torch.obs.timeline import build_scan_record

        report = None
        for spans in reversed(self.session.tracer.traces()):
            if spans and spans[0].trace_id == stats["scan_id"]:
                report = profile_trace(spans)
                break
        metrics = self.state.metrics
        plan_delta: dict[str, float] = {}
        for key, metric in (
            ("coalesced", "krr_tpu_fetch_plan_coalesced_total"),
            ("sharded", "krr_tpu_fetch_plan_sharded_total"),
            ("downsampled", "krr_tpu_fetch_downsampled_total"),
        ):
            total = metrics.total(metric)
            plan_delta[key] = max(0.0, total - self._plan_totals[key])
            self._plan_totals[key] = total
        record = build_scan_record(
            report, stats, metrics=metrics, slo=self.state.slo, plan_delta=plan_delta
        )
        self.last_tick_stats = None
        if timeline is not None:
            # The append fsyncs: off the loop like every other disk leg.
            await asyncio.to_thread(timeline.append, record)
        if sentinel is not None:
            sentinel.observe(record)

    # ----------------------------------------------------------- the loop
    async def run_once(self) -> "Optional[bool]":
        """One guarded scheduler round: tick, count a failure if it aborts,
        record the completed tick into the flight recorder (and classify it
        through the sentinel), then evaluate the SLO engine — failures
        included, which is the point: the burn-rate windows must see bad
        ticks the moment they happen, not whenever the next healthy tick
        lands. Returns the tick's result (None when it failed)."""
        did_scan: Optional[bool] = None
        try:
            did_scan = await self.tick()
        except asyncio.CancelledError:
            raise
        except Exception as e:
            self.state.metrics.inc("krr_tpu_scan_failures_total")
            self.state.consecutive_scan_failures += 1
            self.state.last_scan_error = f"{type(e).__name__}: {e}"[:300]
            self.logger.warning(f"Scan failed: {e} — serving the previous result")
            self.logger.debug_exception()
        else:
            self.state.consecutive_scan_failures = 0
        if did_scan:
            # Stash the tick's read-path serving stats BEFORE the recorder
            # distills them: the timeline record (and through it the
            # sentinel's read_p99_ms band) and the read-p99 SLO gauge both
            # ride this delta.
            if self.last_tick_stats is not None:
                self.last_tick_stats["readpath"] = self._readpath_tick_stats()
            try:
                await self._observe_timeline()
            except asyncio.CancelledError:
                raise
            except Exception as e:
                self.logger.warning(f"Scan timeline recording failed: {e}")
                self.logger.debug_exception()
        # Sentinel verdicts land BEFORE the SLO evaluation so the optional
        # scan_regressions objective sees this tick's classification.
        if self.state.slo is not None:
            self.state.slo.evaluate()
        return did_scan

    async def run(self) -> None:
        while True:
            await self.run_once()
            await asyncio.sleep(self.scan_interval)

    def start(self) -> None:
        if self._task is None or self._task.done():
            self._task = asyncio.create_task(self.run(), name="krr-tpu-scan-scheduler")

    async def stop(self) -> None:
        """Graceful shutdown: cancel the loop (a scan cancelled mid-fetch
        leaves the store and published snapshot untouched — ``last_end``
        advances only after a completed fold) and wait for it to unwind."""
        if self._task is not None:
            self._task.cancel()
            with contextlib.suppress(asyncio.CancelledError):
                await self._task
            self._task = None
