"""The streamed scan pipeline: overlap fetch and fold with bounded backpressure.

A copy of `krr_tpu/core/pipeline.py`. A staged digest-ingest scan gathers
the whole fleet and only then folds it, so the fold stage waits through the
whole Prometheus fetch. This module is the coordination primitive that
overlaps the two: producers (namespace-batch fetches, or discovery emitting
fetchable batches) push completed batches through a
BOUNDED ``asyncio.Queue`` while ONE consumer folds each batch off the event
loop as it arrives.

Invariants:

* **Backpressure** — the queue holds at most ``depth`` batches; a producer
  that outruns the consumer blocks in ``put`` instead of accumulating
  unbounded host state. Combined with the producer-side fetch semaphore in
  `krr_tpu_torch.core.runner.ScanSession.stream_fleet_digests`, at most
  ``2 × depth + 1`` batches of fetched-but-unfolded state exist at once.
* **Exactness** — fold order is arrival order, which is nondeterministic;
  the pipeline is only offered folds that are order-independent (digest
  bucket counts are integer-valued and add exactly, peaks merge by max), so
  the folded result is bit-identical to the staged path. Callers assert
  this in tests rather than trusting the comment.
* **Failure containment** — a fold error does not deadlock blocked
  producers: the consumer keeps draining (and discarding) batches until the
  producers finish, and the error re-raises when the pipeline closes. A
  producer-side error is the caller's to collect (gather with
  ``return_exceptions``) so sibling fetches settle first, matching the
  fan-out semantics of the fetch layer.

Stage accounting: the fetch stage spans from pipeline start to the last
``put``; the fold stage's busy time is the sum of fold call durations.
``overlap_seconds = fetch_span + fold_busy − wall`` (clamped to ≥ 0) is the
wall time both stages were genuinely concurrent, and ``overlap_pct``
normalizes it by the shorter stage — 100 % means the cheaper stage was fully
hidden under the other, the ``wall ≈ max(fetch, compute)`` target of a
perfectly pipelined scan.

Wait accounting answers the question overlap alone can't: WHICH stage is
the bottleneck. ``put_blocked_seconds`` (producers stalled in a full
queue's ``put``) says the consumer can't keep up — the scan is FOLD-bound;
``get_starved_seconds`` (the consumer parked in ``get`` with an empty
queue) says producers can't feed it — FETCH-bound. Queue occupancy is
sampled at every put AND get (a put-only peak systematically misses the
drain side: a consumer that always dequeues before the next put would
report depth 1 forever while the producer was actually blocked), and the
live ``krr_tpu_scan_pipeline_queue_depth`` gauge tracks the same samples
on /metrics.
"""

from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass
from typing import Any, Callable, Optional

from krr_tpu_torch.obs.metrics import MetricsRegistry
from krr_tpu_torch.obs.trace import NULL_TRACER, NullTracer

#: Default bounded-queue depth (`Config.pipeline_depth` overrides; 0 there
#: disables streaming entirely and callers take the staged path).
DEFAULT_PIPELINE_DEPTH = 4


@dataclass
class PipelineStats:
    """Per-stage timings of one pipeline run (all seconds, wall clock)."""

    wall_seconds: float = 0.0
    #: Producer-stage span: pipeline start → last batch enqueued.
    fetch_seconds: float = 0.0
    #: Consumer busy time: sum of fold call durations.
    fold_seconds: float = 0.0
    #: Wall seconds during which fetch and fold ran concurrently.
    overlap_seconds: float = 0.0
    #: ``overlap_seconds`` as a percentage of the shorter stage (100 = the
    #: cheaper stage was fully hidden under the other).
    overlap_pct: float = 0.0
    #: Discovery span when the producer streamed inventory (0 when the
    #: caller staged discovery itself).
    discover_seconds: float = 0.0
    batches: int = 0
    #: Batches whose fetch failed terminally and degraded to empty marked
    #: rows (quarantine fodder for the serve scheduler's degraded ticks);
    #: 0 on a clean run and on ``raise_on_failure`` callers, which abort
    #: instead of degrading.
    failed_batches: int = 0
    #: Queue occupancy high-water mark, sampled at every put AND get.
    peak_queue_depth: int = 0
    #: Sum of wall seconds producers spent blocked in ``put`` on a full
    #: queue (summed across concurrent producers: 2 producers blocked for
    #: 1 s each = 2 s). > 0 means the fold side was the bottleneck.
    put_blocked_seconds: float = 0.0
    #: Wall seconds the single consumer spent parked in ``get`` on an empty
    #: queue (including the tail wait for the close sentinel while the last
    #: fetches ran). Large values mean the scan is fetch-bound.
    get_starved_seconds: float = 0.0
    #: Mean queue occupancy over all put/get samples.
    mean_queue_depth: float = 0.0
    #: Internal occupancy accumulators behind ``mean_queue_depth``.
    depth_samples: int = 0
    depth_sum: int = 0

    def finalize(self) -> "PipelineStats":
        self.overlap_seconds = max(0.0, self.fetch_seconds + self.fold_seconds - self.wall_seconds)
        shorter = min(self.fetch_seconds, self.fold_seconds)
        self.overlap_pct = 100.0 * self.overlap_seconds / shorter if shorter > 1e-9 else 0.0
        self.mean_queue_depth = self.depth_sum / self.depth_samples if self.depth_samples else 0.0
        return self


class _Done:
    """Queue sentinel (private singleton — batches can be any object, None included)."""


_DONE = _Done()


class ScanPipeline:
    """Bounded single-consumer fold pipeline.

    Usage::

        async with ScanPipeline(fold, depth=4) as pipeline:
            ... producers: await pipeline.put(batch) ...
        stats = pipeline.stats     # closed + folds settled here

    ``fold(batch)`` is synchronous and runs via ``asyncio.to_thread`` —
    numpy/native fold work belongs off the event loop, and the single
    consumer serializes folds so fold targets need no locking. Exiting the
    ``async with`` block cleanly drains the queue, waits for the last fold,
    and re-raises the first fold error (if any); exiting on an exception
    aborts the consumer instead (the partially-folded target is the
    caller's to discard).
    """

    def __init__(
        self,
        fold: Callable[[Any], None],
        *,
        depth: int = DEFAULT_PIPELINE_DEPTH,
        tracer: NullTracer = NULL_TRACER,
        metrics: Optional[MetricsRegistry] = None,
    ):
        self._fold = fold
        #: Each fold call gets a ``fold`` span (no-op by default). The
        #: consumer task is created in ``__aenter__`` and copies the
        #: caller's context, so fold spans parent to whatever span was
        #: active when the pipeline opened — the scan root.
        self._tracer = tracer
        #: Live occupancy gauge target (``krr_tpu_scan_pipeline_queue_depth``).
        self._metrics = metrics
        self._queue: asyncio.Queue = asyncio.Queue(maxsize=max(1, depth))
        self._consumer: Optional[asyncio.Task] = None
        self._error: Optional[BaseException] = None
        self._started_at = 0.0
        self._last_put_at = 0.0
        self.stats = PipelineStats()

    def _sample_depth(self, depth: int) -> None:
        """One occupancy sample (called from put and get): peak, mean
        accumulators, and the live gauge."""
        stats = self.stats
        if depth > stats.peak_queue_depth:
            stats.peak_queue_depth = depth
        stats.depth_samples += 1
        stats.depth_sum += depth
        if self._metrics is not None:
            self._metrics.set("krr_tpu_scan_pipeline_queue_depth", depth)

    async def __aenter__(self) -> "ScanPipeline":
        self._started_at = time.perf_counter()
        self._consumer = asyncio.create_task(self._consume(), name="krr-tpu-scan-pipeline-fold")
        return self

    async def put(self, batch: Any) -> None:
        """Enqueue one fetched batch; blocks when ``depth`` batches are
        already waiting (the backpressure edge). Raises the consumer's fold
        error, if one happened, so producers stop fetching work that can no
        longer be folded."""
        if self._error is not None:
            raise self._error
        t0 = time.perf_counter()
        await self._queue.put(batch)
        self._last_put_at = time.perf_counter()
        # Any wall inside put() is backpressure: put only parks on a full
        # queue, so a non-blocking put contributes ~a clock tick.
        self.stats.put_blocked_seconds += self._last_put_at - t0
        self.stats.batches += 1
        self._sample_depth(self._queue.qsize())

    async def _consume(self) -> None:
        while True:
            t0 = time.perf_counter()
            batch = await self._queue.get()
            # Symmetric to put: get only parks on an empty queue, so this is
            # consumer starvation (the tail wait for _DONE included — that
            # is real starvation while the last fetches run).
            self.stats.get_starved_seconds += time.perf_counter() - t0
            if batch is _DONE:
                return
            # Sample occupancy on the DRAIN side too: +1 counts the batch
            # just dequeued, so a put-then-immediate-get cadence reads its
            # true depth instead of the put-only view (which misses drains
            # entirely when the consumer always wins the race).
            self._sample_depth(self._queue.qsize() + 1)
            if self._error is not None:
                continue  # drain mode: unblock producers, discard batches
            fold_start = time.perf_counter()
            try:
                with self._tracer.span("fold", queued=self._queue.qsize()):
                    await asyncio.to_thread(self._fold, batch)
            except asyncio.CancelledError:
                # The abort path (__aexit__ on a body exception) cancels this
                # task; swallowing the cancellation into _error would loop
                # back to queue.get() with no _DONE ever coming — the await
                # on the consumer would then hang forever.
                raise
            except BaseException as e:  # noqa: BLE001 — re-raised at close
                self._error = e
            finally:
                self.stats.fold_seconds += time.perf_counter() - fold_start

    async def __aexit__(self, exc_type, exc, tb) -> None:
        assert self._consumer is not None
        if exc is not None:
            # Abort: the caller's producers already unwound; the fold target
            # is about to be discarded with the exception.
            self._consumer.cancel()
            await asyncio.gather(self._consumer, return_exceptions=True)
            return
        await self._queue.put(_DONE)
        await self._consumer
        now = time.perf_counter()
        self.stats.wall_seconds = now - self._started_at
        self.stats.fetch_seconds = (self._last_put_at or now) - self._started_at
        self.stats.finalize()
        if self._error is not None:
            raise self._error
