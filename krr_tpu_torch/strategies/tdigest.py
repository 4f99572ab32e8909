"""The ``tdigest`` strategy: sketch-based quantiles for fleet-scale history.

Port of the one-shot resident path of `krr_tpu/strategies/tdigest.py`
(`:322-348`). Same recommendation semantics as ``simple`` (p-percentile CPU
request, max × buffer memory), but the CPU percentile comes from a mergeable
log-bucket digest (`krr_tpu_torch.ops.digest`, the ``digest_hist`` kernel),
so it carries the digest's guaranteed relative error (0.5 % at the default
gamma). Memory needs only the exact per-row max of the full raw window (the
``row_max`` kernel), so memory recommendations are identical to ``simple``.

With ``exact_upgrade`` the build swaps the histogram for the exact top-K
sketch (`krr_tpu_torch.ops.topk_sketch`, the ``topk_select`` kernel) when
the percentile's rank-from-the-top fits ``exact_sketch_budget`` — zero CPU
error, the same answer as ``simple``.

A window past ``host_stream_mb`` stays in host memory and streams to the
device in ``chunk_size`` time chunks (`krr_tpu_torch.ops.chunked`): the same
sketch built chunk by chunk, bit-identical, and the streamed memory max.

With more than one device and ``use_mesh`` (`krr_tpu_torch.strategies.
window.resolve_mesh`) the window shards over a ``(data, time)`` mesh
(`krr_tpu_torch.parallel`, `krr_tpu/strategies/tdigest.py:173-200`,
`:294-321`): ``digest_hist`` or ``topk_select`` per shard and ``row_max``
per shard, merged exactly per row block; a streamed window splits its
rows over every mesh device instead. On a mesh that spans processes
(`krr_tpu_torch.parallel.initialize_distributed`) every rank gets every
row, so every rank renders the whole result — and, with ``state_path``,
folds the whole window into its own store and persists it, as each JAX
process would: give each rank its own ``state_path`` (hosts have their own
disks).

With ``state_path`` (`krr_tpu/strategies/tdigest.py:267-293`) each run
builds the fetched window's digest on the device — ``digest_hist`` plus
``row_max`` on the scaled memory window, resident or streamed — reads it
back once, and folds it into the durable host store
(`krr_tpu_torch.core.streaming`, `krr_tpu_torch.core.durastore`), which
answers the query from the merged history and persists one WAL record. The
store always holds the mergeable histogram digest, never the top-K sketch.
With ``digest_ingest`` the history arrives digested at parse time
(``run_digested``): the query is host numpy, as in the JAX package, and no
kernel runs.

The legs are stages of the scan trace (``strategy.obs``,
`krr_tpu_torch.obs.device`), as in `krr_tpu/strategies/tdigest.py:222-347`:
``pack``, on the resident path ``cast`` for each resource
(`krr_tpu_torch.strategies.window`, which owns the window's format and
placement; inside ``digest`` with ``state_path``), then ``digest`` (the
window's or the sketch's build), ``fold`` and ``quantile`` (``path=resident``, ``host_stream``, ``mesh``,
``store`` or ``ingest``), ``persist`` (the store's delta), then ``round``;
device results are fenced inside their stage when the tracer records. The
resident window goes to the device by row blocks
(`krr_tpu_torch.strategies.window.ResidentWindow`), each copy an ``h2d``
stage: CPU's inside ``digest``, each block's sketch built into its rows
of the window's, and memory's inside ``quantile`` (with ``state_path``,
both inside ``digest``). With
``profile_dir`` the compute runs under ``torch.profiler``.
"""

from __future__ import annotations

from functools import partial
from typing import TYPE_CHECKING, Literal, Optional

import numpy as np
import pydantic as pd
import torch

from krr_tpu_torch.core.durastore import DurableStore
from krr_tpu_torch.core.streaming import DigestStore, FsOps, object_key
from krr_tpu_torch.models.allocations import ResourceType
from krr_tpu_torch.models.series import FleetBatch, PackedSeries
from krr_tpu_torch.ops import digest as digest_ops
from krr_tpu_torch.ops import topk_sketch as topk_ops
from krr_tpu_torch.ops.cuda_select import masked_max_cuda
from krr_tpu_torch.ops.digest import DigestSpec
from krr_tpu_torch.parallel import gather_rows, sharded_fleet_digest, sharded_fleet_topk, sharded_percentile
from krr_tpu_torch.strategies.base import BatchedStrategy, RunResult
from krr_tpu_torch.strategies.simple import SimpleStrategySettings, exact_topk_k, finalize_fleet
from krr_tpu_torch.strategies.window import MEMORY_SCALE, FleetWindow
from krr_tpu_torch.utils.device import resolve_device

if TYPE_CHECKING:
    from krr_tpu_torch.models.series import DigestedFleet


class TDigestStrategySettings(SimpleStrategySettings):
    digest_gamma: float = pd.Field(
        1.01, gt=1, description="Log-bucket growth factor; relative quantile error is sqrt(gamma) - 1."
    )
    digest_buckets: int = pd.Field(2560, ge=16, description="Number of digest buckets.")
    chunk_size: int = pd.Field(
        8192,
        ge=128,
        description=(
            "Time-axis chunk size of the host-streamed builds (a window past host_stream_mb); "
            "the resident build walks each row in one kernel launch."
        ),
    )
    digest_ingest: bool = pd.Field(
        False,
        description=(
            "Digest-at-ingest mode: Prometheus responses fold straight into per-object digests at "
            "parse time (native fused parse+bucketize), so raw sample arrays are never "
            "materialized. CPU accuracy is the digest bound (0.5% at default gamma); memory stays "
            "exact."
        ),
    )
    exact_upgrade: bool = pd.Field(
        False,
        description=(
            "Swap the one-shot digest build for the EXACT top-K sketch when the percentile's rank "
            "fits exact_sketch_budget: zero CPU error instead of the digest's 0.5% bound."
        ),
    )
    state_path: Optional[str] = pd.Field(
        None,
        description=(
            "Path to the digest state for incremental/streaming scans: each run merges the "
            "fetched window into the stored per-container digests and recommends from the merged "
            "history. Sharded format makes this a state DIRECTORY (manifest + base shards + delta "
            "WAL); legacy single-file state auto-migrates on first open."
        ),
    )
    store_format: Literal["sharded", "legacy"] = pd.Field(
        "sharded",
        description=(
            "On-disk digest state format: 'sharded' (default) is the durable state directory — "
            "checksummed base shards plus a delta WAL, one appended record per merge; 'legacy' "
            "keeps the classic single-file atomic rewrite."
        ),
    )

    def cpu_spec(self) -> DigestSpec:
        # 1e-7 cores ≈ 0.1 µcore resolution floor; top bucket ≥ 10k cores.
        return DigestSpec(gamma=self.digest_gamma, min_value=1e-7, num_buckets=self.digest_buckets)


def _read_back(cpu_digest, *rows: torch.Tensor) -> tuple:
    """A digest's counts ``[N, B]``, totals and peaks, then each of
    ``rows`` (``[N]`` each), as host arrays read back in one copy: the flat
    concatenation keeps the counts block a contiguous ``[N, B]`` view of
    the host copy."""
    n, b = cpu_digest.counts.shape
    host = torch.cat([cpu_digest.counts.reshape(-1), cpu_digest.total, cpu_digest.peak, *rows]).cpu().numpy()
    return (host[: n * b].reshape(n, b), *np.split(host[n * b :], 2 + len(rows)))


class _AppendCountingFs(FsOps):
    """The default filesystem ops, counting the WAL appends of one persist."""

    def __init__(self) -> None:
        self.appends = 0
        self.appended_bytes = 0

    def append(self, f, data: bytes) -> None:
        super().append(f, data)
        self.appends += 1
        self.appended_bytes += len(data)


class TDigestStrategy(BatchedStrategy[TDigestStrategySettings]):
    __display_name__ = "tdigest"

    def __init__(self, settings: TDigestStrategySettings):
        super().__init__(settings)
        self.device = resolve_device(settings.device)
        #: The last streamed window's :class:`StreamStats` as a dict; None
        #: after a resident one.
        self.stream_stats: Optional[dict] = None
        #: The store after the last ``state_path`` persist: its rows, the
        #: rows this run folded, the WAL records and bytes this persist
        #: appended (one record; none for the legacy file), the live WAL's
        #: bytes (a persist that passes the compaction threshold folds the
        #: WAL into base shards, leaving its 8-byte header) and the epoch
        #: (durable persists so far); None when no store was used.
        self.store_stats: Optional[dict] = None

    def _exact_topk_k(self, capacity: int, q: float) -> Optional[int]:
        """K for the exact top-K sketch, or None when the histogram digest
        serves (the default; ``exact_upgrade`` opts in through the shared
        cut-over, `krr_tpu_torch.strategies.simple.exact_topk_k`)."""
        if not self.settings.exact_upgrade:
            return None
        return exact_topk_k(capacity, q, self.settings.exact_sketch_budget)

    def _streamed_sketch(self, cpu: PackedSeries, spec: DigestSpec, q: float, **where) -> torch.Tensor:
        """CPU's percentile with the window streamed from host in
        ``chunk_size`` time chunks, still on the device: the exact top-K
        sketch's when it serves, else the histogram digest's."""
        chunk = self.settings.chunk_size
        k = self._exact_topk_k(cpu.capacity, q)
        if k is not None:
            sketch = topk_ops.build_from_host(cpu.values, cpu.counts, k, chunk, **where)
            return topk_ops.percentile(sketch, q)
        cpu_digest = digest_ops.build_from_host(spec, cpu.values, cpu.counts, chunk, **where)
        return digest_ops.percentile(spec, cpu_digest, q)

    def _window_digest(self, window: FleetWindow, spec: DigestSpec) -> tuple:
        """Digest + memory peak of the fetched window as host arrays:
        float32 CPU counts ``[N, B]``, totals and peaks, the memory sample
        counts, and the memory peak in MB (−inf for an empty row, as the
        store wants) — `krr_tpu/strategies/tdigest.py:173-203`. Resident:
        one ``digest_hist`` launch a CPU block into the window's digest and
        one ``row_max`` a block of the scaled memory window, read back in
        one copy. Streamed: one
        ``digest_hist`` launch a chunk (`krr_tpu/strategies/tdigest.py:
        128-147`), then the streamed memory max. On a mesh: one of each
        per shard, the digest merged per row block and read back per
        field."""
        mem_total = np.asarray(window.memory.counts, dtype=np.float32)
        chunk = self.settings.chunk_size
        if window.placement == "host_stream":
            (counts, total, peak), mem_peak, _total = window.stream(
                lambda cpu, **where: _read_back(
                    digest_ops.build_from_host(spec, cpu.values, cpu.counts, chunk, **where)
                ),
                chunk,
            )
        elif window.placement == "mesh":
            digests, real_rows = sharded_fleet_digest(spec, window.cpu.values, window.cpu.counts, window.mesh)
            counts, total, peak = (
                gather_rows(digests, lambda digest, i=i: digest[i], real_rows) for i in range(3)
            )
            mem_peak = window.mesh_memory_max()
        else:
            resident = window.resident()
            cpu_digest = resident.gather(ResourceType.CPU, partial(digest_ops.build_from_packed, spec))
            mem_max = torch.empty((len(window.batch),), dtype=torch.float32, device=self.device)
            resident.reduce(ResourceType.Memory, masked_max_cuda, mem_max)
            resident.close()
            counts, total, peak, mem_peak = _read_back(cpu_digest, mem_max)
        assert counts.shape[0] == len(window.batch)
        # An empty memory row reads NaN from the row max; the store wants -inf.
        mem_peak = np.where(np.isnan(mem_peak), -np.inf, mem_peak)
        return counts, total, peak, mem_total, mem_peak

    def _store_round(self, spec: DigestSpec, q: float, rows: int, fold) -> tuple:
        """One locked store cycle (`krr_tpu/strategies/tdigest.py:267-293`):
        open the durable state with ``DurableStore.open``'s defaults, ``fold``
        the window into its store (→ the store rows), query the merged
        history, persist one delta, close. Returns (CPU percentile, memory
        peak in MB) for the folded rows, each leg a stage (``fold``,
        ``quantile``, ``persist``), and records :attr:`store_stats`."""
        fs = _AppendCountingFs()
        with DigestStore.locked(self.settings.state_path):
            durable = DurableStore.open(self.settings.state_path, spec, store_format=self.settings.store_format, fs=fs)
            try:
                with self.obs.stage("fold", rows=rows):
                    store_rows = fold(durable.store)
                with self.obs.stage("quantile", rows=rows, path="store"):
                    cpu_p, mem_max = durable.store.query_recommendation(store_rows, q)
                with self.obs.stage("persist", rows=rows):
                    durable.save_delta()
                self.store_stats = {
                    "rows": len(durable.store.keys),
                    "folded_rows": rows,
                    "wal_appends": fs.appends,
                    "wal_appended_bytes": fs.appended_bytes,
                    "wal_bytes": durable.wal_size,
                    "epoch": durable.epoch,
                }
            finally:
                durable.close()
        return cpu_p, mem_max

    def run_digested(self, fleet: "DigestedFleet") -> list[RunResult]:
        """Recommend from pre-digested history (the ``digest_ingest`` fetch
        mode, `krr_tpu/strategies/tdigest.py:205-251`): the window's digests
        are already built, so this is the percentile query — and, with
        ``state_path``, the same store merge as the raw path. Host numpy by
        design, as in the JAX package: ingest digests are born in host
        memory, so no kernel runs."""
        q = float(self.settings.cpu_percentile)
        spec = DigestSpec(gamma=fleet.gamma, min_value=fleet.min_value, num_buckets=fleet.cpu_counts.shape[1])
        self.stream_stats = None
        self.store_stats = None
        rows = len(fleet.objects)
        with self.profile_span():
            if self.settings.state_path:
                cpu_p, mem_max = self._store_round(
                    spec, q, rows, lambda store: store.fold_fleet(fleet, mem_scale=MEMORY_SCALE)
                )
            else:
                with self.obs.stage("quantile", rows=rows, path="ingest"):
                    cpu_p = digest_ops.percentile_host(spec, fleet.cpu_counts, fleet.cpu_total, fleet.cpu_peak, q)
                    mem_peak_mb = np.where(np.isfinite(fleet.mem_peak), fleet.mem_peak / MEMORY_SCALE, -np.inf)
                    mem_max = np.where(fleet.mem_total > 0, mem_peak_mb, np.nan)
        return self._round(cpu_p, mem_max, rows)

    def _round(self, cpu_p, mem_max, rows: int) -> list[RunResult]:
        """The ``round`` stage: the host Decimal finalize."""
        with self.obs.stage("round", rows=rows):
            return finalize_fleet(np.asarray(cpu_p), np.asarray(mem_max), self.settings.memory_buffer_percentage)

    def _run_state(self, window: FleetWindow, spec: DigestSpec, q: float) -> tuple:
        """The ``state_path`` run: the window digest on the device (the
        ``digest`` stage), then the store cycle on the host. On a mesh that
        spans processes every rank holds the whole window's digest and
        folds it into the store at its own ``state_path``."""
        with self.obs.stage("digest", rows=len(window.batch)):
            counts, total, peak, mem_total, mem_peak = self._window_digest(window, spec)
        keys = [object_key(obj) for obj in window.batch.objects]
        return self._store_round(
            spec, q, len(keys),
            lambda store: store.merge_window(keys, counts, total, peak, mem_total, mem_peak),
        )

    def _run_mesh(self, window: FleetWindow, spec: DigestSpec, q: float) -> tuple:
        """The mesh build (the ``digest`` stage: the sharded top-K sketch or
        digest) and query (the ``quantile`` stage: the percentile per row
        block, the sharded memory max), `krr_tpu/strategies/tdigest.py:
        294-321`."""
        obs, cpu, mesh, rows = self.obs, window.cpu, window.mesh, len(window.batch)
        k = self._exact_topk_k(cpu.capacity, q)
        with obs.stage("digest", rows=rows, sketch="topk" if k is not None else "digest"):
            if k is not None:
                sketches, real_rows = obs.fence(sharded_fleet_topk(cpu.values, cpu.counts, k, mesh))
            else:
                digests, real_rows = obs.fence(sharded_fleet_digest(spec, cpu.values, cpu.counts, mesh))
        with obs.stage("quantile", rows=rows, path="mesh"):
            if k is not None:
                cpu_p = gather_rows(sketches, lambda sketch: topk_ops.percentile(sketch, q), real_rows)
            else:
                cpu_p = sharded_percentile(spec, digests, q, real_rows)
            mem_max = window.mesh_memory_max()
        return cpu_p, mem_max

    def _run_resident(self, window: FleetWindow, spec: DigestSpec, q: float) -> tuple:
        """Each resource's ``cast`` stage, the resident build (the
        ``digest`` stage: the window's sketch a CPU block at a time) and
        query (the ``quantile`` stage, carrying the window's ``blocks``:
        memory's max a block at a time, then, with the buffer dropped, the
        percentile of the whole sketch and one readback)."""
        obs, rows = self.obs, len(window.batch)
        resident = window.resident()
        k = self._exact_topk_k(window.cpu.capacity, q)
        with obs.stage("digest", rows=rows, sketch="topk" if k is not None else "digest"):
            if k is not None:
                sketch = resident.gather(ResourceType.CPU, partial(topk_ops.build_from_packed, k=k))
            else:
                cpu_digest = resident.gather(ResourceType.CPU, partial(digest_ops.build_from_packed, spec))
        with obs.stage("quantile", rows=rows, path="resident", blocks=resident.block_count):
            mem_max = torch.empty((rows,), dtype=torch.float32, device=self.device)
            resident.reduce(ResourceType.Memory, masked_max_cuda, mem_max)
            resident.close()
            if k is not None:
                cpu_p = topk_ops.percentile(sketch, q)
            else:
                cpu_p = digest_ops.percentile(spec, cpu_digest, q)
            # One readback for both resources.
            stacked = torch.stack([cpu_p, mem_max]).cpu().numpy()
        return stacked[0], stacked[1]

    def run_batch(self, batch: FleetBatch) -> list[RunResult]:
        if not batch.objects:
            return []
        spec = self.settings.cpu_spec()
        q = float(self.settings.cpu_percentile)
        self.store_stats = None
        with self.profile_span():
            window = FleetWindow(batch, self.settings, self.device, self.obs)
            if self.settings.state_path:
                cpu_p, mem_max = self._run_state(window, spec, q)
            elif window.placement == "host_stream":
                cpu_p, mem_max = window.streamed_quantile(
                    partial(self._streamed_sketch, spec=spec, q=q), self.settings.chunk_size
                )
            elif window.placement == "mesh":
                cpu_p, mem_max = self._run_mesh(window, spec, q)
            else:
                cpu_p, mem_max = self._run_resident(window, spec, q)
            self.stream_stats = window.stream_stats
            self.obs.record_device_memory(self.device)
        return self._round(cpu_p, mem_max, len(batch))
