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

Not ported yet, and raising ``NotImplementedError`` that names the ROADMAP
item: ``state_path`` (the durable digest store) and ``digest_ingest``
(history digested at parse time).
"""

from __future__ import annotations

import time
from typing import Literal, Optional

import pydantic as pd
import torch

from krr_tpu_torch.models.allocations import ResourceType
from krr_tpu_torch.models.series import FleetBatch
from krr_tpu_torch.ops import digest as digest_ops
from krr_tpu_torch.ops import topk_sketch as topk_ops
from krr_tpu_torch.ops.chunked import StreamStats
from krr_tpu_torch.ops.cuda_select import masked_max_cuda
from krr_tpu_torch.ops.digest import DigestSpec
from krr_tpu_torch.ops.quantile import masked_max_from_host
from krr_tpu_torch.strategies.base import BatchedStrategy, RunResult
from krr_tpu_torch.strategies.simple import (
    MEMORY_SCALE,
    SimpleStrategySettings,
    exact_topk_k,
    finalize_fleet,
    fleet_device_arrays,
    streamed_legs,
    use_host_stream,
)
from krr_tpu_torch.utils.device import resolve_device


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
            "parse time, so raw sample arrays are never materialized. Not ported yet: raises."
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
            "Path to the digest state for incremental/streaming scans (the durable digest store). "
            "Not ported yet: raises."
        ),
    )
    store_format: Literal["sharded", "legacy"] = pd.Field(
        "sharded",
        description="On-disk digest state format of state_path: 'sharded' (default) or 'legacy'.",
    )

    def cpu_spec(self) -> DigestSpec:
        # 1e-7 cores ≈ 0.1 µcore resolution floor; top bucket ≥ 10k cores.
        return DigestSpec(gamma=self.digest_gamma, min_value=1e-7, num_buckets=self.digest_buckets)


def _fence(device: torch.device) -> None:
    """Wait for the device, so a leg's wall clock covers its kernels."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class TDigestStrategy(BatchedStrategy[TDigestStrategySettings]):
    __display_name__ = "tdigest"

    def __init__(self, settings: TDigestStrategySettings):
        if settings.state_path:
            raise NotImplementedError(
                "tdigest state_path (the durable digest store, DigestStore/durastore) is not ported "
                "yet: ROADMAP Queue 1"
            )
        if settings.digest_ingest:
            raise NotImplementedError(
                "tdigest digest_ingest (DigestedFleet and the native fused parse) is not ported yet: "
                "ROADMAP Queue 1"
            )
        super().__init__(settings)
        self.device = resolve_device(settings.device)
        #: Wall seconds of the last ``run_batch``'s legs: resident (pack,
        #: h2d, build — the sketch kernel, query — percentile + memory max +
        #: the one readback, finalize) or streamed
        #: (`krr_tpu_torch.strategies.simple.streamed_legs`).
        self.leg_seconds: dict[str, float] = {}
        #: The last streamed ``run_batch``'s :class:`StreamStats` as a
        #: dict; None after a resident one.
        self.stream_stats: Optional[dict] = None

    def _exact_topk_k(self, capacity: int, q: float) -> Optional[int]:
        """K for the exact top-K sketch, or None when the histogram digest
        serves (the default; ``exact_upgrade`` opts in through the shared
        cut-over, `krr_tpu_torch.strategies.simple.exact_topk_k`)."""
        if not self.settings.exact_upgrade:
            return None
        return exact_topk_k(capacity, q, self.settings.exact_sketch_budget)

    def _use_host_stream(self, batch: FleetBatch) -> bool:
        return use_host_stream(batch, self.device, self.settings.host_stream_mb)

    def _streamed_sketch(self, batch: FleetBatch, spec: DigestSpec, q: float, stats: StreamStats) -> tuple:
        """(CPU percentile, memory peak in MB) with the window streamed from
        host in ``chunk_size`` time chunks: the percentile still on the
        device (a tensor), the peak a host array."""
        chunk = self.settings.chunk_size
        cpu = batch.packed(ResourceType.CPU)
        mem = batch.packed(ResourceType.Memory)
        k = self._exact_topk_k(cpu.capacity, q)
        if k is not None:
            sketch = topk_ops.build_from_host(cpu.values, cpu.counts, k, chunk, device=self.device, stats=stats)
            cpu_p = topk_ops.percentile(sketch, q)
        else:
            cpu_digest = digest_ops.build_from_host(
                spec, cpu.values, cpu.counts, chunk, device=self.device, stats=stats
            )
            cpu_p = digest_ops.percentile(spec, cpu_digest, q)
        mem_max = masked_max_from_host(
            mem.values, mem.counts, chunk, scale=MEMORY_SCALE, device=self.device, stats=stats
        )
        return cpu_p, mem_max

    def _run_streamed(self, batch: FleetBatch, spec: DigestSpec, q: float, pack_seconds: float) -> list[RunResult]:
        stats = StreamStats()
        t0 = time.perf_counter()
        cpu_p, mem_max = self._streamed_sketch(batch, spec, q, stats)
        t1 = time.perf_counter()
        cpu_p = cpu_p.cpu().numpy()
        t2 = time.perf_counter()
        results = finalize_fleet(cpu_p, mem_max, self.settings.memory_buffer_percentage)
        self.leg_seconds = streamed_legs(pack_seconds, t1 - t0, stats, t2 - t1, time.perf_counter() - t2)
        self.stream_stats = stats.as_dict()
        return results

    def run_batch(self, batch: FleetBatch) -> list[RunResult]:
        if not batch.objects:
            return []
        spec = self.settings.cpu_spec()
        q = float(self.settings.cpu_percentile)
        t0 = time.perf_counter()
        cpu = batch.packed(ResourceType.CPU)
        batch.packed(ResourceType.Memory)
        t1 = time.perf_counter()
        if self._use_host_stream(batch):
            return self._run_streamed(batch, spec, q, t1 - t0)
        self.stream_stats = None
        cpu_values, cpu_counts = fleet_device_arrays(batch, ResourceType.CPU, device=self.device)
        mem_values, mem_counts = fleet_device_arrays(
            batch, ResourceType.Memory, scale=MEMORY_SCALE, device=self.device
        )
        t2 = time.perf_counter()
        k = self._exact_topk_k(cpu.capacity, q)
        if k is not None:
            sketch = topk_ops.build_from_packed(cpu_values, cpu_counts, k)
        else:
            cpu_digest = digest_ops.build_from_packed(spec, cpu_values, cpu_counts)
        _fence(self.device)
        t3 = time.perf_counter()
        if k is not None:
            cpu_p = topk_ops.percentile(sketch, q)
        else:
            cpu_p = digest_ops.percentile(spec, cpu_digest, q)
        # One readback for both resources.
        stacked = torch.stack([cpu_p, masked_max_cuda(mem_values, mem_counts)]).cpu().numpy()
        t4 = time.perf_counter()
        results = finalize_fleet(stacked[0], stacked[1], self.settings.memory_buffer_percentage)
        t5 = time.perf_counter()
        self.leg_seconds = {
            "pack": t1 - t0, "h2d": t2 - t1, "build": t3 - t2, "query": t4 - t3, "finalize": t5 - t4,
        }
        return results
