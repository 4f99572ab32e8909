"""What-if replay: re-run a strategy tick-by-tick over recorded usage.

A copy of `krr_tpu/eval/replay.py`; the strategies run on their own device
(``cuda`` unless their settings say ``cpu``) and the scoring reduce on the
device ``score_replay`` is given. The engine walks a recorded usage grid
(``ReplayInput``) the way the serve scheduler walks real time: at each replay tick the strategy sees only the
history up to that tick's window end, its raw recommendation routes through
a REAL :class:`krr_tpu_torch.history.policy.HysteresisGate` (same dead band, same
confirmation streak, same float32 held values), and what the gate publishes
becomes the recommendation the NEXT stretch of samples is scored against.
No part of the gate or strategy is mocked — an eval verdict is earned
against the exact publish policy production runs.

Inputs come from three places:

* ``ReplayInput.from_journal`` — a serve journal opened READ-ONLY (the
  ``diff`` command's open: no ``.lock``, single fd, never repairs), with the
  journal's raw per-tick series as the observed-demand grid;
* ``ReplayInput.from_series`` — any mapping of object keys to (cpu, mem)
  sample arrays, which is how the chaos-archetype fleets become labeled
  ground truth;
* ``ReplayInput.load_npz`` — the on-disk interchange format the ``eval
  --usage`` flag reads.

Strategies are duck-typed against the registered contract (``run_batch`` +
``settings``), so the CLI replays real registry strategies while tests and
the bench probe the oracle with :class:`StaticReplayStrategy` variants —
fixed under/over-sized recommendations whose expected incident counts are
declared by the chaos labels, without polluting the strategy registry.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from decimal import Decimal
from typing import Any, Mapping, Optional

import numpy as np

from krr_tpu_torch.models.allocations import ResourceType

#: bytes per journal memory unit (the journal stores raw MB, pre-buffer) —
#: the same scale ``finalize_fleet`` applies when publishing.
MEMORY_SCALE = 1e6


def _ffill_rows(grid: np.ndarray) -> np.ndarray:
    """Forward- then back-fill NaN gaps per row (journal reconstruction:
    a workload absent from one tick keeps its neighboring value rather than
    poisoning every window that spans the gap)."""
    out = np.array(grid, np.float64, copy=True)
    for row in out:
        finite = np.isfinite(row)
        if not finite.any() or finite.all():
            continue
        idx = np.where(finite, np.arange(len(row)), 0)
        np.maximum.accumulate(idx, out=idx)
        row[:] = row[idx]
        first = np.flatnonzero(np.isfinite(row))
        if len(first) and first[0] > 0:
            row[: first[0]] = row[first[0]]
    return out


@dataclass
class ReplayInput:
    """A recorded usage grid: ``keys`` (full object keys), the shared sample
    ``timestamps`` ``[T]``, and per-workload ``cpu`` (cores) / ``mem``
    (bytes) grids ``[W × T]``."""

    keys: "list[str]"
    timestamps: np.ndarray
    cpu: np.ndarray
    mem: np.ndarray

    def __post_init__(self) -> None:
        self.timestamps = np.asarray(self.timestamps, np.float64)
        self.cpu = np.asarray(self.cpu, np.float64)
        self.mem = np.asarray(self.mem, np.float64)
        w, t = len(self.keys), len(self.timestamps)
        if self.cpu.shape != (w, t) or self.mem.shape != (w, t):
            raise ValueError(
                f"usage grids must be [{w} x {t}]; got cpu {self.cpu.shape}, mem {self.mem.shape}"
            )

    @property
    def step_seconds(self) -> float:
        if len(self.timestamps) < 2:
            return 0.0
        return float(np.median(np.diff(self.timestamps)))

    # ------------------------------------------------------------- builders
    @classmethod
    def from_series(
        cls,
        series: "Mapping[str, tuple[np.ndarray, np.ndarray]]",
        timestamps: np.ndarray,
    ) -> "ReplayInput":
        """Build from ``{object_key: (cpu_cores[T], mem_bytes[T])}``."""
        keys = sorted(series)
        cpu = np.stack([np.asarray(series[k][0], np.float64) for k in keys])
        mem = np.stack([np.asarray(series[k][1], np.float64) for k in keys])
        return cls(keys=keys, timestamps=np.asarray(timestamps, np.float64), cpu=cpu, mem=mem)

    @classmethod
    def from_journal(
        cls,
        path: str,
        *,
        retention_seconds: float = 365 * 24 * 3600.0,
        logger: Any = None,
    ) -> "ReplayInput":
        """Reconstruct the usage grid from a serve journal, opened through
        the READ-ONLY path: no ``.lock`` is taken, the single fd never
        creates/truncates/repairs, and a torn in-flight tail is dropped
        from the snapshot only — safe against a journal an open server is
        mid-append on. Raises ``ValueError`` when no journal exists at
        ``path`` (the CLI maps it to a usage error)."""
        from krr_tpu_torch.history.journal import RecommendationJournal

        journal = RecommendationJournal(
            path, retention_seconds=retention_seconds, logger=logger, readonly=True
        )
        ticks = journal.tick_timestamps()
        if len(ticks) == 0:
            raise ValueError(f"journal at {path} holds no ticks")
        grid = np.asarray(ticks, np.float64)
        index = {float(ts): i for i, ts in enumerate(grid)}
        keys: "list[str]" = []
        cpu_rows: "list[np.ndarray]" = []
        mem_rows: "list[np.ndarray]" = []
        for key, recs in journal.records_by_workload():
            cpu = np.full(len(grid), np.nan)
            mem = np.full(len(grid), np.nan)
            for rec in recs:
                i = index.get(float(rec["ts"]))
                if i is not None:
                    cpu[i] = float(rec["cpu"])
                    mem[i] = float(rec["mem"]) * MEMORY_SCALE  # raw MB -> bytes
            keys.append(key)
            cpu_rows.append(cpu)
            mem_rows.append(mem)
        order = np.argsort(keys)
        return cls(
            keys=[keys[i] for i in order],
            timestamps=grid,
            cpu=_ffill_rows(np.stack([cpu_rows[i] for i in order])),
            mem=_ffill_rows(np.stack([mem_rows[i] for i in order])),
        )

    @classmethod
    def load_npz(cls, path: str) -> "ReplayInput":
        with np.load(path, allow_pickle=False) as data:
            return cls(
                keys=[str(k) for k in data["keys"]],
                timestamps=data["timestamps"],
                cpu=data["cpu"],
                mem=data["mem"],
            )

    def save_npz(self, path: str) -> None:
        np.savez(
            path,
            keys=np.asarray(self.keys, dtype=np.str_),
            timestamps=self.timestamps,
            cpu=self.cpu,
            mem=self.mem,
        )

    def scoped(
        self,
        *,
        namespaces: "tuple[str, ...] | list[str] | None" = None,
        clusters: "tuple[str, ...] | list[str] | None" = None,
    ) -> "ReplayInput":
        """Filter workloads the way the diff CLI honors ``-n``/``-c``."""
        from krr_tpu_torch.core.streaming import split_object_key

        if not namespaces and not clusters:
            return self
        keep = []
        for i, key in enumerate(self.keys):
            cluster, namespace, _name, _container, _kind = split_object_key(key)
            if namespaces and namespace not in namespaces:
                continue
            if clusters and (cluster or "") not in clusters:
                continue
            keep.append(i)
        return ReplayInput(
            keys=[self.keys[i] for i in keep],
            timestamps=self.timestamps,
            cpu=self.cpu[keep],
            mem=self.mem[keep],
        )


class StaticReplayStrategy:
    """A duck-typed probe strategy publishing one fixed recommendation for
    every workload — the labeled-ground-truth oracle's instrument: an
    UNDERSIZED variant must score exactly the incidents the chaos labels
    declare, an OVERSIZED one must score none (with more slack). Not
    registered in the strategy registry on purpose."""

    class _Settings:
        memory_buffer_percentage = Decimal(0)

    def __init__(self, cpu_cores: float, mem_bytes: float):
        self.cpu_cores = float(cpu_cores)
        self.mem_bytes = float(mem_bytes)
        self.settings = self._Settings()

    def run_batch(self, batch: Any) -> "list[dict]":
        from krr_tpu_torch.strategies.base import ResourceRecommendation

        rec = {
            ResourceType.CPU: ResourceRecommendation(
                request=Decimal(repr(self.cpu_cores)), limit=None
            ),
            ResourceType.Memory: ResourceRecommendation(
                request=Decimal(repr(self.mem_bytes)), limit=Decimal(repr(self.mem_bytes))
            ),
        }
        return [dict(rec) for _ in batch.objects]


@dataclass
class ReplayedSeries:
    """One strategy's replayed publish history: per-tick gate-held values
    aligned with ``tick_indices`` (the sample index each tick's window
    ended at, exclusive), plus the gate-churn tally."""

    strategy: str
    tick_indices: np.ndarray
    rec_cpu: np.ndarray  # [W × K] published cores
    rec_mem: np.ndarray  # [W × K] published bytes (post-buffer, as served)
    flaps: int
    workloads: int = 0
    suppressed: int = 0
    extra: "dict[str, Any]" = field(default_factory=dict)


def _replay_objects(keys: "list[str]") -> "list[Any]":
    from krr_tpu_torch.core.streaming import split_object_key
    from krr_tpu_torch.models.allocations import ResourceAllocations
    from krr_tpu_torch.models.objects import K8sObjectData

    objects = []
    for key in keys:
        cluster, namespace, name, container, kind = split_object_key(key)
        objects.append(
            K8sObjectData(
                cluster=cluster,
                name=name,
                container=container,
                pods=[name],
                namespace=namespace,
                kind=kind,
                allocations=ResourceAllocations(requests={}, limits={}),
            )
        )
    return objects


def tick_ends(samples: int, ticks: int) -> np.ndarray:
    """Evenly spaced replay-tick window ends over ``samples`` (exclusive
    indices, last always == samples), deduplicated for tiny grids."""
    ticks = max(1, int(ticks))
    return np.unique(np.linspace(samples / ticks, samples, num=ticks).round().astype(np.int64))


def replay(
    inputs: ReplayInput,
    strategy: Any,
    *,
    name: Optional[str] = None,
    ticks: int = 16,
    dead_band_pct: float = 5.0,
    confirm_ticks: int = 2,
    hysteresis: bool = True,
) -> ReplayedSeries:
    """Walk the grid tick-by-tick: strategy over the history-so-far, raw
    recommendation through a real hysteresis gate, published values out."""
    from krr_tpu_torch.history.policy import HysteresisGate
    from krr_tpu_torch.models.series import FleetBatch

    if not inputs.keys:
        raise ValueError("replay needs at least one workload")
    ends = tick_ends(len(inputs.timestamps), ticks)
    objects = _replay_objects(inputs.keys)
    gate = HysteresisGate(dead_band_pct, confirm_ticks, enabled=hysteresis)
    buffer_pct = float(getattr(strategy.settings, "memory_buffer_percentage", 0) or 0)
    buffer_factor = 1.0 + buffer_pct / 100.0
    w = len(inputs.keys)
    rec_cpu = np.empty((w, len(ends)), np.float64)
    rec_mem = np.empty((w, len(ends)), np.float64)
    flaps = 0
    suppressed = 0
    published_once = np.zeros(w, bool)
    seconds = {"build": 0.0, "run_batch": 0.0, "gate": 0.0}
    for k, end in enumerate(ends):
        started = time.perf_counter()
        batch = FleetBatch.build(
            objects,
            {
                ResourceType.CPU: [
                    {obj.pods[0]: inputs.cpu[i, :end]} for i, obj in enumerate(objects)
                ],
                ResourceType.Memory: [
                    {obj.pods[0]: inputs.mem[i, :end]} for i, obj in enumerate(objects)
                ],
            },
        )
        built = time.perf_counter()
        results = strategy.run_batch(batch)
        ran = time.perf_counter()
        raw_cpu = np.full(w, np.nan)
        raw_mem_mb = np.full(w, np.nan)
        for i, result in enumerate(results):
            cpu_rec = result.get(ResourceType.CPU)
            if cpu_rec is not None and cpu_rec.request is not None:
                raw_cpu[i] = float(cpu_rec.request)
            mem_rec = result.get(ResourceType.Memory)
            if mem_rec is not None and mem_rec.request is not None:
                # run_batch returns post-buffer BYTES; the gate (like serve)
                # sees raw pre-buffer MB, and the buffer is re-applied to
                # the held value on the way out — bit-for-bit the
                # scheduler's publish pipeline.
                raw_mem_mb[i] = float(mem_rec.request) / MEMORY_SCALE / buffer_factor
        decision = gate.observe(inputs.keys, raw_cpu, raw_mem_mb)
        flaps += int(np.count_nonzero(decision.changed & published_once))
        suppressed += int(np.count_nonzero(decision.suppressed))
        published_once |= decision.published
        rec_cpu[:, k] = np.asarray(decision.cpu, np.float64)
        rec_mem[:, k] = np.asarray(decision.mem, np.float64) * MEMORY_SCALE * buffer_factor
        seconds["build"] += built - started
        seconds["run_batch"] += ran - built
        seconds["gate"] += time.perf_counter() - ran
    return ReplayedSeries(
        strategy=name or getattr(strategy, "__display_name__", type(strategy).__name__),
        tick_indices=ends,
        rec_cpu=rec_cpu,
        rec_mem=rec_mem,
        flaps=flaps,
        workloads=w,
        suppressed=suppressed,
        extra={"seconds": seconds},
    )


def score_replay(inputs: ReplayInput, replayed: ReplayedSeries, *, device="cuda") -> "dict[str, Any]":
    """Replay scores + gate-churn bookkeeping in one scoreboard-row dict;
    the scoring reduce runs on ``device``."""
    from krr_tpu_torch.eval.score import score_grids

    scores = score_grids(
        inputs.cpu,
        inputs.mem,
        replayed.rec_cpu,
        replayed.rec_mem,
        replayed.tick_indices,
        step_seconds=inputs.step_seconds,
        device=device,
    )
    return {
        "strategy": replayed.strategy,
        "workloads": replayed.workloads,
        "ticks": int(len(replayed.tick_indices)),
        "flaps": replayed.flaps,
        **scores,
    }


__all__ = [
    "MEMORY_SCALE",
    "ReplayInput",
    "ReplayedSeries",
    "StaticReplayStrategy",
    "replay",
    "score_replay",
    "tick_ends",
]
