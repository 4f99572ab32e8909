"""Chaos fakes on `krr_tpu_torch`, for the port's bench: the archetype
fleet, the fault injector, the disk-fault seams and the soaks.

The counterpart of `tests/fakes/chaos.py`, with nothing of the JAX package
imported:

* :func:`build_fleet` — the workload-archetype fleet generator, the same
  series from the same specs and seed as the original;
  :func:`fleet_replay_input` — such a fleet as the port's eval
  ``ReplayInput``;
* :class:`FaultTimeline` — scripted per-tick faults over the in-process
  fakes (`tests.fakes.servers`);
* :class:`FaultyFs` and :class:`CrashPointFs` — disk faults and crash
  points over the durable store's ``FsOps`` seam
  (`krr_tpu_torch.core.streaming`);
* :func:`run_soak` — a real ``krr_tpu_torch`` serve composition (fake
  clock) through N scheduler ticks under a fault timeline, one
  :class:`TickSample` a tick;
* :func:`run_kill_soak` — drives ``tests.fakes.torch_soak_driver`` (a real
  ``krr_tpu_torch`` serve composition in a subprocess) and SIGKILLs it at
  random points;
* :func:`stores_bitexact` — keys and every digest array bit for bit.

Test infrastructure: the product ships none of it.
"""

from __future__ import annotations

import errno
import inspect
import json
import os
import queue
import signal
import subprocess
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import numpy as np
import yaml

from krr_tpu_torch.core.streaming import FsOps
from tests.fakes.servers import FakeBackend, FakeCluster, FakeMetrics, ServerThread

ORIGIN = FakeBackend.SERIES_ORIGIN
STEP = 60.0  # the fake series grid (timeframe_duration = 1 minute)


# ------------------------------------------------------------ archetype series
#: Declared incident labels: each generator returns, alongside its series, the
#: sample-index windows ``[start, end)`` where its OWN parameters put demand
#: at archetype peak — the spans an undersized recommendation would incident
#: on. Labels are emitted at generation time from the generator's internal
#: knobs (sawtooth ramp, burst starts, sine phase), NOT re-derived from the
#: noisy output data, so the eval oracle asserts against declared ground
#: truth (`krr_tpu_torch.eval`) instead of against its own detector.
Windows = "tuple[tuple[int, int], ...]"


def _mask_windows(mask: np.ndarray) -> "tuple[tuple[int, int], ...]":
    """Contiguous True runs of ``mask`` as ``(start, end)`` windows."""
    edges = np.flatnonzero(np.diff(np.r_[0, mask.astype(np.int8), 0]))
    return tuple((int(edges[j]), int(edges[j + 1])) for j in range(0, len(edges), 2))


def _merge_windows(windows: "list[tuple[int, int]]") -> "tuple[tuple[int, int], ...]":
    """Sorted union of possibly-overlapping windows (per-pod labels of one
    workload fold into workload-level spans)."""
    merged: "list[list[int]]" = []
    for start, end in sorted(windows):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return tuple((s, e) for s, e in merged)


def _diurnal(rng: np.random.Generator, n: int, i: int) -> "tuple[np.ndarray, np.ndarray, Windows]":
    """Sinusoidal day/night load: the pattern cycles twice inside the series
    so percentiles genuinely move as the scan window grows."""
    t = np.arange(n)
    phase = rng.uniform(0, 2 * np.pi)
    base = rng.uniform(0.2, 0.5)
    wave = np.sin(2 * np.pi * t / (n / 2) + phase)
    cpu = base * (1.0 + 0.6 * wave)
    cpu = np.clip(cpu + rng.normal(0, 0.01, n), 1e-3, None)
    mem = 2e8 * (1.0 + 0.3 * wave) + rng.uniform(0, 1e7, n)
    # Peak label: the top of the drawn sine (phase is a parameter of this
    # pod's series, so the windows are declared, not detected).
    return cpu, mem, _mask_windows(wave >= 0.8)


def _bursty_batch(rng: np.random.Generator, n: int, i: int) -> "tuple[np.ndarray, np.ndarray, Windows]":
    """Idle baseline with periodic tall bursts (cron-style batch): sizing to
    the burst vs the baseline is exactly what percentile strategies disagree
    about."""
    cpu = np.full(n, 0.03) + rng.normal(0, 0.005, n)
    mem = np.full(n, 8e7) + rng.uniform(0, 5e6, n)
    period = max(8, n // 6)
    width = max(2, period // 8)
    windows: "list[tuple[int, int]]" = []
    for start in range(rng.integers(0, period), n, period):
        height = rng.uniform(1.5, 3.0)
        cpu[start : start + width] += height
        mem[start : start + width] += 6e8
        windows.append((start, min(start + width, n)))
    return np.clip(cpu, 1e-3, None), mem, tuple(windows)


def _oom_loop(rng: np.random.Generator, n: int, i: int) -> "tuple[np.ndarray, np.ndarray, Windows]":
    """Memory sawtooth climbing to a ceiling and resetting (an OOM-killed
    container in a restart loop); CPU stays low."""
    cpu = np.clip(np.full(n, 0.05) + rng.normal(0, 0.01, n), 1e-3, None)
    ramp = max(6, n // 8)
    t = np.arange(n)
    fill = (t % ramp) / ramp
    mem = 1e8 + (9e8 - 1e8) * fill
    mem = mem + rng.uniform(0, 5e6, n)
    # Spike label: the top fifth of each sawtooth cycle (where the restart
    # loop's kills land) — one window per cycle, declared from the ramp.
    return cpu, mem, _mask_windows(fill >= 0.8)


def _high_churn(rng: np.random.Generator, n: int, i: int) -> "tuple[np.ndarray, np.ndarray, Windows]":
    """Moderate lognormal noise — the archetype's character is DISCOVERY
    churn (pods and deployments replaced mid-soak via ``on_tick``), not the
    series shape."""
    cpu = rng.lognormal(mean=-2.0, sigma=0.4, size=n)
    mem = rng.uniform(1e8, 2.5e8, n)
    return cpu, mem, ()


def _mixed_qos(rng: np.random.Generator, n: int, i: int) -> "tuple[np.ndarray, np.ndarray, Windows]":
    """Alternating QoS classes: even workloads run flat and hot
    (guaranteed), odd ones idle with rare spikes (burstable)."""
    if i % 2 == 0:
        cpu = np.clip(np.full(n, 0.5) + rng.normal(0, 0.01, n), 1e-3, None)
        mem = np.full(n, 4e8) + rng.uniform(0, 1e7, n)
        return cpu, mem, ()
    cpu = np.clip(np.full(n, 0.04) + rng.normal(0, 0.008, n), 1e-3, None)
    spikes = rng.random(n) < 0.03
    cpu = cpu + np.where(spikes, rng.uniform(0.5, 1.0, n), 0.0)
    mem = np.full(n, 9e7) + rng.uniform(0, 8e6, n)
    return cpu, mem, _mask_windows(spikes)


ARCHETYPES: "dict[str, Callable]" = {
    "diurnal": _diurnal,
    "bursty-batch": _bursty_batch,
    "oom-loop": _oom_loop,
    "high-churn": _high_churn,
    "mixed-qos": _mixed_qos,
}


@dataclass(frozen=True)
class ArchetypeSpec:
    """One archetype's slice of the fleet: ``workloads`` deployments of
    ``pods`` pods each, in their own namespace (default: the archetype
    name) — which is what lets the fault injector target archetypes."""

    kind: str
    workloads: int = 2
    pods: int = 2
    namespace: Optional[str] = None


DEFAULT_FLEET = tuple(ArchetypeSpec(kind) for kind in ARCHETYPES)


@dataclass
class ChaosFleet:
    """A generated fleet plus its backing fakes, ready to serve."""

    cluster: FakeCluster
    metrics: FakeMetrics
    backend: FakeBackend
    #: namespace → workload names, for targeting faults and assertions.
    namespaces: "dict[str, list[str]]"
    #: (namespace, workload, pod) → the generator's DECLARED incident
    #: windows for that pod's series (sample-index ``[start, end)`` spans).
    labels: "dict[tuple[str, str, str], tuple[tuple[int, int], ...]]" = field(
        default_factory=dict
    )

    def incident_windows(self, kind: Optional[str] = None) -> "dict[str, tuple[tuple[int, int], ...]]":
        """The fleet's labeled ground truth, per workload: declared incident
        windows merged across the workload's pods, keyed
        ``namespace/workload``. ``kind`` filters to one archetype. This is
        the oracle surface the eval tests assert against — labels the
        generators emitted, never spans re-derived from the series."""
        grouped: "dict[str, list[tuple[int, int]]]" = {}
        for (namespace, name, _pod), windows in self.labels.items():
            if kind is not None and not name.startswith(f"{kind}-"):
                continue
            grouped.setdefault(f"{namespace}/{name}", []).extend(windows)
        return {key: _merge_windows(spans) for key, spans in sorted(grouped.items())}


def build_fleet(
    specs: "tuple[ArchetypeSpec, ...]" = DEFAULT_FLEET,
    *,
    samples: int = 240,
    seed: int = 0,
) -> ChaosFleet:
    """Deterministic archetype fleet: same specs + seed ⇒ byte-identical
    series, so a faulted soak and its control run share ground truth."""
    cluster = FakeCluster()
    metrics = FakeMetrics()
    metrics.enforce_range = True  # window slicing: the delta-fetch contract
    rng = np.random.default_rng(seed)
    namespaces: "dict[str, list[str]]" = {}
    labels: "dict[tuple[str, str, str], tuple[tuple[int, int], ...]]" = {}
    for spec in specs:
        generate = ARCHETYPES[spec.kind]
        namespace = spec.namespace or spec.kind
        for w in range(spec.workloads):
            name = f"{spec.kind}-{w}"
            pods = cluster.add_workload_with_pods(
                "Deployment", name, namespace, pod_count=spec.pods
            )
            for pod in pods:
                cpu, mem, windows = generate(rng, samples, w)
                metrics.set_series(namespace, "main", pod, cpu=cpu, memory=mem)
                labels[(namespace, name, pod)] = windows
            namespaces.setdefault(namespace, []).append(name)
    return ChaosFleet(
        cluster=cluster,
        metrics=metrics,
        backend=FakeBackend(cluster, metrics),
        namespaces=namespaces,
        labels=labels,
    )


def fleet_replay_input(fleet: ChaosFleet):
    """A chaos fleet as eval replay input (`krr_tpu_torch.eval.ReplayInput`): one
    row per workload on the fake series grid, usage = the elementwise MAX
    across the workload's pods (per-container sizing must cover the
    hungriest pod). Keys use the fleet's object-key grammar so ``-n``
    scoping and the labels' ``namespace/workload`` keys line up."""
    from krr_tpu_torch.eval import ReplayInput

    per_workload: "dict[str, tuple[np.ndarray, np.ndarray]]" = {}
    for (namespace, container, _pod), (cpu, mem) in sorted(fleet.metrics.series.items()):
        name = _workload_for_pod(fleet, namespace, _pod)
        key = f"/{namespace}/{name}/{container}/Deployment"
        held = per_workload.get(key)
        if held is None:
            per_workload[key] = (np.asarray(cpu, float), np.asarray(mem, float))
        else:
            per_workload[key] = (np.maximum(held[0], cpu), np.maximum(held[1], mem))
    samples = len(next(iter(per_workload.values()))[0])
    timestamps = ORIGIN + STEP * np.arange(samples)
    return ReplayInput.from_series(per_workload, timestamps)


def _workload_for_pod(fleet: ChaosFleet, namespace: str, pod: str) -> str:
    for (ns, name, p) in fleet.labels:
        if ns == namespace and p == pod:
            return name
    # Pods added outside build_fleet (churn scenarios): fall back to the
    # conventional "<workload>-<pod suffix>" prefix match.
    for name in fleet.namespaces.get(namespace, ()):
        if pod.startswith(f"{name}-"):
            return name
    return pod


def write_kubeconfig(path, url: str) -> str:
    """The single-cluster kubeconfig the serve fixtures use, pointed at a
    running fake backend."""
    with open(path, "w") as f:
        yaml.dump(
            {
                "current-context": "fake",
                "contexts": [{"name": "fake", "context": {"cluster": "fake", "user": "fake"}}],
                "clusters": [{"name": "fake", "cluster": {"server": url}}],
                "users": [{"name": "fake", "user": {"token": "t"}}],
            },
            f,
        )
    return str(path)


# ------------------------------------------------------------- fault injector
@dataclass(frozen=True)
class FaultSpec:
    """One tick's fault regime (everything defaults to healthy)."""

    down: bool = False
    fail_namespaces: "frozenset[str]" = frozenset()
    fail_rate: float = 0.0
    fault_seed: int = 0
    latency_seconds: float = 0.0
    truncate_bodies: bool = False
    freeze_discovery: bool = False

    @property
    def clean(self) -> bool:
        return self == CLEAN


CLEAN = FaultSpec()


class FaultTimeline:
    """Scripted faults: ``(first_tick, last_tick, FaultSpec)`` spans, first
    match wins, everything else healthy. ``apply`` mutates the fake's knobs
    for the coming tick — deterministic replay by construction."""

    def __init__(self, spans: "list[tuple[int, int, FaultSpec]]" = ()):  # type: ignore[assignment]
        self.spans = list(spans)

    def at(self, tick: int) -> FaultSpec:
        for first, last, spec in self.spans:
            if first <= tick <= last:
                return spec
        return CLEAN

    def apply(self, backend: FakeBackend, tick: int) -> FaultSpec:
        spec = self.at(tick)
        metrics = backend.metrics
        metrics.down = spec.down
        metrics.fail_namespaces = frozenset(spec.fail_namespaces)
        metrics.fail_rate = spec.fail_rate
        if spec.fail_rate > 0:
            # A fresh seeded stream per storm span keeps storms reproducible
            # regardless of how many requests earlier ticks made.
            metrics.fault_seed = spec.fault_seed
            metrics._fault_rng = None
        metrics.latency_seconds = spec.latency_seconds
        metrics.truncate_bodies = spec.truncate_bodies
        backend.freeze_discovery(spec.freeze_discovery)
        return spec


# ---------------------------------------------------------- disk-fault fakes
class FaultyFs(FsOps):
    """Scripted disk faults over the durable store's fs-ops seam
    (`krr_tpu_torch.core.streaming.FsOps`): every listed op raises ``OSError``
    with the scripted errno (ENOSPC by default, EIO for media faults),
    optionally only after ``after`` matching calls succeed. Install on one
    ``DurableStore`` instance (``durable.fs = FaultyFs(...)``) to fault
    that store without touching the process-wide default."""

    def __init__(
        self,
        ops: "tuple[str, ...]" = ("append", "fsync", "write", "replace", "fsync_dir"),
        *,
        error: int = errno.ENOSPC,
        after: int = 0,
    ) -> None:
        self.ops = frozenset(ops)
        self.error = error
        self.after = int(after)
        self.calls = 0
        self.faults = 0

    def _maybe_fault(self, op: str) -> None:
        if op not in self.ops:
            return
        self.calls += 1
        if self.calls > self.after:
            self.faults += 1
            raise OSError(self.error, os.strerror(self.error))

    def write(self, f, data: bytes) -> None:
        self._maybe_fault("write")
        super().write(f, data)

    def append(self, f, data: bytes) -> None:
        self._maybe_fault("append")
        super().append(f, data)

    def fsync(self, f) -> None:
        self._maybe_fault("fsync")
        super().fsync(f)

    def replace(self, src: str, dst: str) -> None:
        self._maybe_fault("replace")
        super().replace(src, dst)

    def fsync_dir(self, path: str) -> None:
        self._maybe_fault("fsync_dir")
        super().fsync_dir(path)

    def truncate(self, f, size: int) -> None:
        self._maybe_fault("truncate")
        super().truncate(f, size)


class SimulatedCrash(BaseException):
    """Raised by :class:`CrashPointFs` at its scripted fault point.

    A ``BaseException`` on purpose: persistence code must not catch it on
    the way out, exactly like a real crash doesn't unwind through handlers."""


class CrashPointFs(FsOps):
    """Crash-injection at the Nth durability-critical syscall: counts every
    fs op and raises :class:`SimulatedCrash` at op ``crash_at`` (0-based).
    The crash-point matrix in the durability tests runs a persist once per
    possible value of ``crash_at`` and asserts recovery lands on a durable
    state after each — every fsync/rename/append boundary is a tested
    crash window, not an assumed one."""

    def __init__(self, crash_at: Optional[int] = None) -> None:
        self.crash_at = crash_at
        self.calls = 0

    def _tick(self) -> None:
        if self.crash_at is not None and self.calls == self.crash_at:
            raise SimulatedCrash(f"injected crash at fs op {self.calls}")
        self.calls += 1

    def write(self, f, data: bytes) -> None:
        self._tick()
        super().write(f, data)

    def append(self, f, data: bytes) -> None:
        self._tick()
        super().append(f, data)

    def fsync(self, f) -> None:
        self._tick()
        super().fsync(f)

    def replace(self, src: str, dst: str) -> None:
        self._tick()
        super().replace(src, dst)

    def fsync_dir(self, path: str) -> None:
        self._tick()
        super().fsync_dir(path)

    def truncate(self, f, size: int) -> None:
        self._tick()
        super().truncate(f, size)


# ------------------------------------------------------------ SIGKILL soaks
def _pump_lines(proc: "subprocess.Popen", out: "queue.Queue") -> None:
    for line in proc.stdout:
        out.put(line)
    out.put(None)


def run_kill_soak(
    config_payload: dict,
    ticks: "list[float]",
    *,
    kills: int,
    seed: int,
    cfg_path: str,
    repo_root: str,
    run_timeout: float = 300.0,
    env: Optional[dict] = None,
) -> dict:
    """Drive ``tests.fakes.torch_soak_driver`` (a REAL serve composition in a
    subprocess, ticking a scripted schedule against the fake backend) and
    SIGKILL it at ``kills`` random points — sampled across the whole run:
    a random tick index plus a sub-tick jitter, so kills land mid-fetch,
    mid-fold, mid-journal-append, mid-WAL-append, and mid-compaction.
    After each kill the driver restarts from the same state directory
    (recovery is the restart itself: an unrecoverable store fails the
    rerun loudly); once the kill budget is spent, a final run completes
    the schedule. Returns run/kill bookkeeping for the assertions."""
    rng = np.random.default_rng(seed)
    with open(cfg_path, "w") as f:
        json.dump({"config": config_payload, "ticks": ticks}, f)
    runs = 0
    kill_points: "list[tuple[int, float]]" = []
    remaining = int(kills)
    while True:
        proc = subprocess.Popen(
            [sys.executable, "-m", "tests.fakes.torch_soak_driver", cfg_path],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
            cwd=repo_root,
            env=env,
        )
        runs += 1
        lines: "queue.Queue" = queue.Queue()
        pump = threading.Thread(target=_pump_lines, args=(proc, lines), daemon=True)
        pump.start()
        kill_after = int(rng.integers(0, len(ticks))) if remaining > 0 else None
        jitter = float(rng.uniform(0.0, 0.2))
        deadline = time.monotonic() + run_timeout
        done = False
        killed_this_run = False
        transcript: "list[str]" = []
        try:
            while True:
                try:
                    line = lines.get(timeout=max(0.01, deadline - time.monotonic()))
                except queue.Empty:
                    proc.kill()
                    raise TimeoutError(
                        f"soak driver run {runs} produced no output for "
                        f"{run_timeout}s:\n{''.join(transcript[-50:])}"
                    )
                if line is None:
                    break
                transcript.append(line)
                if line.startswith("DONE"):
                    done = True
                if kill_after is not None and line.startswith(f"TICK {kill_after} "):
                    time.sleep(jitter)
                    proc.send_signal(signal.SIGKILL)
                    kill_points.append((kill_after, jitter))
                    killed_this_run = True
                    remaining -= 1
                    break
        finally:
            proc.wait(timeout=60)
            pump.join(timeout=10)
        if done:
            if proc.returncode != 0:
                raise RuntimeError(
                    f"soak driver run {runs} exited rc={proc.returncode} after DONE:\n"
                    + "".join(transcript[-50:])
                )
            break
        if not killed_this_run:
            # The run ended without DONE and without our kill: it crashed —
            # which is exactly what an unrecoverable store would look like.
            raise RuntimeError(
                f"soak driver run {runs} died rc={proc.returncode} without finishing:\n"
                + "".join(transcript[-50:])
            )
    return {"runs": runs, "kills": int(kills) - remaining, "kill_points": kill_points}


# ------------------------------------------------------------------ serve soaks
@dataclass
class TickSample:
    """Everything the assertions need about one scheduler tick."""

    tick: int
    fault: FaultSpec
    #: run_once result: True scanned, False skipped, None aborted.
    ok: "Optional[bool]"
    wall_seconds: float
    stale_workloads: int
    consecutive_failures: int
    slo_firing: "list[str]"
    #: krr_tpu_prom_breaker_state for the fake cluster (None before the
    #: loader exists): 0 closed, 1 half-open, 2 open.
    breaker_state: "Optional[float]"
    #: This tick published with quarantined workloads (partial failure).
    degraded: bool


@dataclass
class SoakReport:
    ticks: "list[TickSample]"
    store: Any
    state: Any
    metrics: Any

    def counts(self) -> "dict[str, int]":
        return {
            "scanned": sum(1 for t in self.ticks if t.ok),
            "aborted": sum(1 for t in self.ticks if t.ok is None),
            "degraded": sum(1 for t in self.ticks if t.degraded),
        }


async def run_soak(
    config,
    backend: FakeBackend,
    timeline: Optional[FaultTimeline] = None,
    *,
    ticks: int,
    tick_seconds: float = 300.0,
    start: float = ORIGIN + 3600.0,
    on_tick: Optional[Callable] = None,
) -> SoakReport:
    """Drive a real serve composition (fake clock) through ``ticks``
    scheduler rounds, applying the fault timeline before each. ``on_tick``
    (sync or async, called AFTER each round with ``(server, sample)``) is
    the hook for HTTP-level assertions and for deterministic mid-soak
    cluster mutation (churn scenarios) — give the control run the same hook.
    The fakes are returned to the healthy regime before the server shuts
    down, so a shared fixture can't leak faults into the next scenario."""
    from krr_tpu_torch.server.app import KrrServer

    timeline = timeline or FaultTimeline()
    now = [start]
    server = KrrServer(config, clock=lambda: now[0])
    await server.start(run_scheduler=False)
    samples: "list[TickSample]" = []
    try:
        for tick in range(ticks):
            now[0] = start + tick * tick_seconds
            spec = timeline.apply(backend, tick)
            metrics = server.state.metrics
            degraded_before = metrics.value("krr_tpu_scans_degraded_total") or 0.0
            t0 = time.perf_counter()
            ok = await server.scheduler.run_once()
            wall = time.perf_counter() - t0
            sample = TickSample(
                tick=tick,
                fault=spec,
                ok=ok,
                wall_seconds=wall,
                stale_workloads=len(server.state.stale_workloads),
                consecutive_failures=server.state.consecutive_scan_failures,
                slo_firing=list(server.state.slo.firing()) if server.state.slo else [],
                breaker_state=metrics.value("krr_tpu_prom_breaker_state", cluster="fake"),
                degraded=(metrics.value("krr_tpu_scans_degraded_total") or 0.0) > degraded_before,
            )
            samples.append(sample)
            if on_tick is not None:
                outcome = on_tick(server, sample)
                if inspect.isawaitable(outcome):
                    await outcome
    finally:
        FaultTimeline().apply(backend, 0)  # heal the fakes for the next user
        await server.shutdown()
    return SoakReport(
        ticks=samples, store=server.state.store, state=server.state, metrics=server.state.metrics
    )


def stores_bitexact(a, b) -> "tuple[bool, str]":
    """(equal, detail) across keys and every digest array — the degraded
    path's recovery discipline: after faults clear and catch-up folds, the
    soaked store must be BIT-identical to the never-faulted control's."""
    if a.keys != b.keys:
        return False, f"keys differ: {len(a.keys)} vs {len(b.keys)} rows"
    for attr in ("cpu_counts", "cpu_total", "cpu_peak", "mem_total", "mem_peak"):
        if not np.array_equal(getattr(a, attr), getattr(b, attr)):
            return False, f"{attr} differs"
    return True, ""


__all__ = [
    "ARCHETYPES",
    "ArchetypeSpec",
    "CLEAN",
    "ChaosFleet",
    "CrashPointFs",
    "DEFAULT_FLEET",
    "FaultSpec",
    "FaultTimeline",
    "FaultyFs",
    "ORIGIN",
    "STEP",
    "ServerThread",
    "SimulatedCrash",
    "SoakReport",
    "TickSample",
    "build_fleet",
    "fleet_replay_input",
    "run_kill_soak",
    "run_soak",
    "stores_bitexact",
    "write_kubeconfig",
]
