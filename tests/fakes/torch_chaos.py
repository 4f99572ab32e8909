"""Chaos fakes on `krr_tpu_torch`, for the port's bench: the archetype
fleet and the SIGKILL soak.

The part of `tests/fakes/chaos.py` that the port's store legs use, with
nothing of the JAX package imported:

* :func:`build_fleet` — the workload-archetype fleet generator, the same
  series from the same specs and seed as the original;
* :func:`run_kill_soak` — drives ``tests.fakes.torch_soak_driver`` (a real
  ``krr_tpu_torch`` serve composition in a subprocess) and SIGKILLs it at
  random points;
* :func:`stores_bitexact` — keys and every digest array bit for bit.

Test infrastructure: the product ships none of it.
"""

from __future__ import annotations

import json
import queue
import signal
import subprocess
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import yaml

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
    "ChaosFleet",
    "DEFAULT_FLEET",
    "ORIGIN",
    "STEP",
    "ServerThread",
    "build_fleet",
    "run_kill_soak",
    "stores_bitexact",
    "write_kubeconfig",
]
