#!/usr/bin/env python3
"""Benchmark of the PyTorch/CUDA port: containers right-sized per second.

The counterpart of `bench.py`'s headline and kernel legs, on `krr_tpu_torch`
and one CUDA card. It measures the fleet recommendation step at the
BASELINE.md headline shape (10,000 containers × 7 days of 5-second samples =
120,960 timesteps a container) through the port's public ops:

* the headline: ``simple``'s single device program,
  `krr_tpu_torch.ops.cuda_select.fleet_exact` — the ``bisect_select`` kernel
  (exact CPU p99) and the ``row_max`` kernel (memory peak) into one
  ``[2, N]`` tensor, one readback;
* the top-K leg: `krr_tpu_torch.ops.topk_sketch` built by one
  ``topk_select`` launch over the resident window (``chunk_size=None``), as
  the ``tdigest --exact_upgrade`` scan builds it, then its p99 and peak;
* the digest leg: `krr_tpu_torch.ops.digest` built by one ``digest_hist``
  launch (``chunk_size=None``), then its p99 and peak.

`bench.py` builds both sketches in 8,192-column chunks only because of the
TPU's memory; on the card that would time 15 stateful launches, a path no
scan of the port takes, so the legs here time the one-launch build.

**Parity gates** on the first ``BENCH_PARITY_ROWS`` rows, on the same
device: (1) ``fleet_exact`` equals its plain PyTorch version
(``fleet_exact_plain``) bit for bit; (2) the top-K sketch's p99 equals the
exact p99 bit for bit; (3) the digest's p99 is within its relative-error
bound of the exact p99; (4) the digest's peak equals the ``row_max`` kernel
(``masked_max_cuda``) bit for bit. Any failure prints ``"parity": "fail"``
and exits 1. On the card every kernel leg must also have launched its
kernels (the wrappers' launch counters).

The shape is the one requested: the port's kernels take any ``N`` and ``T``,
so the tile alignment `bench.py` applies (8 rows, 128 lanes) is dropped.
Data is generated on the device in ``BENCH_CHUNK`` column blocks from
seeded ``torch.Generator``s (0 for CPU histories, 1 for memory), straight
into one preallocated ``[N, T]`` float32 tensor each.

Timing: every timed call ends in a host readback (``.cpu()``). The raw rate
is one call, best of ``BENCH_RUNS``; the pipelined headline launches
``BENCH_PIPELINE_DEPTH`` programs back to back on the stream and reads back
only the last; ``dispatch_floor_ms`` is one trivial op on an ``[8, 128]``
tensor plus its readback, best of 5.

The service-plane and observability legs then run in this process, in
`bench.py`'s order, each with `bench.py`'s ``secondary.<prefix>_*`` fields
and gates, every ``Config``, strategy and server on ``--device``:
``journal_leg`` (the history journal's append, compaction and diff
render), ``obs_leg`` (a digest-ingest scan with and without a recording
tracer) with ``analyze_smoke_leg`` (``python -m krr_tpu_torch analyze``
over its trace), ``obs_device_leg`` (``SimpleStrategy.run_batch`` with and
without `obs.device.DeviceObs`), ``sentinel_leg`` (the regression sentinel
over synthetic timelines), ``chaos_leg`` (serve ticks under a scripted
fault timeline, `tests/fakes/torch_chaos.py`, against a never-faulted
control), ``eval_leg`` (``simple`` and ``tdigest`` replays and two static
probes, rendered twice), ``discovery_leg`` (watch reconcile against
relist), ``ingest_leg`` (a remote-write-fed serve against a range-fetched
pull control), ``fetchplan_leg`` (the adaptive fetch plan against the
fixed one), ``wire_leg`` (gzip and downsampling against the identity/raw
control), ``federation_leg`` (shards over TCP into an aggregator against a
single-process control), ``ha_leg`` (a 2-node ring with a killed primary,
a duplicate record and a read replica), ``fleet_obs_leg`` (stitched traces
and freshness lineage against a no-lineage control), ``readpath_leg``
(keep-alive readers against a live serve and an uncached control),
``store_leg`` (the durable store's delta append, legacy rewrite and
recovery) and ``store_kill_leg`` (SIGKILLed serve subprocesses,
`tests/fakes/torch_soak_driver.py`, against a never-killed control). Each
leg's launches of K1–K5 are read around it (``kernel_launches_by_leg``)
and gated (``<leg>_kernel_launches``): on the card ``obs_device_leg`` and
``eval_leg`` launch exactly what their ``run_batch`` calls imply
(``RUN_BATCH_LAUNCHES``), every other leg none; the plain versions count
none. A leg that raises fails the bench; a failed gate, exact or
wall-clock, is a parity failure.

The end-to-end legs run `bench_e2e_torch.py` in two subprocesses (the main
legs with ``BENCH_E2E_CONTAINERS`` defaulted to 10,000, then the full-fleet
scan alone), merged into ``secondary``. A leg that fails, times out or
returns no payload is noted under its tag and makes the bench exit
non-zero after it prints what it measured.

Prints ONE JSON line with `bench.py`'s field names:
    {"metric": "containers_per_sec_exact_p99_7d_at_5s_pipelined", "value": N,
     "unit": "containers/s", "vs_baseline": N, "parity": "ok", "runs": N,
     "raw_containers_per_sec": N, "raw_spread_pct": N, "raw_vs_baseline": N,
     "dispatch_floor_ms": N, "pipelined_depth": N, "pipelined_spread_pct": N,
     "floor_corrected_containers_per_sec": N|null, "vs_previous_round": N|null,
     "previous_round_file": ..., "previous_round_stable_rate": ...,
     "regression_vs_previous": bool, "fetch_vs_previous_round": N|null, ...,
     "readpath_vs_previous_round": N|null, ..., "device": {...},
     "secondary": {...}}
The round-over-round fields read the newest ``BENCH_TORCH_r*.json`` beside
this script, never a ``BENCH_r*.json`` (those are rounds of the JAX
program on other hardware).

Env knobs (`bench.py`'s names and defaults): BENCH_CONTAINERS (10000),
BENCH_TIMESTEPS (120960), BENCH_CHUNK (8192), BENCH_RUNS (5),
BENCH_PIPELINE_DEPTH (16), BENCH_PY_SAMPLE (3), BENCH_PARITY_ROWS (512),
BENCH_SKIP_E2E, the BENCH_E2E_* sizes of `bench_e2e_torch.py`, and the
service and observability legs': BENCH_SKIP_JOURNAL, BENCH_JOURNAL_ROWS
(2000), BENCH_JOURNAL_TICKS (32); BENCH_SKIP_OBS (the obs, analyze,
obs-device and sentinel legs), BENCH_OBS_ROWS (256), BENCH_OBS_SAMPLES
(4096), BENCH_OBS_RUNS (5), BENCH_SENTINEL_TICKS (60); BENCH_SKIP_CHAOS,
BENCH_CHAOS_TICKS (8), BENCH_CHAOS_WORKLOADS (2); BENCH_SKIP_EVAL,
BENCH_EVAL_SAMPLES (240), BENCH_EVAL_WORKLOADS (2), BENCH_EVAL_TICKS (8);
BENCH_SKIP_DISCOVERY, BENCH_DISCOVERY_WORKLOADS (400),
BENCH_DISCOVERY_ROUNDS (5); BENCH_SKIP_INGEST, BENCH_INGEST_WORKLOADS
(200), BENCH_INGEST_ROUNDS (5); BENCH_SKIP_FETCHPLAN,
BENCH_FETCHPLAN_WORKLOADS (3); BENCH_SKIP_WIRE, BENCH_WIRE_WORKLOADS (3),
BENCH_WIRE_SAMPLES (180); BENCH_SKIP_FEDERATION, BENCH_FED_SHARDS (3),
BENCH_FED_TICKS (4), BENCH_FED_WORKLOADS (2); BENCH_SKIP_HA, BENCH_HA_TICKS
(4), BENCH_HA_WORKLOADS (2), BENCH_HA_CLIENTS (4), BENCH_HA_REQUESTS (40);
BENCH_SKIP_FLEETOBS, BENCH_FLEETOBS_TICKS (4), BENCH_FLEETOBS_WORKLOADS
(2); BENCH_SKIP_READPATH, BENCH_READPATH_WORKLOADS (400),
BENCH_READPATH_CLIENTS (8), BENCH_READPATH_REQUESTS (120);
BENCH_SKIP_STORE, BENCH_STORE_ROWS (100000), BENCH_STORE_KILLS (2),
BENCH_STORE_KILL_TICKS (6).

    python3 bench_torch.py                       # on the card
    python3 bench_torch.py --smoke --device cpu  # toy sizes, plain versions

``--smoke`` runs every leg at toy sizes (``SMOKE_DEFAULTS``; explicitly set
BENCH_* values win): a check that the harness works, not a measurement.
``--device`` defaults to ``cuda``, which exits 1 without a card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from decimal import Decimal

import torch

from krr_tpu_torch.ops import cuda_select, cuda_sketch, digest, topk_sketch
from krr_tpu_torch.ops.digest import DigestSpec
from krr_tpu_torch.utils.device import resolve_device

#: Where the round records (``BENCH_TORCH_r<NN>.json``) and the end-to-end
#: script live.
ROUNDS_DIR = os.path.dirname(os.path.abspath(__file__))
E2E_SCRIPT = os.path.join(ROUNDS_DIR, "bench_e2e_torch.py")
ROUND_PREFIX = "BENCH_TORCH_r"

#: The kernels the legs launch on the card: the headline's (``bisect_select``,
#: ``row_max``), the top-K leg's and the digest leg's.
KERNELS = ("bisect_select", "row_max", "topk_select", "digest_hist")

#: The end-to-end subprocesses: (tag, extra env, timeout seconds). The main
#: legs and the long full-fleet scan run apart, so one's timeout cannot
#: lose the other's numbers; FLEET_ONLY is cleared on the main-legs call.
E2E_LEGS = (
    ("e2e", {"BENCH_E2E_FLEET_ROWS": "0", "BENCH_E2E_FLEET_ONLY": "0"}, 900),
    ("fleet_e2e", {"BENCH_E2E_FLEET_ONLY": "1"}, 1800),
)


def _time_once(fn) -> float:
    start = time.perf_counter()
    fn()
    return time.perf_counter() - start


def python_reference_seconds_per_container(timesteps: int, sample: int) -> float:
    """Time the reference algorithm (Decimal flatten → percentile-index → max;
    sorted, per its documented intent) on `sample` containers."""
    import numpy as np

    rng = np.random.default_rng(7)
    histories = []
    for _ in range(sample):
        cpu = [Decimal(repr(float(v))) for v in rng.gamma(2.0, 0.05, size=timesteps)]
        mem = [Decimal(repr(float(v))) for v in rng.uniform(1e7, 4e8, size=timesteps)]
        histories.append((cpu, mem))

    start = time.perf_counter()
    for cpu, mem in histories:
        data = sorted(cpu)
        _ = data[int((len(data) - 1) * Decimal(99) / 100)]
        _ = max(mem) * Decimal("1.05")
    return (time.perf_counter() - start) / sample


SMOKE_DEFAULTS = {
    "BENCH_CONTAINERS": "64",
    "BENCH_TIMESTEPS": "1024",
    "BENCH_RUNS": "1",
    "BENCH_PIPELINE_DEPTH": "2",
    "BENCH_PY_SAMPLE": "1",
    "BENCH_PARITY_ROWS": "8",
    # bench_e2e_torch subprocess legs, toy-sized but all executed, the
    # full-fleet streamed-pipeline leg (FLEET_ROWS) included.
    "BENCH_E2E_CONTAINERS": "8",
    "BENCH_E2E_SAMPLES": "48",
    "BENCH_E2E_INGEST_ROWS": "64",
    "BENCH_E2E_STORE_ROWS": "256",
    "BENCH_E2E_FLEET_ROWS": "12",
    # History-journal leg (host-only): append/compaction throughput plus a
    # diff render through the formatter registry, all executed at toy scale.
    "BENCH_JOURNAL_ROWS": "32",
    "BENCH_JOURNAL_TICKS": "4",
    # Tracing-overhead legs: the traced-vs-no-op scan pair and the
    # instrumented run_batch still execute at toy scale (the <2% gates lean
    # on their 10 ms noise floor).
    "BENCH_OBS_ROWS": "48",
    "BENCH_OBS_SAMPLES": "1024",
    "BENCH_OBS_RUNS": "3",
    # Chaos leg: archetype fleet + scripted fault timeline through real
    # serve ticks, at toy scale but with every gate executed.
    "BENCH_CHAOS_TICKS": "8",
    "BENCH_CHAOS_WORKLOADS": "2",
    # Eval leg: strategy + probe replays over a labeled archetype fleet
    # (determinism + ranking gates executed at toy scale).
    "BENCH_EVAL_SAMPLES": "96",
    "BENCH_EVAL_WORKLOADS": "1",
    "BENCH_EVAL_TICKS": "6",
    # Discovery leg: watch-reconcile vs per-round relist at equal fleet
    # width with injected churn (bit-exactness + reconcile-beats-relist
    # gates executed at toy scale).
    "BENCH_DISCOVERY_WORKLOADS": "120",
    "BENCH_DISCOVERY_ROUNDS": "3",
    # Durable-store legs: delta-append vs legacy full rewrite + recovery
    # replay at toy row counts, and the kill-recover-verify soak (real
    # SIGKILLed serve subprocesses) with a reduced kill budget.
    "BENCH_STORE_ROWS": "512",
    "BENCH_STORE_KILLS": "2",
    "BENCH_STORE_KILL_TICKS": "6",
    # Wire leg: compressed + downsampled scan vs the identity/raw control
    # (bit-exactness, engagement, and wire_compression_ratio gates).
    "BENCH_WIRE_WORKLOADS": "2",
    "BENCH_WIRE_SAMPLES": "120",
    # Federation leg: N in-process shards vs the single-process control
    # (merged-store bit-exactness + engagement gates; fold seconds and
    # delta wire bytes trended).
    "BENCH_FED_SHARDS": "3",
    "BENCH_FED_TICKS": "4",
    "BENCH_FED_WORKLOADS": "2",
    # HA leg: 2-node ring (primary|standby pair + single) with a mid-soak
    # primary kill, duplicate injection, and a read replica (bit-exactness,
    # zero-lost-epochs, replica RPS scaling gates), toy-sized.
    "BENCH_HA_TICKS": "4",
    "BENCH_HA_WORKLOADS": "2",
    "BENCH_HA_CLIENTS": "2",
    "BENCH_HA_REQUESTS": "16",
    # Fleet-observability leg: 2 shards + aggregator + replica with every
    # trace ring recording, stitched-trace / lineage-monotonicity /
    # <2%-overhead gates all executed against the no-lineage control.
    "BENCH_FLEETOBS_TICKS": "3",
    "BENCH_FLEETOBS_WORKLOADS": "2",
    # Read-path leg: concurrent keep-alive readers against a live serve
    # (cache hit rate, 304 zero-render, pushdown bit-exactness, LRU bound,
    # cached-vs-uncached RPS), toy-sized but every gate executed.
    "BENCH_READPATH_WORKLOADS": "12",
    "BENCH_READPATH_CLIENTS": "4",
    "BENCH_READPATH_REQUESTS": "36",
    # Push-ingest leg: remote-write-fed serve vs the range-fetched pull
    # control (bit-exactness + zero-range-queries + push-beats-pull gates;
    # decode/ingest samples-per-second ceiling trended).
    "BENCH_INGEST_WORKLOADS": "24",
    "BENCH_INGEST_ROUNDS": "3",
}


def generate(n: int, t: int, chunk: int, seed: int, device):
    """An ``[n, t]`` float32 matrix of right-skewed CPU-like values
    ``u·u·0.8 + 1e-4`` (``u`` uniform in [0, 1)), filled in place on
    ``device`` one ``chunk``-column block at a time from a generator seeded
    with ``seed``, so no temporary is larger than a block."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    out = torch.empty((n, t), dtype=torch.float32, device=device)
    for start in range(0, t, chunk):
        block = out[:, start:start + chunk]
        block.uniform_(0.0, 1.0, generator=gen)
        block.mul_(block).mul_(0.8).add_(1e-4)
    return out


def topk_step(values, counts, k: int):
    """The top-K leg's program: the exact sketch built by one
    ``topk_select`` launch over the resident window, then its p99 and its
    peak (the sketch's top-1, no second pass), stacked ``[2, N]``."""
    sketch = topk_sketch.build_from_packed(values, counts, k=k)
    return torch.stack([topk_sketch.percentile(sketch, 99.0), topk_sketch.peak(sketch)])


def digest_step(spec, values, counts):
    """The digest leg's program: the digest built by one ``digest_hist``
    launch over the resident window, then its p99 and its exact peak,
    stacked ``[2, N]``."""
    d = digest.build_from_packed(spec, values, counts)
    return torch.stack([digest.percentile(spec, d, 99.0), digest.peak(d)])


def same_bits(a, b) -> bool:
    """Bit-for-bit equality of two float32 tensors, NaN payloads included."""
    return a.shape == b.shape and bool(torch.equal(a.view(torch.int32), b.view(torch.int32)))


def nvidia_smi() -> str:
    """The card's name and power limit as ``nvidia-smi`` prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def run_e2e_legs(env: dict, device: str, secondary: dict) -> list[str]:
    """Run the `bench_e2e_torch.py` subprocesses (``E2E_LEGS``), merge each
    payload into ``secondary`` and return one note per leg that failed,
    timed out or returned no payload (also recorded under its tag)."""
    failures = []
    for tag, extra_env, timeout in E2E_LEGS:
        try:
            proc = subprocess.run(
                [sys.executable, E2E_SCRIPT, "--device", device],
                capture_output=True, text=True, timeout=timeout, env={**env, **extra_env},
            )
        except subprocess.TimeoutExpired as e:
            # The child is killed; what it wrote so far may come as bytes.
            partial = e.stderr or ""
            if isinstance(partial, bytes):
                partial = partial.decode(errors="replace")
            for line in partial.splitlines():
                print(line, file=sys.stderr)
            note = f"timed out after {timeout} s"
        else:
            for line in proc.stderr.splitlines():
                print(line, file=sys.stderr)
            lines = proc.stdout.strip().splitlines()
            try:
                payload = json.loads(lines[-1]) if lines else None
            except ValueError:
                payload = None
            if proc.returncode != 0:
                note = f"failed rc={proc.returncode}"
            elif not isinstance(payload, dict) or not payload:
                note = "no payload"
            else:
                secondary.update(payload)
                continue
        secondary[tag] = note
        failures.append(f"{tag}: {note}")
    return failures


class KeepAliveReader:
    """Minimal keep-alive HTTP/1.1 client — dependency-free and thin, so
    read-path measurements read the SERVER, not a client library. Shared by
    the readpath and HA legs (the replica-vs-primary RPS comparison must use
    the identical client on both sides)."""

    def __init__(self, port: int):
        self.port = port
        self.reader = self.writer = None

    async def connect(self):
        import asyncio

        self.reader, self.writer = await asyncio.open_connection("127.0.0.1", self.port)

    async def get(self, target: str, headers: "tuple[tuple[str, str], ...]" = ()):
        request = f"GET {target} HTTP/1.1\r\nHost: bench\r\n" + "".join(
            f"{k}: {v}\r\n" for k, v in headers
        ) + "\r\n"
        start = time.perf_counter()
        self.writer.write(request.encode())
        await self.writer.drain()
        status_line = await self.reader.readline()
        status = int(status_line.split()[1])
        response_headers: dict[str, str] = {}
        while True:
            line = await self.reader.readline()
            if line in (b"\r\n", b"\n", b""):
                break
            name, _, value = line.decode("latin-1").partition(":")
            response_headers[name.strip().lower()] = value.strip()
        length = int(response_headers.get("content-length") or 0)
        body = await self.reader.readexactly(length) if length else b""
        return status, response_headers, body, time.perf_counter() - start

    async def close(self):
        if self.writer is not None:
            self.writer.close()


#: The digest arrays the service legs' store comparisons hold bit for bit.
STORE_ARRAYS = ("cpu_counts", "cpu_total", "cpu_peak", "mem_total", "mem_peak")


def same_array(a, b) -> bool:
    """Bit-for-bit equality of two host arrays: the comparator of the
    ingest, HA and store legs' digest rows."""
    import numpy as np

    return bool(np.array_equal(a, b))


def _service_config(device: str, tick_seconds: float, **overrides):
    """The federation and HA legs' ``Config``: `bench.py`'s, on ``device``."""
    from krr_tpu_torch.core.config import Config

    defaults = dict(
        strategy="tdigest",
        quiet=True,
        server_port=0,
        scan_interval_seconds=tick_seconds,
        hysteresis_enabled=False,
        device=device,
        other_args={"history_duration": 1, "timeframe_duration": 1},
    )
    defaults.update(overrides)
    return Config(**defaults)


def store_leg(secondary: dict, check, env: dict) -> None:
    """Durable-store persistence legs (`krr_tpu_torch.core.durastore`), host
    + disk only: the per-tick delta APPEND vs the legacy full-store rewrite
    at the configured row count, and the recovery replay wall. Two
    parity-style gates:

    * delta-beats-rewrite — a tick's ``store_persist_seconds`` (one WAL
      record: sparse window + fsync) must undercut the legacy
      ``store_legacy_save_seconds`` (whole-state atomic rewrite), which is
      the whole point of the WAL;
    * recovery bit-exactness — reopening the directory (checksummed bases
      + WAL replay) reconstructs the persisted state bit-identically.

    The digests are seeded with numpy, as in `bench.py`: no kernel runs.
    """
    import tempfile

    import numpy as np

    from krr_tpu_torch.core.durastore import DurableStore
    from krr_tpu_torch.core.streaming import DigestStore
    from krr_tpu_torch.ops.digest import DigestSpec

    rows = int(env.get("BENCH_STORE_ROWS", 100_000))
    spec = DigestSpec(gamma=1.01, min_value=1e-7, num_buckets=2560)
    rng = np.random.default_rng(23)
    keys = [f"bench/ns{i % 64}/w{i}/main/Deployment" for i in range(rows)]

    def seasoned_store() -> DigestStore:
        """A store with realistic occupancy: ~40 occupied buckets per row
        (a series' samples land in tens of its 2,560 buckets)."""
        store = DigestStore(spec=spec, keys=list(keys))
        occupied = rng.integers(0, spec.num_buckets, size=(rows, 40))
        vals = rng.integers(1, 50, size=(rows, 40)).astype(np.float32)
        flat = occupied + (np.arange(rows)[:, None] * spec.num_buckets)
        np.add.at(store.cpu_counts.ravel(), flat.ravel(), vals.ravel())
        store.cpu_total[:] = store.cpu_counts.sum(axis=1)
        store.cpu_peak[:] = rng.gamma(2.0, 0.3, rows).astype(np.float32)
        store.mem_total[:] = store.cpu_total
        store.mem_peak[:] = rng.uniform(50, 400, rows).astype(np.float32)
        return store

    def tick_window() -> "tuple[np.ndarray, ...]":
        """One delta tick's whole-fleet contribution: every row touched,
        ~4 occupied buckets each (a short window's samples)."""
        counts = np.zeros((rows, spec.num_buckets), np.float32)
        occupied = rng.integers(0, spec.num_buckets, size=(rows, 4))
        np.add.at(
            counts.ravel(),
            (occupied + np.arange(rows)[:, None] * spec.num_buckets).ravel(),
            1.0,
        )
        totals = counts.sum(axis=1)
        return (
            counts,
            totals,
            rng.gamma(2.0, 0.3, rows).astype(np.float32),
            totals,
            rng.uniform(50, 400, rows).astype(np.float32),
        )

    with tempfile.TemporaryDirectory() as tmp:
        # Legacy control: the monolithic atomic rewrite per tick.
        legacy_path = os.path.join(tmp, "legacy.npz")
        legacy = seasoned_store()
        legacy.extra_meta["serve_last_end"] = 1.0
        start = time.perf_counter()
        legacy.save(legacy_path)
        legacy_seconds = time.perf_counter() - start
        legacy_bytes = os.path.getsize(legacy_path)

        # Sharded store, seasoned identically, one delta tick appended.
        state_path = os.path.join(tmp, "state")
        durable = DurableStore.open(state_path, spec)
        durable.store = seasoned_store()
        durable.store.track_deltas = True
        durable.maybe_compact(force=True)  # base snapshots of the seasoned state
        window = tick_window()
        durable.store.merge_window(keys, *window)
        durable.store.extra_meta["serve_last_end"] = 2.0
        start = time.perf_counter()
        durable.save_delta()
        persist_seconds = time.perf_counter() - start
        wal_bytes = durable._wal_size
        final_counts = durable.store.cpu_counts.copy()
        final_extra = dict(durable.store.extra_meta)
        durable.close()

        start = time.perf_counter()
        recovered = DurableStore.open(state_path, spec)
        recovery_seconds = time.perf_counter() - start
        bitexact = bool(
            recovered.store.keys == keys
            and same_array(recovered.store.cpu_counts, final_counts)
            and recovered.store.extra_meta == final_extra
        )
        recovered.close()

    secondary["store_legacy_save_seconds"] = round(legacy_seconds, 4)
    secondary["store_persist_seconds"] = round(persist_seconds, 4)
    secondary["store_recovery_seconds"] = round(recovery_seconds, 4)
    secondary["store_delta_vs_legacy"] = round(legacy_seconds / max(persist_seconds, 1e-9), 1)
    secondary["store_wal_tick_bytes"] = wal_bytes - 8
    print(
        f"bench: durable store {rows} rows: delta append {persist_seconds * 1e3:.1f} ms "
        f"({wal_bytes - 8} B) vs legacy rewrite {legacy_seconds * 1e3:.1f} ms "
        f"({legacy_bytes} B) -> x{legacy_seconds / max(persist_seconds, 1e-9):.1f}; "
        f"recovery {recovery_seconds * 1e3:.1f} ms, bit-exact: {bitexact}",
        file=sys.stderr,
    )
    check(
        "store_delta_beats_full_rewrite",
        persist_seconds < legacy_seconds,
        f"delta append {persist_seconds:.4f}s vs legacy rewrite {legacy_seconds:.4f}s",
    )
    check("store_recovery_bitexact", bitexact, "recovered state differs")


def store_kill_leg(secondary: dict, check, env: dict, device: str) -> None:
    """Kill-recover-verify at toy scale: a REAL ``krr_tpu_torch`` serve
    subprocess on ``device`` over the chaos fakes, SIGKILLed at random
    points (mid-tick, mid-append, mid-compaction — the compaction floor is
    forced tiny), restarted from the same state directory, then compared
    BIT-exact against a never-killed control run
    (`tests.fakes.torch_chaos.run_kill_soak`). The subprocesses get ``env``
    with this directory put in front of its ``PYTHONPATH``."""
    import tempfile

    from krr_tpu_torch.core.durastore import DurableStore
    from krr_tpu_torch.strategies.tdigest import TDigestStrategySettings
    from tests.fakes.torch_chaos import (
        ORIGIN,
        ArchetypeSpec,
        ServerThread,
        build_fleet,
        run_kill_soak,
        stores_bitexact,
        write_kubeconfig,
    )

    kills = int(env.get("BENCH_STORE_KILLS", 2))
    ticks_n = int(env.get("BENCH_STORE_KILL_TICKS", 6))
    fleet = build_fleet(
        (ArchetypeSpec("diurnal", workloads=2, pods=1),
         ArchetypeSpec("oom-loop", workloads=2, pods=1)),
        samples=240,
        seed=31,
    )
    child_env = {**env, "PYTHONPATH": os.pathsep.join(filter(None, (ROUNDS_DIR, env.get("PYTHONPATH"))))}
    server = ServerThread(fleet.backend).start()
    try:
        with tempfile.TemporaryDirectory() as tmp:
            kubeconfig = write_kubeconfig(os.path.join(tmp, "kubeconfig"), server.url)

            def payload(state_path: str) -> dict:
                return dict(
                    kubeconfig=kubeconfig,
                    prometheus_url=server.url,
                    strategy="tdigest",
                    quiet=True,
                    server_port=0,
                    scan_interval_seconds=300.0,
                    hysteresis_enabled=False,
                    store_compact_min_wal_mb=0.002,
                    prometheus_retry_deadline_seconds=1.0,
                    prometheus_backoff_cap_seconds=0.2,
                    device=device,
                    other_args={
                        "history_duration": 1,
                        "timeframe_duration": 1,
                        "state_path": state_path,
                    },
                )

            ticks = [ORIGIN + 3600.0 + i * 300.0 for i in range(ticks_n)]
            state = os.path.join(tmp, "state")
            control = os.path.join(tmp, "control")
            start = time.perf_counter()
            report = run_kill_soak(
                payload(state), ticks, kills=kills, seed=41,
                cfg_path=os.path.join(tmp, "soak.json"), repo_root=ROUNDS_DIR,
                env=child_env,
            )
            run_kill_soak(
                payload(control), ticks, kills=0, seed=42,
                cfg_path=os.path.join(tmp, "control.json"), repo_root=ROUNDS_DIR,
                env=child_env,
            )
            wall = time.perf_counter() - start
            spec = TDigestStrategySettings().cpu_spec()
            soaked = DurableStore.open(state, spec)
            clean = DurableStore.open(control, spec)
            equal, detail = stores_bitexact(soaked.store, clean.store)
            cursor_equal = (
                soaked.store.extra_meta.get("serve_last_end")
                == clean.store.extra_meta.get("serve_last_end")
            )
            soaked.close()
            clean.close()
    finally:
        server.stop()

    secondary["store_kill_recover_bitexact"] = 1.0 if (equal and cursor_equal) else 0.0
    secondary["store_kill_runs"] = float(report["runs"])
    secondary["store_kills"] = float(report["kills"])
    print(
        f"bench: kill-recover soak {report['kills']} SIGKILLs over {ticks_n} ticks "
        f"({report['runs']} runs, {wall:.1f}s): bit-exact vs control: {equal and cursor_equal}",
        file=sys.stderr,
    )
    check(
        "store_kill_recover_bitexact",
        equal and cursor_equal,
        detail if not equal else "window cursor differs",
    )


def ingest_leg(secondary: dict, check, env: dict, device: str) -> None:
    """Push-ingest gates (`--metrics-mode push`, `krr_tpu_torch.ingest`): a
    remote-write-fed serve and a range-fetched pull control, both on
    ``device``, run the same fleet over byte-identical fake series. Three
    parity-style gates:

    * every round's published result AND the resident digest store stay
      BIT-identical between the push and pull stacks (the audit's contract,
      measured end to end);
    * steady-state push ticks (after the first round's verify audit) issue
      ZERO range queries — pinned on the fake Prometheus request counter;
    * the push tick wall beats the range-fetched control's (the point of
      folding buffered samples instead of re-fetching windows).

    The decode+route+buffer ceiling (samples/s through ``ingest_body``) is
    trended as ``secondary.ingest_samples_per_second``.
    """
    import asyncio
    import statistics
    import tempfile
    import time as _time

    import numpy as np

    from krr_tpu_torch.core.config import Config
    from krr_tpu_torch.ingest import IngestPlane
    from krr_tpu_torch.server.app import KrrServer
    from tests.fakes.remote_write import RemoteWriteSender
    from tests.fakes.servers import FakeBackend, FakeCluster, FakeMetrics, ServerThread
    from tests.fakes.torch_chaos import write_kubeconfig

    workloads = int(env.get("BENCH_INGEST_WORKLOADS", 200))
    rounds = max(2, int(env.get("BENCH_INGEST_ROUNDS", 5)))
    series_len = max(180, 62 + rounds * 10)
    origin = FakeBackend.SERIES_ORIGIN

    def build_env(series: dict):
        cluster = FakeCluster()
        metrics = FakeMetrics()
        metrics.enforce_range = True
        for i in range(workloads):
            namespace = f"ns-{i % 8}"
            for pod in cluster.add_workload_with_pods(
                "Deployment", f"wl-{i}", namespace, pod_count=2
            ):
                cpu, mem = series[(namespace, pod)]
                metrics.set_series(namespace, "main", pod, cpu=cpu, memory=mem)
        return cluster, metrics

    rng = np.random.default_rng(77)
    series = {}
    for i in range(workloads):
        namespace = f"ns-{i % 8}"
        for p in range(2):
            series[(namespace, f"wl-{i}-{p}")] = (
                rng.gamma(2.0, 0.05, series_len),
                rng.uniform(5e7, 4e8, series_len),
            )
    push_cluster, push_metrics = build_env(series)
    pull_cluster, pull_metrics = build_env(series)
    push_server = ServerThread(FakeBackend(push_cluster, push_metrics)).start()
    pull_server = ServerThread(FakeBackend(pull_cluster, pull_metrics)).start()

    try:
        with tempfile.TemporaryDirectory() as tmp:
            push_kube = write_kubeconfig(os.path.join(tmp, "kube-push"), push_server.url)
            pull_kube = write_kubeconfig(os.path.join(tmp, "kube-pull"), pull_server.url)

            def config(kubeconfig, prometheus_url, **overrides) -> Config:
                return Config(
                    kubeconfig=kubeconfig, prometheus_url=prometheus_url,
                    strategy="tdigest", quiet=True, server_port=0,
                    hysteresis_enabled=False,
                    prometheus_breaker_cooldown_seconds=0.02,
                    device=device,
                    other_args={"history_duration": 1, "timeframe_duration": 1},
                    **overrides,
                )

            async def run() -> dict:
                now = [origin + 3600.0]
                push_ks = KrrServer(
                    config(
                        push_kube, push_server.url,
                        metrics_mode="push", ingest_port=0,
                        # One verify round (the first push tick: the audit's
                        # range control is part of the contract), then pure
                        # push — the zero-query regime under measurement.
                        ingest_verify_interval_seconds=1e9,
                    ),
                    clock=lambda: now[0],
                )
                pull_ks = KrrServer(
                    config(pull_kube, pull_server.url), clock=lambda: now[0]
                )
                await push_ks.start(run_scheduler=False)
                await pull_ks.start(run_scheduler=False)
                try:
                    sender = RemoteWriteSender(push_metrics)
                    ingest_port = push_ks.ingest_listener.port
                    assert await push_ks.scheduler.tick()
                    assert await pull_ks.scheduler.tick()
                    push_walls: list[float] = []
                    pull_walls: list[float] = []
                    bitexact = True
                    steady_requests = 0
                    for r in range(1, rounds + 1):
                        now[0] = origin + 3600.0 + 600.0 * r
                        i0, i1 = 61 + (r - 1) * 10, 60 + r * 10
                        status = await sender.push(ingest_port, i0, i1)
                        assert status == 204, f"push round {r}: HTTP {status}"
                        requests_before = push_metrics.request_count
                        t0 = _time.perf_counter()
                        assert await push_ks.scheduler.tick()
                        push_walls.append(_time.perf_counter() - t0)
                        if r > 1:  # round 1 runs the verify audit's fetch
                            steady_requests += push_metrics.request_count - requests_before
                        t0 = _time.perf_counter()
                        assert await pull_ks.scheduler.tick()
                        pull_walls.append(_time.perf_counter() - t0)
                        bitexact = bitexact and (
                            push_ks.state.peek().result.format("json")
                            == pull_ks.state.peek().result.format("json")
                        )
                    store_equal = all(
                        same_array(getattr(push_ks.state.store, field),
                                   getattr(pull_ks.state.store, field))
                        for field in STORE_ARRAYS
                    )
                    ingest_stats = push_ks.ingest.stats()
                    return {
                        "push_seconds": statistics.median(push_walls),
                        "pull_seconds": statistics.median(pull_walls),
                        "bitexact": bitexact and store_equal,
                        "steady_requests": steady_requests,
                        "rejected": sum(ingest_stats["rejected"].values()),
                    }
                finally:
                    await push_ks.shutdown()
                    await pull_ks.shutdown()

            report = asyncio.run(run())
    finally:
        push_server.stop()
        pull_server.stop()

    # Decode+route+buffer ceiling, off the serve path: successive window
    # bodies through a fresh plane, wall-clocked end to end.
    plane = IngestPlane(max_samples_per_series=1 << 20)
    sender = RemoteWriteSender(push_metrics)
    chunk = 30
    bodies = [
        sender.frames(i, min(i + chunk - 1, series_len - 1))
        for i in range(0, series_len, chunk)
    ]
    t0 = _time.perf_counter()
    accepted = sum(plane.ingest_body(body) for body in bodies)
    ingest_wall = _time.perf_counter() - t0
    samples_per_second = accepted / max(ingest_wall, 1e-9)

    check("push_ingest_bitexact", report["bitexact"], "push stack diverged from pull control")
    check(
        "push_zero_range_queries",
        report["steady_requests"] == 0,
        f"{report['steady_requests']} range queries during steady-state push ticks",
    )
    check(
        "push_tick_beats_pull",
        report["push_seconds"] < report["pull_seconds"],
        f"push {report['push_seconds']:.4f}s vs pull {report['pull_seconds']:.4f}s",
    )
    secondary["ingest_workloads"] = float(workloads)
    secondary["ingest_rounds"] = float(rounds)
    secondary["ingest_push_tick_seconds"] = round(report["push_seconds"], 4)
    secondary["ingest_pull_tick_seconds"] = round(report["pull_seconds"], 4)
    secondary["ingest_tick_speedup"] = round(
        report["pull_seconds"] / max(report["push_seconds"], 1e-9), 1
    )
    secondary["ingest_samples_per_second"] = round(samples_per_second)
    secondary["ingest_bitexact"] = 1.0 if report["bitexact"] else 0.0
    secondary["ingest_zero_range_queries"] = 1.0 if report["steady_requests"] == 0 else 0.0
    secondary["ingest_rejected_samples"] = float(report["rejected"])
    print(
        f"bench: ingest leg {workloads} workloads x {rounds} rounds: push tick "
        f"{report['push_seconds'] * 1e3:.1f}ms vs pull {report['pull_seconds'] * 1e3:.1f}ms "
        f"({secondary['ingest_tick_speedup']}x), decode ceiling "
        f"{samples_per_second / 1e6:.2f}M samples/s, bitexact={report['bitexact']}",
        file=sys.stderr,
    )


def federation_leg(secondary: dict, check, env: dict, device: str) -> None:
    """Federation gates (`krr_tpu_torch.federation`): N in-process scanner
    shards stream their ticks' delta-WAL records over real TCP to an
    aggregator serve, against a single-process control scanning the same
    fleet; every composition on ``device``. Two parity-style gates:

    * bit-exactness — the aggregator's merged DigestStore is bit-identical
      (per key) to the single-process control's after every tick applies;
    * engagement — every shard connected, records actually flowed, and the
      aggregate ticks applied them (a silently idle federation must fail,
      not trend zeros).

    Trended: ``federation_fold_seconds`` (aggregate-tick replay cost, the
    sum of the apply histogram) and ``federation_wire_bytes`` (delta record
    payload bytes on the wire per run), under ``secondary.federation_*``.
    """
    import asyncio
    import time as _time

    from krr_tpu_torch.core.runner import ScanSession
    from krr_tpu_torch.federation.shard import FederatedShard
    from krr_tpu_torch.server.app import KrrServer
    from tests.fakes.torch_federation import (
        FleetInventory,
        MultiClusterFleet,
        ORIGIN,
        history_factory,
        stores_bitexact_by_key,
    )

    shards_n = max(2, int(env.get("BENCH_FED_SHARDS", 3)))
    ticks = max(2, int(env.get("BENCH_FED_TICKS", 4)))
    workloads = max(1, int(env.get("BENCH_FED_WORKLOADS", 2)))
    tick_seconds = 300.0
    start = ORIGIN + 3600.0
    fleet = MultiClusterFleet(
        clusters=shards_n,
        namespaces_per_cluster=2,
        workloads_per_namespace=workloads,
        seed=53,
    )

    def config(**overrides):
        return _service_config(device, tick_seconds, **overrides)

    async def run() -> dict:
        now = [start]

        # Single-process control over the whole fleet.
        control = KrrServer(
            config(),
            session=ScanSession(
                config(),
                inventory=FleetInventory(fleet),
                history_factory=history_factory(fleet),
            ),
            clock=lambda: now[0],
        )
        for t in range(ticks):
            now[0] = start + t * tick_seconds
            assert await control.scheduler.run_once()

        # Federated: aggregator serve + one in-process shard per cluster,
        # over real TCP.
        now[0] = start
        server = KrrServer(
            config(federation_listen="127.0.0.1:0"),
            session=ScanSession(
                config(),
                inventory=FleetInventory(fleet, clusters=[]),
                history_factory=history_factory(fleet),
            ),
            clock=lambda: now[0],
        )
        await server.start(run_scheduler=False)
        shards = [
            FederatedShard(
                config(
                    clusters=[c],
                    federation_aggregator=f"127.0.0.1:{server.aggregator.port}",
                ),
                session=ScanSession(
                    config(clusters=[c]),
                    inventory=FleetInventory(fleet, clusters=[c]),
                    history_factory=history_factory(fleet),
                ),
                clock=lambda: now[0],
                shard_id=c,
            )
            for c in fleet.clusters
        ]
        try:
            for t in range(ticks):
                now[0] = start + t * tick_seconds
                for shard in shards:
                    assert await shard.tick(now[0])
                agg = server.aggregator
                deadline = _time.monotonic() + 30.0
                while not all(
                    s.shard_id in agg._shards
                    and agg._shards[s.shard_id].enqueued >= s.epoch
                    for s in shards
                ):
                    assert _time.monotonic() < deadline, "aggregator never received"
                    await asyncio.sleep(0.01)
                assert await server.scheduler.run_once()
                for shard in shards:
                    assert await shard.wait_acked(shard.epoch, timeout=10.0)
            metrics = server.state.metrics
            equal, detail = stores_bitexact_by_key(
                server.state.store, control.state.store
            )
            return {
                "equal": equal,
                "detail": detail,
                "connected": metrics.value("krr_tpu_federation_connected_shards") or 0.0,
                "records": metrics.total("krr_tpu_federation_records_total"),
                "wire_bytes": metrics.total("krr_tpu_federation_bytes_total"),
                "fold_seconds": metrics.total("krr_tpu_federation_apply_seconds_sum"),
                "applied": sum(s.applied for s in agg._shards.values()),
                "rows": len(server.state.store.keys),
            }
        finally:
            for shard in shards:
                await shard.close()
            await server.shutdown()
            await control.shutdown()

    report = asyncio.run(run())
    secondary["federation_shards"] = float(shards_n)
    secondary["federation_ticks"] = float(ticks)
    secondary["federation_rows"] = float(report["rows"])
    secondary["federation_records"] = report["records"]
    secondary["federation_wire_bytes"] = report["wire_bytes"]
    secondary["federation_fold_seconds"] = round(report["fold_seconds"], 4)
    secondary["federation_bitexact"] = 1.0 if report["equal"] else 0.0
    print(
        f"bench: federation {shards_n} shards x {ticks} ticks -> "
        f"{report['records']:.0f} records / {report['wire_bytes'] / 1e3:.1f} KB wire, "
        f"aggregate fold {report['fold_seconds']:.4f}s, "
        f"merged store bit-exact: {report['equal']}",
        file=sys.stderr,
    )
    check("federation_bitexact", report["equal"], report["detail"])
    check(
        "federation_engaged",
        report["connected"] == shards_n
        and report["records"] >= shards_n * ticks
        and report["applied"] >= shards_n * ticks
        and report["wire_bytes"] > 0,
        f"connected={report['connected']}, records={report['records']}, "
        f"applied={report['applied']}, wire={report['wire_bytes']}",
    )


def ha_leg(secondary: dict, check, env: dict, device: str) -> None:
    """HA aggregation + read-replica gates (`krr_tpu_torch.federation.ring` /
    `krr_tpu_torch.federation.replica`): a 2-node consistent-hash ring — node
    ``a0`` an HA primary|standby pair sharing the replicated delta-WAL
    stream, node ``a1`` a single aggregator — fed by one shard per
    cluster, plus one stateless read replica subscribed to ``a1``'s epoch
    feed; every composition on ``device``. The soak kills ``a0``'s primary
    mid-run and force-feeds the standby a duplicate record (disconnect
    after enqueue, before the aggregate tick acks) to exercise the
    exactly-once watermark. Gates:

    * ``ha_bitexact`` — the union of the surviving aggregators' stores
      and served response scans is bit-identical, per key, to a
      single-process control over the same fleet;
    * ``ha_failover_zero_lost_epochs`` — after the kill, every shard
      epoch is acked and applied exactly once at the survivors, with the
      injected duplicate COUNTED (never double-applied: bit-exactness
      above would fail);
    * ``replica_rps_scaling`` — the replica serves the identical bytes
      at >= 90% of its source aggregator's RPS under the same keep-alive
      client mix, so N replicas multiply read capacity. Each RPS is the
      median of ten interleaved runs (`bench.py`: the best of two, source
      first; see the measurement below).

    Trended under ``secondary.ha_*``: tick count, duplicate count,
    replica/primary RPS and their ratio.
    """
    import asyncio
    import statistics
    import time as _time

    from krr_tpu_torch.core.runner import ScanSession
    from krr_tpu_torch.federation.replica import ReplicaServer
    from krr_tpu_torch.federation.shard import FederatedShard
    from krr_tpu_torch.server.app import KrrServer
    from tests.fakes.torch_federation import (
        FleetInventory,
        MultiClusterFleet,
        ORIGIN,
        history_factory,
    )

    ticks = max(3, int(env.get("BENCH_HA_TICKS", 4)))
    workloads = max(1, int(env.get("BENCH_HA_WORKLOADS", 2)))
    clients = max(2, int(env.get("BENCH_HA_CLIENTS", 4)))
    requests_per_client = max(8, int(env.get("BENCH_HA_REQUESTS", 40)))
    tick_seconds = 300.0
    start = ORIGIN + 3600.0
    fleet = MultiClusterFleet(
        clusters=2,
        namespaces_per_cluster=2,
        workloads_per_namespace=workloads,
        seed=59,
    )

    def config(**overrides):
        return _service_config(device, tick_seconds, **overrides)

    def scans_by_key(state) -> dict:
        body = json.loads(state.peek().body_json.decode())
        return {
            "{cluster}/{namespace}/{name}/{container}/{kind}".format(**scan["object"]): scan
            for scan in body["scans"]
        }

    async def run() -> dict:
        now = [start]

        def aggregator():
            return KrrServer(
                config(federation_listen="127.0.0.1:0"),
                session=ScanSession(
                    config(),
                    inventory=FleetInventory(fleet, clusters=[]),
                    history_factory=history_factory(fleet),
                ),
                clock=lambda: now[0],
            )

        # Single-process control over the whole fleet.
        control = KrrServer(
            config(),
            session=ScanSession(
                config(),
                inventory=FleetInventory(fleet),
                history_factory=history_factory(fleet),
            ),
            clock=lambda: now[0],
        )
        for t in range(ticks):
            now[0] = start + t * tick_seconds
            assert await control.scheduler.run_once()

        now[0] = start
        primary, standby, single = aggregator(), aggregator(), aggregator()
        for server in (primary, standby, single):
            await server.start(run_scheduler=False)
        ring_spec = (
            f"a0=127.0.0.1:{primary.aggregator.port}|127.0.0.1:{standby.aggregator.port},"
            f"a1=127.0.0.1:{single.aggregator.port}"
        )
        shards = [
            FederatedShard(
                config(clusters=[c], federation_ring=ring_spec),
                session=ScanSession(
                    config(clusters=[c]),
                    inventory=FleetInventory(fleet, clusters=[c]),
                    history_factory=history_factory(fleet),
                ),
                clock=lambda: now[0],
                shard_id=c,
            )
            for c in fleet.clusters
        ]
        replica = ReplicaServer(
            config(
                federation_aggregator=f"127.0.0.1:{single.aggregator.port}",
                federation_shard_id="bench-replica",
            ),
            clock=lambda: now[0],
        )
        await replica.start()
        primary_dead = [False]

        async def wait(predicate, message, timeout=30.0):
            deadline = _time.monotonic() + timeout
            while not predicate():
                assert _time.monotonic() < deadline, f"ha: timed out waiting for {message}"
                await asyncio.sleep(0.01)

        def live_servers():
            return [standby, single] if primary_dead[0] else [primary, standby, single]

        async def ring_round(t: int) -> None:
            now[0] = start + t * tick_seconds
            for shard in shards:
                assert await shard.tick(now[0])
            by_port = {s.aggregator.port: s for s in live_servers()}

            def enqueued() -> bool:
                for shard in shards:
                    for uplink in shard._uplinks:
                        server = by_port.get(uplink.port)
                        if server is None:
                            continue  # the killed primary
                        status = server.aggregator._shards.get(uplink.stream_id)
                        if status is None or status.enqueued < shard.epoch:
                            return False
                return True

            await wait(enqueued, f"tick {t} records to enqueue everywhere")
            for server in live_servers():
                assert await server.scheduler.run_once()
            for shard in shards:
                for uplink in shard._uplinks:
                    if uplink.port in by_port:
                        await wait(
                            lambda u=uplink, s=shard: u.acked >= s.epoch,
                            f"tick {t} acks",
                        )

        try:
            await ring_round(0)

            # Duplicate injection: tick, wait for the standby to ENQUEUE the
            # epoch-2 records, then tear its connections before the aggregate
            # tick acks them. The reconnect's WELCOME reports the APPLIED
            # watermark (1), so the shard re-sends epoch 2 — which the standby
            # must count as a duplicate and never double-apply.
            now[0] = start + 1 * tick_seconds
            for shard in shards:
                assert await shard.tick(now[0])
            await wait(
                lambda: all(
                    server.aggregator._shards.get(f"{s.shard_id}/{node}") is not None
                    and server.aggregator._shards[f"{s.shard_id}/{node}"].enqueued >= s.epoch
                    for s in shards
                    for server, node in ((primary, "a0"), (standby, "a0"), (single, "a1"))
                ),
                "tick 2 records to enqueue before the tear",
            )
            for shard in shards:
                shard._node_uplinks["a0"][1]._disconnect()
                await shard._pump()
            await wait(
                lambda: sum(s.duplicates for s in standby.aggregator._shards.values())
                >= len(shards),
                "re-sent records to count as duplicates",
            )
            for server in (primary, standby, single):
                assert await server.scheduler.run_once()
            for shard in shards:
                assert await shard.wait_acked(shard.epoch, timeout=10.0)
            duplicates = int(
                sum(s.duplicates for s in standby.aggregator._shards.values())
            )

            # Kill the HA pair's primary; the soak continues on the standby.
            await primary.shutdown()
            primary_dead[0] = True
            for t in range(2, ticks):
                await ring_round(t)

            # Gate 1: union of the surviving ring stores + served scans is
            # bit-exact, per key, against the single-process control.
            control_store = control.state.store
            control_index = {k: i for i, k in enumerate(control_store.keys)}
            merged_keys: list = []
            bitexact, detail = True, ""
            for server in (standby, single):
                store = server.state.store
                for i, key in enumerate(store.keys):
                    merged_keys.append(key)
                    j = control_index.get(key)
                    if j is None:
                        bitexact, detail = False, f"unexpected key {key}"
                        continue
                    for attr in STORE_ARRAYS:
                        if not same_array(
                            getattr(store, attr)[i], getattr(control_store, attr)[j]
                        ):
                            bitexact, detail = False, f"{attr} differs at {key}"
            if sorted(merged_keys) != sorted(control_store.keys):
                bitexact, detail = False, "merged ring keys != control keys"
            control_scans = scans_by_key(control.state)
            served: dict = {}
            for server in (standby, single):
                served.update(scans_by_key(server.state))
            if served != control_scans:
                bitexact, detail = False, "served response scans != control scans"

            # Gate 2: zero lost epochs, exactly-once apply at the survivors.
            survivor_ports = {standby.aggregator.port, single.aggregator.port}
            lost = [
                (uplink.stream_id, uplink.port, uplink.acked, shard.epoch)
                for shard in shards
                for uplink in shard._uplinks
                if uplink.port in survivor_ports and uplink.acked != shard.epoch
            ]
            applied_ok = all(
                s.applied == ticks
                for server in (standby, single)
                for s in server.aggregator._shards.values()
            )

            # Gate 3: replica converges on the source's published epoch and
            # serves byte-identical bodies at matching RPS.
            await wait(
                lambda: replica.state.publish_epoch == single.state.publish_epoch
                and replica.state.publish_epoch > 0,
                "replica to converge on the source epoch",
            )

            async def one_get(port: int):
                reader = KeepAliveReader(port)
                await reader.connect()
                try:
                    return await reader.get("/recommendations")
                finally:
                    await reader.close()

            src_status, src_headers, src_body, _ = await one_get(single.port)
            rep_status, rep_headers, rep_body, _ = await one_get(replica.port)
            replica_identical = (
                src_status == rep_status == 200
                and src_body == rep_body
                and src_headers.get("etag") == rep_headers.get("etag")
                and src_headers.get("x-krr-epoch") == rep_headers.get("x-krr-epoch")
            )

            async def measure_rps(port: int) -> float:
                readers = [KeepAliveReader(port) for _ in range(clients)]
                for r in readers:
                    await r.connect()
                latencies: list = []

                async def worker(r) -> None:
                    for _ in range(requests_per_client):
                        status, _headers, body, latency = await r.get("/recommendations")
                        assert status == 200 and body, f"ha reader got {status}"
                        latencies.append(latency)

                begun = _time.perf_counter()
                await asyncio.gather(*(worker(r) for r in readers))
                wall = _time.perf_counter() - begun
                for r in readers:
                    await r.close()
                return len(latencies) / max(wall, 1e-9)

            # The gate compares the two, not an absolute throughput. One
            # server's read rate moves by a quarter between consecutive
            # runs of the same load (both serve through the same
            # `HttpApp`), so `bench.py`'s best of two, source first, reads
            # that noise: each side's rate here is the median of ten runs
            # interleaved source, replica, replica, source, so a drift
            # during the reads lands on both sides alike.
            rps = {single.port: [], replica.port: []}
            for port in (single.port, replica.port, replica.port, single.port) * 5:
                rps[port].append(await measure_rps(port))
            primary_rps = statistics.median(rps[single.port])
            replica_rps = statistics.median(rps[replica.port])

            return {
                "bitexact": bitexact,
                "detail": detail,
                "duplicates": duplicates,
                "lost": lost,
                "applied_ok": applied_ok,
                "replica_identical": replica_identical,
                "primary_rps": primary_rps,
                "replica_rps": replica_rps,
                "rows": len(control_store.keys),
            }
        finally:
            for shard in shards:
                await shard.close()
            await replica.shutdown()
            for server in (primary, standby, single):
                await server.shutdown()
            await control.shutdown()

    report = asyncio.run(run())
    ratio = report["replica_rps"] / max(report["primary_rps"], 1e-9)
    secondary["ha_ticks"] = float(ticks)
    secondary["ha_rows"] = float(report["rows"])
    secondary["ha_duplicates"] = float(report["duplicates"])
    secondary["ha_primary_rps"] = round(report["primary_rps"], 1)
    secondary["ha_replica_rps"] = round(report["replica_rps"], 1)
    secondary["ha_replica_rps_ratio"] = round(ratio, 3)
    secondary["ha_bitexact"] = 1.0 if report["bitexact"] else 0.0
    secondary["ha_failover_zero_lost_epochs"] = (
        1.0 if not report["lost"] and report["applied_ok"] else 0.0
    )
    print(
        f"bench: ha 2-node ring x {ticks} ticks -> primary killed, "
        f"{report['duplicates']} duplicate(s) absorbed, merged bit-exact: "
        f"{report['bitexact']}; replica {report['replica_rps']:.0f} rps vs "
        f"source {report['primary_rps']:.0f} rps (ratio {ratio:.2f})",
        file=sys.stderr,
    )
    check("ha_bitexact", report["bitexact"], report["detail"])
    check(
        "ha_failover_zero_lost_epochs",
        not report["lost"] and report["applied_ok"] and report["duplicates"] >= 2,
        f"lost={report['lost']}, applied_ok={report['applied_ok']}, "
        f"duplicates={report['duplicates']}",
    )
    check(
        "replica_rps_scaling",
        report["replica_identical"] and ratio >= 0.9,
        f"identical={report['replica_identical']}, replica={report['replica_rps']:.0f} "
        f"rps, source={report['primary_rps']:.0f} rps, ratio={ratio:.2f}",
    )


def readpath_leg(secondary: dict, check, env: dict, device: str) -> None:
    """High-QPS read-path loadtest (`krr_tpu_torch.server.state.ResponseCache`
    + the app's conditional-GET / pushdown / bounded-render machinery):
    concurrent keep-alive readers hammer a LIVE serve on ``device`` — mixed
    formats, filters, pagination, compressed variants, and conditional
    revalidations — WHILE scheduler ticks publish underneath, against an
    uncached (`--no-response-cache`) control serving the same fleet.
    Records p50/p99 latency, RPS, cache hit rate, and bytes served under
    ``secondary.readpath_*``. Six parity-style gates:

    * steady-state cache hit rate ≥ 99% (hysteresis-quiet publishes keep
      the epoch, so the warm cache survives live ticks);
    * conditional revalidations return 304 with ZERO render work (the miss
      counter must not move under an If-None-Match burst);
    * filtered + paginated responses bit-identical to the pre-cache
      render-then-slice path on the same snapshot;
    * gzip variants round-trip to the identity bytes;
    * the LRU stays inside its entry/byte bounds under a
      filter-cardinality attack;
    * cached RPS beats the uncached control (≥ 10× at fleet scale,
      ≥ 2× at toy scale where render cost barely exceeds HTTP overhead).
    """
    import asyncio
    import gzip as _gzip

    import numpy as np

    from krr_tpu_torch.core.config import Config
    from krr_tpu_torch.core.runner import ScanSession
    from krr_tpu_torch.models.allocations import ResourceAllocations, ResourceType
    from krr_tpu_torch.models.objects import K8sObjectData
    from krr_tpu_torch.models.result import Result
    from krr_tpu_torch.server.app import KrrServer

    workloads = int(env.get("BENCH_READPATH_WORKLOADS", 400))
    clients = int(env.get("BENCH_READPATH_CLIENTS", 8))
    requests_per_client = int(env.get("BENCH_READPATH_REQUESTS", 120))
    control_requests = max(8, requests_per_client // 6)

    alloc = ResourceAllocations(
        requests={ResourceType.CPU: None, ResourceType.Memory: None},
        limits={ResourceType.CPU: None, ResourceType.Memory: None},
    )
    objects = [
        K8sObjectData(
            cluster="c", namespace=f"ns{i % 8}", name=f"w{i}", kind="Deployment",
            container="main", pods=[f"w{i}-0"], allocations=alloc,
        )
        for i in range(workloads)
    ]
    rng = np.random.default_rng(61)
    cpu_series = rng.gamma(2.0, 0.05, (workloads, 12))
    mem_series = rng.uniform(5e7, 4e8, (workloads, 12))
    by_name = {obj.name: i for i, obj in enumerate(objects)}

    class Inventory:
        async def list_clusters(self):
            return ["c"]

        async def list_scannable_objects(self, clusters):
            return list(objects)

    class Source:
        """Deterministic: the full backfill window carries the fleet's
        samples, delta windows are QUIET (no new samples — a no-op fold),
        so every live publish is byte-identical and the epoch holds — the
        hysteresis steady state the cache is designed for."""

        async def gather_fleet(self, objs, history_seconds, step_seconds, **kw):
            rows = [by_name[obj.name] for obj in objs]
            if history_seconds < 3000:  # a delta tick, not the backfill
                quiet = np.empty(0)
                return {
                    resource: [{obj.pods[0]: quiet} for obj in objs]
                    for resource in (ResourceType.CPU, ResourceType.Memory)
                }
            return {
                ResourceType.CPU: [{objs[j].pods[0]: cpu_series[i]} for j, i in enumerate(rows)],
                ResourceType.Memory: [{objs[j].pods[0]: mem_series[i]} for j, i in enumerate(rows)],
            }

    def build_server(now, **overrides) -> KrrServer:
        config = Config(
            strategy="tdigest", quiet=True, server_port=0,
            hysteresis_enabled=False,
            response_cache_max_entries=64,
            device=device,
            other_args={"history_duration": 1, "timeframe_duration": 1},
            **overrides,
        )
        session = ScanSession(
            config, inventory=Inventory(), history_factory=lambda cluster: Source()
        )
        return KrrServer(config, session=session, clock=lambda: now[0])

    Reader = KeepAliveReader

    GZIP = (("Accept-Encoding", "gzip"),)

    async def run() -> dict:
        now = [1_700_000_000.0]
        ks = build_server(now)
        await ks.start(run_scheduler=False)
        control = build_server([now[0]], response_cache_enabled=False)
        await control.start(run_scheduler=False)
        try:
            assert await ks.scheduler.run_once()
            assert await control.scheduler.run_once()
            metrics = ks.state.metrics
            prime = Reader(ks.port)
            await prime.connect()

            _status, h, identity_body, _ = await prime.get("/recommendations")
            etag = h["etag"]
            #: The cacheable mix (distinct cache keys), primed once so the
            #: timed phase measures STEADY STATE.
            mix = [
                ("/recommendations", GZIP),
                ("/recommendations?format=yaml", ()),
                ("/recommendations?namespace=ns1", ()),
                ("/recommendations?limit=20&offset=40", ()),
            ]
            for target, headers in mix:
                status, _h, _b, _lat = await prime.get(target, headers)
                assert status == 200, (target, status)

            # Gate: pushdown bit-identity vs the render-then-slice oracle.
            snapshot = ks.state.peek()

            def golden(fmt="json", namespaces=(), limit=None, offset=0) -> bytes:
                scans = [
                    s for s in snapshot.result.scans
                    if not namespaces or s.object.namespace in namespaces
                ]
                scans = scans[offset:(offset + limit) if limit else None]
                return Result(scans=scans).format(fmt).encode()

            _s, _h, filtered, _lat = await prime.get("/recommendations?namespace=ns1")
            _s, _h, paged, _lat = await prime.get("/recommendations?limit=20&offset=40")
            _s, _h, fyaml, _lat = await prime.get("/recommendations?format=yaml&namespace=ns2")
            pushdown_ok = (
                filtered == golden(namespaces={"ns1"})
                and paged == golden(limit=20, offset=40)
                and fyaml == golden("yaml", namespaces={"ns2"})
            )

            # Gate: gzip round-trips to the identity bytes.
            _s, gz_headers, gz_body, _lat = await prime.get("/recommendations", GZIP)
            gzip_ok = (
                gz_headers.get("content-encoding") == "gzip"
                and _gzip.decompress(gz_body) == identity_body
            )

            # Gate: 304 revalidations do ZERO render work.
            misses_before = metrics.total("krr_tpu_http_cache_misses_total")
            revalidations = 0
            for _ in range(32):
                status, _h, body, _lat = await prime.get(
                    "/recommendations", (("If-None-Match", etag),)
                )
                revalidations += int(status == 304 and body == b"")
            zero_render_304 = (
                revalidations == 32
                and metrics.total("krr_tpu_http_cache_misses_total") == misses_before
            )

            # Timed steady-state phase: concurrent keep-alive readers over
            # the full mix (bare identity + cached variants + conditionals)
            # WHILE scheduler ticks publish underneath.
            hits_before = metrics.total("krr_tpu_http_cache_hits_total")
            misses_before = metrics.total("krr_tpu_http_cache_misses_total")
            cycle = [
                ("/recommendations", ()),
                ("/recommendations", (("If-None-Match", etag),)),
                *mix,
            ]
            latencies: list[float] = []
            served_bytes = [0]

            async def reader_task(reader: Reader, n: int) -> None:
                for i in range(n):
                    target, headers = cycle[i % len(cycle)]
                    status, _h, body, latency = await reader.get(target, headers)
                    assert status in (200, 304), (target, status)
                    latencies.append(latency)
                    served_bytes[0] += len(body)

            readers = [Reader(ks.port) for _ in range(clients)]
            for reader in readers:
                await reader.connect()
            wall_start = time.perf_counter()
            tasks = [
                asyncio.create_task(reader_task(reader, requests_per_client))
                for reader in readers
            ]
            # Live publishes mid-load: byte-identical content keeps the
            # epoch (suppression discipline), so the cache must stay warm.
            for _ in range(2):
                await asyncio.sleep(0.02)
                now[0] += 120.0
                assert await ks.scheduler.run_once()
            await asyncio.gather(*tasks)
            wall = time.perf_counter() - wall_start
            for reader in readers:
                await reader.close()

            hits = metrics.total("krr_tpu_http_cache_hits_total") - hits_before
            misses = metrics.total("krr_tpu_http_cache_misses_total") - misses_before
            hit_pct = 100.0 * hits / max(1.0, hits + misses)

            # Apples-to-apples ratio phase: the SAME 4-target cacheable mix
            # the uncached control serves below, against the cached server —
            # the mixed phase above includes near-free bare/304 requests
            # that would inflate the cached side of the ratio.
            mix_latencies: list[float] = []

            async def mix_task(reader: Reader, n: int) -> None:
                for i in range(n):
                    target, headers = mix[i % len(mix)]
                    status, _h, _b, latency = await reader.get(target, headers)
                    assert status == 200, (target, status)
                    mix_latencies.append(latency)

            mix_readers = [Reader(ks.port) for _ in range(clients)]
            for reader in mix_readers:
                await reader.connect()
            mix_start = time.perf_counter()
            await asyncio.gather(
                *[asyncio.create_task(mix_task(r, control_requests)) for r in mix_readers]
            )
            mix_wall = time.perf_counter() - mix_start
            for reader in mix_readers:
                await reader.close()
            cacheable_rps = len(mix_latencies) / max(mix_wall, 1e-9)

            # LRU bound under a filter-cardinality attack.
            for i in range(3 * ks.config.response_cache_max_entries):
                await prime.get(f"/recommendations?namespace=attack{i}")
            cache = ks.state.response_cache
            lru_ok = (
                len(cache) <= ks.config.response_cache_max_entries
                and cache.nbytes <= int(ks.config.response_cache_max_mb * (1 << 20))
            )
            await prime.close()

            # Uncached control: the SAME cacheable mix, rendered per
            # request (--no-response-cache), smaller request count (it is
            # the slow side by design).
            control_latencies: list[float] = []

            async def control_task(reader: Reader, n: int) -> None:
                for i in range(n):
                    target, headers = mix[i % len(mix)]
                    status, _h, _b, latency = await reader.get(target, headers)
                    assert status == 200, (target, status)
                    control_latencies.append(latency)

            control_readers = [Reader(control.port) for _ in range(clients)]
            for reader in control_readers:
                await reader.connect()
            control_start = time.perf_counter()
            await asyncio.gather(
                *[asyncio.create_task(control_task(r, control_requests)) for r in control_readers]
            )
            control_wall = time.perf_counter() - control_start
            for reader in control_readers:
                await reader.close()

            # ``rps`` is the full production-like mix (bare + conditionals
            # included); the vs-uncached ratio instead uses the dedicated
            # cacheable-mix phase above, which mirrors the control exactly.
            total_requests = len(latencies)
            rps = total_requests / max(wall, 1e-9)
            control_rps = len(control_latencies) / max(control_wall, 1e-9)
            ordered = sorted(latencies)
            timeline_records = ks.state.timeline.records()
            readpath_recorded = any(
                (r.get("readpath") or {}).get("requests", 0) > 0 for r in timeline_records
            )
            return {
                "requests": total_requests,
                "wall": wall,
                "rps": rps,
                "cacheable_rps": cacheable_rps,
                "p50_ms": ordered[len(ordered) // 2] * 1e3,
                "p99_ms": ordered[min(len(ordered) - 1, int(len(ordered) * 0.99))] * 1e3,
                "hit_pct": hit_pct,
                "bytes": served_bytes[0],
                "revalidations": revalidations,
                "control_rps": control_rps,
                "pushdown_ok": pushdown_ok,
                "gzip_ok": gzip_ok,
                "zero_render_304": zero_render_304,
                "lru_ok": lru_ok,
                "readpath_recorded": readpath_recorded,
                "epoch": ks.state.peek().epoch,
            }
        finally:
            await ks.shutdown()
            await control.shutdown()

    report = asyncio.run(run())
    vs_uncached = report["cacheable_rps"] / max(report["control_rps"], 1e-9)
    secondary["readpath_workloads"] = float(workloads)
    secondary["readpath_clients"] = float(clients)
    secondary["readpath_requests"] = float(report["requests"])
    secondary["readpath_rps"] = round(report["rps"], 1)
    secondary["readpath_cacheable_rps"] = round(report["cacheable_rps"], 1)
    secondary["readpath_p50_ms"] = round(report["p50_ms"], 3)
    secondary["readpath_p99_ms"] = round(report["p99_ms"], 3)
    secondary["readpath_cache_hit_pct"] = round(report["hit_pct"], 2)
    secondary["readpath_bytes_mb"] = round(report["bytes"] / 1e6, 3)
    secondary["readpath_uncached_rps"] = round(report["control_rps"], 1)
    secondary["readpath_rps_vs_uncached"] = round(vs_uncached, 1)
    print(
        f"bench: readpath {workloads} workloads x {clients} keep-alive readers: "
        f"{report['requests']} requests in {report['wall']:.2f}s "
        f"({report['rps']:.0f} rps mixed, p50 {report['p50_ms']:.2f} ms, "
        f"p99 {report['p99_ms']:.2f} ms, hit rate {report['hit_pct']:.1f}%, "
        f"epoch held at {report['epoch']}); cacheable mix "
        f"{report['cacheable_rps']:.0f} rps vs uncached {report['control_rps']:.0f} rps "
        f"-> x{vs_uncached:.1f}",
        file=sys.stderr,
    )
    check(
        "readpath_hit_rate>=99%",
        report["hit_pct"] >= 99.0,
        f"steady-state cache hit rate {report['hit_pct']:.1f}%",
    )
    check(
        "readpath_304_zero_render",
        report["zero_render_304"],
        f"{report['revalidations']}/32 revalidations returned 304 without render work",
    )
    check("readpath_pushdown_bitexact", report["pushdown_ok"],
          "filtered/paginated responses diverged from render-then-slice")
    check("readpath_gzip_roundtrip", report["gzip_ok"],
          "gzip variant did not round-trip to the identity bytes")
    check("readpath_lru_bounded", report["lru_ok"],
          "response cache exceeded its entry/byte bounds under filter cardinality")
    check("readpath_timeline_recorded", report["readpath_recorded"],
          "no timeline record carried read-path tick stats")
    # The RPS ratio bar scales with fleet width: at toy (smoke) scale the
    # render cost barely exceeds raw HTTP overhead, so 10x is a fleet-scale
    # acceptance bar, not a smoke one.
    bar = 10.0 if workloads >= 200 else 2.0
    check(
        f"readpath_rps>={bar:.0f}x_uncached",
        vs_uncached >= bar,
        f"cached {report['cacheable_rps']:.0f} rps vs uncached "
        f"{report['control_rps']:.0f} rps (x{vs_uncached:.1f} < x{bar:.0f})",
    )


#: Every counted kernel: the kernel legs' four and K5 (the streamed
#: select's digit histogram, `cuda_select.radix_digit_hist`).
COUNTED_KERNELS = KERNELS + ("radix_digit_hist",)

#: What one resident ``run_batch`` of a registered strategy launches on the
#: card: `strategies/simple.py` ``_run_resident`` one ``fleet_exact`` (K1 +
#: K2); `strategies/tdigest.py` ``_run_resident`` the digest build (K3) and
#: the memory max (K2).
RUN_BATCH_LAUNCHES = {
    "simple": {"bisect_select": 1, "row_max": 1},
    "tdigest": {"digest_hist": 1, "row_max": 1},
}

#: The legs that run the main path's kernels: each returns the launches
#: its calls imply on the card (every other leg launches none).
KERNEL_LEGS = ("obs_device", "eval")


def launch_counts() -> dict:
    """Every counted kernel's launches so far, by wrapper name."""
    return {**cuda_select.LAUNCHES, **cuda_sketch.LAUNCHES}


def implied_launches(calls: "dict[str, int]") -> dict:
    """The launches of ``calls`` resident ``run_batch`` calls a strategy
    (``{strategy: calls}``), by counted kernel."""
    counts = dict.fromkeys(COUNTED_KERNELS, 0)
    for strategy, n in calls.items():
        for name, per_call in RUN_BATCH_LAUNCHES[strategy].items():
            counts[name] += per_call * n
    return counts


def journal_leg(secondary: dict, env: dict) -> None:
    """Journal append/compaction throughput + an end-to-end diff render —
    the history subsystem's secondary numbers (host numpy + disk, no
    device). Appends are fsync'd per tick (the crash-safe contract is part
    of what's being measured); compaction is the atomic whole-file rewrite.
    The diff leg renders the first-vs-last tick delta through the json
    formatter, exercising journal → diff → formatter end to end."""
    import tempfile

    import numpy as np

    from krr_tpu_torch.history.diff import build_diff_result, tick_values
    from krr_tpu_torch.history.journal import RecommendationJournal

    rows = int(env.get("BENCH_JOURNAL_ROWS", 2000))
    ticks = max(2, int(env.get("BENCH_JOURNAL_TICKS", 32)))
    rng = np.random.default_rng(11)
    keys = [f"bench/ns{i % 16}/w{i}/main/Deployment" for i in range(rows)]
    cpu = rng.gamma(2.0, 0.05, rows).astype(np.float32)
    mem = rng.uniform(50, 400, rows).astype(np.float32)
    base_ts = 1_700_000_000.0

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "bench.journal")
        # Retention sized so compaction drops the older half of the ticks.
        journal = RecommendationJournal(path, retention_seconds=(ticks // 2) * 60.0)
        start = time.perf_counter()
        for t in range(ticks):
            published = np.full(rows, t == 0)
            journal.append_tick(base_ts + t * 60.0, keys, cpu * (1 + 0.01 * t), mem, published)
        append_seconds = time.perf_counter() - start
        total = rows * ticks
        secondary["journal_append_records_per_sec"] = round(total / append_seconds, 1)

        before = journal.record_count
        start = time.perf_counter()
        dropped = journal.compact(base_ts + ticks * 60.0)
        compact_seconds = time.perf_counter() - start
        assert dropped > 0, "bench journal compaction dropped nothing — retention sizing bug"
        secondary["journal_compact_records_per_sec"] = round(before / max(compact_seconds, 1e-9), 1)

        # Diff leg over the surviving window: oldest surviving tick vs newest.
        remaining = journal.tick_timestamps()
        start = time.perf_counter()
        diff = build_diff_result(
            tick_values(journal, float(remaining[0])), tick_values(journal, float(remaining[-1]))
        )
        rendered = diff.format("json")
        diff_seconds = time.perf_counter() - start
        assert len(diff.scans) == rows and rendered
        secondary["journal_diff_objects_per_sec"] = round(rows / max(diff_seconds, 1e-9), 1)
        journal.close()
    print(
        f"bench: journal {total} appends {append_seconds:.3f}s "
        f"({total / append_seconds:.0f} rec/s), compaction of {before} recs "
        f"{compact_seconds * 1e3:.1f} ms, diff render {rows} objects {diff_seconds:.3f}s",
        file=sys.stderr,
    )


def _scan_objects(rows: int):
    """The observability legs' fleet: ``rows`` one-pod Deployments over 8
    namespaces, no allocations."""
    from krr_tpu_torch.models.allocations import ResourceAllocations, ResourceType
    from krr_tpu_torch.models.objects import K8sObjectData

    alloc = ResourceAllocations(
        requests={ResourceType.CPU: None, ResourceType.Memory: None},
        limits={ResourceType.CPU: None, ResourceType.Memory: None},
    )
    return [
        K8sObjectData(
            cluster=None, namespace=f"ns{i % 8}", name=f"w{i}", kind="Deployment",
            container="main", pods=[f"w{i}-0"], allocations=alloc,
        )
        for i in range(rows)
    ]


def obs_leg(secondary: dict, check, env: dict, device: str):
    """Tracing-overhead leg: the SAME in-process digest scan (fake inventory
    + deterministic history source, streamed pipeline, tdigest
    digest-ingest, on ``device``) run with the no-op tracer and with a
    recording tracer + metrics registry. Two gates ride on it: the traced
    wall must stay within 2% of the plain wall (with a 10 ms absolute floor
    — at smoke scale 2% of a ~50 ms scan is below timer noise, while 10 ms
    of genuine span overhead would mean a real hot-path regression), and
    the recommendations must be BIT-exact — observability must never
    perturb results. Reported under ``secondary.obs_*``. Returns the last
    recording tracer, whose ring the analyze leg reads."""
    import asyncio
    import contextlib
    import io

    import numpy as np

    from krr_tpu_torch.core.config import Config
    from krr_tpu_torch.core.runner import Runner
    from krr_tpu_torch.models.allocations import ResourceType
    from krr_tpu_torch.obs.metrics import MetricsRegistry
    from krr_tpu_torch.obs.trace import NULL_TRACER, Tracer

    rows = int(env.get("BENCH_OBS_ROWS", 256))
    samples = int(env.get("BENCH_OBS_SAMPLES", 4096))
    runs = max(2, int(env.get("BENCH_OBS_RUNS", 5)))

    rng = np.random.default_rng(23)
    objects = _scan_objects(rows)
    # Series precomputed ONCE and shared by every run: both tracer modes
    # scan identical data, and the timed region holds no rng work.
    series = {
        ResourceType.CPU: [{f"w{i}-0": rng.gamma(2.0, 0.05, samples)} for i in range(rows)],
        ResourceType.Memory: [{f"w{i}-0": rng.uniform(5e7, 4e8, samples)} for i in range(rows)],
    }
    by_key = {(obj.namespace, obj.name): i for i, obj in enumerate(objects)}

    class Inventory:
        async def list_clusters(self):
            return None

        async def list_scannable_objects(self, clusters):
            return objects

    class Source:
        async def gather_fleet(self, objs, history_seconds, step_seconds, **kw):
            indices = [by_key[(obj.namespace, obj.name)] for obj in objs]
            return {r: [series[r][i] for i in indices] for r in ResourceType}

    def scan(tracer):
        config = Config(quiet=True, format="json", strategy="tdigest", device=device,
                        other_args={"digest_ingest": True})
        r = Runner(
            config, inventory=Inventory(), history_factory=lambda cluster: Source(),
            tracer=tracer, metrics=MetricsRegistry(),
        )
        with contextlib.redirect_stdout(io.StringIO()):
            return asyncio.run(r.run())

    scan(NULL_TRACER)  # warmup: import and first-call costs out of the timing
    tracer = None
    plain_times, traced_times = [], []
    plain_result = traced_result = None
    for _ in range(runs):  # interleaved so machine-load drift hits both modes
        start = time.perf_counter()
        plain_result = scan(NULL_TRACER)
        plain_times.append(time.perf_counter() - start)
        tracer = Tracer(ring_scans=4)
        start = time.perf_counter()
        traced_result = scan(tracer)
        traced_times.append(time.perf_counter() - start)

    plain_best, traced_best = min(plain_times), min(traced_times)
    overhead = traced_best - plain_best
    overhead_pct = 100.0 * overhead / plain_best
    span_count = len(tracer.traces()[-1])
    secondary["obs_plain_scan_seconds"] = round(plain_best, 4)
    secondary["obs_traced_scan_seconds"] = round(traced_best, 4)
    secondary["obs_trace_overhead_pct"] = round(max(0.0, overhead_pct), 2)
    secondary["obs_spans_per_scan"] = span_count
    print(
        f"bench: obs overhead plain {plain_best:.4f}s vs traced {traced_best:.4f}s "
        f"({max(0.0, overhead_pct):.2f}% over {runs} interleaved runs, "
        f"{span_count} spans/scan)",
        file=sys.stderr,
    )
    check(
        "obs_overhead<2%",
        overhead <= max(0.02 * plain_best, 0.010),
        f"traced {traced_best:.4f}s vs plain {plain_best:.4f}s (+{overhead_pct:.2f}%)",
    )
    check(
        "obs_bitexact",
        same_json(plain_result, traced_result),
        "tracing changed the recommendations",
    )
    return tracer


def same_json(a, b) -> bool:
    """The obs leg's bit-exact comparator: two scan results' JSON."""
    return a.model_dump_json() == b.model_dump_json()


def same_repr(a, b) -> bool:
    """The obs-device leg's bit-exact comparator: two batches' results'
    ``repr``."""
    return repr(a) == repr(b)


def analyze_smoke_leg(tracer, secondary: dict, check, env: dict) -> None:
    """`krr_tpu_torch analyze` smoke: dump the obs leg's recorded ring as a
    Chrome trace file, run the real CLI subprocess over it
    (``python -m krr_tpu_torch analyze``, with ``env``), and assert the
    attribution report comes back (rc 0, ≥1 scan, categories partition the
    wall). A break anywhere in trace export → chrome re-import → sweep →
    CLI wiring fails the round like a parity break. Reported under
    ``secondary.analyze_*``."""
    import tempfile

    from krr_tpu_torch.obs.trace import write_chrome_trace

    with tempfile.TemporaryDirectory() as tmp:
        trace_path = os.path.join(tmp, "scan-trace.json")
        write_chrome_trace(tracer, trace_path)
        proc = subprocess.run(
            [sys.executable, "-m", "krr_tpu_torch", "analyze", "--trace", trace_path, "--format", "json"],
            capture_output=True,
            text=True,
            timeout=300,
            cwd=ROUNDS_DIR,
            env=env,
        )
    report: dict = {}
    if proc.returncode == 0:
        try:
            report = json.loads(proc.stdout)
        except ValueError:
            pass
    scans = report.get("scans", [])
    partitioned = all(
        abs(sum(s["categories"].values()) - s["wall_seconds"])
        <= max(0.01 * s["wall_seconds"], 1e-3)
        for s in scans
    )
    ok = proc.returncode == 0 and bool(scans) and partitioned
    secondary["analyze_smoke"] = "ok" if ok else f"failed rc={proc.returncode}"
    secondary["analyze_scans"] = len(scans)
    print(
        f"bench: analyze smoke -> rc {proc.returncode}, {len(scans)} scan(s) attributed",
        file=sys.stderr,
    )
    check(
        "analyze_smoke",
        ok,
        f"rc={proc.returncode}, scans={len(scans)}, partitioned={partitioned}: "
        f"{proc.stderr[-300:]}",
    )


def sentinel_leg(secondary: dict, check, env: dict) -> None:
    """Regression-sentinel gates (`krr_tpu_torch.obs.sentinel` over
    `krr_tpu_torch.obs.timeline`): two synthetic 60-tick timelines sharing
    byte-identical noise — a clean control and a twin with one injected
    fetch-transport regression (ttfb bulge) and one injected compute
    regression — driven through the SAME trend_report/sentinel code that
    serves ``GET /debug/timeline`` and ``krr_tpu_torch analyze --trend``.
    Four parity-style gates:

    * detection — both injected regressions produce regressed verdicts;
    * attribution — the verdicts name fetch_transport (ttfb-dominated) and
      compute at the injected ticks;
    * zero false positives — the clean control produces NO verdicts, and
      the injected run flags only the injected ticks;
    * recorder overhead — the full per-tick recorder cost (record build +
      durable CRC-framed fsync'd append + sentinel classification) stays
      under 2% of the obs leg's measured scan wall (10 ms absolute floor,
      like the tracing-overhead gate).
    """
    import copy
    import tempfile

    import numpy as np

    from krr_tpu_torch.obs.sentinel import RegressionSentinel, trend_report
    from krr_tpu_torch.obs.timeline import ScanTimeline

    ticks = max(20, int(env.get("BENCH_SENTINEL_TICKS", 60)))
    rng = np.random.default_rng(47)
    base = {
        "fetch_transport": 0.9,
        "fetch_decode": 0.25,
        "fetch_backoff": 0.0,
        "fetch_other": 0.1,
        "fold": 0.2,
        "compute": 0.35,
        "discover": 0.05,
        "publish": 0.05,
        "other": 0.0,
        "idle": 0.1,
    }

    def record(i: int) -> dict:
        cats = {k: round(v * float(1.0 + rng.normal(0, 0.04)), 6) for k, v in base.items()}
        phases = {
            "ttfb": round(0.5 * float(1.0 + rng.normal(0, 0.05)), 6),
            "body_read": round(0.3 * float(1.0 + rng.normal(0, 0.05)), 6),
            "connect": round(0.05 * float(1.0 + rng.normal(0, 0.05)), 6),
        }
        return {
            "v": 1,
            "ts": 1e9 + i * 300.0,
            "scan_id": f"bench-{i}",
            "kind": "delta",
            "wall": round(sum(cats.values()), 6),
            "categories": cats,
            "phases": phases,
            "rows": 256,
            "failed_rows": 0,
            "wire_bytes": 1 << 22,
            "queries": 16,
            "retries": 0,
            "publish": {"changed": 3, "suppressed": 1},
            "persist": {"seconds": 0.02, "bytes": 4096, "epoch": i + 1, "failing": False},
            "plan": {"coalesced": 2, "sharded": 1},
        }

    clean = [record(i) for i in range(ticks)]
    injected = copy.deepcopy(clean)
    fetch_at, compute_at = int(ticks * 0.6), int(ticks * 0.85)
    for i in (fetch_at, fetch_at + 1):
        injected[i]["categories"]["fetch_transport"] = round(
            injected[i]["categories"]["fetch_transport"] + 3.0, 6
        )
        injected[i]["phases"]["ttfb"] = round(injected[i]["phases"]["ttfb"] + 2.8, 6)
        injected[i]["wall"] = round(injected[i]["wall"] + 3.0, 6)
    for i in (compute_at, compute_at + 1):
        injected[i]["categories"]["compute"] = round(
            injected[i]["categories"]["compute"] + 2.0, 6
        )
        injected[i]["wall"] = round(injected[i]["wall"] + 2.0, 6)
    injected_ts = {injected[i]["ts"] for i in
                   (fetch_at, fetch_at + 1, compute_at, compute_at + 1)}

    control = trend_report(clean, warmup_scans=8)
    report = trend_report(injected, warmup_scans=8)
    fetch_verdicts = [v for v in report["regressions"] if v["dominant"] == "fetch_transport"]
    compute_verdicts = [v for v in report["regressions"] if v["dominant"] == "compute"]
    detected = bool(fetch_verdicts) and bool(compute_verdicts)
    attributed = (
        any(v["ts"] == injected[fetch_at]["ts"] and "ttfb-dominated" in v["suspect"]
            for v in fetch_verdicts)
        and any(v["ts"] == injected[compute_at]["ts"] for v in compute_verdicts)
    )
    spurious = [v for v in report["regressions"] if v["ts"] not in injected_ts]
    no_false_positives = control["regressed"] == 0 and not spurious

    # Recorder overhead: the whole per-tick cost — durable append (CRC frame
    # + fsync) plus sentinel classification — against a real scan wall.
    sentinel = RegressionSentinel(warmup_scans=8)
    with tempfile.TemporaryDirectory() as tmp:
        timeline = ScanTimeline.open(os.path.join(tmp, "timeline.log"))
        start = time.perf_counter()
        for r in injected:
            timeline.append(r)
            sentinel.observe(r, fire=False)
        recorder_seconds = time.perf_counter() - start
        timeline.close()
    per_tick = recorder_seconds / ticks
    scan_wall = float(secondary.get("obs_plain_scan_seconds") or 0.0)
    overhead_pct = 100.0 * per_tick / scan_wall if scan_wall > 0 else 0.0

    secondary["sentinel_ticks"] = float(ticks)
    secondary["sentinel_clean_regressions"] = float(control["regressed"])
    secondary["sentinel_injected_regressions"] = float(report["regressed"])
    secondary["sentinel_recorder_seconds_per_tick"] = round(per_tick, 6)
    secondary["timeline_overhead_pct"] = round(overhead_pct, 3)
    print(
        f"bench: sentinel {ticks}-tick timeline: injected run flagged "
        f"{report['regressed']} (fetch_transport {len(fetch_verdicts)}, compute "
        f"{len(compute_verdicts)}), clean control {control['regressed']}; recorder "
        f"{per_tick * 1e3:.2f} ms/tick ({overhead_pct:.2f}% of a "
        f"{scan_wall:.3f}s scan)",
        file=sys.stderr,
    )
    check(
        "sentinel_detects_injected",
        detected,
        f"fetch verdicts {len(fetch_verdicts)}, compute verdicts {len(compute_verdicts)}",
    )
    check(
        "sentinel_attribution_correct",
        attributed,
        f"regressions: {[(v['ts'], v['dominant'], v['suspect']) for v in report['regressions']]}",
    )
    check(
        "sentinel_zero_false_positives",
        no_false_positives,
        f"clean {control['regressed']}, spurious {[(v['ts'], v['dominant']) for v in spurious]}",
    )
    check(
        "timeline_overhead<2%",
        per_tick <= max(0.02 * scan_wall, 0.010),
        f"recorder {per_tick * 1e3:.2f} ms/tick vs scan wall {scan_wall:.4f}s "
        f"({overhead_pct:.2f}%)",
    )


def obs_device_leg(secondary: dict, check, env: dict, device: str) -> dict:
    """Device-observability leg (`krr_tpu_torch.obs.device`): the SAME
    compute — one `SimpleStrategy.run_batch` over a fixed synthetic fleet on
    ``device``, K1 + K2 on the card — run with the inert NULL_DEVICE_OBS and
    with a recording DeviceObs (staged pack/quantile/round sub-spans, the
    CUDA-event fence, padding gauges). Gates mirror the scan-level obs leg:
    instrumented compute must stay within 2% wall of plain (10 ms absolute
    floor at smoke scale) and BIT-exact. Also asserts the device stages
    actually recorded: stage spans present, padding waste fired. Reported
    under ``secondary.obs_device_*``. Returns the launches its calls imply
    on the card: a warm-up and ``2 × BENCH_OBS_RUNS`` ``run_batch`` calls."""
    import numpy as np

    from krr_tpu_torch.models.allocations import ResourceType
    from krr_tpu_torch.models.series import FleetBatch
    from krr_tpu_torch.obs.device import NULL_DEVICE_OBS, DeviceObs
    from krr_tpu_torch.obs.metrics import MetricsRegistry
    from krr_tpu_torch.obs.trace import Tracer
    from krr_tpu_torch.strategies.simple import SimpleStrategy, SimpleStrategySettings

    rows = int(env.get("BENCH_OBS_ROWS", 256))
    samples = int(env.get("BENCH_OBS_SAMPLES", 4096))
    runs = max(2, int(env.get("BENCH_OBS_RUNS", 5)))

    rng = np.random.default_rng(29)
    objects = _scan_objects(rows)
    # Ragged on purpose (varying sample counts) so the padding gauges
    # measure genuine waste, not a degenerate all-full matrix.
    histories = {
        ResourceType.CPU: [
            {f"w{i}-0": rng.gamma(2.0, 0.05, samples - (i % 7) * (samples // 8))}
            for i in range(rows)
        ],
        ResourceType.Memory: [
            {f"w{i}-0": rng.uniform(5e7, 4e8, samples - (i % 5) * (samples // 8))}
            for i in range(rows)
        ],
    }
    batch = FleetBatch.build(objects, histories)
    strategy = SimpleStrategy(SimpleStrategySettings(use_mesh=False, device=device))
    strategy.run_batch(batch)  # warmup: the kernels' build out of the timing

    tracer = registry = None
    plain_times, traced_times = [], []
    plain_result = traced_result = None
    for _ in range(runs):  # interleaved so machine-load drift hits both modes
        strategy.obs = NULL_DEVICE_OBS
        start = time.perf_counter()
        plain_result = strategy.run_batch(batch)
        plain_times.append(time.perf_counter() - start)
        tracer, registry = Tracer(ring_scans=4), MetricsRegistry()
        strategy.obs = DeviceObs(tracer, registry)
        start = time.perf_counter()
        with tracer.span("compute", rows=rows):
            traced_result = strategy.run_batch(batch)
        traced_times.append(time.perf_counter() - start)
    strategy.obs = NULL_DEVICE_OBS

    plain_best, traced_best = min(plain_times), min(traced_times)
    overhead = traced_best - plain_best
    overhead_pct = 100.0 * overhead / plain_best
    stages = [s.name for s in tracer.traces()[-1] if s.name != "compute"]
    secondary["obs_device_plain_seconds"] = round(plain_best, 4)
    secondary["obs_device_traced_seconds"] = round(traced_best, 4)
    secondary["obs_device_overhead_pct"] = round(max(0.0, overhead_pct), 2)
    secondary["obs_device_stage_spans"] = len(stages)
    print(
        f"bench: obs-device overhead plain {plain_best:.4f}s vs traced {traced_best:.4f}s "
        f"({max(0.0, overhead_pct):.2f}% over {runs} interleaved runs, "
        f"stages {sorted(set(stages))})",
        file=sys.stderr,
    )
    check(
        "obs_device_overhead<2%",
        overhead <= max(0.02 * plain_best, 0.010),
        f"traced {traced_best:.4f}s vs plain {plain_best:.4f}s (+{overhead_pct:.2f}%)",
    )
    check(
        "obs_device_bitexact",
        same_repr(plain_result, traced_result),
        "device instrumentation changed the recommendations",
    )
    check(
        "obs_device_stages",
        {"pack", "quantile", "round"} <= set(stages),
        f"missing compute sub-spans: {sorted(set(stages))}",
    )
    waste = registry.value("krr_tpu_pad_waste_pct", resource="cpu")
    check(
        "obs_device_pad_waste",
        waste is not None and 0.0 < waste < 100.0,
        f"pad waste gauge: {waste}",
    )
    return implied_launches({"simple": 1 + 2 * runs})


def chaos_leg(secondary: dict, check, env: dict, device: str) -> None:
    """Chaos soak gates (`tests.fakes.torch_chaos`): an archetype fleet
    served by the REAL composition on ``device`` (real PrometheusLoader
    over HTTP against the fakes) rides a scripted fault timeline — two
    degraded (partial-outage) ticks, one hard-down tick, then recovery.
    Three gates, all parity-style (a failure exits nonzero):

    * no crash — every tick returns (scanned, degraded, or cleanly aborted);
    * recovery bit-exactness — after the faults clear, the soaked resident
      store is BIT-identical to a never-faulted control run's (the degraded
      path's streamed==staged-grade discipline);
    * bounded degraded wall — the hard-down tick's wall stays within an
      absolute ceiling (breaker fail-fast + the retry deadline budget, not
      a full backoff ladder per query).
    """
    import asyncio
    import tempfile

    from tests.fakes.torch_chaos import (
        ArchetypeSpec,
        FaultSpec,
        FaultTimeline,
        ServerThread,
        build_fleet,
        run_soak,
        stores_bitexact,
        write_kubeconfig,
    )

    ticks = max(8, int(env.get("BENCH_CHAOS_TICKS", 8)))
    workloads = int(env.get("BENCH_CHAOS_WORKLOADS", 2))
    fleet = build_fleet(
        tuple(
            ArchetypeSpec(kind, workloads=workloads, pods=1)
            for kind in ("diurnal", "bursty-batch", "oom-loop", "mixed-qos")
        ),
        samples=240,
        seed=29,
    )
    server = ServerThread(fleet.backend).start()
    try:
        with tempfile.TemporaryDirectory() as tmp:
            kubeconfig = write_kubeconfig(os.path.join(tmp, "kubeconfig"), server.url)

            def config():
                return _service_config(
                    device,
                    300.0,
                    kubeconfig=kubeconfig,
                    prometheus_url=server.url,
                    # Ticks run back-to-back in wall time while the scan
                    # clock jumps a cadence: a microscopic cooldown keeps
                    # recovery immediate, the small budget keeps faulted
                    # ticks fast, and the threshold scales with the fleet
                    # knob so one namespace's tail fallback wave (2 ladders
                    # per workload after its healthy siblings finish, which
                    # the success-epoch guard can no longer discount) can't
                    # open the breaker during the PARTIAL phase — only the
                    # hard-down tick (every query failing) trips it.
                    prometheus_breaker_threshold=max(10, 4 * workloads + 2),
                    prometheus_breaker_cooldown_seconds=0.02,
                    prometheus_retry_deadline_seconds=1.0,
                    prometheus_backoff_cap_seconds=0.2,
                )

            timeline = FaultTimeline(
                [
                    (2, 3, FaultSpec(fail_namespaces=frozenset({"diurnal"}))),
                    (4, 4, FaultSpec(down=True)),
                ]
            )

            async def settle_breaker(server, sample):
                # The breaker cooldown is WALL-clock while soak ticks run
                # back-to-back on a fake scan clock: under scheduling
                # jitter the recovery tick's first queries can land inside
                # the cooldown window of the hard-down tick's last
                # fast-fail and quarantine a workload — an extra degraded
                # tick that reads as starvation. Waiting out the cooldown
                # after any tick that left the breaker non-closed makes
                # recovery deterministic: the next tick's first query is
                # the half-open probe.
                if sample.breaker_state and sample.breaker_state > 0:
                    await asyncio.sleep(0.05)

            report = asyncio.run(
                run_soak(
                    config(), fleet.backend, timeline, ticks=ticks,
                    tick_seconds=300.0, on_tick=settle_breaker,
                )
            )
            control = asyncio.run(
                run_soak(
                    config(), fleet.backend, None, ticks=ticks,
                    tick_seconds=300.0, on_tick=settle_breaker,
                )
            )
    finally:
        server.stop()

    counts = report.counts()
    clean_wall = max(t.wall_seconds for t in report.ticks[:2])
    down_wall = report.ticks[4].wall_seconds
    equal, detail = stores_bitexact(report.store, control.store)
    breaker_opens = (
        report.metrics.value(
            "krr_tpu_prom_breaker_transitions_total", cluster="fake", to="open"
        )
        or 0.0
    )
    secondary["chaos_ticks"] = float(len(report.ticks))
    secondary["chaos_degraded_ticks"] = float(counts["degraded"])
    secondary["chaos_aborted_ticks"] = float(counts["aborted"])
    secondary["chaos_clean_tick_seconds"] = round(clean_wall, 4)
    secondary["chaos_down_tick_seconds"] = round(down_wall, 4)
    secondary["chaos_breaker_opens"] = breaker_opens
    secondary["chaos_recovered_bitexact"] = 1.0 if equal else 0.0
    print(
        f"bench: chaos soak {len(report.ticks)} ticks "
        f"({counts['degraded']} degraded, {counts['aborted']} aborted, "
        f"{breaker_opens:.0f} breaker opens): clean tick {clean_wall:.3f}s, "
        f"hard-down tick {down_wall:.3f}s, recovery bit-exact: {equal}",
        file=sys.stderr,
    )
    check(
        "chaos_no_starvation",
        counts["degraded"] == 2 and all(t.ok for t in report.ticks[:4]),
        f"expected 2 degraded published ticks, got {counts}",
    )
    check(
        "chaos_down_tick_aborts",
        report.ticks[4].ok is None and counts["aborted"] == 1,
        f"hard-down tick outcome {report.ticks[4].ok}, counts {counts}",
    )
    check("chaos_recovery_bitexact", equal, detail)
    # Absolute ceiling, generous for noise: the budget allows 1 s of
    # backoff and the breaker fail-fasts the rest — without them this tick
    # would burn a retry ladder per query and blow far past it.
    check(
        "chaos_down_tick_wall_bounded",
        down_wall < 10.0,
        f"hard-down tick took {down_wall:.2f}s (clean tick {clean_wall:.2f}s)",
    )


#: The registered strategies the eval leg replays, in board order.
EVAL_STRATEGIES = ("simple", "tdigest")


def eval_leg(secondary: dict, check, env: dict, device: str) -> dict:
    """Quality-evaluation gates (`krr_tpu_torch.eval`): replay registered
    strategies (on ``device``: K1 + K2 for ``simple``, K3 + K2 for
    ``tdigest`` a tick on the card) plus labeled static probes over a
    chaos-archetype fleet, with the archetypes' DECLARED incident windows as
    ground truth. Two parity-style gates:

    * eval_deterministic — the same replay rendered twice is BYTE-identical
      (the port's own two replays: the slacks are float64 sums of the
      float32 terms, so the board is not byte-equal to the JAX package's);
    * eval_ranks_labeled_archetypes — the undersized probe scores >0
      would-have-been OOM incidents on the oom-loop archetype, the
      oversized probe scores none with MORE over-provisioned GB-hours, and
      the board ranks the incident-free probe first (safety before cost).

    Replay wall + throughput are trended under ``secondary.eval_*``.
    Returns the launches its replays imply on the card: two boards, each
    one resident ``run_batch`` a strategy a replay tick.
    """
    from krr_tpu_torch.eval import (
        StaticReplayStrategy,
        build_scoreboard,
        render_scoreboard,
        replay,
        score_replay,
        tick_ends,
    )
    from krr_tpu_torch.strategies.base import BaseStrategy
    from tests.fakes.torch_chaos import ArchetypeSpec, build_fleet, fleet_replay_input

    samples = int(env.get("BENCH_EVAL_SAMPLES", 240))
    workloads = int(env.get("BENCH_EVAL_WORKLOADS", 2))
    ticks = int(env.get("BENCH_EVAL_TICKS", 8))
    fleet = build_fleet(
        tuple(
            ArchetypeSpec(kind, workloads=workloads, pods=1)
            for kind in ("oom-loop", "diurnal", "bursty-batch")
        ),
        samples=samples,
        seed=31,
    )
    inputs = fleet_replay_input(fleet)
    probes = (
        # Under every oom-loop incident peak (~7.4e8+ bytes) but over the
        # diurnal baseline; vs comfortably over everything.
        ("static-under", lambda: StaticReplayStrategy(0.01, 3e8)),
        ("static-over", lambda: StaticReplayStrategy(10.0, 5e9)),
    )

    def board_json() -> "tuple[str, float]":
        rows = []
        start = time.perf_counter()
        for name in EVAL_STRATEGIES:
            strategy_type = BaseStrategy.find(name)
            strategy = strategy_type(strategy_type.get_settings_type()(device=device))
            replayed = replay(inputs, strategy, name=name, ticks=ticks)
            rows.append(score_replay(inputs, replayed, device=device))
        wall = time.perf_counter() - start
        for name, make in probes:
            replayed = replay(inputs, make(), name=name, ticks=ticks)
            rows.append(score_replay(inputs, replayed, device=device))
        board = build_scoreboard(
            rows,
            samples=len(inputs.timestamps),
            window_seconds=float(inputs.timestamps[-1] - inputs.timestamps[0]),
        )
        return render_scoreboard(board, "json"), wall

    first, wall = board_json()
    second, _ = board_json()
    payload = json.loads(first)
    order = [s["strategy"] for s in payload["scores"]]
    by_name = {s["strategy"]: s for s in payload["scores"]}
    under, over = by_name["static-under"], by_name["static-over"]
    replayed_rows = 2 * len(inputs.keys) * ticks  # registry strategies only
    rows_per_sec = replayed_rows / wall if wall > 0 else 0.0
    secondary["eval_workloads"] = float(len(inputs.keys))
    secondary["eval_samples"] = float(len(inputs.timestamps))
    secondary["eval_replay_seconds"] = round(wall, 4)
    secondary["eval_replay_rows_per_sec"] = round(rows_per_sec, 2)
    print(
        f"bench: eval replayed 2 strategies + {len(probes)} probes over "
        f"{len(inputs.keys)} workloads x {len(inputs.timestamps)} samples "
        f"in {ticks} ticks: {wall:.3f}s ({rows_per_sec:.0f} rows/s), "
        f"board order {order}",
        file=sys.stderr,
    )
    check(
        "eval_deterministic",
        same_text(first, second),
        "repeated replay rendered a different scoreboard (byte-identity broken)",
    )
    ranks = (
        under["oom_incidents"] > 0
        and over["oom_incidents"] == 0
        and over["throttle_incidents"] == 0
        and over["overprovisioned_gb_hours"] > under["overprovisioned_gb_hours"]
        and order.index("static-over") < order.index("static-under")
    )
    check(
        "eval_ranks_labeled_archetypes",
        ranks,
        f"under={under['oom_incidents']} oom / {under['overprovisioned_gb_hours']} GBh, "
        f"over={over['oom_incidents']} oom / {over['overprovisioned_gb_hours']} GBh, "
        f"order {order}",
    )
    replay_ticks = len(tick_ends(len(inputs.timestamps), ticks))
    return implied_launches(dict.fromkeys(EVAL_STRATEGIES, 2 * replay_ticks))


def same_text(a: str, b: str) -> bool:
    """The eval leg's determinism comparator: two renderings byte for byte."""
    return a == b


def discovery_leg(secondary: dict, check, env: dict, device: str) -> None:
    """Watch-driven discovery gates (`--discovery-mode watch`): at the same
    fleet width, with the same injected churn per round, the watch
    reconcile must (a) stay BIT-identical — objects and staged order — to a
    fresh relist at every round, and (b) beat the relist's wall (the whole
    point of an O(churn) resident inventory is that the per-tick discovery
    cost stops scaling with the fleet). Trended as ``secondary.discovery_*``.
    """
    import asyncio
    import statistics
    import tempfile
    import time as _time

    from krr_tpu_torch.core.config import Config
    from krr_tpu_torch.integrations.kubernetes import KubernetesLoader
    from tests.fakes.servers import FakeBackend, FakeCluster, FakeMetrics, ServerThread
    from tests.fakes.torch_chaos import write_kubeconfig

    workloads = int(env.get("BENCH_DISCOVERY_WORKLOADS", 400))
    rounds = max(2, int(env.get("BENCH_DISCOVERY_ROUNDS", 5)))
    namespaces = max(2, min(8, workloads // 20))
    churn = max(1, workloads // 50)

    cluster = FakeCluster()
    created: "list[tuple[str, str]]" = []  # (name, namespace), oldest first
    serial = [0]

    def add_one() -> None:
        namespace = f"ns-{serial[0] % namespaces}"
        name = f"wl-{serial[0]}"
        serial[0] += 1
        cluster.add_workload_with_pods("Deployment", name, namespace, pod_count=2)
        created.append((name, namespace))

    def drop_one() -> None:
        name, namespace = created.pop(0)
        cluster.delete_workload("Deployment", name, namespace)
        cluster.delete_pod(f"{name}-0", namespace)
        cluster.delete_pod(f"{name}-1", namespace)

    for _ in range(workloads):
        add_one()

    backend = FakeBackend(cluster, FakeMetrics())
    server = ServerThread(backend).start()
    try:
        with tempfile.TemporaryDirectory() as tmp:
            kubeconfig = write_kubeconfig(os.path.join(tmp, "kubeconfig"), server.url)

            def config(**overrides) -> Config:
                return Config(kubeconfig=kubeconfig, quiet=True, device=device, **overrides)

            async def run() -> dict:
                watch = KubernetesLoader(
                    config(
                        discovery_mode="watch",
                        # The verify audit stays out of the measurement: the
                        # reconcile path itself is what's on the clock.
                        discovery_verify_interval_seconds=3600.0,
                    )
                )
                relist = KubernetesLoader(config())
                relist_walls: list[float] = []
                reconcile_walls: list[float] = []
                bitexact = True
                try:
                    await watch.list_scannable_objects(["fake"])  # cold seed
                    for _round in range(rounds):
                        for _ in range(churn):
                            drop_one()
                            add_one()
                        t0 = _time.perf_counter()
                        relisted = await relist.list_scannable_objects(["fake"])
                        relist_walls.append(_time.perf_counter() - t0)
                        expected = [obj.model_dump() for obj in relisted]
                        # Wait for watch delivery OUTSIDE the timed window —
                        # the reconcile being measured is the steady-state
                        # tick cost, not event-propagation latency.
                        deadline = _time.monotonic() + 30.0
                        while _time.monotonic() < deadline:
                            watched = await watch.list_scannable_objects(["fake"])
                            if [obj.model_dump() for obj in watched] == expected:
                                break
                            await asyncio.sleep(0.02)
                        t0 = _time.perf_counter()
                        watched = await watch.list_scannable_objects(["fake"])
                        reconcile_walls.append(_time.perf_counter() - t0)
                        bitexact = bitexact and same_dumps(watched, relisted)
                finally:
                    await watch.close()
                    await relist.close()
                return {
                    "relist_seconds": statistics.median(relist_walls),
                    "reconcile_seconds": statistics.median(reconcile_walls),
                    "bitexact": bitexact,
                    "objects": len(created) * 1,
                }

            report = asyncio.run(run())
    finally:
        server.stop()

    relist_seconds = report["relist_seconds"]
    reconcile_seconds = report["reconcile_seconds"]
    check(
        "discovery_bitexact",
        report["bitexact"],
        "watch reconcile diverged from the fresh relist",
    )
    check(
        "discovery_reconcile_beats_relist",
        reconcile_seconds < relist_seconds,
        f"reconcile {reconcile_seconds:.4f}s vs relist {relist_seconds:.4f}s",
    )
    secondary["discovery_workloads"] = float(workloads)
    secondary["discovery_churn_per_round"] = float(churn)
    secondary["discovery_relist_seconds"] = round(relist_seconds, 4)
    # Rounded to 0.1 ms as `bench.py` rounds it: a reconcile under 0.05 ms
    # reads 0.0 here; the speedup keeps the unrounded ratio.
    secondary["discovery_reconcile_seconds"] = round(reconcile_seconds, 4)
    secondary["discovery_speedup"] = round(relist_seconds / max(reconcile_seconds, 1e-9), 1)
    secondary["discovery_bitexact"] = 1.0 if report["bitexact"] else 0.0
    secondary["discovery_reconcile_beats_relist"] = (
        1.0 if reconcile_seconds < relist_seconds else 0.0
    )
    print(
        f"bench: discovery leg {workloads} workloads x {rounds} rounds "
        f"(churn {churn}/round): reconcile {reconcile_seconds * 1e3:.1f}ms vs "
        f"relist {relist_seconds * 1e3:.1f}ms "
        f"({secondary['discovery_speedup']}x), bitexact={report['bitexact']}",
        file=sys.stderr,
    )


def same_dumps(a, b) -> bool:
    """The discovery leg's comparator: two object lists' ``model_dump``s,
    in order."""
    return [obj.model_dump() for obj in a] == [obj.model_dump() for obj in b]


def _discover_once(config):
    """The fake cluster's scannable objects, through one `KubernetesLoader`
    list (closed after: pooled clients outlive calls)."""
    import asyncio

    from krr_tpu_torch.integrations.kubernetes import KubernetesLoader

    async def discover():
        loader = KubernetesLoader(config)
        try:
            return await loader.list_scannable_objects(["fake"])
        finally:
            await loader.close()

    return asyncio.run(discover())


def fetchplan_leg(secondary: dict, check, env: dict, device: str) -> None:
    """Adaptive fetch-engine gates (`krr_tpu_torch.core.fetchplan` + the
    prometheus loader's plan/pump/limiter wiring), at toy scale with every
    gate EXECUTED: a fleet shaped so BOTH planner transforms fire (one
    giant namespace shards, three small ones coalesce) is fetched through
    the real PrometheusLoader over HTTP twice — adaptive plan vs the
    ``--fetch-plan fixed`` escape-hatch control. Three parity-style gates:

    * engagement — the plan counters are non-zero (coalesced >= 1 query
      group, sharded >= 2) so a planner wiring break can't pass silently;
    * bit-exactness — the adaptive fleet digest arrays are BIT-identical
      to the fixed-plan control's;
    * autotuner — the AIMD limiter saw per-query TTFB verdicts and
      exported its live in-flight limit gauge.
    """
    import asyncio
    import tempfile

    import numpy as np

    from krr_tpu_torch.core.config import Config
    from krr_tpu_torch.integrations.prometheus import PrometheusLoader
    from krr_tpu_torch.obs.metrics import MetricsRegistry
    from tests.fakes.servers import FakeBackend, FakeCluster, FakeMetrics, ServerThread
    from tests.fakes.torch_chaos import write_kubeconfig

    workloads = int(env.get("BENCH_FETCHPLAN_WORKLOADS", 3))
    cluster = FakeCluster()
    metrics = FakeMetrics()
    rng = np.random.default_rng(31)

    def add(namespace: str, name: str, pod_count: int) -> None:
        for pod in cluster.add_workload_with_pods(
            "Deployment", name, namespace, pod_count=pod_count
        ):
            metrics.set_series(
                namespace, "main", pod,
                cpu=rng.gamma(2.0, 0.05, 48), memory=rng.uniform(5e7, 4e8, 48),
            )

    for w in range(workloads):
        add("big", f"bigwl-{w}", pod_count=4)
    for ns in ("s1", "s2", "s3"):
        add(ns, f"{ns}-app", pod_count=1)

    server = ServerThread(FakeBackend(cluster, metrics)).start()
    try:
        with tempfile.TemporaryDirectory() as tmp:
            kubeconfig = write_kubeconfig(os.path.join(tmp, "kubeconfig"), server.url)

            def config(**overrides) -> Config:
                return Config(
                    kubeconfig=kubeconfig,
                    prometheus_url=server.url,
                    quiet=True,
                    device=device,
                    # Tiny plan targets so the toy fleet exercises BOTH
                    # transforms (sharding needs >= 2x this many series).
                    fetch_plan_target_series=6,
                    **overrides,
                )

            objects = _discover_once(config())

            def gather(cfg, registry=None):
                async def fetch():
                    prom = PrometheusLoader(cfg, cluster="fake", metrics=registry)
                    try:
                        fleet = await prom.gather_fleet_digests(
                            objects, 3600, 60, gamma=1.01, min_value=1e-7, num_buckets=128
                        )
                        return fleet, prom._limiter
                    finally:
                        await prom.close()

                return asyncio.run(fetch())

            registry = MetricsRegistry()
            start = time.perf_counter()
            adaptive, limiter = gather(config(), registry)
            adaptive_seconds = time.perf_counter() - start
            fixed, _ = gather(config(fetch_plan="fixed"))
    finally:
        server.stop()

    coalesced = registry.total("krr_tpu_fetch_plan_coalesced_total")
    sharded = registry.total("krr_tpu_fetch_plan_sharded_total")
    bitexact = all(same_array(getattr(adaptive, attr), getattr(fixed, attr)) for attr in STORE_ARRAYS)
    limit_gauge = registry.value("krr_tpu_prom_inflight_limit", cluster="fake")
    autotuned = limiter.enabled and limiter.baseline_ttfb is not None and limit_gauge
    secondary["fetchplan_scan_seconds"] = round(adaptive_seconds, 4)
    secondary["fetchplan_coalesced"] = coalesced
    secondary["fetchplan_sharded"] = sharded
    secondary["fetchplan_bitexact"] = 1.0 if bitexact else 0.0
    secondary["fetchplan_autotune_engaged"] = 1.0 if autotuned else 0.0
    print(
        f"bench: fetchplan {len(objects)} workloads in {adaptive_seconds:.3f}s "
        f"({coalesced:.0f} coalesced + {sharded:.0f} sharded groups, "
        f"inflight limit {limit_gauge}, bit-exact vs fixed plan: {bitexact})",
        file=sys.stderr,
    )
    check(
        "fetchplan_engaged",
        coalesced >= 1 and sharded >= 2,
        f"plan counters coalesced={coalesced} sharded={sharded}",
    )
    check("fetchplan_bitexact", bitexact, "adaptive plan diverged from the fixed plan")
    check(
        "fetchplan_autotuner",
        bool(autotuned),
        f"limiter enabled={limiter.enabled} baseline={limiter.baseline_ttfb} gauge={limit_gauge}",
    )


def wire_leg(secondary: dict, check, env: dict, device: str) -> None:
    """Wire-shrink gates (compressed transport + server-side downsampling,
    `--fetch-compression`/`--fetch-downsample`): the same grid-aligned
    digest-fleet fetch runs through the real PrometheusLoader over HTTP
    twice — treated (gzip negotiation + downsampled stats route) vs the
    identity/raw escape-hatch control. Three parity-style gates:

    * bit-exactness — the treated fleet arrays are BIT-identical to the
      identity/raw control's;
    * engagement — gzip responses negotiated AND stats queries rode the
      downsample rewrite (a wiring break can't pass silently);
    * compression — wire bytes shrank: ``wire_compression_ratio``
      (identity wire ÷ treated wire) must hit the acceptance bar of 5x.
      The ratio is deterministic for a fixed fixture (byte counts, not
      timings), so the gate cannot flake.
    """
    import asyncio
    import tempfile

    import numpy as np

    from krr_tpu_torch.core.config import Config
    from krr_tpu_torch.integrations.prometheus import PrometheusLoader
    from krr_tpu_torch.obs.metrics import MetricsRegistry
    from tests.fakes.servers import FakeBackend, FakeCluster, FakeMetrics, ServerThread
    from tests.fakes.torch_chaos import write_kubeconfig

    workloads = int(env.get("BENCH_WIRE_WORKLOADS", 3))
    samples = int(env.get("BENCH_WIRE_SAMPLES", 180))
    cluster = FakeCluster()
    metrics = FakeMetrics()
    metrics.enforce_range = True
    rng = np.random.default_rng(43)
    for ns in ("w1", "w2"):
        for w in range(workloads):
            for pod in cluster.add_workload_with_pods(
                "Deployment", f"{ns}-wl{w}", ns, pod_count=2
            ):
                # Realistic value precision (real fleets quantize: irates
                # resolve to ~0.1 millicores, working sets to whole pages)
                # — full-precision iid random mantissas would render the
                # JSON artificially incompressible and benchmark the RNG's
                # entropy instead of the transport.
                metrics.set_series(
                    ns, "main", pod,
                    cpu=np.round(rng.gamma(2.0, 0.05, samples), 4),
                    memory=np.floor(rng.uniform(5e7, 4e8, samples) / 4096) * 4096,
                )

    backend = FakeBackend(cluster, metrics)
    # Sample anchor on the absolute minute grid: downsample eligibility
    # (epoch-aligned subquery steps) and the fake's interval-membership
    # sample model both demand it.
    backend.SERIES_ORIGIN = 1_699_999_980.0
    start = backend.SERIES_ORIGIN
    end = start + (samples - 1) * 60.0
    server = ServerThread(backend).start()
    try:
        with tempfile.TemporaryDirectory() as tmp:
            kubeconfig = write_kubeconfig(os.path.join(tmp, "kubeconfig"), server.url)

            def config(**overrides) -> Config:
                return Config(
                    kubeconfig=kubeconfig,
                    prometheus_url=server.url,
                    quiet=True,
                    device=device,
                    **overrides,
                )

            objects = _discover_once(config())

            def gather(cfg, registry):
                async def fetch():
                    prom = PrometheusLoader(cfg, cluster="fake", metrics=registry)
                    try:
                        return await prom.gather_fleet_digests(
                            objects, end - start, 60, gamma=1.01, min_value=1e-7,
                            num_buckets=128, end_time=end,
                        )
                    finally:
                        await prom.close()

                return asyncio.run(fetch())

            treated_registry = MetricsRegistry()
            t0 = time.perf_counter()
            treated = gather(config(fetch_downsample="auto"), treated_registry)
            treated_seconds = time.perf_counter() - t0
            control_registry = MetricsRegistry()
            control = gather(
                config(fetch_compression="off", fetch_downsample="off"),
                control_registry,
            )
    finally:
        server.stop()

    bitexact = all(
        same_array(getattr(treated, attr), getattr(control, attr)) for attr in STORE_ARRAYS
    ) and not treated.failed_rows
    treated_wire = treated_registry.total("krr_tpu_prom_wire_bytes_total")
    control_wire = control_registry.total("krr_tpu_prom_wire_bytes_total")
    gzip_responses = treated_registry.value(
        "krr_tpu_prom_wire_encoding_total", encoding="gzip"
    ) or 0.0
    downsampled = treated_registry.value(
        "krr_tpu_fetch_downsampled_total", cluster="fake"
    ) or 0.0
    ratio = control_wire / treated_wire if treated_wire else 0.0
    secondary["wire_scan_seconds"] = round(treated_seconds, 4)
    secondary["wire_identity_mb"] = round(control_wire / 1e6, 3)
    secondary["wire_compressed_mb"] = round(treated_wire / 1e6, 3)
    secondary["wire_compression_ratio"] = round(ratio, 2)
    secondary["wire_gzip_responses"] = gzip_responses
    secondary["wire_downsampled_queries"] = downsampled
    secondary["wire_bitexact"] = 1.0 if bitexact else 0.0
    print(
        f"bench: wire {len(objects)} workloads x {samples} samples -> "
        f"{control_wire / 1e6:.2f} MB identity vs {treated_wire / 1e6:.2f} MB "
        f"treated (x{ratio:.1f}, {gzip_responses:.0f} gzip responses, "
        f"{downsampled:.0f} downsampled queries, bit-exact: {bitexact})",
        file=sys.stderr,
    )
    check("wire_bitexact", bitexact, "treated scan diverged from the identity/raw control")
    check(
        "wire_engaged",
        gzip_responses >= 1 and downsampled >= 1,
        f"gzip={gzip_responses} downsampled={downsampled}",
    )
    check(
        "wire_ratio",
        ratio >= 5.0,
        f"wire_compression_ratio {ratio:.2f} < 5 "
        f"(identity {control_wire}B vs treated {treated_wire}B)",
    )


def fleet_obs_leg(secondary: dict, check, env: dict, device: str) -> None:
    """Fleet-observability gates (`krr_tpu_torch.obs.trace` stitching +
    `krr_tpu_torch.federation` freshness lineage): two in-process scanner
    shards stream into an aggregator serve whose epoch feed drives a read
    replica — every process recording its own trace ring, every
    composition on ``device`` — then the identical soak repeats with
    ``--no-lineage`` as the overhead control. Three gates:

    * ``fleet_trace_stitched`` — ``stitch_chrome`` over the four processes'
      trace exports joins the shard ``scan``, aggregator ``apply_record``,
      and replica ``install`` spans into one causally-connected stitched
      component, with every remote parent reference resolving;
    * ``fleet_freshness_monotonic`` — every published epoch's lineage chain
      (newest sample → fold → apply → publish → install) is monotone
      non-decreasing, install receipts included, and all four
      ``krr_tpu_e2e_freshness_seconds{stage}`` histograms actually fired;
    * ``fleet_lineage_overhead`` — the lineage-stamped soak's tick wall is
      within 2% of the no-lineage control's (plus a 50 ms toy-scale noise
      floor), and both runs' merged stores are bit-identical per key
      (lineage is metadata-only by construction).

    Trended under ``secondary.fleet_*``: soak walls, the overhead delta,
    stitched component/lane counts, and lineage epoch depth.
    """
    import asyncio
    import time as _time

    from krr_tpu_torch.core.runner import ScanSession
    from krr_tpu_torch.federation.replica import ReplicaServer
    from krr_tpu_torch.federation.shard import FederatedShard
    from krr_tpu_torch.obs.trace import stitch_chrome
    from krr_tpu_torch.server.app import KrrServer
    from tests.fakes.torch_federation import (
        FleetInventory,
        MultiClusterFleet,
        ORIGIN,
        history_factory,
        stores_bitexact_by_key,
    )

    ticks = max(2, int(env.get("BENCH_FLEETOBS_TICKS", 4)))
    workloads = max(1, int(env.get("BENCH_FLEETOBS_WORKLOADS", 2)))
    tick_seconds = 300.0
    start = ORIGIN + 3600.0
    fleet = MultiClusterFleet(
        clusters=2,
        namespaces_per_cluster=2,
        workloads_per_namespace=workloads,
        seed=61,
    )

    def config(**overrides):
        return _service_config(device, tick_seconds, **overrides)

    async def soak(lineage: bool) -> dict:
        now = [start]
        server = KrrServer(
            config(
                federation_listen="127.0.0.1:0",
                federation_lineage_enabled=lineage,
            ),
            session=ScanSession(
                config(),
                inventory=FleetInventory(fleet, clusters=[]),
                history_factory=history_factory(fleet),
            ),
            clock=lambda: now[0],
        )
        await server.start(run_scheduler=False)
        shards = [
            FederatedShard(
                config(
                    clusters=[c],
                    federation_aggregator=f"127.0.0.1:{server.aggregator.port}",
                    federation_lineage_enabled=lineage,
                ),
                session=ScanSession(
                    config(clusters=[c]),
                    inventory=FleetInventory(fleet, clusters=[c]),
                    history_factory=history_factory(fleet),
                ),
                clock=lambda: now[0],
                shard_id=c,
            )
            for c in fleet.clusters
        ]
        replica = ReplicaServer(
            config(
                federation_aggregator=f"127.0.0.1:{server.aggregator.port}",
                federation_shard_id="bench-replica",
                federation_backoff_cap_seconds=0.2,
            ),
            clock=lambda: now[0],
        )
        await replica.start()

        async def wait(predicate, message, timeout=30.0):
            deadline = _time.monotonic() + timeout
            while not predicate():
                assert (
                    _time.monotonic() < deadline
                ), f"fleet_obs: timed out waiting for {message}"
                await asyncio.sleep(0.01)

        wall = 0.0
        try:
            agg = server.aggregator
            await wait(lambda: replica.client.connected, "replica subscribe")
            for t in range(ticks):
                now[0] = start + t * tick_seconds
                for shard in shards:
                    begin = _time.perf_counter()
                    assert await shard.tick(now[0])
                    wall += _time.perf_counter() - begin
                await wait(
                    lambda: all(
                        s.shard_id in agg._shards
                        and agg._shards[s.shard_id].enqueued >= s.epoch
                        for s in shards
                    ),
                    f"tick {t} records to enqueue",
                )
                begin = _time.perf_counter()
                assert await server.scheduler.run_once()
                wall += _time.perf_counter() - begin
                for shard in shards:
                    assert await shard.wait_acked(shard.epoch, timeout=10.0)
                await wait(
                    lambda: replica.client.feed_epoch >= agg._feed_epoch,
                    f"tick {t} replica install",
                )
            if lineage:
                # The replica's install receipt travels back over the feed
                # socket — the lineage chain's last hop must land before the
                # rings are read.
                await wait(
                    lambda: agg.newest_installed_lineage() is not None,
                    "a replica install ack",
                )
            payloads = [s.tracer.export_chrome() for s in shards] + [
                server.session.tracer.export_chrome(),
                replica.tracer.export_chrome(),
            ]
            metrics = server.state.metrics
            return {
                "wall": wall,
                "store": server.state.store,
                "payloads": payloads,
                "lineage": agg.epoch_lineage(n=64),
                "installed": agg.newest_installed_lineage(),
                "stage_counts": {
                    stage: metrics.value(
                        "krr_tpu_e2e_freshness_seconds_count", stage=stage
                    )
                    for stage in ("fold", "apply", "publish", "install")
                },
            }
        finally:
            for shard in shards:
                await shard.close()
            await replica.shutdown()
            await server.shutdown()

    control = asyncio.run(soak(lineage=False))
    report = asyncio.run(soak(lineage=True))

    # Stitched-trace gate: one component must carry all three cross-process
    # hops, and every re-parented remote span must resolve inside the merge.
    stitched = stitch_chrome(report["payloads"])
    spans = [e for e in stitched["traceEvents"] if e.get("ph") == "X"]
    ids_by_pid: dict = {}
    names_by_pid: dict = {}
    for event in spans:
        ids_by_pid.setdefault(event["pid"], set()).add(event["args"].get("span_id"))
        names_by_pid.setdefault(event["pid"], set()).add(event["name"])
    joined = [
        pid
        for pid, names in names_by_pid.items()
        if {"scan", "apply_record", "install"} <= names
    ]
    remote_spans = [e for e in spans if e["args"].get("remote")]
    remote_resolved = all(
        e["args"].get("parent_id") in ids_by_pid.get(e["pid"], ())
        for e in remote_spans
    )
    remote_installs = [e for e in remote_spans if e["name"] == "install"]
    lanes = max(
        (len({e["tid"] for e in spans if e["pid"] == pid}) for pid in joined),
        default=0,
    )
    stitched_ok = bool(joined) and bool(remote_installs) and remote_resolved

    # Lineage-monotonicity gate over every retained epoch record.
    def monotone() -> "tuple[bool, str]":
        if not report["lineage"]:
            return False, "no lineage records"
        for record in report["lineage"]:
            chain = [
                float(record["newest_sample_ts"]),
                float(record["fold_ts"]),
                float(record["apply_ts"]),
                float(record["publish_ts"]),
            ]
            if chain != sorted(chain):
                return False, f"epoch {record['epoch']} chain out of order: {chain}"
            for replica_id, install_ts in (record.get("installs") or {}).items():
                if float(install_ts) < float(record["publish_ts"]):
                    return False, (
                        f"epoch {record['epoch']} installed at {replica_id} "
                        "before its publish"
                    )
        if report["installed"] is None:
            return False, "no epoch carries a replica install receipt"
        return True, f"{len(report['lineage'])} epochs monotone"

    monotonic_ok, monotonic_detail = monotone()
    stages_ok = all(
        (report["stage_counts"].get(stage) or 0.0) >= 1.0
        for stage in ("fold", "apply", "publish", "install")
    )

    # Overhead gate: lineage stamping is metadata-only — same bytes in the
    # merged store, and a tick wall within 2% (50 ms floor at toy scale).
    equal, detail = stores_bitexact_by_key(report["store"], control["store"])
    overhead = report["wall"] - control["wall"]
    budget = max(0.02 * control["wall"], 0.05)

    secondary["fleet_obs_ticks"] = float(ticks)
    secondary["fleet_trace_stitched"] = 1.0 if stitched_ok else 0.0
    secondary["fleet_stitched_components"] = float(len(joined))
    secondary["fleet_stitched_lanes"] = float(lanes)
    secondary["fleet_freshness_monotonic"] = (
        1.0 if monotonic_ok and stages_ok else 0.0
    )
    secondary["fleet_lineage_epochs"] = float(len(report["lineage"]))
    secondary["fleet_lineage_wall_seconds"] = round(report["wall"], 4)
    secondary["fleet_control_wall_seconds"] = round(control["wall"], 4)
    secondary["fleet_lineage_overhead_seconds"] = round(overhead, 4)
    secondary["fleet_lineage_bitexact"] = 1.0 if equal else 0.0
    print(
        f"bench: fleet obs 2 shards + replica x {ticks} ticks -> "
        f"{len(joined)} stitched component(s) ({lanes} lanes), "
        f"{len(report['lineage'])} lineage epochs, lineage wall "
        f"{report['wall']:.3f}s vs control {control['wall']:.3f}s "
        f"({overhead:+.3f}s)",
        file=sys.stderr,
    )
    check(
        "fleet_trace_stitched",
        stitched_ok,
        f"joined={len(joined)}, remote_installs={len(remote_installs)}, "
        f"remote_resolved={remote_resolved}",
    )
    check(
        "fleet_freshness_monotonic",
        monotonic_ok and stages_ok,
        f"{monotonic_detail}; stage counts={report['stage_counts']}",
    )
    check(
        "fleet_lineage_overhead",
        equal and overhead <= budget,
        f"bitexact={equal} ({detail}), overhead={overhead:.3f}s "
        f"over budget={budget:.3f}s",
    )


def main(argv=None, environ=None) -> int:
    """Run the bench; return its exit code. The knobs are read from
    ``environ`` (default ``os.environ``), which is never written."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--smoke", action="store_true", help="every leg at toy sizes (SMOKE_DEFAULTS)")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu (the plain PyTorch versions)")
    args = parser.parse_args(argv)
    env = dict(os.environ if environ is None else environ)
    if args.smoke:
        for key, value in SMOKE_DEFAULTS.items():
            env.setdefault(key, value)

    try:
        device = resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        print(f"bench: no CUDA card for --device {args.device}: {e}", file=sys.stderr)
        return 1

    n = int(env.get("BENCH_CONTAINERS", 10_000))
    t = int(env.get("BENCH_TIMESTEPS", 120_960))
    if n < 1 or t < 1:
        print(f"bench: BENCH_CONTAINERS and BENCH_TIMESTEPS must be >= 1, got {n} x {t}", file=sys.stderr)
        return 1
    chunk = min(int(env.get("BENCH_CHUNK", 8_192)), t)
    # Best of 5 (bench.py's round-2 verdict: 3 left round-over-round
    # comparisons inside the recorded spread).
    runs = max(1, int(env.get("BENCH_RUNS", 5)))
    py_sample = int(env.get("BENCH_PY_SAMPLE", 3))
    parity_rows = min(n, max(1, int(env.get("BENCH_PARITY_ROWS", 512))))
    pipeline_depth = max(2, int(env.get("BENCH_PIPELINE_DEPTH", 16)))

    on_card = device.type == "cuda"
    if on_card:
        kind = torch.cuda.get_device_name(device)
        print(f"bench: nvidia-smi: {nvidia_smi()}", file=sys.stderr)
        device_info = {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}
    else:
        device_info = {"platform": "cpu", "kind": "cpu", "count": 1}
    print(f"bench: {n} containers x {t} timesteps on {device}:{device_info['kind']}", file=sys.stderr)

    values = generate(n, t, chunk, 0, device)  # CPU histories
    mem_values = generate(n, t, chunk, 1, device)  # memory histories (same shape)
    counts = torch.full((n,), t, dtype=torch.int32, device=device)
    _ = values[:1, :4].cpu(), mem_values[:1, :4].cpu()  # generation done

    cuda_select.reset_launches()
    cuda_sketch.reset_launches()
    parity_failures: list[str] = []

    def check(name: str, ok: bool, detail: str = "") -> None:
        if ok:
            print(f"bench: parity [{name}] ok", file=sys.stderr)
        else:
            parity_failures.append(name)
            print(f"bench: parity [{name}] FAILED {detail}", file=sys.stderr)

    def exact_step(values, counts):
        # The full exact strategy program — CPU p99 selection + memory
        # peak — two kernels into one [2, N] tensor, one readback.
        return cuda_select.fleet_exact(values, counts, mem_values, counts, 99.0)

    def timed(step) -> tuple[float, float]:
        """(best, spread_pct) over `runs` timed calls after a warmup, each
        ending in a host readback."""
        step(values, counts).cpu()
        times = [_time_once(lambda: step(values, counts).cpu()) for _ in range(runs)]
        best = min(times)
        return best, 100.0 * (max(times) - best) / best

    exact_elapsed, exact_spread = timed(exact_step)
    throughput = n / exact_elapsed
    print(
        f"bench: exact select+max {exact_elapsed:.4f}s (spread {exact_spread:.0f}% over {runs}) "
        f"-> {throughput:.0f} containers/s",
        file=sys.stderr,
    )

    # Measured dispatch floor: one trivial op + host readback.
    tiny = torch.ones((8, 128), dtype=torch.float32, device=device)
    tiny.sum(dim=1).cpu()
    floor = min(_time_once(lambda: tiny.sum(dim=1).cpu()) for _ in range(5))
    print(f"bench: dispatch+readback floor {floor * 1e3:.3f} ms", file=sys.stderr)

    # Pipelined headline: R programs back to back on the stream, ONE
    # readback of the last (the stream runs them in order), so the
    # per-call launch and readback cost is paid once per R programs.
    def dispatch_pipeline() -> None:
        results = [exact_step(values, counts) for _ in range(pipeline_depth)]
        results[-1].cpu()

    pipe_times = [_time_once(dispatch_pipeline) for _ in range(runs)]
    pipe_best = min(pipe_times)
    pipe_spread = 100.0 * (max(pipe_times) - pipe_best) / pipe_best
    pipelined_throughput = n * pipeline_depth / pipe_best
    # The subtraction means nothing when the floor comes within 1 ms of the
    # measurement: report null then.
    corrected_seconds = exact_elapsed - floor
    floor_corrected = n / corrected_seconds if corrected_seconds > 1e-3 else None
    print(
        f"bench: pipelined x{pipeline_depth} {pipe_best:.4f}s (spread {pipe_spread:.0f}%) "
        f"-> {pipelined_throughput:.0f} containers/s ({pipe_best / pipeline_depth * 1e3:.3f} ms/call)",
        file=sys.stderr,
    )

    # Parity gate 1: the kernels against their plain PyTorch version, on the
    # same device and rows, bit for bit.
    sub_v = values[:parity_rows]
    sub_m = mem_values[:parity_rows]
    sub_c = counts[:parity_rows]
    got = cuda_select.fleet_exact(sub_v, sub_c, sub_m, sub_c, 99.0)
    want = cuda_select.fleet_exact_plain(sub_v, sub_c, sub_m, sub_c, 99.0)
    check(
        "fleet_exact==plain",
        same_bits(got, want),
        f"max |Δ| = {(got - want).abs().max().item() if got.shape == want.shape else 'shape'}",
    )
    exact_p99_sub = got[0]

    # The memory histories are not needed past here.
    del exact_step, sub_m, got, want
    mem_values = None

    secondary: dict = {}
    k = topk_sketch.required_k(t, 99.0)
    topk_elapsed, topk_spread = timed(lambda values, counts: topk_step(values, counts, k))
    secondary["topk_containers_per_sec"] = round(n / topk_elapsed, 1)
    print(
        f"bench: exact top-K sketch (K={k}, one topk_select launch) {topk_elapsed:.4f}s "
        f"(spread {topk_spread:.0f}%) -> {n / topk_elapsed:.0f} containers/s",
        file=sys.stderr,
    )
    # Parity gate 2: the sketch's p99 equals the exact selection.
    topk_p99_sub = topk_step(sub_v, sub_c, k)[0]
    check(
        "topk_sketch==exact",
        same_bits(topk_p99_sub, exact_p99_sub),
        f"max |Δ| = {(topk_p99_sub - exact_p99_sub).abs().max().item()}",
    )

    spec = DigestSpec(gamma=1.01, min_value=1e-7, num_buckets=2560)
    digest_elapsed, digest_spread = timed(lambda values, counts: digest_step(spec, values, counts))
    secondary["digest_containers_per_sec"] = round(n / digest_elapsed, 1)
    print(
        f"bench: digest sketch (one digest_hist launch) {digest_elapsed:.4f}s "
        f"(spread {digest_spread:.0f}%) -> {n / digest_elapsed:.0f} containers/s",
        file=sys.stderr,
    )
    # Parity gate 3: the digest honours its relative-error bound;
    # gate 4: its tracked peak is exact (memory recommendations use it).
    est, peak_sub = digest_step(spec, sub_v, sub_c)
    rel = (est - exact_p99_sub).abs() / torch.clamp_min(exact_p99_sub, spec.min_value)
    bound = spec.relative_error * 1.05 + 1e-6  # bound + float slack
    check(
        "digest_error_bound",
        bool((rel <= bound).all()),
        f"max rel err = {rel.max().item():.5f} vs bound {bound:.5f}",
    )
    check("digest_peak==max", same_bits(peak_sub, cuda_select.masked_max_cuda(sub_v, sub_c)),
          "peak mismatch")

    launches = launch_counts()
    secondary["kernel_launches"] = launches
    if on_card:
        check("kernels_launched", all(launches[name] >= 1 for name in KERNELS), f"launches {launches}")
    # The end-to-end legs use the card from other processes: free it.
    values = counts = sub_v = sub_c = exact_p99_sub = None

    # The service-plane and observability legs, in `bench.py`'s order. Each
    # one's launches of the counted kernels are read around it and gated:
    # on the card a host leg launches none, `KERNEL_LEGS` exactly what
    # their calls imply; the plain versions count none. A leg that raises
    # fails the bench; a failed gate goes through `check`.
    by_leg: dict = {}

    def run_leg(name: str, leg, *args):
        before = launch_counts()
        result = leg(*args)
        after = launch_counts()
        delta = {kernel: after[kernel] - before[kernel] for kernel in COUNTED_KERNELS}
        by_leg[name] = delta
        expected = result if on_card and name in KERNEL_LEGS else dict.fromkeys(COUNTED_KERNELS, 0)
        check(f"{name}_kernel_launches", delta == expected, f"launched {delta}, expected {expected}")
        return result

    dev = str(device)
    if not env.get("BENCH_SKIP_JOURNAL"):
        run_leg("journal", journal_leg, secondary, env)
    if not env.get("BENCH_SKIP_OBS"):
        # The tracing-overhead legs, then the sentinel, which reads the obs
        # leg's scan wall.
        tracer = run_leg("obs", obs_leg, secondary, check, env, dev)
        run_leg("analyze", analyze_smoke_leg, tracer, secondary, check, env)
        run_leg("obs_device", obs_device_leg, secondary, check, env, dev)
        run_leg("sentinel", sentinel_leg, secondary, check, env)
    if not env.get("BENCH_SKIP_CHAOS"):
        run_leg("chaos", chaos_leg, secondary, check, env, dev)
    if not env.get("BENCH_SKIP_EVAL"):
        run_leg("eval", eval_leg, secondary, check, env, dev)
    if not env.get("BENCH_SKIP_DISCOVERY"):
        run_leg("discovery", discovery_leg, secondary, check, env, dev)
    if not env.get("BENCH_SKIP_INGEST"):
        run_leg("ingest", ingest_leg, secondary, check, env, dev)
    if not env.get("BENCH_SKIP_FETCHPLAN"):
        run_leg("fetchplan", fetchplan_leg, secondary, check, env, dev)
    if not env.get("BENCH_SKIP_WIRE"):
        run_leg("wire", wire_leg, secondary, check, env, dev)
    if not env.get("BENCH_SKIP_FEDERATION"):
        run_leg("federation", federation_leg, secondary, check, env, dev)
    if not env.get("BENCH_SKIP_HA"):
        run_leg("ha", ha_leg, secondary, check, env, dev)
    if not env.get("BENCH_SKIP_FLEETOBS"):
        run_leg("fleet_obs", fleet_obs_leg, secondary, check, env, dev)
    if not env.get("BENCH_SKIP_READPATH"):
        run_leg("readpath", readpath_leg, secondary, check, env, dev)
    if not env.get("BENCH_SKIP_STORE"):
        run_leg("store", store_leg, secondary, check, env)
        run_leg("store_kill", store_kill_leg, secondary, check, env, dev)
    secondary["kernel_launches_by_leg"] = by_leg

    leg_failures: list[str] = []
    if not env.get("BENCH_SKIP_E2E"):
        # Record the e2e number at fleet scale unless the caller pinned a size.
        e2e_env = {"BENCH_E2E_CONTAINERS": "10000", **env}
        leg_failures = run_e2e_legs(e2e_env, str(device), secondary)

    py_per_container = python_reference_seconds_per_container(t, py_sample)
    baseline_throughput = 1.0 / py_per_container
    print(
        f"bench: python-reference {py_per_container:.3f}s/container ({baseline_throughput:.2f}/s)",
        file=sys.stderr,
    )

    print(
        json.dumps(
            {
                "metric": "containers_per_sec_exact_p99_7d_at_5s_pipelined",
                "value": round(pipelined_throughput, 1),
                "unit": "containers/s",
                "vs_baseline": round(pipelined_throughput / baseline_throughput, 1),
                "parity": "fail" if parity_failures else "ok",
                "runs": runs,
                "raw_containers_per_sec": round(throughput, 1),
                "raw_spread_pct": round(exact_spread, 1),
                "raw_vs_baseline": round(throughput / baseline_throughput, 1),
                "dispatch_floor_ms": round(floor * 1e3, 3),
                "pipelined_depth": pipeline_depth,
                "pipelined_spread_pct": round(pipe_spread, 1),
                "floor_corrected_containers_per_sec": (
                    round(floor_corrected, 1) if floor_corrected is not None else None
                ),
                **_previous_round_fields(pipelined_throughput),
                **_fetch_trendline_fields(secondary),
                **_readpath_trendline_fields(secondary),
                "device": device_info,
                "secondary": secondary,
            }
        )
    )
    if parity_failures:
        print(f"bench: PARITY FAILURES: {parity_failures}", file=sys.stderr)
    if leg_failures:
        print(f"bench: LEG FAILURES: {leg_failures}", file=sys.stderr)
    return 1 if parity_failures or leg_failures else 0


def _previous_round_payload():
    """(filename, parsed payload) of the newest recorded
    ``BENCH_TORCH_r*.json``, or None — the shared source of every
    round-over-round gate."""
    import glob
    import re

    newest, newest_round = None, -1
    for path in glob.glob(os.path.join(ROUNDS_DIR, f"{ROUND_PREFIX}*.json")):
        match = re.search(rf"{ROUND_PREFIX}(\d+)\.json$", path)
        if match and int(match.group(1)) > newest_round:
            newest, newest_round = path, int(match.group(1))
    if newest is None:
        return None
    try:
        with open(newest) as f:
            payload = json.load(f)
        # A round record wraps the bench's own JSON line under "parsed".
        return os.path.basename(newest), payload.get("parsed", payload)
    except (OSError, ValueError, AttributeError):
        return None


def _previous_round_stable():
    """(filename, headline ``value``) of the newest recorded round, or None."""
    previous = _previous_round_payload()
    if previous is None:
        return None
    prev_file, payload = previous
    try:
        return prev_file, float(payload["value"])
    except (KeyError, TypeError, ValueError):
        return None


def _previous_round_fields(pipelined_throughput: float) -> dict:
    """This run's pipelined headline against the newest recorded round's
    stable rate; ``regression_vs_previous`` trips at a drop past 5 %. The
    fields are emitted with or without a previous round."""
    previous = _previous_round_stable()
    if previous is None:
        return {
            "vs_previous_round": None,
            "previous_round_file": None,
            "previous_round_stable_rate": None,
            "regression_vs_previous": False,
        }
    prev_file, prev_rate = previous
    vs_previous = pipelined_throughput / prev_rate
    regression = vs_previous < 0.95
    print(
        f"bench: vs {prev_file} stable rate {prev_rate:.0f} -> x{vs_previous:.3f}"
        + (" REGRESSION (>5% below previous round)" if regression else ""),
        file=sys.stderr,
    )
    return {
        "vs_previous_round": round(vs_previous, 3),
        "previous_round_file": prev_file,
        "previous_round_stable_rate": round(prev_rate, 1),
        "regression_vs_previous": regression,
    }


def _fetch_trendline_fields(secondary: dict) -> dict:
    """The fleet-scan fetch-wall gate: this run's warm
    ``fleet_e2e_fetch_seconds`` against the newest recorded round's at the
    same fleet width (>15 % slower flags a regression), and its twin on the
    warm scan's wire MB. The fields are emitted unconditionally."""
    fields = {
        "fetch_vs_previous_round": None,
        "previous_round_fetch_seconds": None,
        "fetch_regression_vs_previous": False,
        "wire_vs_previous_round": None,
        "previous_round_wire_mb": None,
        "wire_regression_vs_previous": False,
    }
    current = secondary.get("fleet_e2e_fetch_seconds")
    previous = _previous_round_payload()
    if previous is None or not isinstance(current, (int, float)) or current <= 0:
        return fields
    prev_file, payload = previous
    prev_secondary = payload.get("secondary") or {}
    prev_fetch = prev_secondary.get("fleet_e2e_fetch_seconds")
    if not isinstance(prev_fetch, (int, float)) or prev_fetch <= 0:
        return fields
    if prev_secondary.get("fleet_e2e_containers") != secondary.get("fleet_e2e_containers"):
        # Another fleet width (a --smoke run against a full round): the
        # ratio would read the scale, not the transport.
        return fields
    vs = current / prev_fetch  # >1 = slower than the previous round
    regression = vs > 1.15
    print(
        f"bench: fleet fetch {current}s vs {prev_file} {prev_fetch}s -> x{vs:.3f}"
        + (" FETCH REGRESSION (>15% above previous round)" if regression else ""),
        file=sys.stderr,
    )
    fields.update(
        {
            "fetch_vs_previous_round": round(vs, 3),
            "previous_round_fetch_seconds": prev_fetch,
            "fetch_regression_vs_previous": regression,
        }
    )
    current_wire = secondary.get("fleet_e2e_wire_mb")
    prev_wire = prev_secondary.get("fleet_e2e_wire_mb")
    if (
        isinstance(current_wire, (int, float)) and current_wire > 0
        and isinstance(prev_wire, (int, float)) and prev_wire > 0
    ):
        wire_vs = current_wire / prev_wire
        wire_regression = wire_vs > 1.15
        print(
            f"bench: fleet wire {current_wire} MB vs {prev_file} {prev_wire} MB -> x{wire_vs:.3f}"
            + (" WIRE REGRESSION (>15% above previous round)" if wire_regression else ""),
            file=sys.stderr,
        )
        fields.update(
            {
                "wire_vs_previous_round": round(wire_vs, 3),
                "previous_round_wire_mb": prev_wire,
                "wire_regression_vs_previous": wire_regression,
            }
        )
    return fields


def _readpath_trendline_fields(secondary: dict) -> dict:
    """The read-path p99 gate, mirroring the fetch-wall one: this run's
    loadtest ``readpath_p99_ms`` vs the newest recorded round's at the SAME
    readpath fleet width (a smoke run must not compare against a full
    round), read through `_previous_round_payload` (``BENCH_TORCH_r*.json``
    only). >15% slower flags ``readpath_regression_vs_previous`` — a cache
    wired out of the hot path or a render-pool misbound shows up here as a
    latency cliff, not a silent serving regression. Fields are emitted
    unconditionally so gate scripts can read them without probing."""
    fields = {
        "readpath_vs_previous_round": None,
        "previous_round_readpath_p99_ms": None,
        "readpath_regression_vs_previous": False,
    }
    current = secondary.get("readpath_p99_ms")
    previous = _previous_round_payload()
    if previous is None or not isinstance(current, (int, float)) or current <= 0:
        return fields
    prev_file, payload = previous
    prev_secondary = payload.get("secondary") or {}
    prev_p99 = prev_secondary.get("readpath_p99_ms")
    if not isinstance(prev_p99, (int, float)) or prev_p99 <= 0:
        return fields
    if prev_secondary.get("readpath_workloads") != secondary.get("readpath_workloads"):
        return fields
    vs = current / prev_p99  # >1 = slower than the previous round
    regression = vs > 1.15
    print(
        f"bench: readpath p99 {current} ms vs {prev_file} {prev_p99} ms -> x{vs:.3f}"
        + (" READPATH REGRESSION (>15% above previous round)" if regression else ""),
        file=sys.stderr,
    )
    fields.update(
        {
            "readpath_vs_previous_round": round(vs, 3),
            "previous_round_readpath_p99_ms": prev_p99,
            "readpath_regression_vs_previous": regression,
        }
    )
    return fields


if __name__ == "__main__":
    sys.exit(main())
