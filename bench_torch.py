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

The service-plane legs then run in this process, in `bench.py`'s order,
each with `bench.py`'s ``secondary.<prefix>_*`` fields and gates, every
``Config`` on ``--device``: ``ingest_leg`` (a remote-write-fed serve
against a range-fetched pull control), ``federation_leg`` (shards over TCP
into an aggregator against a single-process control), ``ha_leg`` (a 2-node
ring with a killed primary, a duplicate record and a read replica),
``readpath_leg`` (keep-alive readers against a live serve and an uncached
control), ``store_leg`` (the durable store's delta append, legacy rewrite
and recovery) and ``store_kill_leg`` (SIGKILLed serve subprocesses,
`tests/fakes/torch_soak_driver.py`, against a never-killed control). They
are host code: on the card no kernel may launch in them
(``service_legs_launched_no_kernel``). A leg that raises fails the bench;
a failed gate, exact or wall-clock, is a parity failure.

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
service legs': BENCH_SKIP_INGEST, BENCH_INGEST_WORKLOADS (200),
BENCH_INGEST_ROUNDS (5); BENCH_SKIP_FEDERATION, BENCH_FED_SHARDS (3),
BENCH_FED_TICKS (4), BENCH_FED_WORKLOADS (2); BENCH_SKIP_HA, BENCH_HA_TICKS
(4), BENCH_HA_WORKLOADS (2), BENCH_HA_CLIENTS (4), BENCH_HA_REQUESTS (40);
BENCH_SKIP_READPATH, BENCH_READPATH_WORKLOADS (400), BENCH_READPATH_CLIENTS
(8), BENCH_READPATH_REQUESTS (120); BENCH_SKIP_STORE, BENCH_STORE_ROWS
(100000), BENCH_STORE_KILLS (2), BENCH_STORE_KILL_TICKS (6).

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
    # Durable-store legs: delta-append vs legacy full rewrite + recovery
    # replay at toy row counts, and the kill-recover-verify soak (real
    # SIGKILLed serve subprocesses) with a reduced kill budget.
    "BENCH_STORE_ROWS": "512",
    "BENCH_STORE_KILLS": "2",
    "BENCH_STORE_KILL_TICKS": "6",
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

    launches = {**cuda_select.LAUNCHES, **cuda_sketch.LAUNCHES}
    secondary["kernel_launches"] = launches
    if on_card:
        check("kernels_launched", all(launches[name] >= 1 for name in KERNELS), f"launches {launches}")
    # The end-to-end legs use the card from other processes: free it.
    values = counts = sub_v = sub_c = exact_p99_sub = None

    # The service-plane legs, in `bench.py`'s order: host code on the
    # port's serve, ingest, federation and store planes (their digests are
    # built and queried on the host), every composition on ``device``. A
    # leg that raises fails the bench; a failed gate goes through `check`.
    if not env.get("BENCH_SKIP_INGEST"):
        ingest_leg(secondary, check, env, str(device))
    if not env.get("BENCH_SKIP_FEDERATION"):
        federation_leg(secondary, check, env, str(device))
    if not env.get("BENCH_SKIP_HA"):
        ha_leg(secondary, check, env, str(device))
    if not env.get("BENCH_SKIP_READPATH"):
        readpath_leg(secondary, check, env, str(device))
    if not env.get("BENCH_SKIP_STORE"):
        store_leg(secondary, check, env)
        store_kill_leg(secondary, check, env, str(device))
    if on_card:
        after = {**cuda_select.LAUNCHES, **cuda_sketch.LAUNCHES}
        check("service_legs_launched_no_kernel", after == launches, f"launches {launches} -> {after}")

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
