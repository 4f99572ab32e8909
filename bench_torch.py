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
     "device": {...}, "secondary": {...}}
The round-over-round fields read the newest ``BENCH_TORCH_r*.json`` beside
this script, never a ``BENCH_r*.json`` (those are rounds of the JAX
program on other hardware).

Env knobs (`bench.py`'s names and defaults): BENCH_CONTAINERS (10000),
BENCH_TIMESTEPS (120960), BENCH_CHUNK (8192), BENCH_RUNS (5),
BENCH_PIPELINE_DEPTH (16), BENCH_PY_SAMPLE (3), BENCH_PARITY_ROWS (512),
BENCH_SKIP_E2E, and the BENCH_E2E_* sizes of `bench_e2e_torch.py`.

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


if __name__ == "__main__":
    sys.exit(main())
