#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`krr_tpu_torch`) on one NVIDIA GPU and check it.

    python3 chip_smoke.py            # every phase; needs one CUDA GPU

Phases, each printing one JSON line (any failure raises and exits non-zero):

1. ``device``  — the card's name, its ``nvidia-smi`` name and power limit.
2. ``build``   — compile every ``krr_tpu_torch/csrc/*.cu`` with nvcc for
   ``sm_90a`` (one nvcc per source, started together).
3. ``parity``  — each kernel against its plain PyTorch version on the same
   CUDA tensors, and the plain version on the card against the plain version
   on the CPU: fuzzed ragged rows salted with edge values (±0.0, negatives,
   NaN payloads, subnormals, ±inf, huge values), odd widths, rows longer
   than a block's shared-memory cache, N = 0 and T = 0, and the memory shape
   of the ``e2e`` scan. Bit-exact.
4. ``headline`` — the benchmark shape (10,000 × 120,960 float32 for CPU and
   for memory, generated on the card from a seeded generator): CUDA-event
   medians of ``fleet_exact`` and each kernel, the plain version once, the
   library yardsticks (``torch.kthvalue`` at the same rank, ``torch.amax``),
   each kernel's bound, and parity of the kernels with the plain versions;
   also ``row_max`` at the memory shape of the ``e2e`` scan.
5. ``e2e``     — the port's one-shot ``simple`` scan through ``Runner.run``
   with in-memory inventory and history sources: 10,000 objects × 3 pods,
   40,320 CPU samples per pod (7 days at 5 s) made with numpy from a seed,
   memory through the stats route (one max per pod), json output. Checks
   10,000 scans with no ``?``, that both kernels launched during the scan,
   and that a 256-object re-run on the CPU renders the same JSON bytes.

The last three lines are the card's ``nvidia-smi`` name and power limit, one
``{"kernels": [...]}`` JSON object, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

#: Published H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and the
#: float32 rate outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12

HEADLINE_ROWS = 10_000
HEADLINE_T = 120_960
E2E_OBJECTS = 10_000
E2E_PODS = 3
E2E_SAMPLES_PER_POD = 40_320
E2E_CPU_CHECK_ROWS = 256

KERNELS = {
    "bisect_select": "krr_tpu/ops/pallas_select.py:61",
    "row_max": "krr_tpu/ops/pallas_select.py:93",
}
KERNEL_SOURCE = "krr_tpu_torch/csrc/select.cu"


class SmokeFailure(AssertionError):
    pass


def check(ok: bool, message: str) -> None:
    if not ok:
        raise SmokeFailure(message)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def bound(n: int, t: int) -> tuple[float, str]:
    """(ms, "bytes" | "operations"): the least time for one per-row
    reduction over an [n, t] float32 matrix — every sample read once (plus
    the counts and one output per row) at the HBM rate, or at least one
    operation per sample at the float32 rate, whichever is longer."""
    bytes_ms = 1e3 * (4 * n * t + 4 * n + 4 * n) / PEAK_BYTES_PER_S
    ops_ms = 1e3 * n * t / PEAK_F32_OPS_PER_S
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def cuda_ms(torch, fn, warmup: int = 1, runs: int = 5) -> list[float]:
    """Per-run milliseconds of ``fn`` between CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def same_bits(torch, a, b) -> bool:
    return a.shape == b.shape and bool(torch.equal(a.cpu().view(torch.int32), b.cpu().view(torch.int32)))


def max_abs_err(torch, a, b) -> float:
    a, b = a.double().cpu(), b.double().cpu()
    check(bool(torch.equal(torch.isnan(a), torch.isnan(b))), "NaN positions differ")
    finite = ~torch.isnan(a)
    if not bool(finite.any()):
        return 0.0
    return float((a[finite] - b[finite]).abs().max())


# ------------------------------------------------------------------ phases
def phase_build() -> None:
    from krr_tpu_torch.ops import cuda_build

    started = time.perf_counter()
    report = cuda_build.build_all()
    ptxas = {
        name: [line.strip() for line in entry["log"].splitlines() if "registers" in line or "smem" in line]
        for name, entry in report.items()
    }
    emit("build", seconds=time.perf_counter() - started, sources=sorted(report), ptxas=ptxas)


def fuzz(np, seed: int, n: int, t: int, special_frac: float = 0.2):
    special = np.array(
        [
            0x00000000, 0x80000000, 0xBFC00000, 0xFF7FFFFF, 0x7F7FFFFF, 0x7F800000, 0xFF800000,
            0x7FC00000, 0x7FFFFFFF, 0xFFC00000, 0x00000001, 0x000F0000, 0x800F0000, 0x00800000,
        ],
        dtype=np.uint32,
    ).view(np.float32)
    rng = np.random.default_rng(seed)
    values = rng.gamma(2.0, 0.05, size=(n, t)).astype(np.float32)
    if seed % 3 == 0:  # heavy ties
        values = (rng.integers(0, 6, size=(n, t)) / 4).astype(np.float32)
    salted = rng.random((n, t)) < special_frac
    values[salted] = rng.choice(special, int(salted.sum()))
    counts = rng.integers(0, t + 1, size=n).astype(np.int32)
    if n > 1:
        counts[0], counts[1] = 0, t
    return values, counts


def main_path_memory(torch, np):
    """The memory input ``row_max`` gets in the ``e2e`` scan: one max per pod
    (stats route), packed to one 128-lane row per object; fuzzed, with 0 to
    ``E2E_PODS`` valid samples per row."""
    values, counts = fuzz(np, 99, E2E_OBJECTS, 128)
    counts = np.minimum(counts, E2E_PODS).astype(np.int32)
    return torch.from_numpy(values).cuda(), torch.from_numpy(counts).cuda()


def phase_parity(torch, np) -> dict:
    from krr_tpu_torch.ops import cuda_select
    from krr_tpu_torch.ops.quantile import masked_max
    from krr_tpu_torch.ops.selection import masked_percentile_bisect

    dev = torch.device("cuda")
    shapes = [(300, 1), (257, 31), (301, 1000), (129, 4097), (97, 8191), (64, 8192), (24, 70_001),
              (8, HEADLINE_T), (0, 16), (5, 0)]
    errs = {"bisect_select": 0.0, "row_max": 0.0}
    cases = 0
    for i, (n, t) in enumerate(shapes):
        for special_frac in (0.0, 0.2):
            values, counts = fuzz(np, 100 + i + (50 if special_frac else 0), n, t, special_frac)
            v_cpu, c_cpu = torch.from_numpy(values), torch.from_numpy(counts)
            v, c = v_cpu.to(dev), c_cpu.to(dev)
            for q in (0.0, 50.0, 95.0, 99.0, 100.0, 120.0):
                kernel = cuda_select.masked_percentile_bisect_cuda(v, c, q)
                if n and t:
                    plain = masked_percentile_bisect(v, c, q)
                    check(same_bits(torch, kernel, plain),
                          f"bisect_select != plain at n={n} t={t} q={q} frac={special_frac}")
                    check(same_bits(torch, plain, masked_percentile_bisect(v_cpu, c_cpu, q)),
                          f"plain bisect on the card != on the CPU at n={n} t={t} q={q}")
                    errs["bisect_select"] = max(errs["bisect_select"], max_abs_err(torch, kernel, plain))
                else:
                    check(bool(torch.isnan(kernel).all()) and kernel.shape == (n,),
                          f"degenerate select at n={n} t={t}")
                cases += 1
            kernel = cuda_select.masked_max_cuda(v, c)
            if n and t:
                plain = masked_max(v, c)
                check(same_bits(torch, kernel, plain), f"row_max != plain at n={n} t={t} frac={special_frac}")
                check(same_bits(torch, plain, masked_max(v_cpu, c_cpu)),
                      f"plain max on the card != on the CPU at n={n} t={t}")
                errs["row_max"] = max(errs["row_max"], max_abs_err(torch, kernel, plain))
            else:
                check(bool(torch.isnan(kernel).all()) and kernel.shape == (n,), f"degenerate max at n={n} t={t}")
            cases += 1
    v, c = main_path_memory(torch, np)
    kernel = cuda_select.masked_max_cuda(v, c)
    plain = masked_max(v, c)
    check(same_bits(torch, kernel, plain), "row_max != plain at the main path's memory shape")
    errs["row_max"] = max(errs["row_max"], max_abs_err(torch, kernel, plain))
    cases += 1
    for n, tc, tm in [(211, 1000, 130), (64, 4097, 3), (33, 0, 64), (33, 64, 0), (0, 32, 32), (9, 70_001, 128)]:
        cpu, cpu_counts = fuzz(np, 7 + n, n, tc)
        mem, mem_counts = fuzz(np, 8 + n, n, tm)
        args = [torch.from_numpy(a).to(dev) for a in (cpu, cpu_counts, mem, mem_counts)]
        for q in (50.0, 99.0):
            kernel = cuda_select.fleet_exact(*args, q)
            plain = cuda_select.fleet_exact_plain(*args, q)
            check(same_bits(torch, kernel, plain), f"fleet_exact != plain at n={n} tc={tc} tm={tm} q={q}")
            cases += 1
    torch.cuda.synchronize()
    emit("parity", cases=cases, bit_exact=True, max_abs_err=errs)
    return errs


def phase_headline(torch, np) -> dict:
    from krr_tpu_torch.ops import cuda_select
    from krr_tpu_torch.ops.quantile import masked_max
    from krr_tpu_torch.ops.selection import masked_percentile_bisect, selection_rank

    dev = torch.device("cuda")
    n, t, q = HEADLINE_ROWS, HEADLINE_T, 99.0

    def generate(seed: int):
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        values = torch.rand((n, t), generator=gen, device=dev, dtype=torch.float32)
        return values.mul_(values).mul_(0.8).add_(1e-4)  # right-skewed cpu-like values

    cpu = generate(0)
    mem = generate(1)
    counts = torch.full((n,), t, dtype=torch.int32, device=dev)

    fleet_times = cuda_ms(torch, lambda: cuda_select.fleet_exact(cpu, counts, mem, counts, q))
    select_times = cuda_ms(torch, lambda: cuda_select.masked_percentile_bisect_cuda(cpu, counts, q))
    max_times = cuda_ms(torch, lambda: cuda_select.masked_max_cuda(mem, counts))

    kernel_p = cuda_select.masked_percentile_bisect_cuda(cpu, counts, q)
    kernel_m = cuda_select.masked_max_cuda(mem, counts)
    plain_select_ms = cuda_ms(torch, lambda: masked_percentile_bisect(cpu, counts, q), warmup=0, runs=1)[0]
    plain_p = masked_percentile_bisect(cpu, counts, q)
    plain_max_ms = cuda_ms(torch, lambda: masked_max(mem, counts), warmup=0, runs=1)[0]
    plain_m = masked_max(mem, counts)
    check(same_bits(torch, kernel_p, plain_p), "headline bisect_select != plain")
    check(same_bits(torch, kernel_m, plain_m), "headline row_max != plain")
    sample = slice(0, 512)
    check(same_bits(torch, kernel_p[sample], masked_percentile_bisect(cpu[sample].cpu(), counts[sample].cpu(), q)),
          "headline bisect_select != plain on the CPU (512-row sample)")

    k = int(selection_rank(counts[:1], q)[0]) + 1  # kthvalue is 1-based
    kth_times = cuda_ms(torch, lambda: torch.kthvalue(cpu, k, dim=1), warmup=1, runs=3)
    kth = torch.kthvalue(cpu, k, dim=1).values
    amax_times = cuda_ms(torch, lambda: torch.amax(mem, dim=1))

    # row_max at the memory shape the e2e scan gives it: a few microseconds,
    # so each timed run holds 100 launches.
    main_v, main_c = main_path_memory(torch, np)
    main_valid = int(main_c.sum())

    def hundred_row_max():
        for _ in range(100):
            cuda_select.masked_max_cuda(main_v, main_c)

    main_times = [ms / 100 for ms in cuda_ms(torch, hundred_row_max)]
    main_bound = 1e3 * (4 * main_valid + 8 * main_v.shape[0]) / PEAK_BYTES_PER_S
    del main_v, main_c

    fleet = cuda_select.fleet_exact(cpu, counts, mem, counts, q)
    check(same_bits(torch, fleet[0], kernel_p) and same_bits(torch, fleet[1], kernel_m),
          "fleet_exact rows != the kernels run alone")
    errs = {"bisect_select": max_abs_err(torch, kernel_p, plain_p), "row_max": max_abs_err(torch, kernel_m, plain_m)}
    kth_equal = bool(torch.equal(kth, kernel_p))
    peak = torch.cuda.max_memory_allocated(dev)
    del cpu, mem, counts, plain_p, plain_m, kernel_p, kernel_m, kth, fleet
    torch.cuda.empty_cache()

    headline = {
        "shape": [n, t],
        "q": q,
        "fleet_exact_ms": statistics.median(fleet_times),
        "fleet_exact_runs_ms": fleet_times,
        "fleet_exact_bound_ms": 2 * bound(n, t)[0],
        "bisect_select": {
            "ms": statistics.median(select_times), "runs_ms": select_times, "plain_ms": plain_select_ms,
            "library_ms": statistics.median(kth_times), "library": "torch.kthvalue",
            "bound_ms": bound(n, t)[0], "bound_by": bound(n, t)[1], "max_abs_err": errs["bisect_select"],
        },
        "row_max": {
            "ms": statistics.median(max_times), "runs_ms": max_times, "plain_ms": plain_max_ms,
            "library_ms": statistics.median(amax_times), "library": "torch.amax",
            "bound_ms": bound(n, t)[0], "bound_by": bound(n, t)[1], "max_abs_err": errs["row_max"],
        },
        "row_max_main_path": {
            "shape": [E2E_OBJECTS, 128], "valid_samples": main_valid, "ms": statistics.median(main_times),
            "runs_ms": main_times, "bound_ms": main_bound, "bound_by": "bytes",
        },
        "kthvalue_equals_kernel": kth_equal,
        "peak_device_bytes": peak,
    }
    emit("headline", **headline)
    return headline


class _Inventory:
    def __init__(self, objects):
        self.objects = objects

    async def list_clusters(self):
        return None

    async def list_scannable_objects(self, clusters):
        return list(self.objects)


class _History:
    """Serves per-pod CPU views of one flat sample array and, through the
    stats route, one memory max per pod."""

    def __init__(self, np, cpu_flat, mem_max, resource_type):
        self.np = np
        self.cpu_flat = cpu_flat
        self.mem_max = mem_max
        self.resource_type = resource_type

    async def gather_fleet(self, objects, history_seconds, step_seconds, stats_resources=frozenset()):
        cpu_type, mem_type = self.resource_type.CPU, self.resource_type.Memory
        check(mem_type in stats_resources, "the simple strategy must ask for memory through the stats route")
        cpu, memory = [], []
        for obj in objects:
            row = int(obj.name.rsplit("-", 1)[1])
            first = row * E2E_PODS * E2E_SAMPLES_PER_POD
            cpu.append({
                pod: self.cpu_flat[first + p * E2E_SAMPLES_PER_POD:first + (p + 1) * E2E_SAMPLES_PER_POD]
                for p, pod in enumerate(obj.pods)
            })
            memory.append({pod: self.np.asarray([self.mem_max[row, p]]) for p, pod in enumerate(obj.pods)})
        return {cpu_type: cpu, mem_type: memory}


def phase_e2e(np, seed: int = 0) -> dict:
    from krr_tpu_torch.core.config import Config
    from krr_tpu_torch.core.runner import Runner
    from krr_tpu_torch.models import K8sObjectData, ResourceAllocations, ResourceType, Result
    from krr_tpu_torch.ops import cuda_select

    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    cpu_flat = rng.random(E2E_OBJECTS * E2E_PODS * E2E_SAMPLES_PER_POD, dtype=np.float32)
    np.multiply(cpu_flat, cpu_flat, out=cpu_flat)
    cpu_flat *= np.float32(0.8)
    cpu_flat += np.float32(1e-4)
    mem_max = np.round(rng.uniform(50e6, 4e9, size=(E2E_OBJECTS, E2E_PODS)))
    allocations = ResourceAllocations(
        requests={ResourceType.CPU: "500m", ResourceType.Memory: "1Gi"},
        limits={ResourceType.CPU: None, ResourceType.Memory: "2Gi"},
    )
    objects = [
        K8sObjectData(
            name=f"workload-{i}", container="main", namespace=f"ns-{i % 50}", kind="Deployment",
            pods=[f"workload-{i}-pod-{p}" for p in range(E2E_PODS)], allocations=allocations,
        )
        for i in range(E2E_OBJECTS)
    ]
    setup_seconds = time.perf_counter() - t0

    def scan(subset, device: str):
        runner = Runner(
            Config(quiet=True, format="json", device=device),
            inventory=_Inventory(subset),
            history_factory=lambda cluster: _History(np, cpu_flat, mem_max, ResourceType),
        )
        with open(os.devnull, "w") as sink, contextlib.redirect_stdout(sink):
            started = time.perf_counter()
            result = asyncio.run(runner.run())
            wall = time.perf_counter() - started
        return result, runner, wall

    cuda_select.reset_launches()
    result, runner, wall = scan(objects, "cuda")
    launches = dict(cuda_select.LAUNCHES)
    render_started = time.perf_counter()
    rendered = result.format("json")
    render_seconds = time.perf_counter() - render_started

    check(len(result.scans) == E2E_OBJECTS, f"{len(result.scans)} scans, expected {E2E_OBJECTS}")
    check('"?"' not in rendered, "an unknown ('?') value in the scan")
    check(all(count >= 1 for count in launches.values()), f"a kernel did not launch on the main path: {launches}")

    subset = objects[:E2E_CPU_CHECK_ROWS]
    cpu_result, _cpu_runner, cpu_wall = scan(subset, "cpu")
    check(
        Result(scans=result.scans[:E2E_CPU_CHECK_ROWS]).format("json") == cpu_result.format("json"),
        "the CPU re-run's JSON differs from the GPU scan's",
    )
    e2e = {
        "objects": E2E_OBJECTS,
        "samples_per_object": E2E_PODS * E2E_SAMPLES_PER_POD,
        "setup_seconds": setup_seconds,
        "run_wall_seconds": wall,
        "runner_stats": runner.stats,
        "legs_seconds": {**runner.session.strategy.leg_seconds, "render_json": render_seconds},
        "launches": launches,
        "json_bytes": len(rendered),
        "cpu_recheck_rows": E2E_CPU_CHECK_ROWS,
        "cpu_recheck_wall_seconds": cpu_wall,
    }
    emit("e2e", **e2e)
    return e2e


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument(
        "--phases", default="build,parity,headline,e2e",
        help="comma-separated subset of build,parity,headline,e2e (default: all; the kernels line and "
        "the ok line need headline and e2e)",
    )
    args = parser.parse_args(argv)
    phases = set(args.phases.split(","))

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this needs one CUDA GPU", file=sys.stderr)
        return 2
    import numpy as np

    import krr_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)

    smi = nvidia_smi()
    emit("device", kind=torch.cuda.get_device_name(0), count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)
    phase_build()
    parity = phase_parity(torch, np) if "parity" in phases else None
    headline = phase_headline(torch, np) if "headline" in phases else None
    e2e = phase_e2e(np) if "e2e" in phases else None
    if headline is None or e2e is None or parity is None:
        print(smi)
        return 0
    kernels = [
        {
            "name": name, "route": "cuda", "source": KERNEL_SOURCE, "replaces": KERNELS[name],
            "launches": e2e["launches"][name], "max_abs_err": max(parity[name], headline[name]["max_abs_err"]),
            "ms": headline[name]["ms"], "plain_ms": headline[name]["plain_ms"],
            "bound_ms": headline[name]["bound_ms"], "bound_by": headline[name]["bound_by"],
            "library_ms": headline[name]["library_ms"],
        }
        for name in KERNELS
    ]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
