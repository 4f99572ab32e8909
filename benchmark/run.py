"""Run one cell of the benchmark of ``krr_tpu_torch`` on this machine's cards.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of ``workloads`` in ``BENCHMARK.json``. The last line
of standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with ``--trace 1``
its per-layer ones), ``device``, with ``--trace 1`` a ``breakdown``, and
``checks``, each number compared with its limit (also the last lines of
standard error). Without enough CUDA cards, without the port beside this
folder, or with JAX or the JAX package loaded, it prints no result and
exits non-zero.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    if not (ROOT / "krr_tpu_torch" / "__init__.py").is_file():
        print(f"benchmark: no krr_tpu_torch package in {ROOT}", file=sys.stderr)
        return 2
    sys.path[0] = str(ROOT)  # the package's root, not this folder: its modules are benchmark.*
    from benchmark import harness, spec

    cell = spec.load_cell(args.workload, ROOT)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {cell.name} needs {cell.chips} CUDA card(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}, device_count() {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    outcome = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", STARTED)

    loaded = harness.forbidden_modules(sys.modules)
    if loaded:
        print(f"benchmark: forbidden modules loaded: {', '.join(loaded)}", file=sys.stderr)
        return 3
    for name, why in outcome.missing.items():
        print(f"benchmark: metric {name} not read: {why}", file=sys.stderr)
    import resource

    print(f"host peak RSS {resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20:.2f} GiB", file=sys.stderr)
    for reading in outcome.readings:
        print(f"check {reading.name} {reading.value!r} limit {reading.limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(outcome.line(), allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
