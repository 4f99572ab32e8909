"""The readings that the limits of ``benchmark/check.py`` were set from, on
this machine's card at a cell's own size.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 --control-seeds 4,5,6 [--fault-seeds 7,8,9]

For each of ``--seeds``: the program's readings, one scan through
``Runner.run`` of the sample set a run's window starts with, held to the
reference as a run holds it. For each of ``--control-seeds``: the
control's, the reference computed in bfloat16 put in the program's place.
For each of ``--fault-seeds`` (a cell whose CPU request comes from a
digest): a planted fault, the reference's digest answer with the bucket
index one too high, put in the program's place. One JSON line a seed and
side. The benchmark's own runs never run this.
"""

import gc
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent


def _seeds(text: str) -> list:
    return [int(part) for part in text.split(",") if part]


def digest_answers(cell, fleet, exact, shift: int):
    """The answers of a log-bucket digest (the configuration's
    ``digest_gamma`` and ``digest_buckets``, the port's least value 1e-7)
    whose query reads the bucket ``shift`` above the one that holds the
    exact percentile: its estimate, the bucket's geometric midpoint, capped
    at the row's exact max. ``shift`` 0 is a sound digest; memory is
    exact."""
    from decimal import Decimal

    from benchmark import check
    from benchmark.reference.recommend import MILLICORE, _as_decimal, _ceil_to

    settings = cell.config["settings"]
    gamma, buckets, least = float(settings["digest_gamma"]), int(settings["digest_buckets"]), 1e-7
    value = exact.cpu_value.astype(np.float64)
    index = 1 + np.clip(np.floor(np.log(value / least) / np.log(gamma)), 0, buckets - 2) + shift
    estimate = least * np.exp((index - 0.5) * np.log(gamma))
    first = np.concatenate([[0], np.cumsum(fleet.shape.row_samples)[:-1]]).astype(np.int64)
    row_max = np.maximum.reduceat(fleet.samples[0].cpu.astype(np.float32), first)
    estimate = np.minimum(estimate.astype(np.float32), row_max)
    floor = Decimal(cell.config["cpu_min_millicores"]) * MILLICORE
    requests = [_ceil_to(_as_decimal(v), MILLICORE, floor) for v in estimate.tolist()]
    return check.Rendered(cpu_request=requests, cpu_limit=[None] * len(requests),
                          memory_request=list(exact.memory_request), memory_limit=list(exact.memory_limit), extra=0)


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=_seeds, default=[])
    parser.add_argument("--control-seeds", type=_seeds, default=[])
    parser.add_argument("--fault-seeds", type=_seeds, default=[])
    args = parser.parse_args(argv)
    sys.path[0] = str(ROOT)
    import torch

    from benchmark import check, harness, scan, spec

    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload, ROOT)
    guarantee, floor = cell.config["guarantee"], harness.cpu_floor(cell)
    for side, seeds in (("program", args.seeds), ("control", args.control_seeds), ("fault", args.fault_seeds)):
        for seed in seeds:
            started = time.perf_counter()
            fleet = scan.Fleet(cell, seed, "cuda")
            exact = harness.reference_answers(cell, fleet, sets=[0])
            if side == "program":
                with scan.histories(cell, fleet):  # the fake Prometheus, on that route
                    record = scan.scan(cell, fleet, 0, "cuda")
                readings = harness.judge(cell, fleet, [record], exact)
            elif side == "control":
                low = harness.reference_answers(cell, fleet, precision="bfloat16", sets=[0])
                readings = check.compare(check.as_rendered(low[0]), exact[0], guarantee, floor)
            else:
                readings = check.compare(digest_answers(cell, fleet, exact[0], 1), exact[0], guarantee, floor)
            print(json.dumps({"workload": cell.name, "side": side, "seed": seed,
                              "readings": {r.name: r.value for r in readings},
                              "limits": {r.name: r.limit for r in readings},
                              "seconds": time.perf_counter() - started}), flush=True)
            del fleet, exact, readings
            gc.collect()  # the runner's cycles hold the fleet's gigabytes until collected
    return 0


if __name__ == "__main__":
    sys.exit(main())
