"""Where ``torch.profiler`` puts the card's work inside its traced window.

The profiler keeps a device record only when it falls inside the window it
traced, on the host clock, so the port's ``--profile_dir`` traces
(``krr_tpu_torch.strategies.base.profiled``) depend on how far the card's
records sit from the window's ends. This probe measures that, in fresh
processes as a scan's first trace is taken: each child starts the profiler
in a worker thread, launches ``fleet_exact`` (K1 + K2) between two host
markers (after a device fence), fences again and closes the window at once.
One JSON line per trace:

- ``kernels``: the kernel records the trace kept (2 when nothing dropped);
- ``head_us``: the first device record's start minus the marker before the
  launch (negative: the card's records sit earlier than physically
  possible, i.e. the profiler's mapping of the card's clock is off);
- ``tail_us``: the marker after the fence minus the last device record's
  end (the room the last kernel has before the window closes).

Run on one CUDA card: ``python3 profiler_window_probe.py [children] [traces]``
(default 12 children of 3 traces). The card's name and power limit are
printed first.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
ROWS, COLUMNS = 10_000, 12_096
#: Chrome trace categories of the card's own work.
DEVICE = ("kernel", "gpu_memcpy", "gpu_memset")


def child(traces: int) -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from krr_tpu_torch.ops.cuda_select import fleet_exact

    generator = torch.Generator(device="cuda")
    generator.manual_seed(0)
    values = torch.rand(ROWS, COLUMNS, device="cuda", generator=generator)
    counts = torch.full((ROWS,), COLUMNS, dtype=torch.int32, device="cuda")
    fleet_exact(values, counts, values, counts, 99.0).cpu()  # build and warm

    def one(index: int) -> None:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(0.2)
            torch.cuda.synchronize()
            with record_function("before_launch"):
                pass
            fleet_exact(values, counts, values, counts, 99.0).cpu()
            torch.cuda.synchronize()
            with record_function("after_fence"):
                pass
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                spans = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X" and "dur" in e]
        marks = {e["name"]: float(e["ts"]) for e in spans if e["name"] in ("before_launch", "after_fence")}
        device = [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in spans if e.get("cat") in DEVICE]
        print(json.dumps({
            "pid": os.getpid(), "trace": index, "kernels": sum(1 for e in spans if e.get("cat") == "kernel"),
            "device_records": len(device),
            "head_us": min(s for s, _ in device) - marks["before_launch"] if device else None,
            "tail_us": marks["after_fence"] - max(e for _, e in device) if device else None,
        }), flush=True)

    for index in range(traces):
        worker = threading.Thread(target=one, args=(index,))
        worker.start()
        worker.join()


def main(argv: list[str]) -> int:
    if len(argv) > 1 and argv[1] == "--child":
        child(int(argv[2]))
        return 0
    import torch

    if not torch.cuda.is_available():
        print("profiler_window_probe: needs a CUDA card", file=sys.stderr)
        return 1
    children = int(argv[1]) if len(argv) > 1 else 12
    traces = int(argv[2]) if len(argv) > 2 else 3
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    from krr_tpu_torch.ops import cuda_build

    cuda_build.build_all(["select"])
    failed = 0
    for _ in range(children):
        run = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", str(traces)],
                             cwd=ROOT, capture_output=True, text=True, timeout=300)
        sys.stdout.write(run.stdout)
        if run.returncode:
            failed += 1
            sys.stderr.write(run.stderr[-2000:])
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
