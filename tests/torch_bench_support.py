"""Helpers shared by the tests of the port's bench legs
(`tests/test_torch_bench_service.py`, `tests/test_torch_bench_legs.py`,
`tests/test_torch_bench_obs.py`): the import blocker, the gate lines of a
run's stderr, one blocked ``bench_torch.py --smoke --device cpu``
subprocess, `bench.py`'s legs in process, and one in-process run of
`bench_torch.main` with one comparator broken."""

from __future__ import annotations

import ast
import contextlib
import io
import json
import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

import bench_torch

REPO = Path(__file__).resolve().parent.parent

#: The knobs that leave out each service-plane or observability leg
#: (``BENCH_SKIP_OBS`` the obs, analyze, obs-device and sentinel legs,
#: ``BENCH_SKIP_STORE`` both store legs).
SKIPS = (
    "BENCH_SKIP_JOURNAL", "BENCH_SKIP_OBS", "BENCH_SKIP_CHAOS", "BENCH_SKIP_EVAL", "BENCH_SKIP_DISCOVERY",
    "BENCH_SKIP_INGEST", "BENCH_SKIP_FETCHPLAN", "BENCH_SKIP_WIRE", "BENCH_SKIP_FEDERATION", "BENCH_SKIP_HA",
    "BENCH_SKIP_FLEETOBS", "BENCH_SKIP_READPATH", "BENCH_SKIP_STORE",
)

#: A ``sitecustomize`` that refuses and records any import of the JAX
#: package or of JAX in every Python process started with it on the path,
#: and notes each process's command line.
IMPORT_BLOCKER = textwrap.dedent(
    """
    import os, sys

    _log = os.environ["BENCH_TEST_IMPORT_LOG"]
    with open("/proc/self/cmdline", "rb") as f:
        _cmdline = f.read().replace(b"\\0", b" ").decode(errors="replace")
    with open(os.path.join(_log, "started"), "a") as f:
        f.write(_cmdline + "\\n")

    class _Blocker:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib", "krr_tpu"):
                with open(os.path.join(_log, "refused-" + str(os.getpid())), "a") as f:
                    f.write(name + "\\n")
                raise ImportError(f"{name} must not be imported by the port's bench")
            return None

    sys.meta_path.insert(0, _Blocker())
    """
)

#: Every counted kernel, as ``kernel_launches_by_leg`` lists them.
NO_LAUNCHES = dict.fromkeys(("bisect_select", "row_max", "topk_select", "digest_hist", "radix_digit_hist"), 0)


def meets(value, requirement) -> bool:
    """Whether a required field's ``value`` meets ``requirement``:
    ``(comparison, bound)`` with ``>``, ``>=`` or ``==``, or None (present)."""
    import operator

    if requirement is None:
        return True
    op, bound = requirement
    return {">": operator.gt, ">=": operator.ge, "==": operator.eq}[op](value, bound)


def gate_lines(stderr: str) -> dict:
    """``{gate: "ok" | "FAILED <detail>"}`` from the ``bench: parity [...]`` lines."""
    found = {}
    for match in re.finditer(r"^bench: parity \[(.+?)\] (ok|FAILED.*)$", stderr, re.M):
        found[match.group(1)] = match.group(2)
    return found


def parity_failures(stderr: str) -> list:
    lines = [line for line in stderr.splitlines() if line.startswith("bench: PARITY FAILURES: ")]
    return ast.literal_eval(lines[-1].split(": ", 2)[2]) if lines else []


def blocked_smoke(tmp: Path, run: "tuple[str, ...]") -> tuple:
    """(rc, payload, stderr, refused imports, started command lines) of one
    ``bench_torch.py --smoke --device cpu`` with the end-to-end legs and
    every leg whose skip knob is not in ``run`` left out, under the import
    blocker."""
    site = tmp / "site"
    site.mkdir()
    (site / "sitecustomize.py").write_text(IMPORT_BLOCKER)
    log = tmp / "imports"
    log.mkdir()
    env = {key: value for key, value in os.environ.items() if not key.startswith("BENCH_")}
    env.update(PYTHONPATH=str(site), BENCH_TEST_IMPORT_LOG=str(log), BENCH_SKIP_E2E="1",
               **{key: "1" for key in SKIPS if key not in run})
    proc = subprocess.run(
        [sys.executable, str(REPO / "bench_torch.py"), "--smoke", "--device", "cpu"],
        capture_output=True, text=True, timeout=300, cwd=tmp, env=env,
    )
    refused = {p.name: p.read_text() for p in log.iterdir() if p.name.startswith("refused-")}
    started = (log / "started").read_text().splitlines()
    lines = proc.stdout.strip().splitlines()
    payload = json.loads(lines[-1]) if lines else {}
    return proc.returncode, payload, proc.stderr, refused, started


def jax_legs(legs) -> tuple:
    """`bench.py`'s ``legs`` (functions of ``(secondary, check)``) in this
    process at `bench_torch`'s smoke sizes: their ``secondary``,
    ``{gate: ok}`` and stderr."""
    secondary: dict = {}
    gates: dict = {}
    err = io.StringIO()

    def check(name, ok, detail=""):
        gates[name] = ok

    with pytest.MonkeyPatch.context() as mp:
        for key, value in bench_torch.SMOKE_DEFAULTS.items():
            mp.setenv(key, value)
        with contextlib.redirect_stderr(err):
            for leg in legs:
                leg(secondary, check)
    return secondary, gates, err.getvalue()


def broken_gate_run(run: str, extra: dict, capsys) -> tuple:
    """``bench_torch.main`` in this process at smoke sizes with only the
    legs of skip knob ``run`` (and the kernel legs) and ``extra`` knobs:
    (exit code, payload, the parity failures, stderr)."""
    environ = {**os.environ, **bench_torch.SMOKE_DEFAULTS, "BENCH_SKIP_E2E": "1", **extra,
               **{key: "1" for key in SKIPS if key != run}}
    rc = bench_torch.main(["--smoke", "--device", "cpu"], environ)
    out, err = capsys.readouterr()
    payload = json.loads(out.strip().splitlines()[-1])
    return rc, payload, parity_failures(err), err


#: The wrappers the strategies call, where they call them (``module``,
#: ``name``), and the kernels each call launches on the card.
WRAPPER_CALL_SITES = (
    ("krr_tpu_torch.strategies.simple", "fleet_exact", ("bisect_select", "row_max")),
    ("krr_tpu_torch.strategies.tdigest", "masked_max_cuda", ("row_max",)),
    ("krr_tpu_torch.ops.digest", "digest_hist", ("digest_hist",)),
    ("krr_tpu_torch.ops.topk_sketch", "topk_select", ("topk_select",)),
    ("krr_tpu_torch.ops.cuda_select", "radix_digit_hist", ("radix_digit_hist",)),
    ("krr_tpu_torch.ops.cuda_select", "row_max_chunk", ("row_max",)),
)


def count_wrapper_calls(monkeypatch) -> dict:
    """Count, on the CPU, the launches the wrappers' calls would make on
    the card: each call site in ``WRAPPER_CALL_SITES`` adds one to each of
    its kernels, then runs the wrapper (its plain version here)."""
    import importlib

    counts = dict(NO_LAUNCHES)
    for module_name, name, kernels in WRAPPER_CALL_SITES:
        module = importlib.import_module(module_name)
        original = getattr(module, name)

        def counted(*args, _original=original, _kernels=kernels, **kwargs):
            for kernel in _kernels:
                counts[kernel] += 1
            return _original(*args, **kwargs)

        monkeypatch.setattr(module, name, counted)
    return counts
