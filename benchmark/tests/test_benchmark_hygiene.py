"""What a run may load and where it refuses to run."""

import ast
import os
import shutil
import subprocess
import sys

import pytest

from benchmark import spec
from benchmark.harness import forbidden_modules

RUN = [sys.executable, "benchmark/run.py", "--workload", "simple-14d-15m.uniform", "--seed", "1",
       "--seconds", "1", "--trace", "0"]


def test_forbidden_modules_compare_whole_top_level_names():
    assert forbidden_modules(["krr_tpu_torch", "krr_tpu_torch.x", "jaxtyping", "numpy"]) == []
    assert forbidden_modules(["krr_tpu.x", "jax.numpy", "jaxlib", "flax.linen", "krr_tpu"]) == [
        "flax.linen", "jax.numpy", "jaxlib", "krr_tpu", "krr_tpu.x"]


def _no_card_env():
    env = dict(os.environ)
    env["CUDA_VISIBLE_DEVICES"] = ""  # hide any card this machine has
    return env


def test_the_measurement_path_refuses_a_cpu():
    done = subprocess.run(RUN, cwd=spec.ROOT, env=_no_card_env(), capture_output=True, text=True, timeout=300)
    assert done.returncode != 0 and done.stdout.strip() == ""
    assert "CUDA" in done.stderr


def test_a_folder_without_the_program_runs_nothing(tmp_path):
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(spec.ROOT / "benchmark", tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    done = subprocess.run(RUN, cwd=tmp_path, env=_no_card_env(), capture_output=True, text=True, timeout=300)
    assert done.returncode != 0 and done.stdout.strip() == ""


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = (
        "import sys; sys.path.insert(0, '.')\n"
        "from benchmark import harness, spec\n"
        "cell = spec.load_cell('tdigest-28d-1m.uniform')\n"
        "outcome = harness.run_cell(cell, 5, 0.0, True, 'cpu', 0.0, containers=6)\n"
        "assert outcome.correct\n"
        "print(harness.forbidden_modules(sys.modules))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    done = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT, env=env, capture_output=True, text=True,
                          timeout=300)
    assert done.returncode == 0, done.stderr
    assert done.stdout.strip().splitlines()[-1] == "[]"


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted((spec.ROOT / "benchmark").rglob("*.py")), ids=lambda p: p.name)
def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package(path):
    roots = {name.split(".")[0] for name in _imports(path)}
    assert not roots & {"jax", "jaxlib", "flax", "krr_tpu", "bench_torch", "bench_e2e_torch", "chip_smoke", "tests"}
    if "reference" in path.parts:
        assert roots <= {"__future__", "math", "dataclasses", "decimal", "fractions", "numpy"}
    if path.name == "prometheus.py":  # the fake's child process: numpy and the standard library alone
        assert roots <= set(sys.stdlib_module_names) | {"numpy"}
