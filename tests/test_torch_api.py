"""The public extension API (``krr_tpu_torch.api``) against ``krr_tpu.api``.

The repo's plugin examples (`examples/custom_strategy.py`, a ``spikeguard``
strategy, and `examples/custom_formatter.py`, a ``my_formatter`` format)
are read as text; for the port every ``krr_tpu`` becomes ``krr_tpu_torch``
(the files themselves stay as they are). Each package's version registers
in a subprocess of its own, whose CLI then scans the fake apiserver and
Prometheus (`tests/fakes/servers.py`) and replays a usage grid through
``eval``; the port's stdout must equal the JAX package's. The port's
process also checks that registering the plugins through its ``api``
leaves ``krr_tpu``'s registries untouched.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from .test_integrations import fake_env  # noqa: F401  (module-scoped fixture)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = ("custom_strategy.py", "custom_formatter.py")

#: One process per package: load the examples, record the JAX package's
#: registries around the load, run each CLI case, print JSON.
PLUGIN_RUN = r'''
import importlib, json, os, re, sys
from click.testing import CliRunner

package, examples_dir, cases = sys.argv[1], sys.argv[2], json.loads(sys.argv[3])
import krr_tpu.formatters.base as jax_formatters
import krr_tpu.strategies.base as jax_strategies
before = (sorted(jax_strategies.BaseStrategy.get_all()), sorted(jax_formatters.BaseFormatter.get_all()))
for example in ("custom_strategy.py", "custom_formatter.py"):
    path = os.path.join(examples_dir, example)
    source = open(path).read()
    if package == "krr_tpu_torch":
        source = re.sub(r"\bkrr_tpu\b", "krr_tpu_torch", source)
    exec(compile(source, path, "exec"), {"__name__": "plugin_" + example[:-3], "__file__": path})
after = (sorted(jax_strategies.BaseStrategy.get_all()), sorted(jax_formatters.BaseFormatter.get_all()))
main = importlib.import_module(package + ".main")
main.load_commands()
out = {"jax_registries": [before, after], "commands": sorted(main.app.commands), "cases": {}}
for name, args in cases.items():
    result = CliRunner().invoke(main.app, args)
    out["cases"][name] = [result.exit_code, result.output]
print("RESULT " + json.dumps(out))
'''


def cases(kubeconfig: str, url: str, npz: str, port: bool) -> dict:
    scan = ["--kubeconfig", kubeconfig, "-p", url, "-q"]
    device = ["--device", "cpu"] if port else []
    return {
        "spikeguard_json": ["spikeguard", *scan, "-f", "json"],
        "spikeguard_knobs_yaml": ["spikeguard", *scan, "-f", "yaml", "--cpu_percentile", "50",
                                  "--spike_guard", "0", "--memory_slack_mb", "0"],
        "my_formatter": ["simple", *scan, "-f", "my_formatter", *device],
        "spikeguard_table": ["spikeguard", *scan, "-f", "table"],
        "eval_spikeguard": ["eval", "--usage", npz, "--strategy", "spikeguard", "--strategy", "simple",
                            "-f", "json", "-q", *device],
    }


@pytest.fixture(scope="module")
def runs(fake_env, tmp_path_factory):  # noqa: F811
    """Each package's plugin run, once for the module."""
    rng = np.random.default_rng(11)
    npz = str(tmp_path_factory.mktemp("api") / "usage.npz")
    keys = np.asarray([f"/default/wl{i}/main/Deployment" for i in range(3)], dtype=np.str_)
    np.savez(npz, keys=keys, timestamps=1_700_000_000.0 + 60.0 * np.arange(96),
             cpu=np.round(rng.gamma(2.0, 0.05, (3, 96)), 4), mem=rng.uniform(5e7, 4e8, (3, 96)))
    env = {**os.environ, "PYTHONPATH": REPO_ROOT, "JAX_PLATFORMS": "cpu", "CUDA_VISIBLE_DEVICES": ""}
    out = {}
    for package in ("krr_tpu", "krr_tpu_torch"):
        argv = cases(fake_env["kubeconfig"], fake_env["server"].url, npz, package == "krr_tpu_torch")
        proc = subprocess.run(
            [sys.executable, "-c", PLUGIN_RUN, package, os.path.join(REPO_ROOT, "examples"), json.dumps(argv)],
            cwd=REPO_ROOT, env=env, capture_output=True, text=True, timeout=300,
        )
        assert proc.returncode == 0, proc.stderr[-3000:]
        (line,) = [line for line in proc.stdout.splitlines() if line.startswith("RESULT ")]
        out[package] = json.loads(line[len("RESULT "):])
    return out


@pytest.mark.parametrize("case", ["spikeguard_json", "spikeguard_knobs_yaml", "my_formatter", "spikeguard_table"])
def test_plugin_prints_the_jax_packages_stdout(runs, case):
    jax_code, jax_out = runs["krr_tpu"]["cases"][case]
    port_code, port_out = runs["krr_tpu_torch"]["cases"][case]
    assert jax_code == 0, jax_out
    assert port_code == 0, port_out
    assert port_out == jax_out
    if case == "my_formatter":
        assert port_out.startswith("Custom formatter: ")
    if case == "spikeguard_json":
        assert len(json.loads(port_out)["scans"]) > 0


def test_eval_replays_the_plugin_like_jax(runs):
    from .test_torch_eval import assert_rendered_equal

    jax_code, jax_out = runs["krr_tpu"]["cases"]["eval_spikeguard"]
    port_code, port_out = runs["krr_tpu_torch"]["cases"]["eval_spikeguard"]
    assert jax_code == port_code == 0, port_out
    assert_rendered_equal(jax_out, port_out)
    assert sorted(s["strategy"] for s in json.loads(port_out)["scores"]) == ["simple", "spikeguard"]


def test_plugin_command_is_registered_in_the_port_alone(runs):
    assert "spikeguard" in runs["krr_tpu_torch"]["commands"]
    assert "eval" in runs["krr_tpu_torch"]["commands"]
    # The JAX package's registries are the same before and after the port's
    # api registered the plugins.
    before, after = runs["krr_tpu_torch"]["jax_registries"]
    assert before == after
    assert "spikeguard" not in after[0] and "my_formatter" not in after[1]
    # …while the JAX package's own examples do register there.
    _before, jax_after = runs["krr_tpu"]["jax_registries"]
    assert "spikeguard" in jax_after[0] and "my_formatter" in jax_after[1]


def test_api_exports_the_jax_names():
    import krr_tpu.api.formatters as jax_formatters
    import krr_tpu.api.models as jax_models
    import krr_tpu.api.strategies as jax_strategies
    import krr_tpu_torch.api.formatters as port_formatters
    import krr_tpu_torch.api.models as port_models
    import krr_tpu_torch.api.strategies as port_strategies

    for jax_module, port_module in ((jax_formatters, port_formatters), (jax_models, port_models),
                                    (jax_strategies, port_strategies)):
        assert port_module.__all__ == jax_module.__all__
        for name in port_module.__all__:
            assert getattr(port_module, name).__module__.startswith("krr_tpu_torch.") or name in (
                "HistoryData", "RunResult", "RecommendationValue")
    from krr_tpu_torch.strategies.base import BaseStrategy

    assert port_strategies.BaseStrategy is BaseStrategy


def test_example_source_needs_only_the_package_name_changed():
    for example in EXAMPLES:
        source = open(os.path.join(REPO_ROOT, "examples", example)).read()
        ported = re.sub(r"\bkrr_tpu\b", "krr_tpu_torch", source)
        assert "krr_tpu_torch.api." in ported and "krr_tpu_torch.run()" in ported
        assert re.search(r"\bkrr_tpu\b", ported) is None
