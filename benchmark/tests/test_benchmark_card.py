"""A tiny cell on the card: kernels, the profiler's trace and every
per-layer metric (skips without a CUDA card)."""

import pytest

from benchmark import harness, spec


@pytest.mark.card
@pytest.mark.parametrize("name", ["simple-14d-15m.uniform", "tdigest-28d-1m.uniform"])
def test_a_tiny_traced_cell_on_the_card(name):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = spec.load_cell(name)
    outcome = harness.run_cell(cell, 17, 0.5, True, "cuda", 0.0, containers=64)
    assert outcome.correct, outcome.line()
    assert set(outcome.metrics) == {entry["name"] for entry in cell.per_layer}, outcome.missing
    assert 0 < outcome.device["busy_s"] < outcome.device["window_s"]
    assert outcome.breakdown["device_ops"] and outcome.breakdown["idle_gaps"]
