"""Quality evaluation over the recommendation journal (`krr_tpu/eval` in the
JAX package). This slice carries only :func:`journal_savings`, the serve
plane's ``/statusz`` savings block; the replay engine, the scoring grids and
the ``eval`` command are ROADMAP M9."""

from krr_tpu_torch.eval.score import journal_savings

__all__ = ["journal_savings"]
