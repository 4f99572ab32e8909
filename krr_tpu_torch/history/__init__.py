"""The recommendation flight recorder (`krr-tpu serve`'s publish memory).

A copy of `krr_tpu/history` (host numpy, no device): the journal files,
gate decisions and drift rows are the JAX package's, so a journal written
by either package opens in the other.

Three pieces, layered under the serve scheduler's publish path:

* :mod:`krr_tpu_torch.history.journal` — an append-only per-workload journal of
  recommendation ticks (compact columnar records keyed by workload identity
  hash, retention-window compaction, crash-safe persistence alongside
  ``--state_path``).
* :mod:`krr_tpu_torch.history.drift` — vectorized drift computation over the
  journal: relative change of the raw recommendation vs the trailing
  published value, flap counting, regime-change detection.
* :mod:`krr_tpu_torch.history.policy` — the hysteresis gate: the published
  recommendation only moves when drift exceeds a dead band for N consecutive
  ticks, so the snapshot the fleet consumes is stable by construction while
  the journal retains the raw series.

:mod:`krr_tpu_torch.history.diff` renders the delta between two journal points (or
journal vs a live scan) through the existing formatter registry — the
``krr-tpu diff`` subcommand.
"""

from krr_tpu_torch.history.journal import RecommendationJournal
from krr_tpu_torch.history.policy import GateDecision, HysteresisGate

__all__ = ["RecommendationJournal", "HysteresisGate", "GateDecision"]
