"""Recommendation quality evaluation: what-if replay + scoreboard.

The port's copy of `krr_tpu/eval`, the offline judge of the recommender:
replay any strategy tick-by-tick over recorded usage (a serve journal, a
chaos-archetype fleet, or an ``.npz`` grid), through the real hysteresis
gate, and score it with vectorized incident detection on the device.

Public surface: :class:`ReplayInput` / :func:`replay` / :func:`score_replay`
(the engine), :func:`build_scoreboard` / :func:`render_scoreboard` (the
board), :func:`journal_savings` (the serve ``/statusz`` savings twin), and
:class:`StaticReplayStrategy` (the labeled-oracle probe).
"""

from krr_tpu_torch.eval.replay import (
    ReplayedSeries,
    ReplayInput,
    StaticReplayStrategy,
    replay,
    score_replay,
    tick_ends,
)
from krr_tpu_torch.eval.score import expand_ticks, journal_savings, score_grids
from krr_tpu_torch.eval.scoreboard import (
    Scoreboard,
    StrategyScore,
    build_scoreboard,
    render_scoreboard,
)

__all__ = [
    "ReplayInput",
    "ReplayedSeries",
    "Scoreboard",
    "StrategyScore",
    "StaticReplayStrategy",
    "build_scoreboard",
    "expand_ticks",
    "journal_savings",
    "render_scoreboard",
    "replay",
    "score_grids",
    "score_replay",
    "tick_ends",
]
