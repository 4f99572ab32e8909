"""Global configuration: the fields the one-shot raw scan reads.

A trimmed copy of `krr_tpu/core/config.py`: value floors, output format,
strategy, logging flags, the pinned scan end, fleet-axis row chunking, and
the compute device. Level 2 — the per-strategy ``StrategySettings`` — rides
in ``other_args``. The Kubernetes, Prometheus, serve and observability fields
arrive with the slices that read them.
"""

from __future__ import annotations

from typing import Any, Optional

import pydantic as pd
from pydantic import field_validator

from krr_tpu_torch.utils.logging import KrrLogger


class Config(pd.BaseModel):
    quiet: bool = False
    verbose: bool = False

    # Value settings
    cpu_min_value: int = pd.Field(5, ge=0)  # millicores
    memory_min_value: int = pd.Field(10, ge=0)  # megabytes

    # Logging settings
    format: str = "table"
    strategy: str = "simple"
    log_to_stderr: bool = False

    #: Pin the scan window's right edge to an absolute unix timestamp —
    #: reproducible scans (two runs see identical samples). Default: now.
    scan_end_timestamp: Optional[float] = None

    #: Fleet-axis host chunking: the raw path's packed [rows × T] copy is
    #: built (and run) at most this many rows at a time
    #: (`krr_tpu_torch.strategies.base.run_batch_row_chunks`).
    max_fleet_rows_per_device: int = pd.Field(200_000, ge=1)

    #: Compute device handed to strategies that take one: "cuda" (the
    #: hand-written kernels; raises without a card) or "cpu" (the plain
    #: PyTorch versions). A ``device`` in ``other_args`` wins.
    device: str = "cuda"

    other_args: dict[str, Any] = pd.Field(default_factory=dict)

    @field_validator("strategy")
    @classmethod
    def _strategy_exists(cls, v: str) -> str:
        from krr_tpu_torch.strategies.base import BaseStrategy

        BaseStrategy.find(v)  # raises with the available list if unknown
        return v

    @field_validator("format")
    @classmethod
    def _format_exists(cls, v: str) -> str:
        from krr_tpu_torch.formatters.base import BaseFormatter

        BaseFormatter.find(v)
        return v

    def create_strategy(self):
        from krr_tpu_torch.strategies.base import BaseStrategy

        strategy_type = BaseStrategy.find(self.strategy)
        settings_type = strategy_type.get_settings_type()
        args = dict(self.other_args)
        if "device" in settings_type.model_fields:
            args.setdefault("device", self.device)
        return strategy_type(settings_type(**args))

    def create_logger(self) -> KrrLogger:
        return KrrLogger(quiet=self.quiet, verbose=self.verbose, log_to_stderr=self.log_to_stderr)
