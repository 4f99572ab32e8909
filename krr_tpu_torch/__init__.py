"""krr_tpu_torch — the PyTorch/CUDA port of krr_tpu.

A second package beside the JAX one: the same host pipeline (packing,
Decimal rounding, severity, formatters, the one-shot runner) with the fleet
reductions as hand-written CUDA kernels for NVIDIA Hopper
(`krr_tpu_torch/csrc/`), each beside a plain PyTorch version that the CPU
path runs. It imports nothing of the JAX package and never imports JAX.
"""

__version__ = "0.1.0"


def run() -> None:
    """CLI entry point (``krr-tpu-torch``). Defining a strategy/formatter
    subclass before calling this registers it as a new sub-command / format
    option — the JAX package's plugin contract."""
    from krr_tpu_torch.main import run as _run

    _run()


__all__ = ["run", "__version__"]
