"""krr_tpu_torch — the PyTorch/CUDA port of krr_tpu.

A second package beside the JAX one: the same host pipeline (packing,
Decimal rounding, severity, formatters, the one-shot runner) with the fleet
reductions as hand-written CUDA kernels for NVIDIA Hopper
(`krr_tpu_torch/csrc/`), each beside a plain PyTorch version that the CPU
path runs. It imports nothing of the JAX package and never imports JAX.
"""

__version__ = "0.1.0"

__all__ = ["__version__"]
