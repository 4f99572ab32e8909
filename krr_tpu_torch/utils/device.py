"""Device selection for the port's entry points.

Entry points run on ``cuda`` unless the caller asks for the CPU. A ``cuda``
request on a machine without a card raises: the port never carries on on
the CPU behind the caller's back.
"""

from __future__ import annotations

import torch


def resolve_device(device: "str | torch.device") -> torch.device:
    """The requested device, checked: ``cuda`` must have a card behind it."""
    resolved = torch.device(device)
    if resolved.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(resolved)!r} requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch versions on the CPU"
        )
    if resolved.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(resolved)!r}: expected 'cuda' or 'cpu'")
    return resolved
