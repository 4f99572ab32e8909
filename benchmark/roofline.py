"""The yardstick of the scan's reductions: the bytes they need, and the
card's published peak.

A scan reduces every container's CPU samples to a percentile and its
memory samples to a max. The work is each real input sample of both
resources read once (4 bytes: the device holds float32), each row's sample
count of both resources read once (int32), and one float32 result per row
and resource written once. Padding, a digest's histogram and any second
pass are an implementation's choices, not the work's, so a kernel that
skips padding or fuses the query reads against the same bytes. The
reductions are bound by bytes: a selection's compares are far below the
card's 67 TFLOP/s of float32.
"""

from __future__ import annotations

#: NVIDIA H100 SXM, HBM3, published (data sheet), at its 700 W power limit.
PEAK_BYTES_PER_S = 3.35e12


def work_bytes(cpu_samples: int, memory_samples: int, rows: int) -> int:
    """Bytes one scan's reductions need (see the module docstring)."""
    return 4 * (cpu_samples + memory_samples) + 2 * 4 * rows + 2 * 4 * rows


def share_pct(total_bytes: float, kernel_seconds: float) -> float:
    """The kernels' share of the bytes roofline: the least time the card
    could take over the time its kernels took, in percent."""
    return 100.0 * total_bytes / PEAK_BYTES_PER_S / kernel_seconds
