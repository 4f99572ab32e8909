"""Kubernetes resource-quantity parsing and humanized formatting.

Behavior-compatible with the reference implementation
(`robusta_krr/utils/resource_units.py:4-48`):

* ``UNITS`` maps suffixes to multipliers. Parsing tries suffixes in insertion
  order and takes the first match (so ``Ki``..``Ei`` binary suffixes are tried
  before the decimal ``k``..``E`` ones, and a bare ``m`` means milli).
* Formatting optionally truncates to the first N significant digits (zeroing
  the rest, not rounding), then renders with the *largest* unit that divides
  the value evenly, scanning units from largest to smallest.

Everything is exact ``Decimal`` arithmetic — this module is part of the host
"Decimal edge" that keeps parity with the reference while the heavy reductions
run on the device (see SURVEY.md §7 "Host edge").
"""

from __future__ import annotations

from decimal import Decimal
from typing import Optional

# Suffix → multiplier. Insertion order is load-bearing for `parse` (first
# matching suffix wins) and, reversed, for `format` (largest unit first).
UNITS: dict[str, Decimal] = {
    "m": Decimal("1e-3"),
    "Ki": Decimal(1024),
    "Mi": Decimal(1024**2),
    "Gi": Decimal(1024**3),
    "Ti": Decimal(1024**4),
    "Pi": Decimal(1024**5),
    "Ei": Decimal(1024**6),
    "k": Decimal("1e3"),
    "M": Decimal("1e6"),
    "G": Decimal("1e9"),
    "T": Decimal("1e12"),
    "P": Decimal("1e15"),
    "E": Decimal("1e18"),
}


def parse(quantity: str) -> Decimal:
    """Parse a k8s quantity string (``"100m"``, ``"128Mi"``, ``"2"``) to a Decimal."""
    for suffix, multiplier in UNITS.items():
        if quantity.endswith(suffix):
            return Decimal(quantity[: -len(suffix)]) * multiplier
    return Decimal(quantity)


def _truncate_significant(value: Decimal, digits: int) -> Decimal:
    """Keep only the first ``digits`` significant digits, zero-filling the rest.

    Truncation (not rounding), matching the reference's digit-tuple surgery:
    123456 with digits=3 → 123000.
    """
    sign, mantissa, exponent = value.as_tuple()
    kept = list(mantissa[:digits]) + [0] * (len(mantissa) - digits)
    return Decimal((sign, tuple(kept), exponent))


def format(value: Decimal, precision: Optional[int] = None) -> str:
    """Render a Decimal with the largest evenly-dividing unit suffix."""
    if precision is not None:
        assert precision >= 0
        value = _truncate_significant(value, precision)

    if value == 0:
        return "0"

    for suffix, multiplier in reversed(UNITS.items()):
        if value % multiplier == 0:
            return f"{int(value / multiplier)}{suffix}"
    return str(value)
