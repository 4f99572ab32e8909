"""The hysteresis gate: dead-band + confirmation filtering on the publish path.

A copy of `krr_tpu/history/policy.py`.

Percentile recommendations over a noisy-but-stationary fleet wiggle
tick-to-tick; publishing every wiggle means every consumer of
``GET /recommendations`` sees constant churn it cannot act on (and a fleet
that APPLIES recommendations would thrash restarts). The gate makes the
published snapshot stable by construction:

* each workload's published value only moves when the RAW recommendation
  drifts more than ``dead_band_pct`` away from it (relative, per resource)
  for ``confirm_ticks`` CONSECUTIVE scan ticks;
* when the gate opens, the published value jumps straight to the current
  raw value (no smoothing — recommendations stay real samples, not
  synthetic averages);
* a workload's first tick always publishes (there is nothing to hold).

The gate holds the strategy's RAW outputs (CPU percentile cores, peak
memory MB pre-buffer) as float32 — substituting a held value through
``finalize_fleet`` reproduces the original published Decimals bit-exactly,
and re-seeding from the journal after a restart is equally exact.
``enabled=False`` (the ``--no-hysteresis`` escape hatch) passes the input
arrays through UNTOUCHED — same array objects, bit-exact legacy publish
behavior — while still tracking churn so the metric stays meaningful.

A workload absent from a tick (real churn: deleted, or filtered out of
discovery) loses its gate state; if it reappears, its first tick publishes
fresh. Discovery holds its inventory stable between re-discoveries, so this
only triggers on actual fleet changes.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

_EPS = 1e-12


@dataclass
class GateDecision:
    """One tick's gate output, aligned to the input key order.

    ``cpu``/``mem`` are the values to publish; ``published`` marks rows
    whose raw value became the published one (the journal's flag);
    ``changed`` marks previously-seen rows whose published value moved (the
    churn metric); ``suppressed`` marks out-of-band rows the gate withheld.
    """

    cpu: np.ndarray
    mem: np.ndarray
    published: np.ndarray
    changed: np.ndarray
    suppressed: np.ndarray
    out_of_band: np.ndarray


def _rel_drift_pct(raw: np.ndarray, held: np.ndarray) -> np.ndarray:
    """Relative drift of ``raw`` vs ``held`` in percent. NaN raw → 0 (no
    data moves nothing); finite raw over NaN held → inf (nothing held, must
    publish)."""
    raw64 = np.asarray(raw, dtype=np.float64)
    held64 = np.asarray(held, dtype=np.float64)
    out = np.zeros(len(raw64))
    finite_raw = np.isfinite(raw64)
    finite_held = np.isfinite(held64)
    both = finite_raw & finite_held
    out[both] = 100.0 * np.abs(raw64[both] - held64[both]) / np.maximum(np.abs(held64[both]), _EPS)
    out[finite_raw & ~finite_held] = np.inf
    return out


def _neq(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Elementwise inequality treating NaN == NaN (both-missing is not a change)."""
    return (a != b) & ~(np.isnan(a) & np.isnan(b))


class HysteresisGate:
    """Per-workload dead-band gate state, vectorized over the fleet."""

    def __init__(self, dead_band_pct: float = 5.0, confirm_ticks: int = 2, *, enabled: bool = True):
        self.dead_band_pct = float(dead_band_pct)
        self.confirm_ticks = int(confirm_ticks)
        self.enabled = bool(enabled)
        self._keys: tuple[str, ...] = ()
        self._index: dict[str, int] = {}
        self._held_cpu = np.empty(0, np.float32)
        self._held_mem = np.empty(0, np.float32)
        self._streak = np.empty(0, np.int32)
        self._seen = np.empty(0, bool)

    def seed(self, keys: list[str], cpu: np.ndarray, mem: np.ndarray) -> None:
        """Install trailing published baselines (restart resume from the
        journal): workloads arrive already-seen, so the first post-restart
        tick gates against the pre-restart published values instead of
        re-publishing the whole fleet."""
        self._keys = tuple(keys)
        self._index = {key: i for i, key in enumerate(self._keys)}
        self._held_cpu = np.asarray(cpu, dtype=np.float32).copy()
        self._held_mem = np.asarray(mem, dtype=np.float32).copy()
        self._streak = np.zeros(len(self._keys), np.int32)
        self._seen = np.isfinite(self._held_cpu) | np.isfinite(self._held_mem)

    def _align(self, keys: tuple[str, ...]) -> None:
        """Re-key the state arrays to this tick's fleet (no-op on the common
        stable-inventory tick)."""
        if keys == self._keys:
            return
        n = len(keys)
        held_cpu = np.full(n, np.nan, np.float32)
        held_mem = np.full(n, np.nan, np.float32)
        streak = np.zeros(n, np.int32)
        seen = np.zeros(n, bool)
        for i, key in enumerate(keys):
            j = self._index.get(key)
            if j is not None:
                held_cpu[i] = self._held_cpu[j]
                held_mem[i] = self._held_mem[j]
                streak[i] = self._streak[j]
                seen[i] = self._seen[j]
        self._keys = keys
        self._index = {key: i for i, key in enumerate(keys)}
        self._held_cpu, self._held_mem = held_cpu, held_mem
        self._streak, self._seen = streak, seen

    def observe(self, keys: list[str], cpu: np.ndarray, mem: np.ndarray) -> GateDecision:
        """One tick: fold the raw recommendations through the gate and
        return what to publish."""
        key_tuple = tuple(keys)
        cpu = np.asarray(cpu)
        mem = np.asarray(mem)
        self._align(key_tuple)
        n = len(key_tuple)

        if not self.enabled:
            # Bit-exact pass-through (same arrays out), with churn tracking
            # so krr_tpu_recommendation_churn_total measures the raw flap
            # rate the gate would otherwise absorb.
            raw_cpu32 = cpu.astype(np.float32, copy=False)
            raw_mem32 = mem.astype(np.float32, copy=False)
            changed = self._seen & (_neq(raw_cpu32, self._held_cpu) | _neq(raw_mem32, self._held_mem))
            self._held_cpu = raw_cpu32.copy()
            self._held_mem = raw_mem32.copy()
            self._seen = np.ones(n, bool)
            self._streak = np.zeros(n, np.int32)
            return GateDecision(
                cpu=cpu,
                mem=mem,
                published=np.ones(n, bool),
                changed=changed,
                suppressed=np.zeros(n, bool),
                out_of_band=np.zeros(n, bool),
            )

        cpu32 = cpu.astype(np.float32, copy=False)
        mem32 = mem.astype(np.float32, copy=False)
        drift = np.maximum(
            _rel_drift_pct(cpu32, self._held_cpu), _rel_drift_pct(mem32, self._held_mem)
        )
        out = drift > self.dead_band_pct
        self._streak = np.where(out, self._streak + 1, 0).astype(np.int32)
        opened = (~self._seen) | (self._streak >= self.confirm_ticks)
        changed = opened & self._seen
        # Publishing takes the raw value where it exists; a NaN resource
        # keeps its held value (an UNKNOWN tick must not erase a good one).
        new_cpu = np.where(opened & np.isfinite(cpu32), cpu32, self._held_cpu)
        new_mem = np.where(opened & np.isfinite(mem32), mem32, self._held_mem)
        suppressed = out & ~opened
        self._streak[opened] = 0
        # A row only counts as seen once it holds SOMETHING — an all-NaN
        # first tick must not make the first real value wait out the
        # confirmation window.
        self._seen = self._seen | (opened & (np.isfinite(new_cpu) | np.isfinite(new_mem)))
        self._held_cpu, self._held_mem = new_cpu, new_mem
        return GateDecision(
            cpu=new_cpu,
            mem=new_mem,
            published=opened,
            changed=changed,
            suppressed=suppressed,
            out_of_band=out,
        )
