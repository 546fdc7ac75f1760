"""Hybrid optimistic/planned switch policy (a copy of
``repro.planner.hybrid``; DESIGN.md §10).

The service plane is optimistic by default — under low contention that is
strictly cheaper (one dispatch per wave, no host-side planning).  Under
zipfian skew aborts rise and the optimistic loop burns its throughput on
retries; that trailing abort rate is exactly the signal
``AdaptiveWaveSizer`` already regulates wave size with, so the hybrid
policy rides the same ceiling: when the trailing abort rate crosses
``enter_high`` (default 0.35 — the sizer's AIMD high-water mark), the
service switches wave execution to the planner.

Exiting is *not* symmetric: in planned mode lanes commit abort-free, so
the abort rate is ~0 by construction and says nothing about whether the
workload calmed down.  The planner instead observes what it uniquely
knows — the *conflict fraction* of each wave it plans (transactions with
at least one conflict edge, plus anything spilled past the lane budget).
When that trailing fraction drops below ``exit_low``, contention has
genuinely subsided and the service returns to the optimistic path.

Both windows reset on every switch so decisions are made on post-switch
evidence only (the sizer's discipline).  Degenerate thresholds pin the
policy: ``exit_low < 0`` never exits planned mode (``from_name("planned")``
— plan every wave), ``enter_high > 1`` never enters it.

The policy reads host counts only: on a process mesh every rank observes
the same merged outcomes, so every rank switches at the same wave.
"""
from __future__ import annotations

from typing import Optional

from .sched import DEFAULT_MAX_LANES


class HybridSwitch:
    """Trailing-window two-signal switch between optimistic and planned
    wave execution.  Mutable; one instance per service session."""

    def __init__(self, enter_high: float = 0.35, exit_low: float = 0.10,
                 window: int = 64, max_lanes: Optional[int] = DEFAULT_MAX_LANES,
                 start_planned: bool = False):
        if window < 1:
            raise ValueError(f"need window >= 1, got {window}")
        self.enter_high = enter_high
        self.exit_low = exit_low
        self.window = window
        self.max_lanes = max_lanes
        self.planned = start_planned
        self._exec = 0          # optimistic window: executions / aborts
        self._abort = 0
        self._seen = 0          # planned window: planned txns / conflicted
        self._conf = 0
        self.to_planned = 0
        self.to_optimistic = 0

    @classmethod
    def from_name(cls, name: str, **kw) -> "HybridSwitch":
        """``"hybrid"`` — adaptive switching (defaults); ``"planned"`` —
        pinned planned mode (plan every wave, never exit)."""
        if name == "hybrid":
            return cls(**kw)
        if name == "planned":
            kw.setdefault("exit_low", -1.0)
            return cls(start_planned=True, **kw)
        raise ValueError(f"unknown planner mode {name!r}; "
                         f"expected 'hybrid' or 'planned'")

    @property
    def switches(self) -> int:
        return self.to_planned + self.to_optimistic

    def observe_optimistic(self, executed: int, aborted: int) -> None:
        """Fold one optimistically-executed wave's counts in; enter planned
        mode at a window boundary when the trailing abort rate crosses the
        AIMD ceiling."""
        if self.planned:
            return
        self._exec += executed
        self._abort += aborted
        if self._exec < self.window:
            return
        if self._abort / self._exec > self.enter_high:
            self.planned = True
            self.to_planned += 1
            self._seen = self._conf = 0
        self._exec = self._abort = 0

    def observe_planned(self, planned: int, conflicted: int) -> None:
        """Fold one planned wave's conflict census in (``conflicted`` =
        txns with >= 1 conflict edge + spilled); exit planned mode when the
        trailing conflict fraction falls below ``exit_low``."""
        if not self.planned:
            return
        self._seen += planned
        self._conf += conflicted
        if self._seen < self.window:
            return
        if self._conf / self._seen < self.exit_low:
            self.planned = False
            self.to_optimistic += 1
            self._exec = self._abort = 0
        self._seen = self._conf = 0
