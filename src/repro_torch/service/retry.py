"""Abort-retry pipeline policy (DESIGN.md §8; a copy of
``repro.service.retry``).

An aborted transaction is not an error in PostSI — it is the scheduler
telling the client to try again with a fresh interval.  The closed-loop
service re-enqueues aborted transactions with a **fresh TID** (the paper's
rules never resurrect an interval; a retry is a brand-new transaction over
the same operations) and **bounded exponential backoff** so a contended
hotspot is not hammered by its own rejects: attempt ``a`` waits
``base * 2**(a-1)`` ticks, capped at ``max_backoff``, with optional ±1 tick
jitter to break retry synchronization.  After ``max_attempts`` executions
the request is reported **dropped** — every admitted request therefore
terminates in exactly one of {committed, dropped}, which is the invariant
the property tests pin down.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded exponential backoff in scheduler ticks."""
    max_attempts: int = 8      # total executions (first try + retries)
    base_backoff: int = 1      # ticks before the first retry
    max_backoff: int = 16      # backoff ceiling, ticks
    jitter: bool = True        # +-1 tick to decorrelate retry storms

    def next_delay(self, attempts: int,
                   rng: np.random.RandomState | None = None) -> int | None:
        """Delay before the next execution, given ``attempts`` completed
        executions so far; ``None`` means the retry budget is exhausted and
        the request must be dropped."""
        if attempts >= self.max_attempts:
            return None
        delay = min(self.base_backoff << (attempts - 1), self.max_backoff)
        if self.jitter and rng is not None and delay > 1:
            delay += int(rng.randint(-1, 2))
        return max(1, delay)

    def worst_case_ticks(self) -> int:
        """Upper bound on ticks between admission and the final verdict —
        the horizon the drain loop and the commit-or-drop test use.  Counts
        one execution tick plus the (jitter-inflated) backoff per retry."""
        jit = 1 if self.jitter else 0
        total = 0
        for a in range(1, self.max_attempts):
            total += min(self.base_backoff << (a - 1),
                         self.max_backoff) + jit + 1
        return total + 1
