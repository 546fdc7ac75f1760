"""Straggler mitigation policy (the port's own copy of
``repro.runtime.straggler``, which is numpy only).

On a 1000+-node job the slowest participant sets the step time.  The policy
tracks a robust (median/MAD) step-time model per worker; when a worker's
step exceeds ``threshold`` MADs it is flagged and the runner can act:

  "flag"    — report only (default; feeds the ops dashboard)
  "skip"    — drop the straggler's microbatch this step and rescale the
              gradient (bounded-staleness data parallelism); the scale
              factor keeps the update unbiased
  "rebalance" — shrink the straggler's assigned microbatch share

The wave-structured PostSI engine gets the same treatment for free: a wave
deadline simply truncates the wave, and unexecuted transactions carry to the
next wave (no partial effects exist before commit — paper §IV-C).
"""
from __future__ import annotations

import collections
from typing import Dict, List, Optional, Tuple

import numpy as np


class StragglerPolicy:
    def __init__(self, window: int = 32, threshold: float = 4.0,
                 action: str = "flag"):
        assert action in ("flag", "skip", "rebalance")
        self.window = window
        self.threshold = threshold
        self.action = action
        self.times: Dict[int, collections.deque] = collections.defaultdict(
            lambda: collections.deque(maxlen=window))
        self.flags: List[Tuple[int, int, float]] = []   # (step, worker, dt)

    def record(self, step: int, dt: float, worker: int = 0) -> bool:
        """Returns True when (step, worker) is flagged as a straggler."""
        hist = self.times[worker]
        flagged = False
        if len(hist) >= 8:
            med = float(np.median(hist))
            mad = float(np.median(np.abs(np.asarray(hist) - med))) + 1e-9
            if dt > med + self.threshold * mad * 1.4826:
                self.flags.append((step, worker, dt))
                flagged = True
        hist.append(dt)
        return flagged

    def grad_scale(self, n_workers: int, n_skipped: int) -> float:
        """Unbiased rescale when ``skip`` drops straggler microbatches."""
        live = max(n_workers - n_skipped, 1)
        return n_workers / live

    def share(self, worker: int, n_workers: int) -> float:
        """Microbatch share under ``rebalance``: inverse mean step time."""
        if not self.times:
            return 1.0 / n_workers
        means = {w: float(np.mean(h)) for w, h in self.times.items() if h}
        if worker not in means:
            return 1.0 / n_workers
        inv = {w: 1.0 / m for w, m in means.items()}
        z = sum(inv.values())
        return inv[worker] / z
