"""Fault-tolerant training runner (port of ``repro.runtime.runner``).

A restart loop around the train step: checkpoint every N steps through
the PostSI store, catch (injected or real) failures, restore the last
*visible* snapshot -- atomicity comes from the paper's scheduler, not from
a manifest lock -- and resume with an exactly replayed data cursor.

The checkpointed tree is the reference's, ``{"params", "opt": AdamWState,
"data": {"step"}}``, so either package restores the other's.  The
reference's ``shardings`` (an elastic restart onto another mesh) has no
counterpart on one card: a restore lands on the device of the parameters
the run started with.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.checkpoint import PostSICheckpointer
from repro_torch.data import TokenStream
from repro_torch.models.module import tree_leaves

from .straggler import StragglerPolicy


class FailureInjector:
    """Deterministic fault injection: raise at the given global steps."""

    def __init__(self, fail_at=()):
        self.fail_at = set(fail_at)
        self.fired = set()

    def maybe_fail(self, step: int) -> None:
        if step in self.fail_at and step not in self.fired:
            self.fired.add(step)
            raise RuntimeError(f"injected node failure at step {step}")


@dataclasses.dataclass
class TrainRunner:
    step_fn: Callable                  # (params, opt, batch) -> (params, opt, metrics)
    stream: TokenStream
    checkpointer: PostSICheckpointer
    ckpt_every: int = 10
    max_restarts: int = 8
    straggler: Optional[StragglerPolicy] = None

    def run(self, params, opt_state, n_steps: int,
            injector: Optional[FailureInjector] = None) -> Dict[str, Any]:
        state = {"params": params, "opt": opt_state}
        device = tree_leaves(params)[0].device
        losses = []
        restarts = 0
        step = 0
        while step < n_steps:
            try:
                while step < n_steps:
                    t0 = time.perf_counter()
                    if injector:
                        injector.maybe_fail(step)
                    batch = self.stream.next()
                    state["params"], state["opt"], metrics = self.step_fn(
                        state["params"], state["opt"], batch)
                    losses.append(float(metrics["loss"]))
                    if self.straggler:
                        self.straggler.record(step, time.perf_counter() - t0)
                    step += 1
                    if step % self.ckpt_every == 0:
                        self._save(step, state)
            except RuntimeError:
                restarts += 1
                if restarts > self.max_restarts:
                    raise
                step, state = self._restore(state, device)
        return {"losses": losses, "restarts": restarts, "final_step": step,
                "state": state}

    # ------------------------------------------------------------------
    def _data_tree(self, step: int):
        return {"step": torch.tensor(step, dtype=torch.int32)}

    def _save(self, step: int, state) -> None:
        tree = {"params": state["params"], "opt": state["opt"],
                "data": self._data_tree(self.stream.state()["step"])}
        assert self.checkpointer.save(step, tree)

    def _restore(self, state, device):
        tree_ex = {"params": state["params"], "opt": state["opt"],
                   "data": self._data_tree(0)}
        step, tree = self.checkpointer.restore(tree_ex, device)
        cursor = {"step": 0, "seed": self.stream.seed,
                  "host_id": self.stream.host_id,
                  "host_count": self.stream.host_count}
        if step is None:           # no checkpoint yet: restart from scratch
            self.stream.restore(cursor)
            return 0, state
        self.stream.restore({**cursor, "step": int(tree["data"]["step"])})
        return step, {"params": tree["params"], "opt": tree["opt"]}
