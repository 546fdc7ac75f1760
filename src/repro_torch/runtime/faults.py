"""Deterministic fault injection at the service seams (a copy of
``repro.runtime.faults``).

Seedable failure schedules the recovery conformance suite replays exactly
(``FaultSchedule.random(seed)`` draws the reference's schedules from the
same numpy ``RandomState``):

* ``kill`` — raise ``InjectedCrash`` at a seam: the process dies with
  dispatched-but-unretired blocks in flight and the group-commit buffer
  unsynced (``DurabilityManager.crash`` then models the page-cache loss);
* ``drop_node`` — the mesh flavor of ``kill``: the SPMD program dies with
  the node, recovery replays onto a *fresh* mesh of the same arity (the
  replacement-node story — per-node state is reconstructed from the log,
  never from the lost device).  On a process mesh every rank holds the
  same schedule and visits the same seams, so a fault fires on every rank
  at the same point; a fresh spawn of ranks is the replacement mesh;
* ``torn_tail`` — after the crash, tear ``arg`` bytes off the WAL's end
  (a partial final write); applied by ``mutilate_wal``, absorbed by
  ``wal.scan``;
* ``delay_retire`` — arm a budget of ``arg`` skipped tick-level
  retirements: the pipeline holds its oldest block ``arg`` extra ticks,
  the injection twin of the straggler the detector flags.  Consumed only
  at tick-level retires, never inside the dispatch loop's K-limit drain,
  so a delay can starve progress but never deadlock it.

Seams (counted independently, so ``Fault.at`` is "the n-th visit"):

* ``dispatch`` — after a block's device dispatch, before it is recorded
  in flight (kill here: work launched, nothing durable, replay-or-drop);
* ``retire``   — at the head of block retirement, before the host sync
  (kill here: outcomes computed, never logged nor acked);
* ``post_log`` — after the WAL append, before outcomes are acked to
  clients (kill here opens the durable-but-unacked window — recovery must
  treat "in recovered WAL" as committed and never re-execute it).
"""
from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Sequence

import numpy as np
import torch.distributed


class InjectedCrash(RuntimeError):
    """A scheduled fault killed the process at a seam.  Harnesses catch
    this where a supervisor would observe the death, then run recovery."""


@dataclasses.dataclass(frozen=True)
class Fault:
    """One scheduled failure.

    ``kind``  — kill | drop_node | torn_tail | delay_retire.
    ``point`` — dispatch | retire | post_log (seam; torn_tail uses the
    pseudo-point "wal": it fires after death, not at a seam).
    ``at``    — fire on the ``at``-th visit of that seam (0-based).
    ``arg``   — torn bytes (torn_tail) or delay budget in ticks
    (delay_retire); unused otherwise.
    """
    kind: str
    point: str
    at: int
    arg: int = 0

    KINDS = ("kill", "drop_node", "torn_tail", "delay_retire")

    def __post_init__(self):
        if self.kind not in self.KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}")


class FaultSchedule:
    """A deterministic list of faults, fired by seam-visit count.

    The service calls the seam hooks; each counts its visits and fires
    every fault scheduled for (point, count).  The same schedule against
    the same workload fails at exactly the same block every run — that is
    what makes crash-restart tests differential.
    """

    POINTS = ("dispatch", "retire", "post_log")

    def __init__(self, faults: Sequence[Fault] = (),
                 seed: Optional[int] = None):
        self.faults: List[Fault] = list(faults)
        self.seed = seed
        self.counts = dict.fromkeys(self.POINTS, 0)
        self.fired: List[Fault] = []
        self.crashed: Optional[Fault] = None
        self._delay_left = 0
        self.delays_taken = 0

    # ------------------------------------------------------------- seams
    def at_dispatch(self, svc=None) -> None:
        self._visit("dispatch")

    def at_retire(self, svc=None) -> None:
        self._visit("retire")

    def post_log(self, svc=None) -> None:
        self._visit("post_log")

    def _visit(self, point: str) -> None:
        n = self.counts[point]
        self.counts[point] += 1
        for f in self.faults:
            if f.point != point or f.at != n or f in self.fired:
                continue
            self.fired.append(f)
            if f.kind in ("kill", "drop_node"):
                self.crashed = f
                raise InjectedCrash(f"{f.kind} at {point}#{n}")
            if f.kind == "delay_retire":
                self._delay_left += max(0, f.arg)

    def delay_retire(self, svc=None) -> bool:
        """True while armed delay budget remains (the caller skips one
        tick-level retirement per True).  Finite by construction."""
        if self._delay_left > 0:
            self._delay_left -= 1
            self.delays_taken += 1
            return True
        return False

    # ----------------------------------------------------------- aftermath
    def mutilate_wal(self, path: str, synced_bytes: int = 0, pmesh=None):
        """Apply every scheduled ``torn_tail`` to the dead process's WAL
        file — the partial final write a real crash leaves.  Call between
        the crash and recovery, passing the writer's fsync barrier
        (``DurabilityManager.crash_synced_bytes``): a tear may only eat
        the at-risk suffix written after the last fsync, never fsynced
        records — fsync is a durability barrier, and with ``fsync_every=1``
        nothing is ever at risk.  ``synced_bytes=0`` (standalone use)
        puts the whole file at risk.  Returns bytes actually torn.  On a
        ``ProcessMesh`` (``pmesh=``; a collective) rank 0 alone, the one
        that writes the log, tears it, and no rank returns before it has:
        the others return 0."""
        from repro_torch.durability import wal
        if pmesh is not None and pmesh.rank != 0:
            torch.distributed.barrier(group=pmesh.host_group)
            return 0
        torn = 0
        for f in self.faults:
            if f.kind != "torn_tail":
                continue
            at_risk = max(0, (os.path.getsize(path) if os.path.exists(path)
                              else 0) - synced_bytes)
            torn += wal.torn_tail(path, min(f.arg, at_risk))
        if pmesh is not None:
            torch.distributed.barrier(group=pmesh.host_group)
        return torn

    @property
    def pure_kill(self) -> bool:
        """True when no fault perturbs pre-crash execution timing (kills
        and torn tails only).  For pure-kill schedules the crashed run's
        WAL is a bit-identical *prefix* of the uninterrupted run's —
        delays reorder retry traffic, which is allowed but breaks the
        prefix property (not the conformance one)."""
        return all(f.kind in ("kill", "drop_node", "torn_tail")
                   for f in self.faults)

    # --------------------------------------------------------- generation
    @classmethod
    def random(cls, seed: int, horizon: int = 10,
               allow_delay: bool = True) -> "FaultSchedule":
        """A seed-deterministic schedule: one terminal kill at a random
        seam within ``horizon`` visits, optionally preceded by a retire
        delay, optionally followed by a torn WAL tail."""
        rng = np.random.RandomState(seed)
        faults: List[Fault] = []
        if allow_delay and rng.rand() < 0.4:
            faults.append(Fault("delay_retire", "retire",
                                int(rng.randint(0, max(1, horizon // 2))),
                                arg=int(rng.randint(1, 4))))
        point = cls.POINTS[int(rng.randint(len(cls.POINTS)))]
        faults.append(Fault("kill", point, int(rng.randint(1, horizon))))
        if rng.rand() < 0.5:
            faults.append(Fault("torn_tail", "wal", 0,
                                arg=int(rng.randint(1, 96))))
        return cls(faults, seed=seed)
