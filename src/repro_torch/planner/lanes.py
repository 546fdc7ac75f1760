"""Deterministic lane partitioning of one wave's conflict graph (a copy of
``repro.planner.lanes``; DESIGN.md §10).

A *lane* is a conflict-free subset of the wave: no two transactions in the
same lane share a WW/WR/RW edge.  Lanes execute sequentially (lane 0 first)
and each lane runs as one ordinary wave through ``engine.run_wave_on`` —
inside a lane the engine finds an empty potential matrix and untouched read
snapshots, so every lane transaction commits (the zero-abort argument in
sched.py).

The coloring is *layered greedy* in transaction (row) order:

    lane(j) = 0                          if j conflicts with no earlier txn
            = 1 + max lane(i)            over conflicting predecessors i < j

This is deterministic (pure function of the graph), and it orients every
conflict edge forward: if i < j conflict then lane(i) < lane(j), so the
pair executes in row order.  Conflicting pairs therefore serialize exactly
as the row (tid) order and non-conflicting pairs commute — planned
execution is conflict-equivalent to the sequential oracle replay
(``core/seq.py``), which is the topological intra-wave order dependency chains
need: a RAW chain of depth d lands in d consecutive lanes and each link
reads its predecessor's committed write.

``max_lanes`` bounds the budget: a transaction whose layer would reach it
is *spilled* instead — left out of every lane and executed afterwards as a
single ordinary optimistic wave, where the engine's CC rules adjudicate it
(it may abort and re-enter the service's retry path).  Spilling trades the
program-order guarantee for a bounded lane count: a laned transaction may
then commit before a spilled predecessor, which is still serializable
(every committed txn passes the engine's rules) but no longer equivalent to
row order.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np

from .graph import ConflictGraph, conflict_graph

SPILLED = -1


class Plan(NamedTuple):
    """One wave's execution plan."""
    lane_of: np.ndarray               # [T] int32 lane index, SPILLED = spill
    lanes: Tuple[np.ndarray, ...]     # row indices per lane, ascending
    spill: np.ndarray                 # row indices spilled past the budget
    conflicted: int                   # txns with >= 1 conflict edge
    n_edges: int                      # undirected conflict edges in the wave

    @property
    def n_lanes(self) -> int:
        return len(self.lanes)

    @property
    def n_spilled(self) -> int:
        return len(self.spill)


def color_lanes(graph: ConflictGraph,
                max_lanes: Optional[int] = None) -> Plan:
    """Partition a wave into conflict-free lanes by layered greedy coloring.

    Deterministic in row order; every row lands in exactly one lane or the
    spill set.  ``max_lanes=None`` never spills (lane count = 1 + longest
    conflict chain)."""
    conflict = graph.conflict
    T = conflict.shape[0]
    lane_of = np.zeros(T, np.int32)
    for j in range(T):
        preds = np.flatnonzero(conflict[j, :j])
        preds = preds[lane_of[preds] != SPILLED]
        lane = int(lane_of[preds].max()) + 1 if len(preds) else 0
        if max_lanes is not None and lane >= max_lanes:
            lane = SPILLED
        lane_of[j] = lane
    n_lanes = int(lane_of.max()) + 1 if (lane_of != SPILLED).any() else 0
    lanes = tuple(np.flatnonzero(lane_of == l) for l in range(n_lanes))
    return Plan(lane_of=lane_of, lanes=lanes,
                spill=np.flatnonzero(lane_of == SPILLED),
                conflicted=int(conflict.any(axis=1).sum()),
                n_edges=int(np.triu(conflict, 1).sum()))


def plan_wave(op_kind: np.ndarray, op_key: np.ndarray,
              max_lanes: Optional[int] = None,
              method: str = "auto") -> Plan:
    """Graph + coloring in one call: the planner front half on a formed
    wave's host-side op arrays."""
    return color_lanes(conflict_graph(op_kind, op_key, method=method),
                       max_lanes=max_lanes)
