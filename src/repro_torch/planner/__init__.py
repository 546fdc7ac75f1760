"""Deterministic conflict-graph planner plane (port of ``repro.planner``,
single device; DESIGN.md §10).

The wave former holds every transaction's declared read/write set on the
host before dispatch, so each wave's conflict graph is knowable *before*
execution.  This package partitions waves into conflict-free lanes and
executes them through the unchanged engine — the seventh scheduler,
``"planned"``, which commits abort-free on planned lanes under any skew.

    graph.py   [T,O] op arrays -> WW/WR/RW conflict graph      (numpy)
    lanes.py   graph -> conflict-free lanes + spill             (numpy)
    sched.py   lanes -> one pow2 wave block -> engine.step_block (device)
    hybrid.py  optimistic <-> planned switch for the service
"""
from .graph import ConflictGraph, conflict_graph, op_masks
from .hybrid import HybridSwitch
from .lanes import SPILLED, Plan, color_lanes, plan_wave
from .sched import (ALL_SCHEDULERS, DEFAULT_MAX_LANES, PLANNED, PlanRunStats,
                    PlannedWave, PlannerError, build_planned_block,
                    run_wave_planned, run_workload_any, run_workload_planned)

__all__ = [
    "ConflictGraph", "conflict_graph", "op_masks",
    "Plan", "SPILLED", "color_lanes", "plan_wave",
    "ALL_SCHEDULERS", "DEFAULT_MAX_LANES", "PLANNED", "PlanRunStats",
    "PlannedWave", "PlannerError", "build_planned_block",
    "run_wave_planned", "run_workload_any", "run_workload_planned",
    "HybridSwitch",
]
