"""Elastic placement plane (port of ``repro.placement``; DESIGN.md §11).

Replaces the frozen ``key % n_nodes`` layout with a host-side
``PlacementMap`` (contiguous key ranges -> nodes, with per-key physical
slot assignments), live range moves executed at a wave boundary and
WAL-logged for bit-identical replay, hot-key read replicas whose
visibility floor is the GC watermark, and a load balancer that plans
splits off per-node commit/abort counters.  On a node mesh a move is
``apply_move_mesh``: the source rings gathered by their owner and merged
over the nodes, the scatters and clears on the owners only.
"""
from .balancer import LoadBalancer
from .map import (MoveRecord, PlacementError, PlacementMap, logical_store,
                  physical_store, validate_routing)
from .move import (apply_move, apply_move_local, apply_move_mesh,
                   move_payload, record_from_payload)
from .replica import HotKeyReplicas

__all__ = [
    "HotKeyReplicas",
    "LoadBalancer",
    "MoveRecord",
    "PlacementError",
    "PlacementMap",
    "apply_move",
    "apply_move_local",
    "apply_move_mesh",
    "logical_store",
    "move_payload",
    "physical_store",
    "record_from_payload",
    "validate_routing",
]
