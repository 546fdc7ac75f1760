"""Meshes of the port (counterpart of ``repro.launch.mesh``).

``make_cc_node_mesh(n_nodes)`` is the launch-layer name of the
concurrency-control data plane's ``("node",)`` mesh,
``core.dist_engine.make_node_mesh``: the paper's shared-nothing nodes as
blocks of one card's store.  Pair it with a ``PlacementMap(n_keys,
n_nodes)`` for the elastic layout, or ``placement=None`` for the frozen
blocks.

Not ported: ``make_production_mesh`` and ``make_test_mesh`` (the
reference's GSPMD meshes of 256 and 512 TPU chips and of 8 host devices
for its model plane) and ``repro.launch.sharding`` (their logical-axis
rules): one card has no such mesh.
"""
from __future__ import annotations

from repro_torch.core.dist_engine import NodeMesh, make_node_mesh

__all__ = ["make_cc_node_mesh"]


def make_cc_node_mesh(n_nodes: int = 8, device=None) -> NodeMesh:
    """The ``("node",)`` mesh of ``n_nodes`` nodes on ``device`` (None:
    the CUDA device)."""
    return make_node_mesh(n_nodes, device)
