"""The paper's shared-nothing cluster on one device (port of
``repro.core.dist_engine``).

The reference block-partitions the version store over a 1-D ``("node",)``
JAX mesh and runs the one commit loop of ``engine.run_wave_on`` inside a
``shard_map`` over a ``MeshSubstrate``: reads answered by their owner and
merged by ``psum``, installs and SID bumps applied on the owner only, the
transaction state replicated, no coordinator anywhere.  On one GPU the node
axis is emulated as the leading dimension of a view: the sharded store is a
plain ``MVStore`` of ``n_slots = N * n_local`` rows (the global shape a
JAX array sharded ``P("node")`` keeps), node ``i``'s block is rows
``[i * n_local, (i + 1) * n_local)``, and ``psum`` / ``pmax`` / ``pmin``
become a sum / max / min over the node dimension
(``substrate.MeshSubstrate``).  Keeping the global shape keeps the padded
row count the reference logs as ``n_slots`` and the snapshot and WAL bytes
the reference's.

This module holds NO concurrency-control rules.  Its drivers wire the
engine's own drivers to a ``MeshSubstrate`` and mirror the single-device
ones one for one:

  ``run_wave_dist``            one wave          <->  ``engine.run_wave``
  ``run_workload_dist``        per-wave driver   <->  ``engine.run_workload``
  ``run_workload_fused_dist``  no host sync
                               between waves     <->  ``run_workload_fused``
  ``step_wave_dist``           closed-loop step  <->  ``engine.step_wave``
  ``run_block_dist`` / ``step_block_dist``       <->  ``run_block`` /
                                                      ``step_block``

plus ``mesh_watermark``, the min of the per-node GC floors.  Their
``n_nodes`` (the logical cluster model of dsi, clocksi skew and
``msgs_cross``) defaults to the mesh's node count.  Like the engine's, the
drivers update the store IN PLACE, and on a CUDA device a block dispatch
does not wait on the card.  The outcomes, the stores and the statistics are
bit-identical to the single-device engine's for every scheduler and route.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Tuple

import numpy as np
import torch

from repro_torch.kernels import resolve_device
from .engine import (Wave, WaveOut, _as_staged, _h2d, _out_to_numpy,
                     _run_fused, _run_stacked, _scalar, _stats_of,
                     run_wave_on, stage_block, wave_from_numpy,
                     wave_to_numpy)
from .store import NO_TID, MVStore, as_placement_arrays, make_store
from .substrate import MeshSubstrate


@dataclasses.dataclass(frozen=True)
class NodeMesh:
    """A 1-D mesh of ``n_nodes`` shared-nothing nodes emulated on one
    device: the store's rows split into ``n_nodes`` equal blocks."""
    n_nodes: int
    device: torch.device


def make_node_mesh(n_nodes: int, device=None) -> NodeMesh:
    """The ``("node",)`` mesh of ``n_nodes`` nodes on ``device`` (``None``:
    the CUDA device).  The reference maps each node to its own XLA device
    and refuses a mesh larger than the device count; here every node is a
    block of one device's store, so any ``n_nodes >= 1`` fits one card."""
    if n_nodes < 1:
        raise ValueError(f"make_node_mesh({n_nodes}): a mesh needs at least "
                         f"one node")
    return NodeMesh(int(n_nodes), _indexed(device))


def _indexed(device) -> torch.device:
    """``resolve_device(device)`` with the current CUDA index filled in, as
    a tensor's ``.device`` names it."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def mesh_device(mesh: NodeMesh, device=None) -> torch.device:
    """The device a service or a recovery on ``mesh`` runs on: the mesh's.
    A ``device`` given beside the mesh must name the same one."""
    if device is not None and _indexed(device) != mesh.device:
        raise ValueError(f"device {device} is not the mesh's {mesh.device}")
    return mesh.device


def check_mesh(mesh) -> NodeMesh | None:
    """``mesh`` if it is ``None`` or a ``NodeMesh``; anything else raises
    ``TypeError`` (the reference's JAX ``Mesh`` has no meaning here)."""
    if mesh is not None and not isinstance(mesh, NodeMesh):
        raise TypeError(f"mesh must be a NodeMesh (make_node_mesh), got "
                        f"{type(mesh).__name__}")
    return mesh


def shard_store(store: MVStore, mesh: NodeMesh,
                n_slots: int | None = None) -> MVStore:
    """Block-partition a store over the mesh's nodes, on the mesh's device.

    A row count that does not divide the node count is PADDED with empty
    rows (``tid == NO_TID`` in every slot: never visible, routed to by no
    key or placement) up to the next multiple of ``n_nodes``, so the block
    arithmetic stays exact.  ``n_slots`` (an elastic placement's
    ``PlacementMap.n_slots``) asks for a given padded row count: a multiple
    of ``n_nodes``, not below the store's rows.  Without padding the
    store's own tensors are returned (moved to the mesh's device)."""
    n_nodes = mesh.n_nodes
    n_rows = store.n_keys
    if n_slots is None:
        n_slots = -(-n_rows // n_nodes) * n_nodes        # ceil to a multiple
    if n_slots % n_nodes != 0:
        raise ValueError(f"shard_store: n_slots={n_slots} is not a multiple "
                         f"of the mesh's {n_nodes} node(s)")
    if n_slots < n_rows:
        raise ValueError(f"shard_store: n_slots={n_slots} < store rows "
                         f"{n_rows}; the store does not shrink")
    store = MVStore(*(t.to(mesh.device) for t in store))
    if n_slots > n_rows:
        pad = make_store(n_slots - n_rows, store.n_versions,
                         device=mesh.device)
        pad.tid.fill_(NO_TID)        # EMPTY rows, not bootstrap rows
        store = MVStore(*(torch.cat([a, b]) for a, b in zip(store, pad)))
    return store


def _prepare(store: MVStore, mesh: NodeMesh, kernels, host_skew, placement):
    """The mesh substrate on the store's device and the wave-independent
    inputs there; the store must live on the mesh's device."""
    mesh = check_mesh(mesh)
    dev = store.device
    if dev != mesh.device:
        raise ValueError(f"the store lives on {dev}, the mesh on "
                         f"{mesh.device}: shard_store it first")
    hs = None if host_skew is None else _h2d(host_skew, dev)
    return (MeshSubstrate(mesh.n_nodes, kernels, dev), hs,
            as_placement_arrays(placement, dev))


def _placement_check(store: MVStore, mesh: NodeMesh, placement,
                     op_key) -> None:
    """``REPRO_PLACEMENT_CHECK=1``: validate the owner/slot routing of the
    keys about to run against the store's block layout before dispatching
    (it reads the tables back from the device, so it is off unless the
    variable is set)."""
    if os.environ.get("REPRO_PLACEMENT_CHECK", "0") in ("", "0"):
        return
    from repro_torch.placement.map import validate_routing
    validate_routing(int(store.head.shape[0]), mesh.n_nodes, placement,
                     op_key)


def run_wave_dist(store: MVStore, wave: Wave, wave_idx, clock,
                  mesh: NodeMesh, n_nodes=None, sched: str = "postsi",
                  host_skew=None, watermark=None, gc_track: bool = False,
                  gc_block: bool = False, kernels=None, placement=None
                  ) -> Tuple[MVStore, WaveOut, torch.Tensor]:
    """One wave on the node mesh, any scheduler, updating ``store`` in
    place; mesh twin of ``engine.run_wave`` (same contract: (store', out,
    clock') with device-resident ``out``).  ``n_nodes`` is the logical
    cluster model; ``None`` takes the mesh's node count."""
    sub, hs, pl = _prepare(store, mesh, kernels, host_skew, placement)
    n_nodes = mesh.n_nodes if n_nodes is None else n_nodes
    _placement_check(store, mesh, pl, wave.op_key)
    return run_wave_on(sub, store, wave_from_numpy(wave, store.device),
                       wave_idx, clock, n_nodes, sched=sched, host_skew=hs,
                       watermark=watermark, gc_track=gc_track,
                       gc_block=gc_block, placement=pl)


def step_wave_dist(store: MVStore, wave, wave_idx: int, clock,
                   mesh: NodeMesh, *, sched: str = "postsi",
                   n_nodes: int | None = None, host_skew=None,
                   watermark=None, gc_track: bool = True,
                   gc_block: bool = False, kernels=None, placement=None):
    """Closed-loop step on the mesh: ``run_wave_dist`` and a host sync of
    the per-txn outcomes; drop-in for ``engine.step_wave``."""
    store, out, clock = run_wave_dist(
        store, wave, wave_idx, clock, mesh, n_nodes=n_nodes, sched=sched,
        host_skew=host_skew, watermark=watermark, gc_track=gc_track,
        gc_block=gc_block, kernels=kernels, placement=placement)
    return store, _out_to_numpy(out), clock


def run_block_dist(store: MVStore, stacked, wave_idx0, clock,
                   mesh: NodeMesh, *, sched: str = "postsi",
                   n_nodes: int | None = None, host_skew=None,
                   watermark=None, gc_track: bool = True,
                   gc_block: bool = False, kernels=None, placement=None):
    """A block of B waves back to back on the mesh, in place; mesh twin of
    ``engine.run_block`` (same contract: device-resident ``(store', outs,
    clock')``, a ``StagedBlock`` or anything ``stage_block`` takes, and on
    a CUDA device nothing here waits on the card).  ``watermark=None`` is
    each wave's entry clock, the port's form of the reference's ``-1``."""
    blk = _as_staged(store, stacked, wave_idx0, watermark)
    sub, hs, pl = _prepare(store, mesh, kernels, host_skew, placement)
    n_nodes = mesh.n_nodes if n_nodes is None else n_nodes
    _placement_check(store, mesh, pl, blk.wave.op_key)
    return _run_stacked(sub, store, blk, _scalar(clock, store.device),
                        n_nodes=n_nodes, sched=sched, host_skew=hs,
                        gc_track=gc_track, gc_block=gc_block, placement=pl)


def step_block_dist(store: MVStore, stacked, wave_idx0: int, clock,
                    mesh: NodeMesh, **kw):
    """Synchronous mesh block step: ``run_block_dist`` and a host sync of
    the per-wave outcomes (mesh twin of ``engine.step_block``)."""
    store, outs, clock = run_block_dist(store, stacked, wave_idx0, clock,
                                        mesh, **kw)
    return store, _out_to_numpy(outs), clock


def run_workload_dist(store: MVStore, waves, mesh: NodeMesh,
                      sched: str = "postsi", host_skew=None,
                      n_nodes: int | None = None, gc_track: bool = False,
                      gc_block: bool = False, kernels=None, placement=None):
    """Per-wave mesh driver (twin of ``engine.run_workload``): one wave and
    one host sync at a time.  Returns (store, history, stats)."""
    clock = 1
    history = []
    for w_idx, wave in enumerate(waves):
        store, out, clock = run_wave_dist(
            store, wave, w_idx + 1, clock, mesh, n_nodes=n_nodes,
            sched=sched, host_skew=host_skew, gc_track=gc_track,
            gc_block=gc_block, kernels=kernels, placement=placement)
        history.append((np.asarray(wave_to_numpy(wave).tid),
                        _out_to_numpy(out)))
    return store, history, _stats_of(history)


def run_workload_fused_dist(store: MVStore, waves, mesh: NodeMesh,
                            sched: str = "postsi", host_skew=None,
                            n_nodes: int | None = None,
                            gc_track: bool = False, gc_block: bool = False,
                            kernels=None, placement=None):
    """Fused mesh driver (twin of ``engine.run_workload_fused``): every
    wave with no host sync between them, one copy of the stacked outcomes
    at the end.  Same (store, history, stats) contract, bit-identical
    history."""
    blk = stage_block(list(waves), 1, None, store.device)
    sub, hs, pl = _prepare(store, mesh, kernels, host_skew, placement)
    n_nodes = mesh.n_nodes if n_nodes is None else n_nodes
    _placement_check(store, mesh, pl, blk.wave.op_key)
    return _run_fused(sub, store, blk, n_nodes=n_nodes, sched=sched,
                      host_skew=hs, gc_track=gc_track, gc_block=gc_block,
                      placement=pl)


def mesh_watermark(mesh: NodeMesh, node_floors) -> int:
    """The global GC watermark: the min over the ``N`` per-node
    live-reader floors (``service.VisibilityGC.node_floors``), the
    reference's ``pmin``.  The floors are host ints and the min is taken on
    the host: the service asks for it at every block dispatch, and a round
    trip through the device would make that dispatch wait."""
    floors = np.asarray(node_floors, np.int64).reshape(mesh.n_nodes)
    return int(floors.min())
