"""Executing a key-range move against the version store (port of
``repro.placement.move``).

A move copies the full version rings of the moving keys from their old
physical slots to freshly allocated slots inside the destination node's
block, then clears the sources to the empty state (``tid == NO_TID``
everywhere, so the freed rows answer no read and accept a later move-in).
Old and new slots are disjoint by construction — destinations were free —
so gather, scatter, clear is safe in that order.

Like the rest of the port's engine the move updates the store IN PLACE:
each field's source rows are gathered into a new tensor (advanced
indexing copies) before the scatter, so the scatter never reads a row it
has already written.  The move runs **under the GC watermark** like any
writer: the service fires it only at a wave boundary, with no block in
flight, so no visibility computation can observe a half-moved store.

On a node mesh (``core.dist_engine``: the store's rows split into
``n_nodes`` equal blocks, emulated as the leading dimension of a view) the
move is the reference's peer program: each node answers the source rows it
owns and the answers merge by a sum over the nodes (the reference's
``psum``), then each node scatters the rings into, and clears, only the
rows of its own block.  A row outside a node's block is DROPPED on that
node, never clamped into it (a clamp would write the block's last row).

On a ``ProcessMesh`` (one ``torch.distributed`` rank a node, each holding
only its block) the same peer program runs with a collective: each rank
gathers the source rings it owns (0 in the other rows), every field is
stacked into ONE int32 buffer merged by one ``all_reduce(SUM)``, and each
rank scatters into, and clears, the rows of its own block only.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.dist_engine import NodeMesh, ProcessMesh, check_mesh
from repro_torch.core.store import MVStore, NO_TID
from repro_torch.kernels.ops import I32_MAX, I32_MIN, _put_

from .map import MoveRecord

_EMPTY = {"val": 0, "tid": int(NO_TID), "cid": 0, "sid": 0,
          "head": 0, "wave": 0}


def apply_move_local(store: MVStore, rec: MoveRecord) -> MVStore:
    """Single-device move, in place: gather the rings at the old slots,
    scatter them to the new ones, clear the sources to empty.  The two
    slot vectors cross to the store's device in one copy."""
    if rec.keys.size == 0:
        return store
    idx = torch.as_tensor(np.stack([rec.old_slots, rec.new_slots]).astype(
        np.int64), device=store.device)
    old, new = idx[0], idx[1]
    for name, a in zip(MVStore._fields, store):
        a[new] = a[old]
        a[old] = _EMPTY[name]
    return store


def _set_owned_(blocks, rows, live, src) -> None:
    """``blocks[i, rows[i, m]] = src[i, m]`` in place wherever ``live[i,
    m]``: each node writes its own block only.  ``blocks``: a field's [N,
    n_local, ...] view; ``rows``/``live``: [N, M]; ``src`` broadcasts to
    [N, M, ...].  A dead entry (a row off the node's block, clamped to a
    real one) contributes the identities of a min and a max scatter, so it
    is dropped, not written (``ops._put_``)."""
    N, n_local = blocks.shape[:2]
    w = blocks[0, 0].numel()                         # cells a row
    node = torch.arange(N, device=rows.device)[:, None]
    cells = ((node * n_local + rows) * w)[..., None] + torch.arange(
        w, device=rows.device)
    live = live[..., None].expand(cells.shape).reshape(-1)
    shape = (*rows.shape, *blocks.shape[2:])
    src = (torch.broadcast_to(src, shape) if isinstance(src, torch.Tensor)
           else torch.full(shape, src, dtype=torch.int32,
                           device=rows.device))
    _put_(blocks.view(-1), cells.reshape(-1), live,
          src.reshape(-1),
          torch.where(live, I32_MIN, I32_MAX).to(torch.int32))


def _move_rows(rec: MoveRecord, base: torch.Tensor, n_local: int):
    """The move's source and destination rows local to each block of
    ``n_local`` rows based at ``base`` ([N, 1] int64): ``((src, dst),
    (mine_src, mine_dst))``, each [N, M], the rows clamped into the block
    and the masks of the ones that lie in it."""
    idx = torch.as_tensor(np.stack([rec.old_slots, rec.new_slots]).astype(
        np.int64), device=base.device)
    lk = idx[:, None, :] - base                      # [2, N, M] local rows
    return lk.clamp(0, n_local - 1), (lk >= 0) & (lk < n_local)


def apply_move_mesh(store: MVStore, rec: MoveRecord,
                    mesh: NodeMesh) -> MVStore:
    """Mesh move, in place, on every node at once: each node gathers the
    source rings it owns (the others give 0) and the answers merge by a
    sum over the nodes; then each node scatters the rings into the
    destination rows of its block and clears the source rows of its block.
    Rows off a node's block are dropped there."""
    if rec.keys.size == 0:
        return store
    N = mesh.n_nodes
    if store.n_keys % N:
        raise ValueError(f"apply_move_mesh: {store.n_keys} rows do not "
                         f"divide over {N} nodes")
    n_local = store.n_keys // N
    dev = store.device
    base = torch.arange(N, dtype=torch.int64, device=dev)[:, None] * n_local
    (src, dst), (mine_src, mine_dst) = _move_rows(rec, base, n_local)
    node = torch.arange(N, device=dev)[:, None]
    for name, a in zip(MVStore._fields, store):
        blocks = a.view(N, n_local, *a.shape[1:])
        owned = mine_src.view(*mine_src.shape, *[1] * (a.dim() - 1))
        rows = torch.where(owned, blocks[node, src], 0).sum(
            0, dtype=torch.int32)                    # the psum gather
        _set_owned_(blocks, dst, mine_dst, rows)
        _set_owned_(blocks, src, mine_src, _EMPTY[name])
    return store


def apply_move_process(block: MVStore, rec: MoveRecord,
                       pmesh: ProcessMesh) -> MVStore:
    """This rank's part of a move on a process mesh, in place on its
    block: the source rings it owns (0 in the others' rows) stacked field
    by field into one ``[M, 4 V + 2]`` int32 buffer, merged over the ranks
    by ONE ``all_reduce(SUM)`` (the reference's ``psum``); then the rings
    scattered into the destination rows of the block and the block's
    source rows cleared (``_set_owned_`` on a one-node view).  Rows off the
    block are dropped.  A collective: every rank calls it with the same
    record."""
    if rec.keys.size == 0:
        return block
    n_local = block.n_keys
    base = torch.full((1, 1), pmesh.rank * n_local, dtype=torch.int64,
                      device=block.device)
    (src, dst), (mine_src, mine_dst) = _move_rows(rec, base, n_local)
    M = src.shape[1]
    rows = torch.cat([torch.where(
        mine_src[0].view(M, *[1] * (a.dim() - 1)), a[src[0]], 0).reshape(
            M, -1) for a in block], dim=1)
    dist.all_reduce(rows, op=dist.ReduceOp.SUM, group=pmesh.group)
    at = 0
    for name, a in zip(MVStore._fields, block):
        w = a[0].numel()
        one = a.view(1, n_local, *a.shape[1:])
        _set_owned_(one, dst, mine_dst,
                    rows[:, at:at + w].reshape(1, M, *a.shape[1:]))
        _set_owned_(one, src, mine_src, _EMPTY[name])
        at += w
    return block


def apply_move(store: MVStore, rec: MoveRecord, mesh=None) -> MVStore:
    """Execute ``rec`` on the store, in place, on the data plane ``mesh``
    names: one device (``None``), a ``NodeMesh`` (``apply_move_mesh``) or
    a ``ProcessMesh`` (``apply_move_process``: ``store`` is this rank's
    block, and every rank calls it)."""
    mesh = check_mesh(mesh)
    if mesh is None:
        return apply_move_local(store, rec)
    if isinstance(mesh, ProcessMesh):
        return apply_move_process(store, rec, mesh)
    return apply_move_mesh(store, rec, mesh)


def move_payload(rec: MoveRecord, seq: int, clock: int) -> dict:
    """WAL payload for a REC_MOVE frame: the explicit arrays (replay never
    re-runs the allocator) plus the log position and the watermark clock
    the move executed under.  The reference's dict, key for key."""
    return {"seq": int(seq), "clock": int(clock),
            "lo": int(rec.lo), "hi": int(rec.hi), "dst": int(rec.dst),
            "keys": np.asarray(rec.keys, np.int32),
            "old_slots": np.asarray(rec.old_slots, np.int32),
            "new_slots": np.asarray(rec.new_slots, np.int32)}


def record_from_payload(payload: dict) -> MoveRecord:
    arr = lambda x: np.asarray(x, np.int32)
    return MoveRecord(int(payload["lo"]), int(payload["hi"]),
                      int(payload["dst"]), arr(payload["keys"]),
                      arr(payload["old_slots"]), arr(payload["new_slots"]))
