"""Executing a key-range move against the version store (port of
``repro.placement.move``, single device).

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

The mesh move (``apply_move_mesh``) comes with the mesh substrate.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.store import MVStore, NO_TID

from .map import MoveRecord

_EMPTY = {"val": 0, "tid": int(NO_TID), "cid": 0, "sid": 0,
          "head": 0, "wave": 0}
_MESH = "Mesh substrate + dist_engine"


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


def apply_move_mesh(store: MVStore, rec: MoveRecord, mesh) -> MVStore:
    raise NotImplementedError(
        f"apply_move_mesh is not ported yet: see ROADMAP.md queue 1, item "
        f"'{_MESH}'")


def apply_move(store: MVStore, rec: MoveRecord, mesh=None) -> MVStore:
    if mesh is None:
        return apply_move_local(store, rec)
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
