"""Periodic snapshots of the version store (port of
``repro.durability.snapshot``).

A snapshot is one PostSI writer transaction over the version rings + SID
state plus a small meta vector — taken through ``PostSICheckpointer``
(``checkpoint/postsi_store.py``), so CID-based visibility guarantees a
restore observes one atomic snapshot, never a torn mix of two, with no
manifest lock.  The meta vector pins the snapshot to the WAL:

    [clock, wave_idx, wal_seq, gc_clock, next_tid]

``wal_seq`` is the number of retired blocks already folded into the
snapshot — recovery restores the snapshot and replays only WAL records
with ``seq >= wal_seq``.  Snapshots are only taken at **pipeline-empty
retire boundaries** (no dispatched-but-unretired block, no open buffer):
that is the only point where the device store is exactly the state of the
retired prefix, so snapshot + WAL-suffix replay reconstructs the same
state as a full replay, bit for bit.

``save`` copies the device store to the host once per field
(``core.store.store_to_numpy``); the files and the meta are the
reference's, so either package restores the other's snapshots.

A corrupt snapshot directory degrades, never kills: the checkpointer
tolerates a damaged meta file (``meta_corrupt``) and ``restore_latest``
then returns ``None`` — recovery falls back to replaying the whole WAL.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np

from repro_torch.checkpoint import PostSICheckpointer
from repro_torch.core.store import store_to_numpy

_META_LEN = 5        # clock, wave_idx, wal_seq, gc_clock, next_tid


@dataclasses.dataclass
class SnapshotState:
    """One restored snapshot: numpy store leaves + the WAL anchor."""
    store: dict                  # field name -> np.ndarray (MVStore leaves)
    clock: int
    wave_idx: int
    wal_seq: int                 # retired blocks already inside the store
    gc_clock: int
    next_tid: int
    snap_id: int                 # the checkpointer step that produced it


def _tree_example(n_slots: int, n_versions: int) -> dict:
    """The fixed tree every snapshot of this store uses — dict leaves (not
    the MVStore NamedTuple) so the checkpointer's leaf paths are stable
    strings, the reference's."""
    kv = (n_slots, n_versions)
    return {
        "store": {
            "val": np.zeros(kv, np.int32), "tid": np.zeros(kv, np.int32),
            "cid": np.zeros(kv, np.int32), "sid": np.zeros(kv, np.int32),
            "head": np.zeros((n_slots,), np.int32),
            "wave": np.zeros((n_slots,), np.int32),
        },
        "meta": np.zeros((_META_LEN,), np.int64),
    }


class SnapshotStore:
    """Snapshot save/restore for one durable service directory.  A snapshot
    holds the store's physical rows: ``n_slots`` of them, which is
    ``n_keys`` under the identity layout and ``PlacementMap.n_slots``
    under an elastic placement."""

    SUBDIR = "snaps"

    def __init__(self, directory: str, n_slots: int, n_versions: int,
                 keep_latest: int = 2):
        self.dir = os.path.join(directory, self.SUBDIR)
        self.keep_latest = keep_latest
        self.example = _tree_example(n_slots, n_versions)
        self.ckpt = PostSICheckpointer(self.dir, self.example)
        self._next_id = 1

    # ---------------------------------------------------------------- save
    def save(self, store, clock: int, wave_idx: int, wal_seq: int,
             gc_clock: int, next_tid: int) -> int:
        """Snapshot ``store`` (an ``MVStore`` on any device); returns the
        snapshot id."""
        fields = store_to_numpy(store)
        tree = {
            "store": {f: fields[f] for f in self.example["store"]},
            "meta": np.array([clock, wave_idx, wal_seq, gc_clock, next_tid],
                             np.int64),
        }
        snap_id = self._next_id
        self._next_id += 1
        ok = self.ckpt.save(snap_id, tree)
        if ok:
            self.ckpt.gc(keep_latest=self.keep_latest)
        return snap_id

    # ------------------------------------------------------------- restore
    def restore_latest(self) -> Optional[SnapshotState]:
        """Latest committed snapshot as numpy leaves, or ``None`` (no
        snapshot yet, or the snapshot store is damaged — recovery then
        replays the full WAL)."""
        try:
            snap_id, tree = self.ckpt.restore(self.example, device="cpu")
        except (OSError, ValueError):
            return None                   # damaged leaf files: full replay
        if snap_id is None:
            return None
        meta = [int(x) for x in tree["meta"].tolist()]
        self._next_id = max(self._next_id, snap_id + 1)
        return SnapshotState(
            store={f: t.numpy() for f, t in tree["store"].items()},
            clock=meta[0], wave_idx=meta[1], wal_seq=meta[2],
            gc_clock=meta[3], next_tid=meta[4], snap_id=snap_id)
