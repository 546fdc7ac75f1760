"""Read-only hot-key replicas with a visibility floor (port of
``repro.placement.replica``).

Every version visible at snapshot ``s = watermark`` is frozen — any future
writer commits at ``cid > clock >= watermark`` — and a reader pinned at
``s = c = watermark`` needs no SID bump, since no writer with ``cid <= s``
can still commit.  So a replica serves reads with no coordination at all;
its staleness is the watermark lag.

``HotKeyReplicas`` keeps host-side numpy snapshots (``val``/``cid`` per
replicated key), refreshed from the store through ``read_visible`` on the
store's device at the current GC watermark.  A read-only transaction whose
keys are all replicated is answered at submit time and never enters the
engine; writes still go to the owner and advance the ring, which the next
refresh picks up.  On a process mesh the store a rank holds is its block
and the refresh reads through the mesh's merged read (``read=``): every
rank makes the same refresh at the same tick and gets the same snapshot.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core.commit_phase import NOP, READ
from repro_torch.core.store import MVStore, read_visible


class HotKeyReplicas:
    """Replicated read-only snapshots of a hot key set at a visibility floor.

    ``keys`` are LOGICAL keys; ``slot_of`` (when elastic) maps them to
    physical store rows at refresh time, so replicas follow keys through
    range moves.
    """

    def __init__(self, keys) -> None:
        self.keys = np.unique(np.asarray(keys, np.int64))
        self.floor = -1                       # watermark of the last refresh
        self.refreshes = 0
        self.served = 0                       # read ops answered locally
        # dense key-indexed snapshots: ``can_serve`` runs on every submit,
        # so membership and value lookups are vectorized array hits
        hi = int(self.keys.max()) + 1 if self.keys.size else 1
        self._member = np.zeros(hi, bool)
        self._member[self.keys] = True
        self._val = np.zeros(hi, np.int32)
        self._cid = np.zeros(hi, np.int32)

    def can_serve(self, op_kind: np.ndarray, op_key: np.ndarray) -> bool:
        """True iff the txn is read-only (every active op is a READ) and
        every active op's key is in the replica set."""
        if self.floor < 0:
            return False
        kinds = np.asarray(op_kind)
        keys = np.asarray(op_key)
        active = kinds != NOP
        if not active.any() or (kinds[active] != READ).any():
            return False
        ka = keys[active]
        # clamp BOTH ends before indexing: a negative key would wrap via
        # Python negative indexing into ``_member`` and could report a
        # false membership
        ok = (ka >= 0) & (ka < self._member.size)
        return bool((ok & self._member[
            np.clip(ka, 0, self._member.size - 1)]).all())

    def serve(self, op_kind: np.ndarray, op_key: np.ndarray):
        """Answer a read-only txn from the replica snapshot.  Returns
        (values, snapshot) — the txn commits with s = c = floor."""
        keys = np.asarray(op_key)[np.asarray(op_kind) != NOP]
        vals = self._val[keys].astype(np.int32)
        self.served += int(keys.size)
        return vals, self.floor

    def refresh(self, store: MVStore, floor: int,
                slot_of: Optional[np.ndarray] = None,
                read=read_visible) -> None:
        """Re-snapshot every replicated key at visibility floor ``floor``
        (the GC watermark): one batched ``read_visible`` gather on the
        store's device and one copy of its values and CIDs to the host.  No
        invalidation traffic is needed: the floor only moves forward and
        versions visible at or below it are immutable.  ``read(store,
        rows, max_cid)`` (``core.store.read_visible`` by default) answers
        GLOBAL rows; on a process mesh it is the mesh's merged read
        (``GroupMeshSubstrate.read_visible``), a collective."""
        if self.keys.size == 0:
            self.floor = max(self.floor, int(floor))
            return
        rows = self.keys if slot_of is None else slot_of[self.keys]
        k = torch.as_tensor(np.asarray(rows, np.int32), device=store.device)
        wm = torch.full(k.shape, int(floor), dtype=torch.int32,
                        device=store.device)
        val, _, cid, _, _ = read(store, k, wm)
        val, cid = torch.stack([val, cid]).cpu().numpy()
        self._val[self.keys] = val
        self._cid[self.keys] = cid
        self.floor = int(floor)
        self.refreshes += 1

    def max_cid(self) -> int:
        """Largest commit timestamp any replica answer could carry — never
        above the floor."""
        return int(self._cid[self.keys].max()) if self.keys.size else 0

    def report(self) -> Dict:
        return {"n_keys": int(self.keys.size), "floor": int(self.floor),
                "refreshes": self.refreshes, "served_reads": self.served}
