"""PlacementMap: host-side owner/slot tables for elastic key routing (port of
``repro.placement.map``).

The contract (DESIGN.md §11):

* every logical key ``k in [0, n_keys)`` has exactly one owning node
  ``owner[k]`` and one physical store row ``slot[k]``;
* ``slot`` is injective, and ``slot[k] // capacity == owner[k]`` — a key's
  ring lives inside its owner's block of the store, so the engine
  translates logical keys to slots once a wave and everything downstream
  is slot-space;
* ownership is kept as contiguous logical ranges (splits move range
  boundaries), but the representation of record is the per-key
  ``owner``/``slot`` arrays — ``ranges()`` is derived from them, so live
  state and WAL-replayed state are structurally identical by construction.

``move()`` only plans: it returns a :class:`MoveRecord` naming the exact
keys, source slots and destination slots.  Applying the record to the
store (copy rings, clear sources) is ``placement.move.apply_move``;
applying it to this map is :meth:`PlacementMap.apply_record`.  Replay from
the WAL re-applies the explicit arrays and never re-runs the allocator.

The tables live on the host as numpy int32.  ``device_arrays(device)``
gives them as int32 tensors on a device, made once and cached; a move
remakes every cached copy in ``apply_record``, which runs at a wave
boundary, so an engine dispatch never copies the tables from the host.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.store import NO_TID, MVStore, PlacementArrays
from repro_torch.kernels import resolve_device


class PlacementError(AssertionError):
    """Routing/placement invariant violation (raised by validate_routing)."""


@dataclass(frozen=True)
class MoveRecord:
    """One executed (or planned) key-range move, fully explicit for replay."""
    lo: int                 # logical range [lo, hi) that moved
    hi: int
    dst: int                # destination node
    keys: np.ndarray        # [m] int32 logical keys (== arange(lo, hi))
    old_slots: np.ndarray   # [m] int32 source store rows
    new_slots: np.ndarray   # [m] int32 destination store rows

    def as_dict(self) -> Dict:
        return {"lo": int(self.lo), "hi": int(self.hi), "dst": int(self.dst),
                "keys": self.keys.tolist(),
                "old_slots": self.old_slots.tolist(),
                "new_slots": self.new_slots.tolist()}

    @staticmethod
    def from_dict(d: Dict) -> "MoveRecord":
        arr = lambda x: np.asarray(x, np.int32)
        return MoveRecord(int(d["lo"]), int(d["hi"]), int(d["dst"]),
                          arr(d["keys"]), arr(d["old_slots"]),
                          arr(d["new_slots"]))


def runs(owner: np.ndarray) -> List[Tuple[int, int]]:
    """``[(lo, hi), ...]``: the maximal runs of equal entries of ``owner``,
    in key order (the reference walks the keys one by one; this finds the
    same boundaries with one vector compare)."""
    cut = (np.flatnonzero(owner[1:] != owner[:-1]) + 1).tolist()
    return list(zip([0] + cut, cut + [int(owner.shape[0])]))


def _device_key(device) -> torch.device:
    """``device`` resolved, with the current CUDA device's index filled in
    so that ``"cuda"`` and ``"cuda:0"`` share one cached copy."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class PlacementMap:
    """Mutable host-side placement state; device tables via device_arrays().

    The initial layout is *block* placement: key ``k`` is owned by node
    ``k // ceil(n_keys / n_nodes)`` at slot ``owner * capacity + offset``.
    With ``headroom=1`` and a dividing key space this is the identity slot
    map over ``n_slots == n_keys`` — bit-identical to no placement at all.
    ``headroom > 1`` reserves free slots per node so ranges can move in.
    """

    def __init__(self, n_keys: int, n_nodes: int, *, headroom: int = 1):
        if n_nodes < 1 or n_keys < 1:
            raise ValueError(f"need n_keys,n_nodes >= 1, got {n_keys},{n_nodes}")
        if headroom < 1:
            raise ValueError(f"headroom must be >= 1, got {headroom}")
        self.n_keys = int(n_keys)
        self.n_nodes = int(n_nodes)
        base = -(-n_keys // n_nodes)            # ceil: block size per node
        self.capacity = int(base * headroom)    # slots per node
        self.owner = np.empty(n_keys, np.int32)
        self.slot = np.empty(n_keys, np.int32)
        for node in range(n_nodes):
            lo, hi = node * base, min((node + 1) * base, n_keys)
            if lo >= hi:
                continue
            self.owner[lo:hi] = node
            self.slot[lo:hi] = node * self.capacity + np.arange(hi - lo)
        self._cache: Dict[torch.device, PlacementArrays] = {}
        self._rebuild()

    @classmethod
    def from_arrays(cls, n_keys: int, n_nodes: int, capacity: int, owner,
                    slot) -> "PlacementMap":
        """A map in the state given by its tables, e.g. the numpy ``owner``,
        ``slot`` and ``capacity`` of a JAX ``PlacementMap`` that has
        already moved ranges."""
        pm = cls.__new__(cls)
        pm.n_keys, pm.n_nodes = int(n_keys), int(n_nodes)
        pm.capacity = int(capacity)
        pm.owner = np.array(owner, np.int32)
        pm.slot = np.array(slot, np.int32)
        if pm.owner.shape != (pm.n_keys,) or pm.slot.shape != (pm.n_keys,):
            raise ValueError(f"owner/slot must be [{pm.n_keys}], got "
                             f"{pm.owner.shape}/{pm.slot.shape}")
        pm._cache = {}
        pm._rebuild()
        return pm

    # -- derived state -----------------------------------------------------

    def _rebuild(self) -> None:
        """Recompute the free slots from owner/slot occupancy (derived, not
        tracked: live mutation and WAL replay land in identical state) and
        remake every cached device copy of the tables.  Each node's free
        slots are an ascending int32 array (the reference keeps Python
        lists; the contents are the same, and a million-key map rebuilds
        without a list of a million Python ints)."""
        used = np.zeros(self.n_slots, bool)
        used[self.slot] = True
        self._free: List[np.ndarray] = []
        for node in range(self.n_nodes):
            blk = slice(node * self.capacity, (node + 1) * self.capacity)
            self._free.append((np.flatnonzero(~used[blk])
                               + node * self.capacity).astype(np.int32))
        for dev in list(self._cache):
            self._cache[dev] = self._to_device(dev)

    def _to_device(self, dev: torch.device) -> PlacementArrays:
        # a copy, also on the CPU: the numpy tables change in place
        return PlacementArrays(torch.tensor(self.owner, device=dev),
                               torch.tensor(self.slot, device=dev))

    @property
    def n_slots(self) -> int:
        return self.n_nodes * self.capacity

    def ranges(self) -> List[Tuple[int, int, int]]:
        """Contiguous ownership ranges [(lo, hi, node), ...], derived."""
        return [(lo, hi, int(self.owner[lo])) for lo, hi in runs(self.owner)]

    def owner_of(self, key: int) -> int:
        return int(self.owner[key])

    def slot_of(self, keys):
        return self.slot[np.asarray(keys, np.int64)]

    def free_slots(self, node: int) -> int:
        return int(self._free[node].size)

    def device_arrays(self, device=None) -> PlacementArrays:
        """The tables as int32 tensors on ``device`` (``None``: the CUDA
        device), cached until the next ``apply_record`` remakes them."""
        dev = _device_key(device)
        arrays = self._cache.get(dev)
        if arrays is None:
            arrays = self._cache[dev] = self._to_device(dev)
        return arrays

    # -- mutation ----------------------------------------------------------

    def move(self, lo: int, hi: int, dst: int) -> MoveRecord:
        """Plan moving logical range [lo, hi) to node ``dst``: allocate
        destination slots (smallest free offsets first, so replayed and live
        allocation agree) and return the explicit record.  Does NOT mutate
        this map — call :meth:`apply_record` once the store move committed."""
        if not (0 <= lo < hi <= self.n_keys):
            raise ValueError(f"bad range [{lo}, {hi}) for n_keys={self.n_keys}")
        if not (0 <= dst < self.n_nodes):
            raise ValueError(f"bad destination node {dst}")
        keys = np.arange(lo, hi, dtype=np.int32)
        moving = self.owner[lo:hi] != dst
        keys = keys[moving]
        if keys.size > self._free[dst].size:
            raise PlacementError(
                f"node {dst} has {self._free[dst].size} free slots, "
                f"range [{lo},{hi}) needs {keys.size}; raise headroom")
        new_slots = self._free[dst][:keys.size].copy()      # ascending
        return MoveRecord(lo, hi, dst, keys,
                          self.slot[keys].astype(np.int32), new_slots)

    def apply_record(self, rec: MoveRecord) -> None:
        """Apply an executed move to the map (live or WAL replay — same
        path)."""
        self.owner[rec.keys] = rec.dst
        self.slot[rec.keys] = rec.new_slots
        self._rebuild()

    # -- (de)serialization -------------------------------------------------

    def to_config(self) -> Dict:
        """Durable identity of the *initial* layout (moves replay on top)."""
        return {"n_keys": self.n_keys, "n_nodes": self.n_nodes,
                "capacity": self.capacity}

    @staticmethod
    def from_config(cfg: Dict) -> "PlacementMap":
        pm = PlacementMap(int(cfg["n_keys"]), int(cfg["n_nodes"]), headroom=1)
        cap = int(cfg["capacity"])
        if cap != pm.capacity:
            # re-derive headroom'd layout: same block assignment, wider blocks
            base = -(-pm.n_keys // pm.n_nodes)
            if cap % base:
                raise ValueError(f"capacity {cap} not a multiple of base {base}")
            pm = PlacementMap(pm.n_keys, pm.n_nodes, headroom=cap // base)
        return pm

    def validate(self) -> None:
        """Full invariant check."""
        if np.unique(self.slot).size != self.n_keys:
            raise PlacementError("slot map is not injective")
        if (self.slot < 0).any() or (self.slot >= self.n_slots).any():
            raise PlacementError("slot out of store range")
        if ((self.owner < 0) | (self.owner >= self.n_nodes)).any():
            raise PlacementError("owner out of node range")
        if (self.slot // self.capacity != self.owner).any():
            raise PlacementError("slot block does not match owner")


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def validate_routing(n_slots: int, n_nodes: int, placement,
                     op_key=None) -> None:
    """Assert the owner/slot tables (numpy arrays or tensors) route every
    key, or every key of ``op_key``, into its owner's physical block:
    ``slot // (n_slots / n_nodes)`` must equal ``owner``, and the slots
    must be in range and distinct."""
    if placement is None:
        return
    owner = _host(placement.owner)
    slot = _host(placement.slot)
    if n_slots % n_nodes:
        raise PlacementError(f"n_slots {n_slots} not divisible by {n_nodes}")
    n_local = n_slots // n_nodes
    if op_key is None:
        keys = np.arange(owner.shape[0])
    else:
        keys = np.unique(_host(op_key).reshape(-1))
        keys = keys[(keys >= 0) & (keys < owner.shape[0])]
    s, o = slot[keys], owner[keys]
    if (s < 0).any() or (s >= n_slots).any():
        bad = keys[(s < 0) | (s >= n_slots)]
        raise PlacementError(f"slots out of range for keys {bad[:8].tolist()}")
    mis = s // n_local != o
    if mis.any():
        bad = keys[mis]
        raise PlacementError(
            f"mis-routed keys {bad[:8].tolist()}: slot block "
            f"{(s[mis] // n_local)[:8].tolist()} != owner {o[mis][:8].tolist()}")
    if np.unique(s).size != s.size:
        raise PlacementError("duplicate physical slots across touched keys")


def logical_store(store: MVStore, placement: Optional[PlacementMap]
                  ) -> MVStore:
    """A placed store in LOGICAL key order — row ``k`` is logical key
    ``k``'s ring — gathered into new tensors on the store's device; used by
    ``verify()`` and the final-state differentials.  ``placement=None`` is
    the identity layout (the store itself)."""
    if placement is None:
        return store
    perm = placement.device_arrays(store.device).slot.long()
    return MVStore(*(t[perm] for t in store))


def physical_store(store: MVStore, placement: PlacementMap) -> MVStore:
    """Inverse of :func:`logical_store`: lay a logical store (row ``k`` =
    key ``k``) out in SLOT order on the store's device — key ``k``'s ring
    lands at physical row ``slot[k]``, every unmapped (free/headroom) row is
    EMPTY (``tid == NO_TID``: answers no read, ready to receive a
    move-in)."""
    if store.n_keys != placement.n_keys:
        raise ValueError(f"store has {store.n_keys} rows, placement "
                         f"maps {placement.n_keys} keys")
    perm = placement.device_arrays(store.device).slot.long()
    out = []
    for name, a in zip(MVStore._fields, store):
        fill = NO_TID if name == "tid" else 0      # NO_TID marks rows empty
        e = torch.full((placement.n_slots,) + tuple(a.shape[1:]), fill,
                       dtype=a.dtype, device=a.device)
        e[perm] = a
        out.append(e)
    return MVStore(*out)
