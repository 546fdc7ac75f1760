"""Multi-version KV store as dense PyTorch tensors (port of
``repro.core.store``).

Each key owns a ring buffer of ``V`` versions carrying the paper's
per-version metadata: creator TID, CID (creator's commit time) and SID (max
start time of committed readers).  Keys are partitioned across ``n_nodes``
shared-nothing nodes by ``key % n_nodes``.

Unlike the JAX store, which is immutable, the port updates a store IN
PLACE (``install_version``, ``bump_sid`` and the engine's installs): a copy
of a million-key store per install would cost more than the install.
Callers that reuse a store clone it first
(``MVStore(*(t.clone() for t in store))``).

``store_from_numpy``/``store_to_numpy`` and ``wave_from_numpy``/
``wave_to_numpy`` carry state across from and to the JAX package as numpy
arrays, so both can run on identical state.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels import resolve_device

INF = 2 ** 30
NO_TID = -1


class MVStore(NamedTuple):
    """Columnar version store.  All tensors live on one device."""
    val: torch.Tensor     # [n_keys, V] int32 payloads
    tid: torch.Tensor     # [n_keys, V] int32 creator TID (NO_TID = empty)
    cid: torch.Tensor     # [n_keys, V] int32 commit time of creator
    sid: torch.Tensor     # [n_keys, V] int32 max start time of readers
    head: torch.Tensor    # [n_keys]    int32 ring index of newest version
    wave: torch.Tensor    # [n_keys]    int32 wave index of last commit

    @property
    def n_keys(self) -> int:
        return self.val.shape[0]

    @property
    def n_versions(self) -> int:
        return self.val.shape[1]

    @property
    def device(self) -> torch.device:
        return self.val.device


def make_store(n_keys: int, n_versions: int = 4, init_val: int = 0,
               device=None) -> MVStore:
    """Fresh store: every key has one initial version by bootstrap txn t0
    (tid 0, cid 0).  ``device=None`` is the CUDA device."""
    dev = resolve_device(device)
    i32 = dict(dtype=torch.int32, device=dev)
    val = torch.full((n_keys, n_versions), init_val, **i32)
    tid = torch.full((n_keys, n_versions), NO_TID, **i32)
    tid[:, 0] = 0
    cid = torch.zeros((n_keys, n_versions), **i32)
    sid = torch.zeros((n_keys, n_versions), **i32)
    head = torch.zeros((n_keys,), **i32)
    wave = torch.zeros((n_keys,), **i32)
    return MVStore(val, tid, cid, sid, head, wave)


def store_from_numpy(fields, device=None) -> MVStore:
    """An ``MVStore`` from numpy leaves: a JAX ``MVStore``, any object with
    the six field attributes, a dict, or a sequence in field order."""
    dev = resolve_device(device)
    if isinstance(fields, dict):
        leaves = [fields[f] for f in MVStore._fields]
    elif all(hasattr(fields, f) for f in MVStore._fields):
        leaves = [getattr(fields, f) for f in MVStore._fields]
    else:
        leaves = list(fields)
    return MVStore(*(torch.as_tensor(np.array(a, np.int32), device=dev)
                     for a in leaves))


def store_to_numpy(store: MVStore) -> dict:
    """The six store fields as int32 numpy arrays, by name."""
    return {f: t.detach().cpu().numpy() for f, t in zip(MVStore._fields,
                                                         store)}


def node_of_key(key, n_nodes):
    return key % n_nodes


class PlacementArrays(NamedTuple):
    """Placement tables for key routing: a logical key ``k`` lives at store
    row ``slot[k]`` on node ``owner[k]``.  ``None`` placement means the
    identity layout (``slot[k] == k``)."""
    owner: torch.Tensor   # [n_keys] int32 owning node of each logical key
    slot: torch.Tensor    # [n_keys] int32 store row of each logical key


def as_placement_arrays(p, device=None) -> PlacementArrays | None:
    """Normalize ``None | PlacementArrays | (owner, slot)`` to int32
    tensors on ``device``."""
    if p is None:
        return None
    owner, slot = p
    dev = resolve_device(device)
    return PlacementArrays(torch.as_tensor(owner, dtype=torch.int32,
                                           device=dev),
                           torch.as_tensor(slot, dtype=torch.int32,
                                           device=dev))


def read_visible(store: MVStore, keys, max_cid):
    """Latest visible version per key: newest version with CID <= max_cid
    (the paper's §IV-B read rule).  keys: [...] int32 (must be in range);
    max_cid broadcastable to keys.  Returns (val, tid, cid, sid, slot)."""
    k = keys.long()
    cids = store.cid[k]
    tids = store.tid[k]
    mc = torch.broadcast_to(torch.as_tensor(max_cid, dtype=torch.int32,
                                            device=store.device), keys.shape)
    ok = (tids != NO_TID) & (cids <= mc[..., None])
    masked = torch.where(ok, cids, -1)
    slot = masked.argmax(dim=-1)
    take = lambda a: torch.gather(a[k], -1, slot[..., None])[..., 0]
    return (take(store.val), take(store.tid), take(store.cid),
            take(store.sid), slot.to(torch.int32))


def read_newest(store: MVStore, keys):
    """Newest committed version (PostSI reads start with s_hi = +inf)."""
    return read_visible(store, keys, INF)


def evicting_visible(store: MVStore, keys, watermark):
    """GC watermark consult: would installing a new version of ``keys``
    evict a version still visible to a live snapshot?  The slot about to be
    reused (``head + 1``) holds the oldest version; it is still needed iff
    its superseder (the next slot) has ``CID > watermark``.  Empty slots
    never evict.  Negative/NOP keys are clamped (never wrap to the last
    key).  Returns a bool mask shaped like ``keys``."""
    k = keys.clamp(0, store.n_keys - 1).long()
    V = store.n_versions
    h_new = ((store.head[k] + 1) % V).long()
    evicted_live = store.tid[k, h_new] != NO_TID
    superseder_cid = store.cid[k, (h_new + 1) % V]
    return evicted_live & (superseder_cid > watermark)


def install_version(store: MVStore, key, value, tid, cid, wave_idx,
                    watermark=None):
    """Push one new version onto each key's ring, IN PLACE.  Returns
    ``(store, evicted_visible)`` where ``evicted_visible`` (int32 scalar)
    counts ring-slot reuses that destroyed a version still visible above
    ``watermark`` (0 when ``None``)."""
    dev = store.device
    key = torch.as_tensor(key, dtype=torch.int32, device=dev)
    wm = 0 if watermark is None else watermark
    evicted = evicting_visible(store, key, wm).sum().to(torch.int32)
    k = key.long()
    h = ((store.head[k] + 1) % store.n_versions).long()
    as_i32 = lambda x: torch.as_tensor(x, dtype=torch.int32, device=dev)
    store.val[k, h] = as_i32(value)
    store.tid[k, h] = as_i32(tid)
    store.cid[k, h] = as_i32(cid)
    store.sid[k, h] = 0
    store.head[k] = h.to(torch.int32)
    store.wave[k] = as_i32(wave_idx)
    return store, evicted


def bump_sid(store: MVStore, key, slot, start_time) -> MVStore:
    """Rule 4(c): raise SID of a read version to the reader's start time,
    IN PLACE."""
    k = torch.as_tensor(key, device=store.device).long()
    s = torch.as_tensor(slot, device=store.device).long()
    cur = store.sid[k, s]
    store.sid[k, s] = torch.maximum(
        cur, torch.as_tensor(start_time, dtype=torch.int32,
                             device=store.device))
    return store
