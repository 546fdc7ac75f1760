"""Per-wave conflict graph from the formed ``[T, O]`` op arrays (a copy of
``repro.planner.graph``; DESIGN.md §10).

The wave former (and every replay generator) already holds each
transaction's full read/write set on the host *before* dispatch — the
``op_kind``/``op_key`` arrays are the declared footprint, not an estimate.
That makes the BOHM/DGCC move available to the wave engine: build the
intra-wave conflict graph up front and plan execution so conflicts never
meet inside one wave.

Edges (undirected in ``conflict``, directed views kept for the planner):

* WW — both transactions write some common key;
* RW — transaction *i* reads a key transaction *j* writes (the engine's
  anti-dependency ``potential[i, j]``, here over declared sets);
* WR — transaction *i* writes a key transaction *j* reads (``rw.T``).

READ contributes to the read side, WRITE to the write side, RMW to both.
NOP slots (padding, deduped duplicate keys) touch nothing: the masks route
them to distinct sentinels that can never collide with a real key (or with
each other), so an all-NOP padding row is an isolated vertex.

Two constructions, same output:

* ``dense`` — one broadcast compare over ``[T, T, O, O]``; this is the
  vectorized-numpy path and the default for service-sized waves (T ≤ a few
  hundred, O ≤ 16 ⇒ the intermediate is a few MB of bool);
* ``grouped`` — sort ops by key and emit cliques per contended key; memory
  is O(T² + total ops) regardless of O, used automatically when the dense
  intermediate would exceed ``_DENSE_LIMIT`` elements.

Both are pure host-side numpy on the formed arrays — nothing here touches
the device.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from repro_torch.core.commit_phase import NOP, READ, RMW, WRITE

# largest [T, T, O, O] bool intermediate the dense path may allocate (64 MB)
_DENSE_LIMIT = 1 << 26

# sentinel for masked (non-reading) op slots; real keys are >= 0.  Masked
# *write* slots get a unique negative sentinel per (txn, slot) instead —
# the WW compare puts write keys on both sides, so a shared sentinel would
# match itself across transactions and fabricate conflicts
_NO_READ = -1


class ConflictGraph(NamedTuple):
    """Boolean [T, T] adjacency views of one wave's conflicts.

    ``rw[i, j]`` — i reads a key j writes (anti-dependency, the declared
    twin of the engine's ``potential``); ``ww[i, j]`` — i and j write a
    common key (symmetric); ``conflict`` — any of WW/WR/RW, symmetric,
    diagonal clear.  ``active[t]`` — row t has at least one non-NOP op."""
    rw: np.ndarray
    ww: np.ndarray
    conflict: np.ndarray
    active: np.ndarray

    @property
    def wr(self) -> np.ndarray:
        """``wr[i, j]`` — i writes a key j reads (= ``rw.T``)."""
        return self.rw.T


def op_masks(op_kind: np.ndarray):
    """(reads, writes) boolean masks over ``[T, O]`` op slots: READ and RMW
    read; WRITE and RMW write; NOP does neither."""
    op_kind = np.asarray(op_kind)
    is_read = (op_kind == READ) | (op_kind == RMW)
    is_write = (op_kind == WRITE) | (op_kind == RMW)
    return is_read, is_write


def _edges_dense(rk: np.ndarray, wk: np.ndarray):
    """One broadcast compare: rw[i, j] = any read key of i equals any write
    key of j; ww likewise over write keys.  Sentinels never match."""
    rw = (rk[:, None, :, None] == wk[None, :, None, :]).any(axis=(2, 3))
    ww = (wk[:, None, :, None] == wk[None, :, None, :]).any(axis=(2, 3))
    return rw, ww


def _edges_grouped(rk: np.ndarray, wk: np.ndarray):
    """Key-grouped construction: for every key touched by >1 transaction,
    mark reader×writer and writer×writer pairs.  The python loop runs only
    over *contended* keys (hot keys under zipf, hash collisions under
    uniform), each iteration vectorized via ``np.ix_``."""
    T = rk.shape[0]
    rw = np.zeros((T, T), bool)
    ww = np.zeros((T, T), bool)
    tt = np.broadcast_to(np.arange(T)[:, None], rk.shape)
    r_mask, w_mask = rk >= 0, wk >= 0
    keys = np.concatenate([rk[r_mask], wk[w_mask]])
    txns = np.concatenate([tt[r_mask], tt[w_mask]])
    is_w = np.concatenate([np.zeros(r_mask.sum(), bool),
                           np.ones(w_mask.sum(), bool)])
    order = np.argsort(keys, kind="stable")
    keys, txns, is_w = keys[order], txns[order], is_w[order]
    bounds = np.flatnonzero(np.diff(keys)) + 1
    for lo, hi in zip(np.r_[0, bounds], np.r_[bounds, len(keys)]):
        if hi - lo < 2:
            continue
        writers = np.unique(txns[lo:hi][is_w[lo:hi]])
        if not len(writers):
            continue
        readers = np.unique(txns[lo:hi][~is_w[lo:hi]])
        ww[np.ix_(writers, writers)] = True
        if len(readers):
            rw[np.ix_(readers, writers)] = True
    return rw, ww


def conflict_graph(op_kind: np.ndarray, op_key: np.ndarray,
                   method: str = "auto") -> ConflictGraph:
    """Build the wave's conflict graph from its declared op arrays.

    ``method``: ``"dense"`` (vectorized broadcast), ``"grouped"`` (sorted
    key groups, O-independent memory), or ``"auto"`` (dense unless the
    intermediate would exceed ~64 MB).  Both produce identical graphs
    (property-tested in tests/test_planner.py)."""
    op_kind = np.asarray(op_kind)
    op_key = np.asarray(op_key)
    if op_kind.ndim != 2 or op_kind.shape != op_key.shape:
        raise ValueError(f"need matching [T, O] arrays, got "
                         f"{op_kind.shape} / {op_key.shape}")
    T, O = op_kind.shape
    is_read, is_write = op_masks(op_kind)
    rk = np.where(is_read, op_key, _NO_READ)
    no_write = -(2 + np.arange(T * O, dtype=np.int64).reshape(T, O))
    wk = np.where(is_write, op_key, no_write)
    if method == "auto":
        method = "dense" if T * T * O * O <= _DENSE_LIMIT else "grouped"
    if method == "dense":
        rw, ww = _edges_dense(rk, wk)
    elif method == "grouped":
        rw, ww = _edges_grouped(rk, wk)
    else:
        raise ValueError(f"unknown method {method!r}")
    eye = np.eye(T, dtype=bool)
    rw &= ~eye          # a txn reading its own write key is not a conflict
    ww &= ~eye
    conflict = rw | rw.T | ww
    return ConflictGraph(rw=rw, ww=ww, conflict=conflict,
                         active=(op_kind != NOP).any(axis=1))


def footprint_nodes(op_kind: np.ndarray, op_key: np.ndarray,
                    owner: np.ndarray, n_nodes: int) -> np.ndarray:
    """Placement-aware node footprint of a wave: boolean ``[T, n_nodes]``
    where ``[t, n]`` means transaction ``t`` touches at least one key whose
    ring physically lives on node ``n`` under the given placement
    (``owner`` = ``PlacementMap.owner``, or any ``[n_keys]`` node vector).

    This is the planner/balancer's locality view: lanes whose union
    footprint stays on one node are candidates for node-local dispatch, and
    ``cross_node_frac`` below is the honest "how much of this wave is
    visitor traffic under the CURRENT placement" measure the bench reports
    next to the engine's logical ``msgs_cross``."""
    op_kind = np.asarray(op_kind)
    op_key = np.asarray(op_key)
    owner = np.asarray(owner)
    T = op_kind.shape[0]
    out = np.zeros((T, n_nodes), bool)
    active = op_kind != NOP
    valid = active & (op_key >= 0) & (op_key < owner.shape[0])
    t_idx, o_idx = np.nonzero(valid)
    out[t_idx, owner[op_key[t_idx, o_idx]]] = True
    return out


def cross_node_frac(op_kind: np.ndarray, op_key: np.ndarray,
                    owner: np.ndarray, n_nodes: int) -> float:
    """Fraction of active transactions whose footprint spans > 1 physical
    node under the given placement."""
    fp = footprint_nodes(op_kind, op_key, owner, n_nodes)
    spans = fp.sum(axis=1)
    active = spans > 0
    if not active.any():
        return 0.0
    return float((spans[active] > 1).mean())
