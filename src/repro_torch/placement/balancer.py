"""Load balancer: plans key-range splits off per-node commit/abort counters
(a numpy copy of ``repro.placement.balancer``).

Observes committed-op key traffic (host-side counters fed from retired
wave outcomes) and, when the max/mean per-node load imbalance crosses
``trigger``, plans moves that peel a load-targeted contiguous prefix of
the hottest node's hottest range onto the coldest node.  The split point
is a prefix-sum walk over per-key load — a *range split*, never a
scatter, so ownership stays contiguous and the PlacementMap's range
invariant holds.  Planning is deterministic given the counters, which the
differential tests rely on.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from .map import PlacementMap, runs


class LoadBalancer:
    def __init__(self, n_keys: int, n_nodes: int, *, every: int = 4,
                 trigger: float = 1.25, max_moves: int = 2,
                 decay: float = 0.5):
        self.n_keys = int(n_keys)
        self.n_nodes = int(n_nodes)
        self.every = int(every)         # plan each `every` observed blocks
        self.trigger = float(trigger)   # max/mean imbalance threshold
        self.max_moves = int(max_moves)
        self.decay = float(decay)       # EWMA so old hot spots cool off
        self.key_ops = np.zeros(self.n_keys, np.float64)
        self.node_commits = np.zeros(self.n_nodes, np.int64)
        self.node_aborts = np.zeros(self.n_nodes, np.int64)
        self.blocks_seen = 0
        self.moves_planned = 0

    # -- observation -------------------------------------------------------

    def observe(self, op_key: np.ndarray, active: np.ndarray,
                committed: np.ndarray, owner: np.ndarray) -> None:
        """Fold one retired wave's outcomes into the counters.

        op_key/active: [T, O]; committed: [T] bool; owner: [n_keys] int.
        Per-key traffic (``key_ops``, what ``plan`` splits on) counts every
        committed transaction's active ops; the per-node occupancy counters
        (``node_commits``/``node_aborts``) count each transaction ONCE,
        charged to the owner of its first active key — committed-TXN
        occupancy, the same statistic DESIGN §11 and the service's
        ``_observe_placement`` report (counting per op skews the balancer
        toward wide-footprint ranges).  Aborts feed the abort counter only
        (abort pressure is a hot-shard symptom too, but moving keys on
        abort noise thrashes).
        """
        op_key = np.asarray(op_key)
        active = np.asarray(active, bool)
        committed = np.asarray(committed, bool)
        mask = active & committed[:, None]
        keys = op_key[mask]
        keys = keys[(keys >= 0) & (keys < self.n_keys)]
        np.add.at(self.key_ops, keys, 1.0)
        T = op_key.shape[0]
        touched = active.any(axis=1)
        first = np.argmax(active, axis=1)
        fk = op_key[np.arange(T), first]
        in_range = (fk >= 0) & (fk < self.n_keys)
        np.add.at(self.node_commits,
                  owner[fk[committed & touched & in_range]], 1)
        np.add.at(self.node_aborts,
                  owner[fk[~committed & touched & in_range]], 1)

    def end_block(self) -> bool:
        """Advance the block counter; True when a planning round is due."""
        self.blocks_seen += 1
        due = self.blocks_seen % self.every == 0
        if due:
            self.key_ops *= self.decay      # cool old traffic pre-plan
        return due

    # -- planning ----------------------------------------------------------

    def node_load(self, pm: PlacementMap) -> np.ndarray:
        load = np.zeros(self.n_nodes, np.float64)
        np.add.at(load, pm.owner, self.key_ops)
        return load

    def imbalance(self, pm: PlacementMap) -> float:
        load = self.node_load(pm)
        mean = load.mean()
        return float(load.max() / mean) if mean > 0 else 1.0

    def plan(self, pm: PlacementMap) -> List[Tuple[int, int, int]]:
        """Plan up to ``max_moves`` splits (lo, hi, dst).  Each step peels
        the prefix of the hottest node's hottest range whose load best
        approaches the surplus over the mean, onto the coldest node —
        capacity-clamped.  Works on a load copy so multi-move rounds see
        the effect of earlier moves in the same round."""
        load = self.node_load(pm)
        owner = pm.owner.copy()
        free = [pm.free_slots(n) for n in range(self.n_nodes)]
        moves: List[Tuple[int, int, int]] = []
        for _ in range(self.max_moves):
            mean = load.mean()
            if mean <= 0 or load.max() / mean < self.trigger:
                break
            hot = int(load.argmax())
            # coldest node WITH free slots: the globally coldest node being
            # full must not end the round while a cooler-than-hot node still
            # has headroom (the fullest-cluster case is exactly when hot
            # ranges most need to move)
            cold = next((int(n) for n in np.argsort(load, kind="stable")
                         if int(n) != hot and free[int(n)] > 0), None)
            if cold is None or load[cold] >= load[hot]:
                break
            split = self._split(owner, hot, cold, load, free[cold])
            if split is None:
                break
            lo, hi = split
            moved = float(self.key_ops[lo:hi].sum())
            owner[lo:hi] = cold
            load[hot] -= moved
            load[cold] += moved
            free[cold] -= hi - lo
            moves.append((lo, hi, cold))
        self.moves_planned += len(moves)
        return moves

    def _split(self, owner: np.ndarray, hot: int, cold: int,
               load: np.ndarray, cap: int) -> Optional[Tuple[int, int]]:
        """Choose [lo, hi) inside the hot node's hottest contiguous range:
        the prefix whose cumulative load is closest to half the hot-cold
        surplus (so one move meets the other halfway), >= 1 key, <= cap,
        and never the whole key set of the hot node (it must keep a key)."""
        ranges = [(lo, hi) for lo, hi in runs(owner) if owner[lo] == hot]
        if not ranges:
            return None
        r_lo, r_hi = max(ranges,
                         key=lambda r: float(self.key_ops[r[0]:r[1]].sum()))
        hot_keys = int((owner == hot).sum())
        width = min(r_hi - r_lo, cap, hot_keys - 1)
        if width < 1:
            return None
        prefix = np.cumsum(self.key_ops[r_lo:r_lo + width])
        target = (load[hot] - load[cold]) / 2.0
        if prefix[-1] <= 0:
            return None
        cut = int(np.argmin(np.abs(prefix - target))) + 1
        return r_lo, r_lo + cut

    def report(self) -> dict:
        return {"blocks_seen": self.blocks_seen,
                "moves_planned": self.moves_planned,
                "node_commits": self.node_commits.tolist(),
                "node_aborts": self.node_aborts.tolist()}
