"""Visibility-based version GC watermark (DESIGN.md §8; a copy of
``repro.service.gc``).

The paper removes the central timestamp authority; this module removes the
central garbage-collection authority the same way.  The reclamation
watermark is not handed down by a coordinator — it is the **decentralized
min over live readers' ``s_lo``**: a version superseded by a commit at or
below the watermark can never again be the visible version for any live or
future snapshot, so its ring slot may be reused.  (Proof sketch, mirrored by
``tests/test_gc_watermark.py`` against the sequential oracle: a reader that
would still need version ``v`` must take a snapshot ``s`` with
``s < CID(superseder) <= watermark <= s_lo <= s`` — contradiction; PostSI
rule 5 aborts it before it can read ``v``.)

In the wave engine every reader's snapshot is pinned at its wave boundary,
so between waves the min over live readers collapses to the engine clock at
the last boundary — that is the engine's default watermark
(``run_wave(watermark=None)``).  This tracker contributes the parts the
engine cannot see:

* **pins** — external long-lived readers (an s_hi-pinned retry per paper
  §IV-B, a backup/analytics scanner, a clock-skewed host whose snapshot
  lags by ``skew`` waves) register the lowest snapshot they may still take;
  the watermark is the min over all pins and never exceeds the clock.
* **accounting** — the per-wave ``evicted_visible`` counters stream in via
  ``observe`` so the service can report when V (the ring depth) is too
  small for the offered load, and ``block=True`` asks the engine to abort
  the offending writer instead of corrupting a still-visible version.
"""
from __future__ import annotations

import itertools
from typing import Dict, Optional


def seq_watermark(scheduler, pins=()) -> int:
    """The decentralized watermark over a ``repro.core.seq.SeqScheduler``:
    min over running transactions' ``s_lo`` and external ``pins``; with no
    live reader at all it rises to the newest commit time (every future
    reader then resolves to newest versions only).  Versions superseded at
    or below this value are reclaimable — ``tests/test_gc_watermark.py``
    checks that differentially against the oracle's actual reads."""
    lows = [t.s_lo for t in scheduler.txns.values() if t.status == "running"]
    lows += [int(p) for p in pins]
    if lows:
        return min(lows)
    return max((v.cid for chain in scheduler.versions.values()
                for v in chain), default=0)


class VisibilityGC:
    """Watermark tracker + eviction accounting for one service instance."""

    def __init__(self, block: bool = False, n_nodes: Optional[int] = None):
        self.block = block
        self.n_nodes = n_nodes            # mesh node-id bound for pins (opt.)
        self.clock = 0                    # engine clock after the last wave
        self.evicted_visible = 0          # cumulative watermark violations
        self.replica_reads = 0            # reads served at a replica floor
        self.replica_floor = 0            # lowest floor a replica served at
        self._pins: Dict[int, int] = {}   # handle -> pinned snapshot floor
        self._pin_node: Dict[int, int] = {}  # handle -> hosting mesh node
        self._handles = itertools.count(1)

    # ------------------------------------------------------------- pins
    def pin(self, snapshot_floor: int, node: int = 0) -> int:
        """Register a live reader whose snapshot may go as low as
        ``snapshot_floor``; returns a handle for ``release``.  ``node`` is
        the mesh node hosting the reader — on the sharded service the
        watermark is merged *from per-node floors* with a ``lax.pmin``
        collective (``dist_engine.mesh_watermark``), so each pin must name
        where its reader lives; single-device callers can ignore it."""
        if node < 0:
            raise ValueError(f"pin: node must be >= 0, got {node}")
        if self.n_nodes is not None and node >= self.n_nodes:
            # fail at the buggy call, not ticks later inside the serve loop
            raise ValueError(f"pin: node {node} out of range for the "
                             f"{self.n_nodes}-node mesh")
        h = next(self._handles)
        self._pins[h] = int(snapshot_floor)
        self._pin_node[h] = int(node)
        return h

    @property
    def pinned(self) -> bool:
        """True when any live pin exists (the watermark is then lower than
        the engine's own wave-boundary collapse may assume)."""
        return bool(self._pins)

    def release(self, handle: int) -> None:
        self._pins.pop(handle, None)
        self._pin_node.pop(handle, None)

    # -------------------------------------------------------- watermark
    def watermark(self) -> Optional[int]:
        """Current reclamation watermark, or ``None`` when no pins exist —
        the engine then uses its own boundary collapse (the wave-entry
        clock), which is the exact min over its live readers."""
        if not self._pins:
            return None
        return min(min(self._pins.values()), self.clock)

    def node_floors(self, n_nodes: int):
        """Per-node snapshot floors for the decentralized mesh merge: node
        ``k``'s entry is the min floor over its live pinned readers, or the
        engine clock when it hosts none (neutral in the min — the wave
        boundary is every unpinned reader's floor).  Their min
        (``dist_engine.mesh_watermark``) equals ``watermark()`` by
        construction."""
        floors = [self.clock] * n_nodes
        for h, f in self._pins.items():
            node = self._pin_node[h]
            if node >= n_nodes:
                raise ValueError(
                    f"pin handle {h} names node {node}, but the mesh has "
                    f"only {n_nodes} node(s)")
            floors[node] = min(floors[node], f)
        return floors

    # ------------------------------------------------------- accounting
    def observe(self, out_np, clock: int) -> None:
        """Fold one wave's outcome into the accounting state."""
        self.clock = int(clock)
        self.evicted_visible += int(out_np.evicted_visible)

    def observe_replica(self, floor: int, n_reads: int = 1) -> None:
        """Account reads served from a hot-key replica at visibility floor
        ``floor`` (DESIGN.md §11): the replica reader's snapshot equals the
        GC watermark, so it needs no pin — versions visible at the floor are
        frozen by the watermark invariant and can never be reclaimed out
        from under it.  Pure accounting; the watermark is unaffected."""
        self.replica_reads += int(n_reads)
        self.replica_floor = int(floor)

    def report(self) -> Dict[str, int]:
        return {
            "evicted_visible": self.evicted_visible,
            "pins": len(self._pins),
            "watermark": self.watermark() if self._pins else self.clock,
            "blocking": int(self.block),
            "replica_reads": self.replica_reads,
            "replica_floor": self.replica_floor,
        }
