"""Crash recovery: snapshot restore + WAL replay (port of
``repro.durability.recovery``).

``recover()`` rebuilds a durable service directory into the exact state of
an uninterrupted run over the retired prefix:

1. restore the latest committed snapshot (or start from the bootstrap
   store) — version rings, SID state, clock, wave index, GC clock, TID
   counter;
2. replay every WAL block with ``seq >= snapshot.wal_seq`` through the
   port's ``engine.run_block`` (``dist_engine.run_block_dist`` onto a node
   mesh) with the logged wave-index origin and
   dispatch-time watermark, on the kernels of the route asked for (on
   ``cuda`` one ``commit_loop`` launch a replayed wave; a kernel that
   cannot build or launch raises, nothing falls back to the plain loop);
3. cross-check each replayed wave's (status, s, c) against the outcomes
   logged at retirement — replay is deterministic, so any divergence means
   corruption or a config mismatch and raises ``RecoveryError`` instead of
   silently serving a forked history.

The log and the snapshots are the reference's formats, and the kernel
backend is not a replay field, so a directory written by the JAX
``TxnService`` recovers here bit for bit, and the reverse
(``tests/test_torch_recovery.py``).  External GC pins are *not* durable: a
pinned reader that matters across restarts re-pins after recovery.

``DurabilityManager`` is the service-side hook: ``TxnService(...,
durability=mgr)`` attaches it — an existing log auto-recovers into the
fresh service (store, clock, wave index, GC clock, TID counter, history),
an empty directory gets a CONFIG head record; thereafter every retired
block is appended durable-before-ack and snapshots are taken at
pipeline-empty retire boundaries every ``snapshot_every`` blocks.

Under an elastic placement the CONFIG record names the initial layout
(``PlacementMap.to_config``) and the store's row count, each live range
move is a ``REC_MOVE`` record in the blocks' seq space, and snapshots hold
the rings in physical slot order: ``recover`` rebuilds the map, replays
moves and blocks in log order and returns the map beside the store.

``mesh=`` (a ``core.dist_engine.NodeMesh``) recovers onto the mesh: the
restored store is sharded over its nodes and the blocks and moves replay
through ``run_block_dist`` and ``apply_move_mesh``.  The substrate is a
free choice: a log served on a mesh recovers bit for bit onto one device,
and the reverse.  A service on a mesh recovers onto its own mesh; after a
``drop_node`` fault a fresh mesh of the same arity takes it up.

``mesh=`` may be a ``ProcessMesh`` (one ``torch.distributed`` rank a
node): every rank scans the one WAL and loads the one snapshot of the
directory, keeps only its own block of the restored store, and replays
the blocks and moves with the others (``step_block_dist``,
``apply_move_process``).  The directory must be readable by every rank:
the ranks of one host share it (ranks on several hosts are not served).
Its ``DurabilityManager`` writes from rank 0 alone: the WAL frames and the
snapshots are the bytes one device would write, the snapshot saved from
the store gathered onto rank 0 (``gather_store_root``); the other ranks
keep the log's counters in step without writing, and no rank acknowledges
a block before rank 0 has logged it (one host-group collective a record).
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.dist_engine import (ProcessMesh, check_mesh,
                                          gather_store_root, global_rows,
                                          mesh_device, shard_store,
                                          step_block_dist)
from repro_torch.core.engine import Wave, WaveOut, step_block
from repro_torch.core.store import MVStore, make_store, store_from_numpy
from repro_torch.kernels import resolve, resolve_device
from repro_torch.placement import (PlacementMap, apply_move, move_payload,
                                   physical_store, record_from_payload)

from . import wal
from .snapshot import SnapshotStore

_WAL_NAME = "wal.log"
_FORMAT = 1
# config fields that must match for replay to be meaningful; T is absent on
# purpose (the adaptive sizer already varies it block to block), and so is
# the kernel backend: every backend replays bit-identically
_REPLAY_FIELDS = ("sched", "n_nodes", "n_keys", "n_versions", "O",
                  "gc_block", "n_slots", "placement")


class RecoveryError(RuntimeError):
    """Replay diverged from the logged outcomes (corruption or config
    drift) — recovery refuses to serve a forked history."""


@dataclasses.dataclass
class RecoveredState:
    """Everything a service needs to resume exactly after the retired
    prefix."""
    store: MVStore               # on the device recovery ran on, in
                                 # physical slot order under a placement
    clock: int
    wave_idx: int                # last executed wave index
    gc_clock: int                # watermark tracker clock (= recovered wm)
    next_tid: int
    evicted_visible: int
    history: List[Tuple[np.ndarray, WaveOut]]   # per-wave, service format
    # when a snapshot was used the history is a SUFFIX; this is the
    # snapshot's numpy store (field -> array) whose version rings seed the
    # verifiers' pre-boundary version lists (core/verify.py); None under
    # full replay (history is complete)
    base_store: Optional[Dict[str, np.ndarray]]
    n_blocks: int                # durable blocks total
    n_replayed: int              # blocks replayed (rest came from snapshot)
    snapshot_seq: Optional[int]  # snapshot id used, or None
    torn_bytes: int              # damaged tail bytes the scan absorbed
    config: Dict[str, Any]
    placement_map: Optional[PlacementMap] = None  # the map after the prefix
    n_records: int = 0           # durable records total (next WAL seq —
                                 # blocks AND moves share one seq space)
    folded_requests: int = 0     # member requests that rode folded RMW rows
                                 # in the replayed suffix
    # host seconds of the three steps: "scan", "snapshot", "replay" (the
    # replay's last outcome copy waits for the device)
    seconds: Dict[str, float] = dataclasses.field(default_factory=dict)


def wal_path(directory: str) -> str:
    return os.path.join(directory, _WAL_NAME)


def service_config(svc) -> Dict[str, Any]:
    """The replay-relevant configuration of a ``TxnService`` — the WAL's
    head record, written once and checked on every reattach.  Field for
    field the reference's; ``backend`` is the port's route name."""
    hs = svc.host_skew
    pm = getattr(svc, "placement", None)
    return {
        "format": _FORMAT, "sched": svc.sched, "n_nodes": svc.n_nodes,
        "n_keys": svc.n_keys, "n_versions": svc.store.n_versions,
        "T": svc.T, "O": svc.O, "gc_block": svc.gc.block,
        "host_skew": None if hs is None else np.asarray(hs, np.int32),
        "backend": svc.kernels.backend,
        # the INITIAL layout's identity; moves replay from explicit
        # REC_MOVE records on top of it
        "n_slots": global_rows(svc.store, svc.mesh),
        "placement": None if pm is None else pm.to_config(),
    }


def check_config(logged: Dict[str, Any], current: Dict[str, Any]) -> None:
    """Reject a reattach whose service would replay under different rules."""
    logged = dict(logged)            # logs from before the elastic plane
    logged.setdefault("n_slots", logged.get("n_keys"))
    logged.setdefault("placement", None)
    for f in _REPLAY_FIELDS:
        if logged.get(f) != current.get(f):
            raise wal.WalError(
                f"durable log was written by a different service config: "
                f"{f}={logged.get(f)!r} logged vs {current.get(f)!r} now")
    a, b = logged.get("host_skew"), current.get("host_skew")
    if (a is None) != (b is None) or \
            (a is not None and not np.array_equal(a, b)):
        raise wal.WalError(
            f"durable log was written under host_skew={a!r}, "
            f"service now has {b!r}")


def _block_record(seq: int, stacked, wave_idx0: int, wm: Optional[int],
                  outs_np: WaveOut, clock: int, gc_clock: int,
                  fold: Optional[np.ndarray] = None) -> Dict:
    """One retired block as a WAL payload: the full ``run_block`` input
    (replay) + the outcome digest (determinism cross-check) + the GC
    watermark after retirement (monotonicity audit).  ``stacked`` and
    ``outs_np`` hold host arrays; every field is numpy int32, an int or
    ``None``.  ``fold`` ([B, T] request multiplicities) is accounting
    only: the folded row IS the executed input."""
    rec = {
        "seq": seq, "wave_idx0": int(wave_idx0),
        "wm": None if wm is None else int(wm),
        "op_kind": np.asarray(stacked.op_kind, np.int32),
        "op_key": np.asarray(stacked.op_key, np.int32),
        "op_val": np.asarray(stacked.op_val, np.int32),
        "host": np.asarray(stacked.host, np.int32),
        "tid": np.asarray(stacked.tid, np.int32),
        "status": np.asarray(outs_np.status, np.int32),
        "s": np.asarray(outs_np.s, np.int32),
        "c": np.asarray(outs_np.c, np.int32),
        "clock": int(clock), "gc_clock": int(gc_clock),
    }
    if fold is not None:
        rec["fold"] = np.asarray(fold, np.int32)
    return rec


def _replay_block(store, rec: Dict, cfg: Dict, clock, kernels,
                  placement=None, mesh=None):
    """Re-execute one logged block on the chosen substrate; returns
    (store, outs_np, clock')."""
    stacked = Wave(op_kind=rec["op_kind"], op_key=rec["op_key"],
                   op_val=rec["op_val"], host=rec["host"], tid=rec["tid"])
    kw = dict(sched=cfg["sched"], n_nodes=cfg["n_nodes"],
              host_skew=cfg["host_skew"], watermark=rec["wm"],
              gc_block=cfg["gc_block"], kernels=kernels, placement=placement)
    if mesh is None:
        return step_block(store, stacked, rec["wave_idx0"], clock, **kw)
    return step_block_dist(store, stacked, rec["wave_idx0"], clock, mesh,
                           **kw)


def recover(directory: str, mesh=None, kernels=None,
            verify_outcomes: bool = True, use_snapshot: bool = True,
            snaps: Optional[SnapshotStore] = None, device=None
            ) -> Optional[RecoveredState]:
    """Rebuild the durable state of ``directory``; ``None`` when it holds
    no log.  The recovered store lives on ``device`` (``None``: the CUDA
    device; with a ``mesh``, sharded over it on its device) and the blocks
    replay through ``kernels`` resolved against it; every choice gives the
    same bits.  ``use_snapshot=False`` forces a full-WAL replay (the
    differential path).  On a ``ProcessMesh`` every rank calls it (the
    replay merges through collectives) and the returned store is the
    rank's block; the whole store is laid out in host memory first."""
    dev = (resolve_device(device) if check_mesh(mesh) is None
           else mesh_device(mesh, device))
    # a rank of a process mesh keeps only its block: the whole store is
    # restored on the host and the block alone goes to the device
    home = torch.device("cpu") if isinstance(mesh, ProcessMesh) else dev
    kernels = resolve(kernels, dev)
    t0 = time.perf_counter()
    scan = wal.scan(wal_path(directory))
    if scan.config is None:
        return None
    cfg = scan.config
    n_keys, n_versions = cfg["n_keys"], cfg["n_versions"]
    n_slots = cfg.get("n_slots") or n_keys
    pm = None
    if cfg.get("placement") is not None:
        pm = PlacementMap.from_config(cfg["placement"])
    t1 = time.perf_counter()

    snap = None
    if use_snapshot:
        if snaps is None:
            snaps = SnapshotStore(directory, n_slots, n_versions)
        snap = snaps.restore_latest()
    if snap is not None and snap.wal_seq > len(scan.records):
        # a snapshot may only lag the durable log (the writer syncs before
        # every save); running ahead of it means the directory was tampered
        raise RecoveryError(
            f"snapshot claims wal_seq={snap.wal_seq} but only "
            f"{len(scan.records)} durable record(s) exist")

    if snap is None:
        store = make_store(n_keys, n_versions, device=home)
        if pm is not None:
            store = physical_store(store, pm)
        clock = 1
        wave_idx, gc_clock, next_tid, start = 0, 0, 1, 0
    else:
        store = store_from_numpy(snap.store, home)
        clock = snap.clock
        wave_idx, gc_clock = snap.wave_idx, snap.gc_clock
        next_tid, start = snap.next_tid, snap.wal_seq
        if pm is not None:
            # fold pre-snapshot moves into the map ONLY: the snapshot's
            # store already holds the rings at their moved slots
            for rt, rec in scan.records[:start]:
                if rt == wal.REC_MOVE:
                    pm.apply_record(record_from_payload(rec))
    if mesh is not None:
        store = shard_store(store, mesh)
    # the snapshot's rings are in PHYSICAL slot order and the verifiers
    # speak logical keys: keep the snapshot-time permutation before the
    # suffix's moves change the map
    snap_perm = None if pm is None else pm.slot.copy()
    t2 = time.perf_counter()

    history: List[Tuple[np.ndarray, WaveOut]] = []
    evicted = 0
    n_replayed = 0
    folded = 0
    for rt, rec in scan.records[start:]:
        if rt == wal.REC_MOVE:
            mrec = record_from_payload(rec)
            store = apply_move(store, mrec, mesh=mesh)
            pm.apply_record(mrec)
            continue
        store, outs, clock = _replay_block(
            store, rec, cfg, clock, kernels,
            placement=None if pm is None else pm.device_arrays(dev),
            mesh=mesh)
        n_replayed += 1
        if verify_outcomes:
            for name in ("status", "s", "c"):
                if not np.array_equal(getattr(outs, name), rec[name]):
                    raise RecoveryError(
                        f"replay of block seq={rec['seq']} diverged from "
                        f"the logged outcomes on '{name}' — refusing to "
                        f"serve a forked history")
        B = rec["op_kind"].shape[0]
        for j in range(B):
            history.append((rec["tid"][j], WaveOut(*(f[j] for f in outs))))
        evicted += int(outs.evicted_visible.sum())
        wave_idx = rec["wave_idx0"] + B - 1
        gc_clock = rec["gc_clock"]
        next_tid = max(next_tid, int(rec["tid"].max()) + 1)
        if rec.get("fold") is not None:
            # members beyond the leader per row (rows with multiplicity 0
            # are NOP padding, clip keeps them out of the count)
            folded += int(np.clip(rec["fold"] - 1, 0, None).sum())
    clock = int(clock)
    t3 = time.perf_counter()

    base_store = None if snap is None else snap.store
    if base_store is not None and snap_perm is not None:
        base_store = {f: np.asarray(a)[snap_perm]
                      for f, a in snap.store.items()}
    return RecoveredState(
        store=store, clock=clock, wave_idx=wave_idx,
        gc_clock=gc_clock, next_tid=next_tid, evicted_visible=evicted,
        history=history,
        base_store=base_store,
        n_blocks=len(scan.blocks),
        n_replayed=n_replayed,
        snapshot_seq=None if snap is None else snap.snap_id,
        torn_bytes=scan.torn_bytes, config=cfg,
        placement_map=pm, n_records=len(scan.records),
        folded_requests=folded,
        seconds={"scan": t1 - t0, "snapshot": t2 - t1, "replay": t3 - t2})


class DurabilityManager:
    """WAL + snapshot lifecycle for one ``TxnService``.

    Knobs: ``fsync_every`` — group-commit batch (1 = durable before every
    ack); ``snapshot_every`` — snapshot cadence in retired blocks taken at
    pipeline-empty boundaries (``None`` disables snapshots: recovery
    replays the whole WAL); ``keep_snapshots`` — retained snapshot count.

    Attached to a service on a ``ProcessMesh`` every rank holds a manager
    on the same directory, and rank 0 alone writes: the WAL frames, and the
    snapshots of the store gathered onto it.  After each record the ranks
    make one collective over the mesh's host group, in which rank 0 tells
    the others its record count, its fsync barrier and its unsynced
    records: no rank acknowledges a block before rank 0 has logged it, and
    every rank keeps ``seq``, the snapshot cadence and the crash counters
    in step.
    """

    def __init__(self, directory: str, fsync_every: int = 1,
                 snapshot_every: Optional[int] = None,
                 keep_snapshots: int = 2):
        self.dir = directory
        self.wal_path = wal_path(directory)
        self.fsync_every = fsync_every
        self.snapshot_every = snapshot_every
        self.keep_snapshots = keep_snapshots
        self.writer: Optional[wal.WalWriter] = None
        self.snaps: Optional[SnapshotStore] = None
        self.seq = 0                      # next block sequence number
        self._since_snap = 0
        self.last_recovery: Optional[RecoveredState] = None
        self.snapshots_taken = 0
        self.crash_synced_bytes = 0   # fsync barrier at the last crash()
        self.pmesh: Optional[ProcessMesh] = None   # set by attach
        # rank 0's (fsync barrier bytes, unsynced records) as of the last
        # record, on every rank of a process mesh
        self._writer_state = (0, 0)

    @property
    def writes(self) -> bool:
        """Whether this manager writes the directory: always on one device
        or a ``NodeMesh``, on rank 0 alone of a ``ProcessMesh``."""
        return self.pmesh is None or self.pmesh.rank == 0

    def _in_step(self) -> None:
        """On a process mesh, the ranks' one collective after a record:
        rank 0 broadcasts its record count, fsync barrier and unsynced
        records over the host group; every rank checks the count against
        its own and keeps the other two for ``crash``.  A no-op
        elsewhere."""
        if self.pmesh is None:
            return
        w = self.writer
        state = torch.tensor([self.seq, w.synced_bytes, w.unsynced_records]
                             if w is not None else [0, 0, 0],
                             dtype=torch.int64)
        group = self.pmesh.host_group
        dist.broadcast(state, src=dist.get_process_group_ranks(group)[0],
                       group=group)
        seq, synced, unsynced = (int(x) for x in state)
        if seq != self.seq:
            raise wal.WalError(f"rank {self.pmesh.rank} is at record "
                               f"{self.seq}, rank 0 at {seq}: the ranks' "
                               f"services diverged")
        self._writer_state = (synced, unsynced)

    # ------------------------------------------------------------- attach
    def attach(self, svc) -> None:
        """Bind to a service: recover an existing log into it (on the
        service's device and kernels), or write the CONFIG head record of
        a fresh one.  Called last by ``TxnService.__init__`` — after this,
        the service's store, clock, wave index, GC clock, TID counter and
        history are the durable prefix's.  On a ``ProcessMesh`` every rank
        attaches (a collective): each scans and recovers the directory,
        then rank 0 alone opens the writer, which truncates a torn tail,
        once every rank's scan is done."""
        if isinstance(svc.mesh, ProcessMesh):
            self.pmesh = svc.mesh
        os.makedirs(self.dir, exist_ok=True)
        cfg = service_config(svc)
        scan = wal.scan(self.wal_path)
        if self.snaps is None:
            # snapshots hold PHYSICAL rows: sized by n_slots (== n_keys
            # under the identity layout)
            self.snaps = SnapshotStore(self.dir,
                                       cfg.get("n_slots") or cfg["n_keys"],
                                       cfg["n_versions"],
                                       keep_latest=self.keep_snapshots)
        if scan.config is not None:
            check_config(scan.config, cfg)
            state = recover(self.dir, mesh=svc.mesh, kernels=svc.kernels,
                            snaps=self.snaps, device=svc.device)
            svc.store = state.store
            svc.clock = torch.full((), state.clock, dtype=torch.int32,
                                   device=svc.device)
            svc.wave_idx = state.wave_idx
            svc.gc.clock = state.gc_clock
            svc.gc.evicted_visible += state.evicted_visible
            svc.former.next_tid = state.next_tid
            svc.history = list(state.history)
            svc.base_store = state.base_store
            if state.placement_map is not None:
                # adopt the replayed map (same initial layout + all logged
                # moves) so routing resumes exactly where the crash left it
                svc.placement = state.placement_map
            self.seq = state.n_records
            self.last_recovery = state
        if self.pmesh is not None:
            # every rank has read the log before rank 0 truncates its tail
            dist.barrier(group=self.pmesh.host_group)
        if self.writes:
            self.writer = wal.WalWriter(self.wal_path, self.fsync_every,
                                        valid_bytes=scan.valid_bytes)
            if scan.config is None:
                self.writer.append(wal.REC_CONFIG, cfg)
                self.writer.sync()        # the head record is never batched
        self._in_step()

    # ---------------------------------------------------------------- log
    def log_block(self, stacked, wave_idx0: int, wm: Optional[int],
                  outs_np: WaveOut, clock: int, gc_clock: int,
                  fold: Optional[np.ndarray] = None) -> None:
        """Append one retired block — called after the outcome copy,
        BEFORE outcomes are routed (acked) to clients.  ``stacked`` holds
        the block's inputs as host arrays (``engine.staged_inputs`` of its
        ``StagedBlock``), ``outs_np`` its numpy outcomes.  ``fold`` carries
        the per-row request multiplicities of a folding former."""
        if self.writes:
            rec = _block_record(self.seq, stacked, wave_idx0, wm, outs_np,
                                clock, gc_clock, fold=fold)
            self.writer.append(wal.REC_BLOCK, rec)
        self.seq += 1
        self._since_snap += 1
        self._in_step()

    def log_move(self, rec, clock: int = 0) -> None:
        """Append one executed placement range move with its explicit slot
        arrays — replay applies the arrays verbatim and never re-runs the
        allocator.  Moves share the block seq space and are synced at once:
        a move is a placement commit point, and every block logged after it
        replays under the moved layout."""
        if self.writes:
            self.writer.append(wal.REC_MOVE,
                               move_payload(rec, self.seq, clock))
            self.writer.sync()
        self.seq += 1
        self._in_step()

    def maybe_snapshot(self, svc, pipeline_empty: bool) -> bool:
        """Snapshot when the cadence is due AND the device store is exactly
        the retired prefix (no block in flight, no open buffer) — the only
        point where snapshot + WAL-suffix replay equals full replay.  On a
        ``ProcessMesh`` the blocks are gathered onto rank 0, which saves
        them (every rank calls it)."""
        if (self.snapshot_every is None or not pipeline_empty
                or self._since_snap < self.snapshot_every):
            return False
        if self.writes:
            self.writer.sync()    # a snapshot may lag the log, never lead it
        store = (svc.store if self.pmesh is None
                 else gather_store_root(svc.store, self.pmesh))
        if self.writes:
            self.snaps.save(store, int(svc.clock), svc.wave_idx,
                            self.seq, svc.gc.clock, svc.former.next_tid)
        self.snapshots_taken += 1
        self._since_snap = 0
        self._in_step()
        return True

    # -------------------------------------------------------------- close
    def crash(self) -> int:
        """Simulated kill honoring fsync semantics: pending group-commit
        frames reach the OS unsynced (at risk of tearing), everything
        behind the last fsync barrier survives.  Records the barrier in
        ``crash_synced_bytes`` — pass it to
        ``FaultSchedule.mutilate_wal(path, synced_bytes=...)`` so injected
        tears respect it.  Returns the number of at-risk records.  A rank
        of a process mesh that does not write reports rank 0's barrier and
        at-risk records as of the last record."""
        if not self.writes:
            self.crash_synced_bytes, at_risk = self._writer_state
            return at_risk
        if self.writer is None:
            return 0
        self.crash_synced_bytes = self.writer.synced_bytes
        return self.writer.simulate_crash()

    def close(self) -> None:
        """Clean shutdown: flush + fsync everything."""
        if self.writer is not None:
            self.writer.close()
