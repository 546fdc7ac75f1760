"""Closed-loop transaction service over the wave engine (port of
``repro.service.service``).

    arrivals ──> WaveFormer ──> engine.step_wave ──> outcomes
                   ^  (admission, packing)   │
                   └── RetryPolicy (backoff) ┴──> committed / dropped

Each scheduler tick forms at most one ``[T, O]`` wave from due retries plus
fresh arrivals, executes it on the device through ``engine.step_wave`` (any
of the six schedulers) and routes per-transaction outcomes: commits record
end-to-end latency (admission tick -> commit tick); aborts re-enter through
the retry calendar with a fresh TID and exponential backoff until the retry
budget drops them.  ``VisibilityGC`` supplies the version-reclamation
watermark and accumulates the ``evicted_visible`` accounting.

The full history (aborted attempts included) is kept as ``(tids,
WaveOut)`` with numpy leaves, so ``verify()`` runs the verifiers of
``core.verify`` on served traffic.

Besides the step loop it serves the same stream through the pipelined
streaming plane (``run_streaming``: blocks of B waves, K blocks in flight,
``stream.StreamingDriver``) and, with ``planner=``, through the planner's
conflict-free lanes (``repro_torch.planner``: ``"planned"`` plans every
wave, ``"hybrid"`` switches on the trailing abort rate).

With ``durability=`` (a ``durability.DurabilityManager``) every retired
wave or block is logged to a write-ahead log before its outcomes are
acknowledged, snapshots are taken at pipeline-empty boundaries, and a
service started on an existing directory recovers it first (through its
own device and kernels); ``faults=`` (a ``runtime.FaultSchedule``) fires
injected crashes and delays at the dispatch, retire and post-log seams.

With ``placement=`` (a ``placement.PlacementMap``) the rings live at the
physical rows ``slot[key]`` of a store with headroom, every dispatch
translates keys through the map's cached device tables, ``move_range``
moves a key range live at a wave boundary (WAL-logged when durable), and
``balancer=True`` plans such moves from the committed traffic;
``replicas=`` (hot logical keys) answers read-only transactions over them
at submit time from host snapshots refreshed at the GC watermark every
``replica_refresh`` ticks.

``mesh=`` (a ``core.dist_engine.NodeMesh``) switches the data plane: the
store is sharded over the mesh's emulated nodes (``shard_store``) and every
wave or block runs through ``step_wave_dist`` / ``run_block_dist``, the
same commit loop over the ``MeshSubstrate``, with the GC watermark merged
from the per-node reader floors (``mesh_watermark``).  Outcomes are
bit-identical between the two data planes.

``mesh=`` may also be a ``core.dist_engine.ProcessMesh``: every rank runs
this same service loop on the same seeded arrivals, its store holds only
the rank's block, and the drivers' merges and the watermark's min are
collectives.  Everything above serves there as on one device: the step
loop, ``run_streaming``, the planner, durability (rank 0 writes the one
log, every rank recovers it), an elastic placement with its moves
(``apply_move_process``), the balancer (host-side, the same on every
rank) and replicas (refreshed through the mesh's merged read), and
``verify()`` (which gathers the store, so every rank calls it).
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Callable, Dict, Iterable, List, Optional

import numpy as np
import torch

from repro_torch.core.commit_phase import ABORTED, COMMITTED, NOP
from repro_torch.core.dist_engine import (ProcessMesh, check_mesh,
                                          gather_store, mesh_device,
                                          mesh_watermark, run_block_dist,
                                          shard_store, step_wave_dist)
from repro_torch.core.engine import Wave, WaveOut, run_block, stage_block, \
    step_wave
from repro_torch.core.store import make_store, read_visible
from repro_torch.core.substrate import GroupMeshSubstrate
from repro_torch.core.verify import final_values_ok, verify_cv, verify_si
from repro_torch.core.workloads import (SMALLBANK_O, rmw_hot_txn,
                                        smallbank_txn, ycsb_txn)
from repro_torch.kernels import resolve, resolve_device
from repro_torch.placement import (HotKeyReplicas, LoadBalancer,
                                   apply_move, logical_store, physical_store)
from repro_torch.planner import HybridSwitch

from .former import TxnRequest, WaveFormer, fold_counts
from .gc import VisibilityGC
from .retry import RetryPolicy


# a ProcessMesh rank's watermark floor when it holds no pin: above any clock
_NO_PIN = np.iinfo(np.int64).max


def _pct(xs: List[int], q: float) -> float:
    return float(np.percentile(np.asarray(xs), q)) if xs else 0.0


@dataclasses.dataclass
class ServiceReport:
    """End-of-run metrics for one closed-loop session (the reference's
    fields; the planes this slice does not serve report 0 / empty)."""
    sched: str
    offered: int           # requests presented to admission
    admitted: int
    rejected: int          # shed at admission (queue full)
    committed: int
    dropped: int           # retry budget exhausted
    retries: int           # re-executions scheduled
    executions: int        # total txn slots executed (incl. retries)
    waves: int
    idle_ticks: int
    wall_s: float
    txns_per_sec: float    # sustained executed txns/sec (wall)
    goodput_tps: float     # committed txns/sec (wall)
    retry_rate: float      # retries / admitted
    latency_p50: float     # ticks, admission -> commit
    latency_p95: float
    latency_p99: float
    evicted_visible: int   # GC watermark violations observed
    gc: Dict[str, int]
    # streaming plane: 0 under the per-wave step loop
    blocks: int = 0        # block dispatches (>= waves / B)
    # planner plane: all 0 without a planner
    planned_waves: int = 0       # waves served through conflict-free lanes
    planned_lane_waves: int = 0  # lane + spill waves they expanded to
    planned_spilled: int = 0     # txns spilled past the lane budget
    planner_switches: int = 0    # hybrid mode flips (either direction)
    # elastic placement plane: all 0/empty when static
    replica_commits: int = 0     # read-only txns answered from replicas
    replica_refreshes: int = 0   # replica snapshot refreshes
    placement_moves: int = 0     # executed live range moves
    moved_keys: int = 0          # keys relocated across all moves
    imbalance: float = 0.0       # max/mean per-node committed-txn occupancy
    occupancy: List[int] = dataclasses.field(default_factory=list)
    tenants: Dict[str, Dict] = dataclasses.field(default_factory=dict)
    fold_groups: int = 0         # wave rows that carried a same-key RMW fold
    folded_requests: int = 0     # member requests that rode those rows free

    def as_dict(self) -> Dict:
        return dataclasses.asdict(self)


class TxnService:
    """Closed-loop transaction service: open stream in, commits out.

    The version store lives on ``device`` (``None``: the CUDA device; pass
    ``"cpu"`` for the CPU; with a ``mesh``, the mesh's device) and every
    wave runs through ``kernels``, resolved once against that device."""

    def __init__(self, n_keys: int, n_versions: int = 8, T: int = 64,
                 O: int = SMALLBANK_O, sched: str = "postsi",
                 n_nodes: int = 8, retry: Optional[RetryPolicy] = None,
                 gc_block: bool = False, max_queue: Optional[int] = None,
                 host_skew: Optional[np.ndarray] = None, seed: int = 0,
                 mesh=None, kernels=None, durability=None, faults=None,
                 planner=None, placement=None, replicas=None, balancer=None,
                 replica_refresh: int = 1,
                 tenants: Optional[Dict[int, float]] = None,
                 fold_rmw: bool = False, fold_max: int = 256, device=None):
        self.mesh = check_mesh(mesh)
        self.device = (resolve_device(device) if mesh is None
                       else mesh_device(mesh, device))
        self.sched = sched
        self.n_nodes = n_nodes
        self.host_skew = host_skew
        self.T, self.O = T, O
        self.kernels = resolve(kernels, self.device)
        # elastic placement plane: with a PlacementMap the rings live at
        # physical rows ``placement.slot[key]`` and every dispatch
        # translates logical keys through the map's cached device tables;
        # the default (None) is the identity layout
        self.placement = placement
        if placement is not None:
            if placement.n_keys != n_keys:
                raise ValueError(f"placement covers {placement.n_keys} keys, "
                                 f"service has {n_keys}")
            if mesh is not None and placement.n_nodes != mesh.n_nodes:
                raise ValueError(f"placement is laid out for "
                                 f"{placement.n_nodes} nodes, mesh has "
                                 f"{mesh.n_nodes}")
        # a rank of a process mesh lays the whole store out in host memory
        # and keeps its block alone on the device
        on_host = isinstance(mesh, ProcessMesh)
        self.store = make_store(n_keys, n_versions,
                                device="cpu" if on_host else self.device)
        if placement is not None:
            self.store = physical_store(self.store, placement)
        if mesh is not None:
            self.store = shard_store(
                self.store, mesh,
                None if placement is None else placement.n_slots)
        self.n_keys = n_keys
        if replicas is not None and not isinstance(replicas, HotKeyReplicas):
            replicas = HotKeyReplicas(replicas)
        self.replicas = replicas
        # the refresh reads GLOBAL rows: on a process mesh the store is
        # this rank's block, so it reads through the mesh's merge (every
        # rank refreshes at the same tick)
        self._replica_read = (
            GroupMeshSubstrate(mesh, self.kernels).read_visible
            if isinstance(mesh, ProcessMesh) else read_visible)
        self.replica_refresh = max(1, int(replica_refresh))
        self.replica_commits = 0
        if balancer is True:
            if placement is None:
                raise ValueError("balancer=True needs an elastic placement")
            balancer = LoadBalancer(n_keys, placement.n_nodes)
        if balancer is not None and placement is None:
            raise ValueError("a balancer needs an elastic placement to move")
        self.balancer = balancer
        self.placement_moves = 0
        self.moved_keys = 0
        self._occupancy = (np.zeros(placement.n_nodes, np.int64)
                           if placement is not None else None)
        self.clock = torch.ones((), dtype=torch.int32, device=self.device)
        self.former = WaveFormer(T, O, max_queue=max_queue, tenants=tenants,
                                 fold_rmw=fold_rmw, fold_max=fold_max)
        self._tenant_stats: Dict[int, Dict] = {}
        self.retry = retry or RetryPolicy()
        self.gc = VisibilityGC(
            block=gc_block, n_nodes=None if mesh is None else mesh.n_nodes)
        self.rng = np.random.RandomState(seed)       # backoff jitter only
        self.tick = 0
        self.wave_idx = 0
        self.blocks = 0                              # streaming plane only
        self.history: List = []                      # (tids, WaveOut) numpy
        self.requests: List[TxnRequest] = []         # every offered request
        self.committed = 0
        self.dropped = 0
        self.retries = 0
        self.executions = 0
        self.idle_ticks = 0
        self.latencies: List[int] = []
        self._req_ids = itertools.count(1)
        self._wall_s = 0.0
        self.stream = None                   # StreamingDriver, when serving
        self._last_dispatch = (0, None)      # (wave_idx0, wm) of last block
        self.base_store = None    # snapshot rings when history is a suffix
        # durability & fault-injection planes: the manager WAL-logs every
        # retired block durable-before-ack and auto-recovers an existing
        # log into this fresh service; the schedule fires at the dispatch,
        # retire and post-log seams
        self.faults = faults
        # planner plane: ``None`` — always optimistic; ``"hybrid"`` — switch
        # to planned lanes when the trailing abort rate crosses the AIMD
        # ceiling and back when contention drops; ``"planned"`` — plan every
        # wave; or a configured HybridSwitch
        self.planner = (HybridSwitch.from_name(planner)
                        if isinstance(planner, str) else planner)
        self.planned_waves = 0        # waves served through the planner
        self.planned_lane_waves = 0   # lane + spill waves they expanded to
        self.planned_spilled = 0      # txns spilled past the lane budget
        self.durability = durability
        if durability is not None:
            durability.attach(self)
        if self.replicas is not None:
            # bootstrap snapshot at floor 0 so pre-first-tick submits can
            # already be answered (every ring starts with the cid-0 version)
            self._refresh_replicas()

    # ------------------------------------------------------------ intake
    def _tstat(self, tenant: int) -> Dict:
        st = self._tenant_stats.get(tenant)
        if st is None:
            st = {"offered": 0, "committed": 0, "dropped": 0, "retries": 0,
                  "replica_commits": 0, "latencies": []}
            self._tenant_stats[tenant] = st
        return st

    def submit(self, op_kind: np.ndarray, op_key: np.ndarray,
               op_val: np.ndarray, host: int, tenant: int = 0) -> TxnRequest:
        """Offer one transaction to admission control; the returned request
        carries its fate (``rejected`` immediately, else async)."""
        req = TxnRequest(next(self._req_ids), np.asarray(op_kind, np.int32),
                         np.asarray(op_key, np.int32),
                         np.asarray(op_val, np.int32), int(host),
                         tenant=int(tenant))
        self.requests.append(req)
        self._tstat(req.tenant)["offered"] += 1
        if (self.replicas is not None
                and self.replicas.can_serve(req.op_kind, req.op_key)):
            # a read-only txn over replicated keys commits AT SUBMIT TIME
            # with s = c = the replica's visibility floor and never enters
            # the engine (versions visible at the floor are immutable)
            _, floor = self.replicas.serve(req.op_kind, req.op_key)
            req.status = "committed"
            req.replica = True
            req.arrive_tick = self.tick
            req.commit_tick = self.tick
            req.s = req.c = int(floor)
            req.attempts = 1
            self.committed += 1
            self.replica_commits += 1
            self.latencies.append(req.latency)
            st = self._tstat(req.tenant)
            st["committed"] += 1
            st["replica_commits"] += 1
            st["latencies"].append(req.latency)
            self.gc.observe_replica(
                floor, n_reads=int((req.op_kind != NOP).sum()))
            return req
        self.former.offer(req, self.tick + 1)     # eligible from next tick
        return req

    # ------------------------------------------------------------- loop
    def step(self):
        """One scheduler tick: form a wave, execute it, route outcomes.
        Returns the numpy ``WaveOut`` or ``None`` for an idle tick."""
        self.tick += 1
        t0 = time.perf_counter()
        if (self.replicas is not None
                and self.tick % self.replica_refresh == 0):
            self._refresh_replicas()
        formed = self.former.form(self.tick)
        if formed is None:
            self.idle_ticks += 1
            return None
        wave, slots = formed
        if self.planner is not None and self.planner.planned:
            out = self._step_planned(wave, slots)
            self._wall_s += time.perf_counter() - t0
            return out
        self.wave_idx += 1
        wm = self._watermark()
        if self.faults is not None:
            self.faults.at_dispatch(self)
        self.store, out, self.clock = self._step_wave(wave, wm)
        if self.faults is not None:
            self.faults.at_retire(self)
        self.gc.observe(out, int(self.clock))
        self.history.append((np.asarray(wave.tid), out))
        if self.durability is not None:
            # the step loop retires every wave synchronously: log it as a
            # B=1 block, durable BEFORE its outcomes are acked below
            self.durability.log_block(
                Wave(*(np.asarray(f)[None] for f in wave)),
                self.wave_idx, wm, WaveOut(*(np.asarray(x)[None]
                                             for x in out)),
                int(self.clock), self.gc.clock,
                fold=fold_counts(slots,
                                 np.asarray(wave.op_kind).shape[0])[None])
            if self.faults is not None:
                self.faults.post_log(self)
        self._route(out, slots)
        self._observe_placement(wave, out, slots)
        if self.planner is not None:
            self.planner.observe_optimistic(
                len(slots), int((out.status[:len(slots)] == ABORTED).sum()))
        if self.durability is not None:
            self.durability.maybe_snapshot(self, pipeline_empty=True)
        self._wall_s += time.perf_counter() - t0
        return out

    def _step_planned(self, wave, slots):
        """Planned-mode tick half: plan the formed wave into conflict-free
        lanes and execute them as ONE pow2 wave block, then route the
        merged per-row outcomes exactly like an optimistic wave.  Lane rows
        commit abort-free; only spilled rows can re-enter the retry
        calendar."""
        from repro_torch.planner.sched import run_wave_planned
        wave_idx0 = self.wave_idx + 1
        wm = self._watermark()
        if self.faults is not None:
            self.faults.at_dispatch(self)
        self.store, self.clock, pw = run_wave_planned(
            self.store, wave, self.clock, wave_idx0=wave_idx0,
            next_tid=self.former.next_tid, sched=self.sched,
            n_nodes=self.n_nodes, mesh=self.mesh, kernels=self.kernels,
            watermark=wm, host_skew=self.host_skew,
            gc_block=self.gc.block, max_lanes=self.planner.max_lanes,
            placement=self._placement_arrays())
        if self.faults is not None:
            self.faults.at_retire(self)
        # the planner relabeled every row with fresh contiguous tids (lane
        # waves need their own [tid0, tid0+T) ranges); advance the former's
        # counter past them and point each request at the tid it ran under,
        # so history rows, requests and store versions all agree
        self.wave_idx += pw.waves_consumed
        self.former.next_tid += pw.tids_consumed
        out = pw.merged
        self.gc.observe(out, int(self.clock))
        self.history.append((pw.exec_tid, out))
        self.planned_waves += 1
        self.planned_lane_waves += pw.lane_waves + pw.spill_waves
        self.planned_spilled += pw.plan.n_spilled
        if self.durability is not None:
            # the dispatched block IS an ordinary wave block: logged as-is,
            # recovery replays it through run_block under the base sched.
            # Fold multiplicities ride along at each request's EXECUTED row
            # (the planner relabeled rows into lanes; exec_tid maps a slot
            # to its contiguous position in the stacked block)
            fold = np.zeros(pw.stacked.tid.shape, np.int32)
            tid0 = int(pw.stacked.tid[0, 0])
            T_pad = pw.stacked.tid.shape[1]
            for i, req in enumerate(slots):
                off = int(pw.exec_tid[i]) - tid0
                fold[off // T_pad, off % T_pad] = 1 + len(req.folded)
            self.durability.log_block(pw.stacked, wave_idx0, wm, pw.outs,
                                      int(self.clock), self.gc.clock,
                                      fold=fold)
            if self.faults is not None:
                self.faults.post_log(self)
        for i, req in enumerate(slots):
            for r in (req, *req.folded):
                r.tid = int(pw.exec_tid[i])
                r.tids[-1] = r.tid
        self._route(out, slots)
        self._observe_placement(wave, out, slots)
        self.planner.observe_planned(
            len(slots), pw.plan.conflicted + pw.plan.n_spilled)
        if self.durability is not None:
            self.durability.maybe_snapshot(self, pipeline_empty=True)
        return out

    def _route(self, out, slots):
        """Route one synced wave's per-txn outcomes: commits record latency,
        aborts re-enter the retry calendar or drop.  A folded row fans its
        outcome out to every member request exactly once."""
        for i, req in enumerate(slots):
            group = (req, *req.folded)
            req.folded = []
            self.executions += len(group)
            if out.status[i] == COMMITTED:
                for r in group:
                    r.status = "committed"
                    r.commit_tick = self.tick
                    r.s, r.c = int(out.s[i]), int(out.c[i])
                    self.committed += 1
                    self.latencies.append(r.latency)
                    st = self._tstat(r.tenant)
                    st["committed"] += 1
                    st["latencies"].append(r.latency)
            else:
                for r in group:
                    delay = self.retry.next_delay(r.attempts, self.rng)
                    if delay is None:
                        r.status = "dropped"
                        self.dropped += 1
                        self._tstat(r.tenant)["dropped"] += 1
                    else:
                        self.retries += 1
                        self._tstat(r.tenant)["retries"] += 1
                        self.former.requeue(r, self.tick + delay)

    def _watermark(self):
        """The GC watermark for the next dispatch: the tracker's min over
        pins, or ``None`` for the engine's wave-boundary collapse.  On the
        mesh the per-node reader floors merge by ``mesh_watermark`` (a min
        over the host floors) when pins exist.  Under pipelined streaming
        the tracker's clock is the clock of the *retired* prefix, which can
        only under-estimate the true floor — a lower watermark is
        conservative, never unsafe."""
        if self.mesh is None:
            return self.gc.watermark()
        n = self.mesh.n_nodes
        if isinstance(self.mesh, ProcessMesh):
            # a collective at every dispatch, pins or none, so that ranks
            # never disagree on whether to merge; a rank without pins
            # gives _NO_PIN, and no pin anywhere is the wave boundary
            wm = mesh_watermark(self.mesh, self.gc.node_floors(n)
                                if self.gc.pinned else [_NO_PIN] * n)
            return None if wm == _NO_PIN else wm
        if not self.gc.pinned:
            return None
        return mesh_watermark(self.mesh, self.gc.node_floors(n))

    def _step_wave(self, wave, wm):
        """Run one formed wave on the configured data plane under the
        watermark ``wm`` (computed once by the caller, so the WAL logs
        exactly what ran); returns ``(store, out_np, clock)``."""
        kw = dict(sched=self.sched, n_nodes=self.n_nodes,
                  host_skew=self.host_skew, watermark=wm,
                  gc_block=self.gc.block, kernels=self.kernels,
                  placement=self._placement_arrays())
        if self.mesh is None:
            return step_wave(self.store, wave, self.wave_idx, self.clock,
                             **kw)
        return step_wave_dist(self.store, wave, self.wave_idx, self.clock,
                              self.mesh, **kw)

    def _run_block(self, waves):
        """Dispatch B formed waves as one block WITHOUT waiting on the
        device (the streaming driver's dispatch half): the waves, their
        wave indices and the watermark are staged in one page-locked
        buffer (``engine.stage_block``) and the store and clock advance on
        the device; outcomes are read only when the driver retires the
        block.  Returns ``(outs, clock, staged)``, the staged block to be
        kept until then; ``_last_dispatch`` records the (wave_idx0,
        watermark) this dispatch consumed."""
        wave_idx0 = self.wave_idx + 1
        self.wave_idx += len(waves)
        wm = self._watermark()
        self._last_dispatch = (wave_idx0, wm)
        staged = stage_block(waves, wave_idx0, wm, self.device)
        kw = dict(sched=self.sched, n_nodes=self.n_nodes,
                  host_skew=self.host_skew, gc_block=self.gc.block,
                  kernels=self.kernels, placement=self._placement_arrays())
        if self.mesh is None:
            self.store, outs, self.clock = run_block(
                self.store, staged, None, self.clock, **kw)
        else:
            self.store, outs, self.clock = run_block_dist(
                self.store, staged, None, self.clock, self.mesh, **kw)
        return outs, self.clock, staged

    # ------------------------------------------------- elastic placement
    def _placement_arrays(self):
        """The placement's (owner, slot) tables on the service's device, or
        ``None`` when static.  Cached by the PlacementMap and remade only
        by a move, so a dispatch copies nothing from the host."""
        return (None if self.placement is None
                else self.placement.device_arrays(self.device))

    def _refresh_replicas(self):
        """Re-snapshot the hot-key replicas at the current visibility floor
        (the GC watermark; the tracker's clock when no pins exist).  The
        floor only moves forward, so one batched gather is the whole
        replication protocol."""
        wm = self._watermark()
        floor = int(self.gc.clock) if wm is None else int(wm)
        slot_of = None if self.placement is None else self.placement.slot
        self.replicas.refresh(self.store, floor, slot_of=slot_of,
                              read=self._replica_read)

    def _observe_placement(self, wave, out, slots):
        """Fold one retired wave into the placement plane's accounting
        (per-node committed-txn occupancy under the CURRENT placement) and
        let the balancer trigger live range moves at its block boundary.
        Reads the host copies of the wave and of its outcomes only."""
        if self.placement is None:
            return
        T = len(slots)
        kinds = np.asarray(wave.op_kind)[:T]
        keys = np.asarray(wave.op_key)[:T]
        status = np.asarray(out.status)[:T]
        owner = self.placement.owner
        active = kinds != NOP
        committed = status == COMMITTED
        sel = committed & active.any(axis=1)
        if sel.any():
            first = np.argmax(active, axis=1)
            np.add.at(self._occupancy,
                      owner[keys[np.arange(T), first][sel]], 1)
        if self.balancer is None:
            return
        self.balancer.observe(keys, active, committed, owner)
        if self.balancer.end_block():
            for lo, hi, dst in self.balancer.plan(self.placement):
                self.move_range(lo, hi, dst)

    def move_range(self, lo: int, hi: int, dst: int):
        """Live-repartition logical keys ``[lo, hi)`` onto node ``dst`` at a
        wave boundary: plan the slots on the PlacementMap, move the rings
        in the store on the device, commit the map (which remakes its
        device tables) and WAL-log the explicit record so recovery replays
        the move bit for bit.  A live streaming driver is flushed first, so
        no dispatched block is in flight.  Returns the applied
        ``MoveRecord`` (``None`` if nothing moved).  On a ``ProcessMesh``
        every rank moves at the same boundary (``apply_move_process``)."""
        if self.placement is None:
            raise ValueError("move_range needs an elastic placement")
        if self.stream is not None:
            self.stream.flush()          # no dispatched block may be in flight
        rec = self.placement.move(lo, hi, dst)
        if rec.keys.size == 0:
            return None
        self.store = apply_move(self.store, rec, mesh=self.mesh)
        self.placement.apply_record(rec)
        self.placement_moves += 1
        self.moved_keys += int(rec.keys.size)
        if self.durability is not None:
            self.durability.log_move(rec, int(self.clock))
        return rec

    def drain(self, max_ticks: Optional[int] = None) -> int:
        """Run ticks until no request is pending (or the safety cap).
        Returns the number of ticks consumed."""
        if max_ticks is None:
            max_ticks = (self.retry.worst_case_ticks()
                         + self.former.pending() // max(self.T, 1) + 8)
        n = 0
        while self.former.pending() and n < max_ticks:
            self.step()
            n += 1
        return n

    def _submit_tick(self, n_arr, txn_gen):
        """Submit one tick's arrivals.  Scalar ``n_arr``: that many calls of
        ``txn_gen()`` (4-tuples, default tenant).  1-D ``n_arr`` of length
        n_tenants: per-tenant counts, each from ``txn_gen(tenant)``, which
        returns a 5-tuple ending in the tenant tag."""
        arr = np.asarray(n_arr)
        if arr.ndim == 0:
            for _ in range(int(arr)):
                self.submit(*txn_gen())
        else:
            for tenant, cnt in enumerate(arr):
                for _ in range(int(cnt)):
                    self.submit(*txn_gen(tenant))

    def run_stream(self, arrivals: Iterable,
                   txn_gen: Callable, drain: bool = True):
        """Feed ``arrivals[t]`` fresh requests per tick (from ``txn_gen``),
        stepping once per tick; optionally drain the backlog afterwards.  A
        2-D arrivals array ``[n_ticks, n_tenants]`` feeds a multi-tenant
        stream."""
        for n_arr in arrivals:
            self._submit_tick(n_arr, txn_gen)
            self.step()
        if drain:
            self.drain()
        return self.report()

    def run_streaming(self, arrivals: Iterable, txn_gen: Callable,
                      B: int = 4, K: int = 2, sizer=None,
                      drain: bool = True):
        """Serve the same open stream through the pipelined streaming
        plane: waves are batched into blocks of ``B`` and dispatched as one
        block each (``engine.run_block``), with up to ``K`` dispatched
        blocks in flight — the host forms the next block(s) while the
        device runs, and a block's outcomes are synced (and its aborts
        routed to retry) only when it retires.

        ``B=1, K=1`` degenerates to the synchronous ``run_stream`` loop and
        is bit-identical to it.  ``sizer`` — a
        ``stream.AdaptiveWaveSizer`` (or ``"auto"``) — regulates the wave
        size T (and optionally B) from the trailing abort rate.  Returns
        the end-of-run ``ServiceReport``."""
        from .stream import AdaptiveWaveSizer, StreamingDriver
        if sizer == "auto":
            sizer = AdaptiveWaveSizer(T0=self.T, B0=B,
                                      t_min=min(8, self.T), adapt_B=True)
        driver = StreamingDriver(self, B=B, K=K, sizer=sizer)
        self.stream = driver                 # expose pipeline state/stats
        for n_arr in arrivals:
            self._submit_tick(n_arr, txn_gen)
            driver.tick()
        if drain:
            driver.drain()
        else:
            driver.flush()
        return self.report()

    # ------------------------------------------------------------ output
    def report(self) -> ServiceReport:
        wall = max(self._wall_s, 1e-9)
        admitted = self.former.admitted
        return ServiceReport(
            sched=self.sched,
            offered=len(self.requests),
            admitted=admitted,
            rejected=self.former.rejected,
            committed=self.committed,
            dropped=self.dropped,
            retries=self.retries,
            executions=self.executions,
            waves=self.wave_idx,
            idle_ticks=self.idle_ticks,
            wall_s=round(wall, 6),
            txns_per_sec=round(self.executions / wall, 1),
            goodput_tps=round(self.committed / wall, 1),
            retry_rate=round(self.retries / max(admitted, 1), 4),
            latency_p50=_pct(self.latencies, 50),
            latency_p95=_pct(self.latencies, 95),
            latency_p99=_pct(self.latencies, 99),
            evicted_visible=self.gc.evicted_visible,
            gc=self.gc.report(),
            blocks=self.blocks,
            planned_waves=self.planned_waves,
            planned_lane_waves=self.planned_lane_waves,
            planned_spilled=self.planned_spilled,
            planner_switches=(self.planner.switches
                              if self.planner is not None else 0),
            replica_commits=self.replica_commits,
            replica_refreshes=(self.replicas.refreshes
                               if self.replicas is not None else 0),
            placement_moves=self.placement_moves,
            moved_keys=self.moved_keys,
            imbalance=self._imbalance(),
            occupancy=([] if self._occupancy is None
                       else self._occupancy.tolist()),
            tenants=self._tenant_report(),
            fold_groups=self.former.fold_groups,
            folded_requests=self.former.folded_requests,
        )

    def _tenant_report(self) -> Dict[str, Dict]:
        """Per-tenant rows (keys stringified for JSON): admission counters
        from the former joined with the service-side outcome/latency
        accounting.  Single-tenant runs report one row for tenant "0"."""
        former_stats = self.former.tenant_stats()
        rows: Dict[str, Dict] = {}
        for t in sorted(set(former_stats) | set(self._tenant_stats)):
            fs = former_stats.get(t, {})
            st = self._tenant_stats.get(t, {})
            lat = st.get("latencies", [])
            rows[str(t)] = {
                "weight": float(fs.get("weight", 1.0)),
                "offered": int(st.get("offered", 0)),
                "admitted": int(fs.get("admitted", 0)),
                "rejected": int(fs.get("rejected", 0)),
                "committed": int(st.get("committed", 0)),
                "replica_commits": int(st.get("replica_commits", 0)),
                "dropped": int(st.get("dropped", 0)),
                "retries": int(st.get("retries", 0)),
                "latency_p50": _pct(lat, 50),
                "latency_p95": _pct(lat, 95),
                "latency_p99": _pct(lat, 99),
            }
        return rows

    def _imbalance(self) -> float:
        """Max/mean per-node committed-txn occupancy under the current
        placement (1.0 = perfectly balanced; 0.0 when static or empty)."""
        if self._occupancy is None or self._occupancy.sum() == 0:
            return 0.0
        occ = self._occupancy.astype(np.float64)
        return round(float(occ.max() / occ.mean()), 4)

    def verify(self) -> List[str]:
        """Post-hoc correctness of the served history: SI (or CV) validity
        plus final-store-matches-serial-replay, via ``core.verify``.  The
        history speaks logical keys, so a placed store is gathered back
        into key order first (moves do not change ring contents).  On a
        ``ProcessMesh`` the blocks are gathered (``gather_store``) before
        the placement's permutation: every rank calls it."""
        check = verify_cv if self.sched == "cv" else verify_si
        errors = check(self.history, base_store=self.base_store)
        store = (gather_store(self.store, self.mesh)
                 if isinstance(self.mesh, ProcessMesh) else self.store)
        errors += final_values_ok(logical_store(store, self.placement),
                                  self.history, self.n_keys)
        return errors


def smallbank_txn_gen(rng: np.random.RandomState, n_nodes: int,
                      keys_per_node: int, dist_frac: float = 0.2,
                      hot_frac: float = 0.0, hot_per_node: int = 20):
    """Request factory for ``run_stream``: SmallBank transactions on random
    host nodes (the open-stream analogue of ``workloads.smallbank_waves``)."""
    def gen():
        host = int(rng.randint(0, n_nodes))
        op_kind, op_key, op_val = smallbank_txn(
            rng, host, n_nodes, keys_per_node, dist_frac, hot_frac,
            hot_per_node)
        return op_kind, op_key, op_val, host
    return gen


def ycsb_txn_gen(rng: np.random.RandomState, n_nodes: int,
                 keys_per_node: int, theta: float = 0.9,
                 read_frac: float = 0.8, dist_frac: float = 0.1,
                 n_ops: int = 4):
    """Request factory: YCSB-style transactions with zipfian key skew
    ``theta`` on random host nodes (``workloads.ycsb_txn``)."""
    def gen():
        host = int(rng.randint(0, n_nodes))
        op_kind, op_key, op_val = ycsb_txn(
            rng, host, n_nodes, keys_per_node, theta, read_frac, dist_frac,
            n_ops)
        return op_kind, op_key, op_val, host
    return gen


def rmw_txn_gen(rng: np.random.RandomState, n_nodes: int,
                keys_per_node: int, theta: float = 0.99, n_ops: int = 4,
                val_max: int = 8):
    """Request factory for the write-hot regime the fold plane targets:
    every transaction is a SINGLE zipfian RMW (``workloads.rmw_hot_txn``)."""
    def gen():
        host = int(rng.randint(0, n_nodes))
        op_kind, op_key, op_val = rmw_hot_txn(
            rng, host, n_nodes, keys_per_node, theta, n_ops, val_max)
        return op_kind, op_key, op_val, host
    return gen


def tenant_txn_gen(gens):
    """Compose per-tenant request factories for 2-D ``run_stream``
    arrivals: ``gens[t]()`` returns ``(op_kind, op_key, op_val, host)``;
    the returned ``gen(tenant)`` appends the tenant tag."""
    def gen(tenant: int):
        return (*gens[tenant](), tenant)
    return gen
