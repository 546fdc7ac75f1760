"""Closed-loop transaction service over the wave engine (port of
``repro.service.service``, single device).

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

This slice serves from one device.  The mesh, placement, replica,
balancer, durability, fault-injection and planner planes and the pipelined
streaming driver are not ported yet: their arguments must be ``None`` and
anything else raises ``NotImplementedError`` naming the ROADMAP item that
brings it.
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Callable, Dict, Iterable, List, Optional

import numpy as np
import torch

from repro_torch.core.commit_phase import COMMITTED
from repro_torch.core.engine import step_wave
from repro_torch.core.store import make_store
from repro_torch.core.verify import final_values_ok, verify_cv, verify_si
from repro_torch.core.workloads import (SMALLBANK_O, rmw_hot_txn,
                                        smallbank_txn, ycsb_txn)
from repro_torch.kernels import resolve, resolve_device

from .former import TxnRequest, WaveFormer
from .gc import VisibilityGC
from .retry import RetryPolicy

# arguments of the reference TxnService that this slice does not serve yet,
# with the ROADMAP.md queue-1 item (by title) that brings each
_NOT_YET = {
    "mesh": "Mesh substrate + dist_engine",
    "placement": "Elastic placement",
    "replicas": "Elastic placement",
    "replica_refresh": "Elastic placement",
    "balancer": "Elastic placement",
    "durability": "Checkpoint store + durability + fault injection",
    "faults": "Checkpoint store + durability + fault injection",
    "planner": "Planner",
}


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
    blocks: int = 0
    planned_waves: int = 0
    planned_lane_waves: int = 0
    planned_spilled: int = 0
    planner_switches: int = 0
    replica_commits: int = 0
    replica_refreshes: int = 0
    placement_moves: int = 0
    moved_keys: int = 0
    imbalance: float = 0.0
    occupancy: List[int] = dataclasses.field(default_factory=list)
    tenants: Dict[str, Dict] = dataclasses.field(default_factory=dict)
    fold_groups: int = 0         # wave rows that carried a same-key RMW fold
    folded_requests: int = 0     # member requests that rode those rows free

    def as_dict(self) -> Dict:
        return dataclasses.asdict(self)


class TxnService:
    """Closed-loop transaction service: open stream in, commits out.

    The version store lives on ``device`` (``None``: the CUDA device; pass
    ``"cpu"`` for the CPU) and every wave runs through ``kernels``, resolved
    once against that device."""

    def __init__(self, n_keys: int, n_versions: int = 8, T: int = 64,
                 O: int = SMALLBANK_O, sched: str = "postsi",
                 n_nodes: int = 8, retry: Optional[RetryPolicy] = None,
                 gc_block: bool = False, max_queue: Optional[int] = None,
                 host_skew: Optional[np.ndarray] = None, seed: int = 0,
                 mesh=None, kernels=None, durability=None, faults=None,
                 planner=None, placement=None, replicas=None, balancer=None,
                 replica_refresh: Optional[int] = None,
                 tenants: Optional[Dict[int, float]] = None,
                 fold_rmw: bool = False, fold_max: int = 256, device=None):
        given = dict(mesh=mesh, placement=placement, replicas=replicas,
                     replica_refresh=replica_refresh, balancer=balancer,
                     durability=durability, faults=faults, planner=planner)
        for name, value in given.items():
            if value is not None:
                raise NotImplementedError(
                    f"TxnService({name}=...) is not ported yet: see "
                    f"ROADMAP.md queue 1, item '{_NOT_YET[name]}'")
        self.device = resolve_device(device)
        self.sched = sched
        self.n_nodes = n_nodes
        self.host_skew = host_skew
        self.T, self.O = T, O
        self.kernels = resolve(kernels, self.device)
        self.store = make_store(n_keys, n_versions, device=self.device)
        self.n_keys = n_keys
        self.clock = torch.ones((), dtype=torch.int32, device=self.device)
        self.former = WaveFormer(T, O, max_queue=max_queue, tenants=tenants,
                                 fold_rmw=fold_rmw, fold_max=fold_max)
        self._tenant_stats: Dict[int, Dict] = {}
        self.retry = retry or RetryPolicy()
        self.gc = VisibilityGC(block=gc_block)
        self.rng = np.random.RandomState(seed)       # backoff jitter only
        self.tick = 0
        self.wave_idx = 0
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
        self.former.offer(req, self.tick + 1)     # eligible from next tick
        return req

    # ------------------------------------------------------------- loop
    def step(self):
        """One scheduler tick: form a wave, execute it, route outcomes.
        Returns the numpy ``WaveOut`` or ``None`` for an idle tick."""
        self.tick += 1
        t0 = time.perf_counter()
        formed = self.former.form(self.tick)
        if formed is None:
            self.idle_ticks += 1
            return None
        wave, slots = formed
        self.wave_idx += 1
        self.store, out, self.clock = step_wave(
            self.store, wave, self.wave_idx, self.clock, sched=self.sched,
            n_nodes=self.n_nodes, host_skew=self.host_skew,
            watermark=self.gc.watermark(), gc_block=self.gc.block,
            kernels=self.kernels)
        self.gc.observe(out, int(self.clock))
        self.history.append((np.asarray(wave.tid), out))
        self._route(out, slots)
        self._wall_s += time.perf_counter() - t0
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

    def run_streaming(self, *args, **kwargs):
        raise NotImplementedError(
            "TxnService.run_streaming (the pipelined StreamingDriver) is not "
            "ported yet: see ROADMAP.md queue 1, item 'Streaming service "
            "plane'")

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

    def verify(self) -> List[str]:
        """Post-hoc correctness of the served history: SI (or CV) validity
        plus final-store-matches-serial-replay, via ``core.verify``."""
        check = verify_cv if self.sched == "cv" else verify_si
        errors = check(self.history)
        errors += final_values_ok(self.store, self.history, self.n_keys)
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
