"""Open-stream wave former (DESIGN.md §8, §12; a copy of
``repro.service.former``).

The fused engine consumes fixed-shape ``[T, O]`` waves; an open system
produces a ragged request stream.  The wave former is the adapter: it holds
bounded *per-tenant* ready queues (admission control — a request arriving
to its tenant's full queue is **rejected**, the load-shedding answer an
open system must give), per-tenant retry calendars ordered by
earliest-eligible tick, and packs up to ``T`` transactions per tick into a
wave, padding the tail with NOP rows so every wave has the same shape.

Fairness (DESIGN.md §12.1): slots are granted by deficit round-robin over
weighted tenant quotas.  Each forming pass deals every backlogged tenant a
quantum ``T * w_i / sum(w)``; a tenant spends whole-slot deficits in
round-robin order, and leftover capacity is filled work-conservingly from
any backlogged tenant (uncharged).  Due retries are packed **before**
fresh arrivals *within* a tenant — a transaction that already burned
scheduler work has priority over new load — but a tenant's retries can
never overdraw another tenant's quota.  With a single (default) tenant the
whole mechanism degenerates to the original global retries-first FIFO.

Write-hot mitigation (DESIGN.md §12.2): when ``fold_rmw`` is on, requests
whose single active op is an RMW on the same (tenant, host, key) are
*folded* into one wave row carrying the summed delta — the engine's RMW is
``val_new = r_val + op_val`` (commutative, associative), so one folded row
commits the same final value the members would reach serially via
lost-update retries.  Members ride free (no slot, no deficit charge) and
fan back out on retire with the leader's outcome.

TIDs are a contiguous ``arange`` per wave — the engine's commit phase maps
newest-version creators to wave-local slots by ``tid - tid[0]``
(``commit_phase.creator_slots``), so the former owns the TID counter and
every retry executes under a fresh TID, as the paper's rules require.
"""
from __future__ import annotations

import dataclasses
import heapq
from collections import deque
from typing import Dict, List, Optional, Tuple
from dataclasses import field

import numpy as np

from repro_torch.core.commit_phase import NOP, RMW
from repro_torch.core.engine import Wave

_I32_MIN, _I32_MAX = -(2 ** 31), 2 ** 31 - 1


@dataclasses.dataclass
class TxnRequest:
    """One client transaction riding the closed loop."""
    req_id: int
    op_kind: np.ndarray          # [O] int32
    op_key: np.ndarray           # [O] int32
    op_val: np.ndarray           # [O] int32
    host: int
    arrive_tick: int = -1        # set at admission
    attempts: int = 0            # executions so far
    tid: int = -1                # TID of the latest execution
    tids: List[int] = field(default_factory=list)  # TID of every execution
    status: str = "new"          # new|queued|inflight|committed|dropped|rejected
    commit_tick: int = -1
    s: int = -1                  # induced interval of the committed run
    c: int = -1
    replica: bool = False        # served from a hot-key read replica
                                 # (s == c == replica floor, never entered
                                 # the engine)
    tenant: int = 0              # admission/fairness class (DESIGN.md §12)
    folded: List["TxnRequest"] = field(default_factory=list)
                                 # same-key RMW members riding this leader's
                                 # wave row; empty unless fold_rmw packed it

    @property
    def latency(self) -> int:
        """End-to-end ticks from admission to commit (incl. the commit
        tick); -1 until committed."""
        if self.status != "committed":
            return -1
        return self.commit_tick - self.arrive_tick + 1


def fold_counts(slots: List["TxnRequest"], T: int) -> np.ndarray:
    """[T] int32 request multiplicity per wave row: 1 + folded members for
    occupied rows, 0 for NOP padding.  Logged alongside each WAL block so
    recovery can account fan-out without re-deriving fold groups; replay
    itself is untouched — the folded row IS what executed."""
    fold = np.zeros(T, np.int32)
    for i, req in enumerate(slots):
        fold[i] = 1 + len(req.folded)
    return fold


class _TenantQueue:
    """One tenant's admission queue + retry calendar + DRR deficit."""

    __slots__ = ("weight", "max_queue", "ready", "retry", "deficit",
                 "admitted", "rejected", "_seq")

    def __init__(self, weight: float, max_queue: int):
        self.weight = float(weight)
        self.max_queue = int(max_queue)
        self.ready: deque = deque()       # admitted, eligible now (FIFO)
        self.retry: list = []             # heap: (eligible_tick, seq, req)
        self.deficit = 0.0
        self.admitted = 0
        self.rejected = 0
        self._seq = 0

    def due(self, tick: int) -> bool:
        return bool(self.ready) or bool(self.retry
                                        and self.retry[0][0] <= tick)

    def pop(self, tick: int) -> TxnRequest:
        """Next eligible request: due retries before fresh arrivals."""
        if self.retry and self.retry[0][0] <= tick:
            return heapq.heappop(self.retry)[2]
        return self.ready.popleft()

    def push_retry(self, req: TxnRequest, eligible_tick: int) -> None:
        self._seq += 1
        heapq.heappush(self.retry, (eligible_tick, self._seq, req))

    def backlog(self, tick: int) -> int:
        return len(self.ready) + sum(1 for t, _, _ in self.retry if t <= tick)

    def pending(self) -> int:
        return len(self.ready) + len(self.retry)


class WaveFormer:
    """Admission control + retry calendars + fixed-shape wave packing,
    multiplexed over weighted tenants (deficit round-robin)."""

    def __init__(self, T: int, O: int, max_queue: Optional[int] = None,
                 next_tid: int = 1,
                 tenants: Optional[Dict[int, float]] = None,
                 fold_rmw: bool = False, fold_max: int = 256,
                 auto_tenant_cap: int = 64):
        self.T, self.O = T, O
        self.max_queue = 4 * T if max_queue is None else max_queue
        self.next_tid = next_tid
        self.fold_rmw = bool(fold_rmw)
        self.fold_max = int(fold_max)     # max requests per folded row
        self.fold_groups = 0              # wave rows that carried a fold
        self.folded_requests = 0          # member requests that rode free
        self._tenants: Dict[int, _TenantQueue] = {}
        self._order: List[int] = []       # round-robin rotation of tenant ids
        self._rr = 0                      # rotation cursor (advances per form)
        # the tenant tag space must stay BOUNDED: with an explicit map only
        # registered tenants may admit; without one, tags auto-register at
        # weight 1 up to ``auto_tenant_cap`` — otherwise every spurious tag
        # would grow admission capacity and dilute real tenants' DRR quotas
        self._explicit = bool(tenants)
        self.auto_tenant_cap = int(auto_tenant_cap)
        self._unknown_rejects: Dict[int, int] = {}   # shed-at-tag counters
        if tenants:
            for t, w in tenants.items():
                self._register(int(t), float(w))

    # --------------------------------------------------------- tenants
    def _register(self, tenant: int, weight: float = 1.0) -> _TenantQueue:
        q = _TenantQueue(weight, self.max_queue)
        self._tenants[tenant] = q
        self._order.append(tenant)
        return q

    def _queue_of(self, tenant: int) -> _TenantQueue:
        q = self._tenants.get(tenant)
        if q is None:                     # unknown tenants join at weight 1
            q = self._register(tenant)
        return q

    def tenant_stats(self) -> Dict[int, Dict[str, float]]:
        """Per-tenant admission counters for ServiceReport.  Unregistered
        tags that were shed at admission report at weight 0 with no queue."""
        rows = {t: {"weight": q.weight, "admitted": q.admitted,
                    "rejected": q.rejected, "pending": q.pending()}
                for t, q in self._tenants.items()}
        for t, n in self._unknown_rejects.items():
            rows.setdefault(t, {"weight": 0.0, "admitted": 0,
                                "rejected": n, "pending": 0})
        return dict(sorted(rows.items()))

    # aggregating views keep the single-tenant API of the original former
    @property
    def admitted(self) -> int:
        return sum(q.admitted for q in self._tenants.values())

    @property
    def rejected(self) -> int:
        return (sum(q.rejected for q in self._tenants.values())
                + sum(self._unknown_rejects.values()))

    # --------------------------------------------------------- admission
    def offer(self, req: TxnRequest, tick: int) -> bool:
        """Admit a fresh arrival, or shed it when its tenant's queue is
        full.  Admission is judged per tenant: one tenant flooding its
        bounded queue cannot evict or block another tenant's arrivals.
        Unregistered tenant tags are shed without creating a queue when an
        explicit tenant map was configured (or past ``auto_tenant_cap``)."""
        assert req.op_kind.shape == (self.O,), (req.op_kind.shape, self.O)
        q = self._tenants.get(req.tenant)
        if q is None:
            if self._explicit or len(self._tenants) >= self.auto_tenant_cap:
                req.status = "rejected"
                self._unknown_rejects[req.tenant] = \
                    self._unknown_rejects.get(req.tenant, 0) + 1
                return False
            q = self._register(req.tenant)
        if len(q.ready) >= q.max_queue:
            req.status = "rejected"
            q.rejected += 1
            return False
        req.status = "queued"
        req.arrive_tick = tick
        q.admitted += 1
        q.ready.append(req)
        return True

    def requeue(self, req: TxnRequest, eligible_tick: int) -> None:
        """Put an aborted transaction on its tenant's retry calendar (no
        admission check — it already holds a slot in the system)."""
        req.status = "queued"
        self._queue_of(req.tenant).push_retry(req, eligible_tick)

    # ----------------------------------------------------------- packing
    def backlog(self, tick: int) -> int:
        """Transactions eligible to run at ``tick`` (ready + due retries)."""
        return sum(q.backlog(tick) for q in self._tenants.values())

    def pending(self) -> int:
        """All transactions still inside the former, due or not."""
        return sum(q.pending() for q in self._tenants.values())

    def _fold_slot(self, req: TxnRequest) -> Optional[int]:
        """Op index if ``req`` is foldable (exactly one active op, an RMW);
        None otherwise."""
        active = req.op_kind != NOP
        n = int(active.sum())
        if n != 1:
            return None
        o = int(np.argmax(active))
        return o if int(req.op_kind[o]) == RMW else None

    def _pack(self, req: TxnRequest, slots: List[TxnRequest],
              folds: Dict[Tuple[int, int, int], List[int]]) -> bool:
        """Place ``req``: either fold it onto an existing leader (returns
        False — no slot consumed) or append it as a new row (True).

        ``folds`` maps the group key to ``[leader row, running delta]``; a
        member joins only while the group is under ``fold_max`` AND the
        summed delta stays inside int32 — the engine's RMW adds int32s, so
        a wrapping fold would commit a value no serial (unfolded) execution
        could produce.  An over-cap/overflow request starts a new leader."""
        if self.fold_rmw:
            o = self._fold_slot(req)
            if o is not None:
                d = int(req.op_val[o])
                gk = (req.tenant, int(req.host), int(req.op_key[o]))
                ent = folds.get(gk)
                if ent is not None:
                    li, total = ent
                    if (len(slots[li].folded) + 1 < self.fold_max
                            and _I32_MIN <= total + d <= _I32_MAX):
                        slots[li].folded.append(req)
                        ent[1] = total + d
                        return False
                folds[gk] = [len(slots), d]   # this row becomes the leader
        req.folded = []
        slots.append(req)
        return True

    def form(self, tick: int,
             T: Optional[int] = None) -> Optional[Tuple[Wave, List[TxnRequest]]]:
        """Pack one wave for ``tick``; ``None`` when nothing is eligible.

        Returns ``(wave, slots)``: ``slots[i]`` is the request in wave row
        ``i`` (the NOP padding rows have no request and always commit
        vacuously — the service skips them when reading outcomes).  When
        folding is on, ``slots[i].folded`` lists member requests riding
        that row; the service fans the row outcome out to them on retire.

        ``T`` overrides the wave size for this call — the contention-adaptive
        streaming driver resizes waves on a bounded ladder (DESIGN.md §8);
        every distinct T is a distinct engine shape.

        Slot grant is deficit round-robin: backlogged tenants split ``T``
        by weight (deficits bank across calls, capped at one wave), then a
        work-conserving pass fills leftover rows from any backlog."""
        T = self.T if T is None else T
        order = self._order
        if not order:
            return None
        n = len(order)
        rr = self._rr % n
        rotation = [order[(rr + j) % n] for j in range(n)]
        active = [t for t in rotation if self._tenants[t].due(tick)]
        if not active:
            return None
        self._rr += 1

        # deal quanta: backlogged tenants share T by weight; idle tenants
        # forfeit their deficit (classic DRR — no banking while idle)
        w_sum = sum(self._tenants[t].weight for t in active) or 1.0
        for t in order:
            q = self._tenants[t]
            if q.due(tick):
                q.deficit = min(q.deficit + T * q.weight / w_sum, float(T))
            else:
                q.deficit = 0.0

        slots: List[TxnRequest] = []
        folds: Dict[Tuple[int, int, int], List[int]] = {}
        # quota pass: spend whole-slot deficits in round-robin order
        for t in active:
            q = self._tenants[t]
            while len(slots) < T and q.deficit >= 1.0 and q.due(tick):
                if self._pack(q.pop(tick), slots, folds):
                    q.deficit -= 1.0
        # work-conserving pass: leftover rows go to any backlog, round-robin
        # one request at a time, uncharged (spare capacity is nobody's quota)
        while len(slots) < T:
            served = False
            for t in active:
                if len(slots) >= T:
                    break
                q = self._tenants[t]
                if q.due(tick):
                    self._pack(q.pop(tick), slots, folds)
                    served = True
            if not served:
                break
        if not slots:
            return None

        O = self.O
        op_kind = np.full((T, O), NOP, np.int32)
        op_key = np.zeros((T, O), np.int32)
        op_val = np.zeros((T, O), np.int32)
        host = np.zeros(T, np.int32)
        tid0 = self.next_tid
        self.next_tid += T                     # padding rows burn TIDs too
        for i, req in enumerate(slots):
            op_kind[i] = req.op_kind
            op_key[i] = req.op_key
            op_val[i] = req.op_val
            host[i] = req.host
            if req.folded:
                o = self._fold_slot(req)
                # each member's delta lives at ITS OWN active op index —
                # groups form by (tenant, host, key), never by op slot, so
                # reading the leader's slot would drop any member whose RMW
                # sits elsewhere (a silent lost update)
                delta = sum(int(m.op_val[self._fold_slot(m)])
                            for m in req.folded)
                op_val[i, o] = np.int32(int(req.op_val[o]) + delta)
                self.fold_groups += 1
                self.folded_requests += len(req.folded)
            for r in (req, *req.folded):
                r.tid = tid0 + i
                r.tids.append(r.tid)
                r.attempts += 1
                r.status = "inflight"
        # numpy leaves on purpose: the wave crosses to the device exactly
        # once, when the engine's step dispatch moves it there
        wave = Wave(op_kind=op_kind, op_key=op_key, op_val=op_val, host=host,
                    tid=(tid0 + np.arange(T)).astype(np.int32))
        return wave, slots
