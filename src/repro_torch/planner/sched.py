"""The seventh scheduler: ``"planned"`` — deterministic lane execution that
commits abort-free (port of ``repro.planner.sched``; DESIGN.md §10).

This module is the planner's back half: it takes one wave plus its ``Plan``
(lanes.py) and turns it into ONE ordinary wave *block* for the existing
engine — every lane becomes a wave in the stack, the spill set (if any)
becomes the final wave, and the whole block runs through
``engine.step_block`` (``dist_engine.step_block_dist`` on a node mesh or
a process mesh),
i.e. through ``engine.run_wave_on`` (on the
``cuda`` routes the read-phase kernels and one ``commit_loop`` launch a
lane wave).  There is **zero new copy of the CC rules**: a lane is just a
wave the planner has proven conflict-free, and the engine's own rules then
have nothing to abort:

* no same-lane writer of a read key  ⇒ re-validation finds the read version
  still newest (no rule-4(a) lost update, no dsi stale-remote);
* the potential anti-dependency matrix is empty  ⇒ no rule-5 RW edges, no
  first-committer-wins WW conflict (si/optimal/clocksi);
* s_hi stays unpinned (+inf)  ⇒ the PostSI interval can always be ordered.

The one honest exception: ``gc_block=True`` aborts *writers* whose ring
slot would destroy a still-visible version — a storage condition the
planner cannot see — so the zero-abort assertion is enforced only when it
is off (likewise under ``host_skew``, where clock-si's deliberately stale
snapshots reintroduce lost updates across lanes).

Shape discipline: lanes are ragged, so every lane/spill wave is padded with
NOP rows to one shared power-of-two width and the lane count is padded with
all-NOP waves to a power-of-two block, and NOP rows/waves commit vacuously
without touching the store.  Each padded wave gets *fresh contiguous*
transaction ids: the commit loop's creator-slot map assumes a wave's tids
are ``[tid0, tid0 + T)`` (``commit_phase.creator_slots``), so lane
transactions are relabeled from a monotone counter and the mapping back to
the caller's rows is returned (``PlannedWave.exec_tid``).

Host-side planning (graph build + coloring + packing, all numpy) is on the
critical path: planned wins only where the abort rate it avoids exceeds
what the planning and extra lane dispatch cost, which is the high-skew
regime.
"""
from __future__ import annotations

import time
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.commit_phase import ABORTED, NOP
from repro_torch.core.dist_engine import check_mesh, step_block_dist
from repro_torch.core.engine import (SCHEDULERS, Wave, WaveOut, step_block,
                                     _stats_of, wave_to_numpy)

from .lanes import Plan, plan_wave

#: the planner registers as a seventh scheduler *above* the engine's six:
#: ``sched``/``base_sched`` below selects which of the six adjudicates each
#: lane, so "planned" composes with — never forks — the CC rules.
PLANNED = "planned"
ALL_SCHEDULERS = SCHEDULERS + (PLANNED,)

#: default lane budget for bounded planning (service hybrid mode); ``None``
#: disables spilling entirely (lane count = longest conflict chain + 1)
DEFAULT_MAX_LANES = 16

_STAT_FIELDS = ("msgs_cross", "msgs_coord", "waits", "evicted_visible")


class PlannerError(RuntimeError):
    """A planned lane aborted — a planner invariant violation, never an
    expected runtime condition."""


class PlannedWave(NamedTuple):
    """Outcome of one planned wave, host-side."""
    merged: WaveOut           # numpy, rows aligned with the input wave
    exec_tid: np.ndarray      # [T] the fresh tid each input row ran under
    plan: Plan                # lane assignment (lanes.py)
    stacked: Wave             # numpy [L, T_pad, O] block that was dispatched
    outs: WaveOut             # numpy raw per-wave outputs, leading [L] axis
    waves_consumed: int       # wave indices used (= L, incl. pow2 padding)
    tids_consumed: int        # tid counter advance (= L * T_pad)
    lane_waves: int           # real lane waves dispatched
    spill_waves: int          # 0 or 1


def _pow2ceil(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def build_planned_block(wave: Wave, plan: Plan, next_tid: int
                        ) -> Tuple[Wave, List[np.ndarray], int]:
    """Pack a wave's lanes (+ spill) into one pow2-padded numpy block.

    Returns ``(stacked, rows, T_pad)`` where ``stacked`` is a numpy
    ``Wave`` with leading [L] axis (L and the per-wave width both rounded
    up to powers of two, padding = NOP rows with tids still contiguous) and
    ``rows[l]`` holds the *input-wave* row indices occupying the first
    ``len(rows[l])`` slots of block wave ``l`` (empty for padding waves)."""
    groups = [lane for lane in plan.lanes]
    if len(plan.spill):
        groups.append(plan.spill)
    if not groups:                       # degenerate empty wave
        groups = [np.arange(0)]
    T_pad = _pow2ceil(max(len(g) for g in groups))
    L = _pow2ceil(len(groups))
    O = np.asarray(wave.op_kind).shape[1]
    op_kind = np.full((L, T_pad, O), NOP, np.int32)
    op_key = np.zeros((L, T_pad, O), np.int32)
    op_val = np.zeros((L, T_pad, O), np.int32)
    host = np.zeros((L, T_pad), np.int32)
    src = {f: np.asarray(getattr(wave, f)) for f in ("op_kind", "op_key",
                                                     "op_val", "host")}
    rows: List[np.ndarray] = []
    for l, g in enumerate(groups):
        n = len(g)
        op_kind[l, :n] = src["op_kind"][g]
        op_key[l, :n] = src["op_key"][g]
        op_val[l, :n] = src["op_val"][g]
        host[l, :n] = src["host"][g]
        rows.append(np.asarray(g))
    rows += [np.arange(0)] * (L - len(groups))
    tid = (next_tid + np.arange(L * T_pad, dtype=np.int64)
           ).reshape(L, T_pad).astype(np.int32)
    return Wave(op_kind, op_key, op_val, host, tid), rows, T_pad


def _merge_rows(wave: Wave, outs: WaveOut, rows: List[np.ndarray],
                n_real_waves: int) -> WaveOut:
    """Scatter the block's per-lane outcomes back to input-row order.
    Scalar stats are summed over the real (non-padding) waves only."""
    T = np.asarray(wave.tid).shape[0]
    O = np.asarray(wave.op_kind).shape[1]
    status = np.zeros(T, np.int32)
    s = np.zeros(T, np.int32)
    c = np.zeros(T, np.int32)
    read_key = np.full((T, O), -1, np.int32)
    read_cid = np.zeros((T, O), np.int32)
    write_key = np.full((T, O), -1, np.int32)
    write_cid = np.zeros((T, O), np.int32)
    for l, g in enumerate(rows):
        n = len(g)
        if not n:
            continue
        status[g] = outs.status[l, :n]
        s[g] = outs.s[l, :n]
        c[g] = outs.c[l, :n]
        read_key[g] = outs.read_key[l, :n]
        read_cid[g] = outs.read_cid[l, :n]
        write_key[g] = outs.write_key[l, :n]
        write_cid[g] = outs.write_cid[l, :n]
    stats = {f: np.asarray(getattr(outs, f))[:n_real_waves].sum()
             .astype(np.int32) for f in _STAT_FIELDS}
    return WaveOut(status=status, s=s, c=c, read_key=read_key,
                   read_cid=read_cid, write_key=write_key,
                   write_cid=write_cid, **stats)


def run_wave_planned(store, wave: Wave, clock, *, wave_idx0: int,
                     next_tid: int, sched: str = "postsi", n_nodes: int = 8,
                     mesh=None, kernels=None, watermark=None,
                     host_skew=None, gc_track: bool = True,
                     gc_block: bool = False,
                     max_lanes: Optional[int] = DEFAULT_MAX_LANES,
                     placement=None):
    """Execute one wave under the planned scheduler.

    Plans on the host (graph → lanes → pow2 block), relabels every row with
    a fresh contiguous tid from ``next_tid``, dispatches the block through
    ``engine.step_block`` (``engine.run_wave_on`` per lane; with ``mesh``, a
    ``NodeMesh`` or a ``ProcessMesh``, ``dist_engine.step_block_dist``),
    asserts zero aborts on planned lanes, and scatters outcomes back to
    input-row order.  ``wave`` may hold numpy arrays or tensors; ``store``
    is updated in place (on a ``ProcessMesh``: this rank's block).  The plan
    is made on the host from the wave alone, so every rank of a process
    mesh makes the same one, and a ``PlannerError`` raises on every rank.

    Returns ``(store', clock', PlannedWave)``; the caller advances its wave
    index by ``.waves_consumed`` and its tid counter by ``.tids_consumed``.
    """
    if sched not in SCHEDULERS:
        raise ValueError(f"base scheduler must be one of {SCHEDULERS}, "
                         f"got {sched!r}")
    check_mesh(mesh)
    wave = wave_to_numpy(wave)
    plan = plan_wave(wave.op_kind, wave.op_key, max_lanes=max_lanes)
    stacked, rows, T_pad = build_planned_block(wave, plan, next_tid)
    L = stacked.op_kind.shape[0]
    n_real = plan.n_lanes + (1 if plan.n_spilled else 0)
    kw = dict(sched=sched, n_nodes=n_nodes, host_skew=host_skew,
              watermark=watermark, gc_track=gc_track, gc_block=gc_block,
              kernels=kernels, placement=placement)
    if mesh is None:
        store, outs, clock = step_block(store, stacked, wave_idx0, clock,
                                        **kw)
    else:
        store, outs, clock = step_block_dist(store, stacked, wave_idx0,
                                             clock, mesh, **kw)
    # zero-abort invariant on planned lanes (spill wave exempt — it is the
    # optimistic path); gc_block / host_skew legitimately abort laned
    # writers for reasons the conflict graph cannot see, so only assert
    # when neither is in play
    if not gc_block and host_skew is None:
        for l in range(plan.n_lanes):
            n = len(rows[l])
            bad = np.flatnonzero(outs.status[l, :n] == ABORTED)
            if len(bad):
                raise PlannerError(
                    f"planned lane {l} aborted rows {bad.tolist()} "
                    f"(wave_idx0={wave_idx0}, sched={sched}) — lanes are "
                    f"conflict-free by construction, this is a planner bug")
    merged = _merge_rows(wave, outs, rows, n_real)
    exec_tid = np.zeros(len(np.asarray(wave.tid)), np.int32)
    for l, g in enumerate(rows):
        if len(g):
            exec_tid[g] = stacked.tid[l, :len(g)]
    pw = PlannedWave(merged=merged, exec_tid=exec_tid, plan=plan,
                     stacked=stacked, outs=outs, waves_consumed=L,
                     tids_consumed=L * T_pad, lane_waves=plan.n_lanes,
                     spill_waves=1 if plan.n_spilled else 0)
    return store, clock, pw


class PlanRunStats(NamedTuple):
    """``RunStats`` superset for the planned replay driver (duck-compatible
    with the engine's: same leading fields)."""
    committed: int
    aborted: int
    msgs_cross: int
    msgs_coord: int
    waits: int
    evicted_visible: int
    waves: int                # source waves (history length)
    dispatched_waves: int     # lane + spill waves actually executed
    lane_waves: int
    spilled_txns: int
    max_lanes_seen: int       # deepest conflict chain over the run
    plan_s: float             # host-side planning + packing seconds


def run_workload_planned(store, waves, sched: str = "postsi",
                         n_nodes: int = 8, mesh=None, kernels=None,
                         host_skew=None, gc_track: bool = False,
                         gc_block: bool = False,
                         max_lanes: Optional[int] = None, placement=None):
    """Replay driver for the planned scheduler (mirror of
    ``engine.run_workload``): plans and executes each wave in order.

    Returns ``(store, history, stats)``.  History rows carry the *input*
    waves' tids aligned with the merged outcomes, so commit-set comparisons
    against the optimistic drivers and the sequential oracle are row-exact;
    the verifiers only consult CIDs, which are the executed ones.  Default
    ``max_lanes=None`` never spills — every transaction commits."""
    clock = torch.ones((), dtype=torch.int32, device=store.device)
    wave_idx0 = 1
    waves = [wave_to_numpy(w) for w in waves]
    next_tid = 1 + max(int(w.tid.max()) for w in waves) if waves else 1
    history = []
    dispatched = lane_waves = spilled = deepest = 0
    plan_s = 0.0
    for wave in waves:
        t0 = time.perf_counter()
        store, clock, pw = run_wave_planned(
            store, wave, clock, wave_idx0=wave_idx0, next_tid=next_tid,
            sched=sched, n_nodes=n_nodes, mesh=mesh, kernels=kernels,
            host_skew=host_skew, gc_track=gc_track, gc_block=gc_block,
            max_lanes=max_lanes, placement=placement)
        plan_s += time.perf_counter() - t0
        wave_idx0 += pw.waves_consumed
        next_tid += pw.tids_consumed
        dispatched += pw.lane_waves + pw.spill_waves
        lane_waves += pw.lane_waves
        spilled += pw.plan.n_spilled
        deepest = max(deepest, pw.plan.n_lanes)
        history.append((np.asarray(wave.tid), pw.merged))
    rs = _stats_of(history)
    return store, history, PlanRunStats(
        **rs._asdict(), dispatched_waves=dispatched, lane_waves=lane_waves,
        spilled_txns=spilled, max_lanes_seen=deepest,
        plan_s=round(plan_s, 6))


def run_workload_any(store, waves, sched: str, **kw):
    """Registry dispatch over all seven schedulers: the six optimistic ones
    go through the fused replay driver, ``"planned"`` through the planner
    (``base_sched=`` selects its lane adjudicator, default postsi)."""
    if sched == PLANNED:
        base = kw.pop("base_sched", "postsi")
        return run_workload_planned(store, waves, sched=base, **kw)
    if sched not in SCHEDULERS:
        raise ValueError(f"unknown scheduler {sched!r}; "
                         f"registry: {ALL_SCHEDULERS}")
    from repro_torch.core.engine import run_workload_fused
    kw.pop("max_lanes", None)
    return run_workload_fused(store, waves, sched=sched, **kw)
