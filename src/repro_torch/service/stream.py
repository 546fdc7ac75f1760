"""Pipelined streaming service plane (port of ``repro.service.stream``,
single device).

``TxnService.step`` syncs the host after every wave: form -> dispatch ->
wait for the device -> route outcomes.  At service wave sizes the dispatch
and the host round trip outweigh the wave's own device time, so the step
loop measures coordination, not the concurrency-control rules.  This
module amortizes it: waves are batched into *blocks*, and block forming is
pipelined against block execution.

    arrivals ─> WaveFormer ─> [wave,wave,..B] ─> run_block (B waves queued
                   ^            block buffer      on the device's stream)
                   │                                   │  ≤ K-1 blocks
                   │                                   ▼  dispatched, unsynced
                   └──── RetryPolicy ◄──── retire: .cpu() waits, routes
                                           per-wave outcomes

Two levers, both bounded:

* **B — block size.**  Up to B formed ``[T, O]`` waves are staged as one
  block (``engine.stage_block``: one page-locked buffer, one asynchronous
  copy) and queued back to back (``engine.run_block``).  A partially
  filled buffer ships as power-of-two-sized blocks (3 waves -> [2]+[1]),
  never as NOP filler, so every dispatched wave carries real work.
* **K — pipeline depth.**  A dispatched block is not synced until K-1
  further blocks have been dispatched: CUDA launches are asynchronous, so
  the host forms (and dispatches, chaining on the store and clock the
  device has not written yet) the next blocks while the device runs.  "K
  in flight" means K dispatched-but-unretired blocks on one stream; the
  device still runs them in order, and the overlap is host-side forming
  and routing against device compute.  It holds only because the dispatch
  half never waits on the device: the retire half is the one place the
  host waits (``_retire_one``: one ``.cpu()`` a ``WaveOut`` leaf and
  ``int(clock)``).

With ``B=1, K=1`` the plane degenerates to the synchronous step loop and
is bit-identical to it.  With B>1 retries route at block granularity (an
abort in wave j of a block re-enters only after the whole block retires).
Every driver decision depends on host state only (the former, the retired
outcomes, the sizer), so a run is bit-identical to the JAX package's
driver on the same stream.

**Contention-adaptive wave sizing** (paper §V-D): ``AdaptiveWaveSizer``
regulates the wave size T (and optionally B) from the trailing abort rate
with bounded AIMD — additive increase by one ``quantum`` rung when the
stream is calm, halving when aborts exceed the high-water threshold — on
the ladder of quantum multiples in ``[t_min, t_max]``.

**Durability and fault injection** sit at the reference's seams: with a
``DurabilityManager`` attached, a retired block is logged once, after its
outcome copy and before any outcome is acknowledged (the block's inputs
come from its page-locked staging buffer, ``engine.staged_inputs``, never
back from the device, so the dispatch still waits on nothing), and a
snapshot is taken when the pipeline is empty; a ``FaultSchedule`` fires at
dispatch, at retire and after the log record, and may hold the oldest
block for a few tick-level retires (``delay_retire``).

On a process mesh every rank runs this driver on the same stream: the
blocks it dispatches are the same on every rank, a retired block is
logged by rank 0 and acknowledged on no rank before that, and a move or
a planned tick happens at the same boundary everywhere.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Deque, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.commit_phase import ABORTED
from repro_torch.core.engine import StagedBlock, Wave, WaveOut, \
    staged_inputs

from .former import fold_counts


def _ladder_snap(T: int, quantum: int, t_min: int, t_max: int) -> int:
    """Snap T to the bounded ladder {multiples of quantum} ∩ [t_min, t_max],
    with t_max itself always a rung — an off-quantum ceiling (e.g. T0=12 on
    a quantum-8 ladder) must stay reachable or additive increase could
    never restore the configured wave size."""
    T = max(t_min, min(t_max, T))
    if T == t_max:
        return t_max
    return max(t_min, (T // quantum) * quantum)


class AdaptiveWaveSizer:
    """Bounded-AIMD wave sizing from the trailing abort rate.

    Observes per-wave (executed, aborted) counts; once ``window`` executions
    accumulate it compares the trailing abort rate against two thresholds:

    * rate > ``high``  ->  multiplicative decrease: T <- max(t_min, T/2),
      snapped to the quantum ladder — smaller waves put fewer concurrent
      writers on the hot keys (fewer conflicts per wave, fewer aborts,
      less retry re-traffic);
    * rate < ``low``   ->  additive increase: T <- min(t_max, T + quantum) —
      probe back toward full parallelism one rung at a time.

    The trailing window resets after every adjustment so decisions are made
    on post-change evidence only.  With ``adapt_B=True`` the block size
    rides the same signal on a halving ladder in [b_min, B0]: high abort
    rates shorten the pipeline's feedback delay (retries see fresher store
    state), calm streams restore full blocks.
    """

    def __init__(self, T0: int, B0: int = 1, t_min: int = 8,
                 t_max: Optional[int] = None, high: float = 0.35,
                 low: float = 0.10, window: int = 128,
                 quantum: Optional[int] = None, adapt_B: bool = False,
                 b_min: int = 1):
        if not 0.0 <= low < high <= 1.0:
            raise ValueError(f"need 0 <= low < high <= 1, got {low}/{high}")
        self.t_min = t_min
        self.t_max = T0 if t_max is None else t_max
        if self.t_max < self.t_min:
            raise ValueError(f"empty ladder: t_max={self.t_max} < "
                             f"t_min={self.t_min}")
        self.quantum = t_min if quantum is None else quantum
        self.high, self.low, self.window = high, low, window
        self.adapt_B, self.b_min = adapt_B, b_min
        self.B0 = B0
        self.T = _ladder_snap(T0, self.quantum, self.t_min, self.t_max)
        self.B = B0
        self._exec = 0
        self._abort = 0
        self.decreases = 0     # MD events (contention reactions)
        self.increases = 0     # AI events (recovery probes)

    def observe(self, executed: int, aborted: int) -> None:
        """Fold one retired wave's counts in; adjust at window boundaries."""
        self._exec += executed
        self._abort += aborted
        if self._exec < self.window:
            return
        rate = self._abort / self._exec
        if rate > self.high:
            self.T = _ladder_snap(self.T // 2, self.quantum, self.t_min,
                                  self.t_max)
            if self.adapt_B:
                self.B = max(self.b_min, self.B // 2)
            self.decreases += 1
        elif rate < self.low:
            self.T = _ladder_snap(self.T + self.quantum, self.quantum,
                                  self.t_min, self.t_max)
            if self.adapt_B:
                self.B = min(self.B0, max(self.b_min, self.B * 2))
            self.increases += 1
        else:
            # deadband: stay put, but shrink the counters back to one
            # window's worth so the rate stays *trailing* — an unbounded
            # cumulative average would react to a later contention spike
            # thousands of executions late instead of within ~one window
            scale = self.window / self._exec
            self._abort = int(round(self._abort * scale))
            self._exec = self.window
            return
        self._exec = self._abort = 0    # decide on post-adjustment data only

    def abort_rate(self) -> float:
        """Trailing abort rate of the (possibly partial) current window."""
        return self._abort / self._exec if self._exec else 0.0


@dataclasses.dataclass
class _Block:
    """One dispatched-but-unretired block: device results + host metadata."""
    outs: WaveOut                               # device, leading [B] axis
    clock: torch.Tensor                         # device scalar after block
    waves: List[Tuple[np.ndarray, list]]        # per wave: (tids, slots)
    staged: StagedBlock                         # its inputs, kept to retire
    wave_idx0: int                              # wave-index origin at dispatch
    wm: object = None                           # GC watermark at dispatch


class StreamingDriver:
    """K-blocks-in-flight pump between a ``TxnService`` and the block
    engine.  One instance per ``run_streaming`` session; the service owns
    all request/GC/latency state, the driver owns only the pipeline."""

    def __init__(self, svc, B: int = 4, K: int = 2,
                 sizer: Optional[AdaptiveWaveSizer] = None):
        if B < 1 or K < 1:
            raise ValueError(f"need B >= 1 and K >= 1, got B={B} K={K}")
        self.svc = svc
        self.B, self.K = B, K
        self.sizer = sizer
        self._buf: List[Tuple[Wave, list]] = []   # block under formation
        self._buf_T: Optional[int] = None         # its wave size (fixed/blk)
        self._buf_B: Optional[int] = None         # its block size (fixed/blk)
        self._inflight: Deque[_Block] = deque()

    # ---------------------------------------------------------------- pump
    def tick(self) -> None:
        """One scheduler tick: form up to B waves into the open block (the
        step loop forms exactly one per tick; the pipeline may catch up on
        backlog), dispatch when it reaches B.  On an arrival gap the partial
        block is held while the device is busy (retiring one finished block
        instead, which feeds retries back to the former) and shipped only
        when the pipeline is empty — the device never idles behind a
        hoarded buffer, and no tick ships NOP filler.

        With a hybrid planner attached and in planned mode, the pipeline is
        first drained (planned lanes must see every earlier wave's commits,
        and routed retries re-enter before the planner forms) and the tick
        is served synchronously through the service's planned step path;
        when the policy drops back to optimistic the pipelined path resumes
        on the next tick."""
        svc = self.svc
        if svc.planner is not None and svc.planner.planned:
            self.flush()
            svc.step()
            return
        svc.tick += 1
        t0 = time.perf_counter()
        if self._buf_T is None:            # block boundary: propose sizes
            self._buf_T = self.sizer.T if self.sizer else svc.T
            self._buf_B = (self.sizer.B if self.sizer and self.sizer.adapt_B
                           else self.B)    # sizer owns B only when adapting
        formed_n = 0
        while len(self._buf) < self._buf_B:
            if formed_n and svc.former.backlog(svc.tick) < self._buf_T:
                break              # catch-up waves beyond the first must be
                                   # full-T: thin waves waste device slots
            formed = svc.former.form(svc.tick, T=self._buf_T)
            if formed is None:
                break
            self._buf.append(formed)
            formed_n += 1
        if len(self._buf) == self._buf_B:
            self._dispatch()               # full block: ship it
        elif self._buf:
            if self._inflight:
                # hold the partial; feed retries (tick-level retire: the
                # one place an injected delay_retire may stall)
                self._retire_one(allow_delay=True)
            else:
                self._dispatch()           # device idle: ship what we have
        else:
            self._buf_T = self._buf_B = None   # no open block: re-propose
            svc.idle_ticks += 1
            if self._inflight:             # nothing to form: drain the pipe
                self._retire_one(allow_delay=True)
        svc._wall_s += time.perf_counter() - t0

    def flush(self) -> None:
        """Ship the partial block and sync every in-flight block."""
        t0 = time.perf_counter()
        if self._buf:
            self._dispatch(retire_to=0)
        while self._inflight:
            self._retire_one()
        self.svc._wall_s += time.perf_counter() - t0

    def drain(self, max_ticks: Optional[int] = None) -> int:
        """Tick until no request is pending anywhere (former, open block,
        pipeline) or the safety cap; returns ticks consumed."""
        svc = self.svc
        if max_ticks is None:
            max_ticks = (svc.retry.worst_case_ticks()
                         + svc.former.pending() // max(svc.T, 1)
                         + self.K * self.B + 16)
        n = 0
        while (svc.former.pending() or self._buf or self._inflight) \
                and n < max_ticks:
            self.tick()
            n += 1
        self.flush()
        return n

    # ------------------------------------------------------------ internals
    def _dispatch(self, retire_to: Optional[int] = None) -> None:
        """Ship the buffered waves as power-of-two-sized blocks, largest
        first (a full buffer with power-of-two B is exactly one block; a
        partial one splits, e.g. 3 waves -> [2]+[1]), so every dispatched
        wave carries real work.  Then retire until at most ``retire_to``
        (default K-1) blocks remain unsynced."""
        svc = self.svc
        while self._buf:
            b = 1 << (len(self._buf).bit_length() - 1)   # max pow2 <= len
            chunk, self._buf = self._buf[:b], self._buf[b:]
            meta = [(np.asarray(w.tid), slots) for w, slots in chunk]
            outs, clock, staged = svc._run_block([w for w, _ in chunk])
            wave_idx0, wm = svc._last_dispatch
            if svc.faults is not None:
                svc.faults.at_dispatch(svc)   # kill: launched, not durable
            self._inflight.append(
                _Block(outs, clock, meta, staged, wave_idx0, wm))
            svc.blocks += 1
        self._buf_T = self._buf_B = None
        limit = (self.K - 1) if retire_to is None else retire_to
        while len(self._inflight) > limit:
            self._retire_one()

    def _retire_one(self, allow_delay: bool = False) -> None:
        """Sync the oldest in-flight block (the pipeline's only blocking
        point), WAL-log it when a durability manager is attached
        (durable-before-ack), then route its per-wave outcomes through the
        service.  ``allow_delay`` marks tick-level calls — the only ones a
        ``delay_retire`` fault may skip; the dispatch loop's K-limit drain
        always completes, so an armed delay stalls the pipeline but can
        never deadlock it."""
        svc = self.svc
        if allow_delay and svc.faults is not None \
                and svc.faults.delay_retire(svc):
            return                       # injected straggler: hold the block
        if svc.faults is not None:
            svc.faults.at_retire(svc)    # kill: computed, never logged/acked
        blk = self._inflight.popleft()
        outs = WaveOut(*(leaf.cpu().numpy() for leaf in blk.outs))  # waits
        clock = int(blk.clock)
        per_wave = []
        for j, (tids, slots) in enumerate(blk.waves):
            out_j = WaveOut(*(leaf[j] for leaf in outs))
            svc.gc.observe(out_j, clock)
            svc.history.append((tids, out_j))
            per_wave.append((out_j, slots))
        if svc.durability is not None:
            # retire point = durability boundary: one record per retired
            # block, appended before any outcome is acked; the fold
            # multiplicities ride along (computed here, before _route
            # clears them)
            T = blk.staged.wave.op_kind.shape[1]
            fold = np.stack([fold_counts(slots, T)
                             for _, slots in blk.waves])
            svc.durability.log_block(staged_inputs(blk.staged),
                                     blk.wave_idx0, blk.wm, outs, clock,
                                     svc.gc.clock, fold=fold)
            if svc.faults is not None:
                svc.faults.post_log(svc)   # kill: durable-but-unacked window
        for out_j, slots in per_wave:
            svc._route(out_j, slots)
            n_abort = int((out_j.status[:len(slots)] == ABORTED).sum())
            if self.sizer is not None:
                self.sizer.observe(len(slots), n_abort)
            if svc.planner is not None:
                svc.planner.observe_optimistic(len(slots), n_abort)
        if svc.durability is not None:
            svc.durability.maybe_snapshot(
                svc, pipeline_empty=not self._inflight and not self._buf)
