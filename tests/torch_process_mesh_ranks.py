"""Rank programs of the process-mesh tests (``test_torch_process_mesh*.py``).

Each function runs on one rank started by
``repro_torch.launch.mesh.spawn_ranks`` and returns numpy results for the
parent to hold against the JAX package, which only the parent imports:
this module imports torch, numpy and the port, never JAX.  The session
helpers take the service package (``repro.service`` or
``repro_torch.service``) as an argument, so the parent runs the same
sessions through either package.
"""
import os
import shutil
import time

import numpy as np
import torch

import repro_torch.core as tc
from repro_torch.core import workloads as tw
from repro_torch.core.workloads import poisson_arrivals
import repro_torch.service as ts

N, KPN, W, T = 4, 32, 2, 16
SKEW = np.array([0, 1, 2, 1], np.int32)
ROUTES = ("torch", "torch+fused")
DRIVERS = ("run_workload_fused_dist", "run_workload_dist")
PAD_KEYS = 102                # on 4 ranks: 104 rows, 2 of them pads


def smallbank(seed=7, n_waves=W, n_nodes=N, kpn=KPN):
    return tw.smallbank_waves(np.random.RandomState(seed), n_waves, T,
                              n_nodes, kpn, dist_frac=0.5, hot_frac=0.5,
                              hot_per_node=4, device="cpu")


def block_waves():
    return tc.stack_waves(tw.ycsb_waves(
        np.random.RandomState(0), 3, 4, N, 4, theta=0.9, read_frac=0.3,
        device="cpu"))


def _np_store(store):
    return tc.store_to_numpy(store)


def engine_cases(pmesh):
    """Every (scheduler, driver, route) of the engine on this rank, a
    padded store, a block against its synchronous twin, and the merged
    watermark.  Returns a dict keyed by case."""
    out = {}
    waves = smallbank()
    for sched in tc.SCHEDULERS:
        hs = SKEW if sched == "clocksi" else None
        for drv in DRIVERS:
            for route in ROUTES:
                store = tc.shard_store(
                    tc.make_store(N * KPN, 8, device="cpu"), pmesh)
                st, hist, stats = getattr(tc, drv)(
                    store, waves, pmesh, sched=sched, host_skew=hs,
                    gc_track=True, kernels=route)
                out[(sched, drv, route)] = (
                    hist, tuple(stats), _np_store(st),
                    _np_store(tc.gather_store(st, pmesh)))
    pad = tc.shard_store(tc.make_store(PAD_KEYS, 4, device="cpu"), pmesh)
    st, hist, stats = tc.run_workload_dist(
        pad, smallbank(3, 2, 2, PAD_KEYS // 2), pmesh, sched="postsi",
        n_nodes=2)
    out["padded"] = (hist, tuple(stats), pad.n_keys,
                     _np_store(tc.gather_store(st, pmesh)))

    fresh = lambda: tc.shard_store(tc.make_store(N * 4, 4, device="cpu"),
                                   pmesh)
    kw = dict(sched="postsi", n_nodes=4)
    s1, o1, c1 = tc.run_block_dist(fresh(), block_waves(), 1, 1, pmesh, **kw)
    s2, o2, c2 = tc.step_block_dist(fresh(), block_waves(), 1, 1, pmesh,
                                    **kw)
    out["block"] = (tuple(f.numpy() for f in o1), o2, int(c1), int(c2),
                    _np_store(tc.gather_store(s1, pmesh)),
                    _np_store(tc.gather_store(s2, pmesh)))

    # each rank gives only its own node's floor: the others' entries here
    # are garbage that must not reach the merge
    rng = np.random.RandomState(0)
    marks = []
    for _ in range(3):
        floors = rng.randint(0, 1000, N)
        mine = np.full(N, -10 ** 6)
        mine[pmesh.rank] = floors[pmesh.rank]
        marks.append((int(floors.min()), tc.mesh_watermark(pmesh, mine)))
    out["watermark"] = marks
    out["mesh"] = (pmesh.n_nodes, pmesh.rank, str(pmesh.device),
                   pmesh.backend)
    return out


def service_kwargs(pkg):
    return dict(n_keys=N * KPN, n_versions=8, T=16, sched="postsi",
                n_nodes=N, retry=pkg.RetryPolicy(max_attempts=6), seed=0)


def stream_inputs(pkg):
    arr = poisson_arrivals(np.random.RandomState(100), 0.9 * 16, 8)
    gen = pkg.smallbank_txn_gen(np.random.RandomState(200), N, KPN,
                                dist_frac=0.3, hot_frac=0.6, hot_per_node=3)
    return arr, gen


def fates(svc):
    return [(r.req_id, r.status, r.arrive_tick, r.commit_tick, r.attempts,
             tuple(r.tids), r.s, r.c, r.tenant, r.latency)
            for r in svc.requests]


WALL = ("wall_s", "txns_per_sec", "goodput_tps")


def report(svc):
    """A service's report as a dict, without the wall-clock fields."""
    rep = svc.report().as_dict()
    for k in WALL:
        rep.pop(k)
    return rep


def same_fields(got, want, msg):
    """Numpy store fields (by name) equal to a store of either package."""
    for f, a in got.items():
        np.testing.assert_array_equal(a, np.asarray(getattr(want, f)),
                                      err_msg=f"{msg} {f}")


def _session(svc):
    return (fates(svc), svc.history, report(svc), _np_store(svc.store),
            _np_store(tc.gather_store(svc.store, svc.mesh)), svc.verify())


def service_cases(pmesh):
    """``TxnService(mesh=pmesh)`` stepped and streamed (B=4, K=2) on both
    routes, and the watermark under pinned readers."""
    out = {}
    for route in ROUTES:
        for mode in ("step", "stream"):
            svc = ts.TxnService(**service_kwargs(ts), kernels=route,
                                mesh=pmesh)
            arr, gen = stream_inputs(ts)
            if mode == "step":
                svc.run_stream(arr, gen)
            else:
                svc.run_streaming(arr, gen, B=4, K=2)
            out[(route, mode)] = _session(svc)

    svc = ts.TxnService(**service_kwargs(ts), mesh=pmesh)
    marks = [svc._watermark()]
    svc.gc.clock = 40                          # floors are capped at it
    h = svc.gc.pin(3, node=2)                  # a reader every rank knows
    marks.append(svc._watermark())
    svc.gc.release(h)
    marks.append(svc._watermark())
    if pmesh.rank == 2:                        # a reader on its own node only
        svc.gc.pin(5, node=2)
    marks.append(svc._watermark())
    arr, gen = stream_inputs(ts)
    svc.run_streaming(arr, gen, B=4, K=2)      # pinned while it serves
    marks.append(svc._watermark())
    out["watermark"] = (marks, svc.verify(), svc.committed)
    return out


def fail_on_rank(pmesh, bad: int):
    """Rank ``bad`` raises; the others wait in a collective."""
    if pmesh.rank == bad:
        raise RuntimeError(f"rank {bad} fails on purpose")
    torch.distributed.barrier(group=pmesh.group)
    return pmesh.rank


def hang_on_rank(pmesh, bad: int):
    """Rank ``bad`` hangs; the others wait in a collective."""
    if pmesh.rank == bad:
        time.sleep(3600)
    torch.distributed.barrier(group=pmesh.group)
    return pmesh.rank


# ------------------------------------------------------------ durability
MODES = ("step", "stream")
DURABLE = dict(fsync_every=1, snapshot_every=2)
CRASH_AT = 3                   # drop_node at the 4th retire
RESUME = [4] * 4               # ticks a reattached service serves on


def serve(svc, pkg, mode, arrivals=None):
    """Phase-5-like stream on ``svc``: the step loop or ``run_streaming``
    (B=4, K=2)."""
    arr, gen = stream_inputs(pkg)
    arr = arr if arrivals is None else arrivals
    if mode == "step":
        return svc.run_stream(arr, gen)
    return svc.run_streaming(arr, gen, B=4, K=2)


def resume(svc, pkg):
    """What a reattached service serves on: ``RESUME`` ticks of YCSB."""
    gen = pkg.ycsb_txn_gen(np.random.RandomState(999), N, KPN, theta=0.6)
    return svc.run_streaming(RESUME, gen, B=2, K=2)


def recovered(st, pmesh):
    """A ``RecoveredState`` on this rank as numpy: the gathered store, the
    rank's block, the meta and the history."""
    return (_np_store(tc.gather_store(st.store, pmesh)), _np_store(st.store),
            (st.clock, st.wave_idx, st.gc_clock, st.next_tid, st.n_blocks,
             st.n_replayed, st.snapshot_seq, st.n_records),
            st.history,
            None if st.placement_map is None
            else (st.placement_map.slot, st.placement_map.owner))


def durability_cases(pmesh, root, jax_dir):
    """Durable sessions (step loop and B=4, K=2 on both routes) with the
    manager's counters, recoveries of a directory the JAX package wrote,
    a ``drop_node`` crash, a group-commit crash with a torn tail, and
    ``compressed_psum`` over the group."""
    from repro_torch.durability import DurabilityManager, recover
    from repro_torch.runtime.faults import (Fault, FaultSchedule,
                                            InjectedCrash)
    out = {}
    for route in ROUTES:
        for mode in MODES:
            mgr = DurabilityManager(os.path.join(root, f"{route}-{mode}"),
                                    **DURABLE)
            svc = ts.TxnService(**service_kwargs(ts), kernels=route,
                                mesh=pmesh, durability=mgr)
            serve(svc, ts, mode)
            mgr.close()
            out[("durable", route, mode)] = _session(svc) + (
                (mgr.seq, mgr.snapshots_taken, mgr._since_snap,
                 mgr.writer is not None),)
    for use_snapshot in (True, False):
        st = recover(jax_dir, mesh=pmesh, use_snapshot=use_snapshot)
        out[("jax dir", use_snapshot)] = recovered(st, pmesh)

    faults = FaultSchedule([Fault("drop_node", "retire", CRASH_AT)])
    mgr = DurabilityManager(os.path.join(root, "crash"), **DURABLE)
    svc = ts.TxnService(**service_kwargs(ts), kernels="torch", mesh=pmesh,
                        durability=mgr, faults=faults)
    try:
        serve(svc, ts, "stream")
        crashed = False
    except InjectedCrash:
        crashed = True
        mgr.crash()
        faults.mutilate_wal(mgr.wal_path, mgr.crash_synced_bytes,
                            pmesh=pmesh)
    out["crash"] = (crashed, mgr.seq)

    # group commit: a kill after the 5th log record with three records a
    # fsync, then a 40-byte tear of the unsynced tail by rank 0
    faults = FaultSchedule([Fault("kill", "post_log", 4),
                            Fault("torn_tail", "wal", 0, arg=40)])
    mgr = DurabilityManager(os.path.join(root, "group"), fsync_every=3)
    svc = ts.TxnService(**service_kwargs(ts), kernels="torch", mesh=pmesh,
                        durability=mgr, faults=faults)
    try:
        serve(svc, ts, "step")
        out["group"] = None
    except InjectedCrash:
        at_risk = mgr.crash()
        torn = faults.mutilate_wal(mgr.wal_path, mgr.crash_synced_bytes,
                                   pmesh=pmesh)
        out["group"] = (at_risk, mgr.crash_synced_bytes, torn, mgr.seq)
    out["psum"] = psum_cases(pmesh)
    return out


def recovery_cases(pmesh, root):
    """On a fresh spawn: every durable directory ``durability_cases`` left
    recovered from its snapshot and by full replay, the torn group-commit
    log, and the crashed directory recovered, reattached and served on."""
    from repro_torch.durability import DurabilityManager, recover
    out = {}
    for route in ROUTES:
        for mode in MODES:
            for use_snapshot in (True, False):
                st = recover(os.path.join(root, f"{route}-{mode}"),
                             mesh=pmesh, kernels=route,
                             use_snapshot=use_snapshot)
                out[(route, mode, use_snapshot)] = recovered(st, pmesh)
    out["group"] = recovered(recover(os.path.join(root, "group"),
                                     mesh=pmesh), pmesh)
    c_d = os.path.join(root, "crash")
    out["crash"] = recovered(recover(c_d, mesh=pmesh), pmesh)
    mgr = DurabilityManager(c_d, fsync_every=1)
    svc = ts.TxnService(**service_kwargs(ts), kernels="torch", mesh=pmesh,
                        durability=mgr)
    attached = _np_store(tc.gather_store(svc.store, pmesh))
    resume(svc, ts)
    mgr.close()
    out["served on"] = (attached,) + _session(svc)
    return out


# -------------------------------------------------------- compressed_psum
PSUM_SHAPES = ((64,), (3, 5, 7), (1,))


def psum_inputs(rank, shape, seed):
    """Rank ``rank``'s tensor and residual: seeded, each rank its own
    scale, a zero tensor on rank 1 of the last seed."""
    rng = np.random.RandomState(seed * 100 + rank)
    x = (rng.randn(*shape) * (rank + 1) ** 2).astype(np.float32)
    if seed == 2 and rank == 1:
        x[:] = 0
    res = (rng.randn(*shape) * 0.01).astype(np.float32)
    return x, res


def psum_cases(pmesh):
    """``compressed_psum`` of this rank's tensor over the group, with and
    without a residual: (x, residual, total, error) per case."""
    from repro_torch.optim.compress import compressed_psum
    out = []
    for seed, shape in enumerate(PSUM_SHAPES):
        x, res = psum_inputs(pmesh.rank, shape, seed)
        for r in (None, res):
            total, err = compressed_psum(
                torch.as_tensor(x),
                None if r is None else torch.as_tensor(r),
                group=pmesh.group)
            out.append((x, r, total.numpy(), err.numpy()))
    return out


# ------------------------------------------------------------- placement
P_KEYS, P_V = N * KPN, 4
MOVES = ((0, 10, 2), (40, 50, 0), (5, 20, 3), (100, 128, 1))
PAD_ROWS = 102                 # on 4 ranks: 104 rows
# a hand-made move on the padded store: sources and destinations in
# different ranks' blocks, the last source the last real row
PAD_MOVE = (np.array([3, 50, 77, 101], np.int32),
            np.array([100, 20, 60, 0], np.int32))
ELASTIC = dict(n_keys=P_KEYS, n_versions=8, T=16, O=2, sched="postsi",
               n_nodes=N, seed=0, replica_refresh=3, balancer=True)
ELASTIC_TICKS = [12] * 6


def random_store(n_rows, V, seed):
    """Random rings as numpy fields, seeded: empty slots, ties, any
    head."""
    rng = np.random.RandomState(seed)
    kv = (n_rows, V)
    f = {"val": rng.randint(-50, 50, kv), "tid": rng.randint(-1, 40, kv),
         "cid": rng.randint(0, 60, kv), "sid": rng.randint(0, 60, kv),
         "head": rng.randint(0, V, n_rows), "wave": rng.randint(0, 9, n_rows)}
    return {k: v.astype(np.int32) for k, v in f.items()}


def pad_record(mod):
    """``PAD_MOVE`` as a ``MoveRecord`` of ``mod`` (a placement package)."""
    old, new = PAD_MOVE
    return mod.MoveRecord(0, old.size, 0, np.arange(old.size, dtype=np.int32),
                          old, new)


def placed_waves(pkg_workloads, **extra):
    """The placed driver's micro waves (both packages)."""
    return pkg_workloads.micro_waves(
        np.random.RandomState(5), 3, 12, N, KPN, n_ops=3, read_ratio=0.5,
        dist_frac=0.5, hot_frac=0.6, hot_per_node=2, **extra)


def placed_map(mod):
    """The placed driver's layout: 2x headroom, keys [0, 6) on node 3."""
    pm = mod.PlacementMap(P_KEYS, N, headroom=2)
    pm.apply_record(pm.move(0, 6, 3))
    return pm


def elastic_service(pkg, placement_mod, hot, mode, durability=None,
                    ticks=ELASTIC_TICKS, move_at=None, gen_seed=31,
                    **extra):
    """The elastic YCSB session: a 2x-headroom map, the balancer, replicas
    of the hot keys, and after ``move_at`` ticks (default: half of them;
    ``False``: none) an explicit ``move_range(0, 8, 1)``.  A session whose
    ticks end at the move stops right after it, undrained.  ``mode``: the
    step loop or B=2, K=2."""
    svc = pkg.TxnService(**ELASTIC, **extra, durability=durability,
                         placement=placement_mod.PlacementMap(P_KEYS, N,
                                                              headroom=2),
                         replicas=hot)
    gen = pkg.ycsb_txn_gen(np.random.RandomState(gen_seed), N, KPN,
                           theta=0.99, read_frac=0.7, n_ops=2)

    def run(part, drain):
        if mode == "step":
            return svc.run_stream(part, gen, drain=drain)
        return svc.run_streaming(part, gen, B=2, K=2, drain=drain)
    if move_at is False:
        run(ticks, drain=True)
        return svc
    move_at = len(ticks) // 2 if move_at is None else move_at
    run(ticks[:move_at], drain=False)
    svc.move_range(0, 8, 1)
    if ticks[move_at:]:
        run(ticks[move_at:], drain=True)
    return svc


def elastic_fates(svc):
    return [(r.req_id, r.status, r.commit_tick, r.attempts, tuple(r.tids),
             r.s, r.c, r.replica) for r in svc.requests]


def elastic_session(svc, pmesh):
    """An elastic session on this rank: fates, history, report without
    the wall-clock fields, the gathered store in key order, the map."""
    import repro_torch.placement as tp
    whole = tc.gather_store(svc.store, pmesh)
    return (elastic_fates(svc), svc.history, report(svc),
            _np_store(tp.logical_store(whole, svc.placement)),
            (svc.placement.slot.copy(), svc.placement.owner.copy()),
            svc.verify())


def placement_cases(pmesh, root):
    """``apply_move`` (a random placed store, a padded store), a placed
    driver call, the elastic service on both routes in both modes, and a
    durable elastic session crashed right after its explicit move,
    recovered and taken up again."""
    import repro_torch.placement as tp
    from repro_torch.durability import DurabilityManager, recover
    out = {}
    pm = tp.PlacementMap(P_KEYS, N, headroom=2)
    store = tc.shard_store(tc.store_from_numpy(
        random_store(pm.n_slots, P_V, 11), "cpu"), pmesh)
    wholes = []
    for lo, hi, dst in MOVES:
        rec = pm.move(lo, hi, dst)
        tp.apply_move(store, rec, mesh=pmesh)
        pm.apply_record(rec)
        wholes.append((rec.as_dict(),
                       _np_store(tc.gather_store(store, pmesh))))
    out["moves"] = (wholes, _np_store(store))
    pad = tc.shard_store(tc.store_from_numpy(
        random_store(PAD_ROWS, P_V, 12), "cpu"), pmesh)
    tp.apply_move(pad, pad_record(tp), mesh=pmesh)
    out["padded"] = (pad.n_keys, _np_store(tc.gather_store(pad, pmesh)))

    waves = placed_waves(tw, device="cpu")
    for route in ROUTES:
        for drv in DRIVERS:
            pmap = placed_map(tp)
            store = tc.shard_store(tp.physical_store(
                tc.make_store(P_KEYS, 8, device="cpu"), pmap), pmesh,
                pmap.n_slots)
            st, hist, stats = getattr(tc, drv)(
                store, waves, pmesh, sched="postsi", gc_track=True,
                kernels=route, placement=pmap.device_arrays("cpu"))
            out[("placed", route, drv)] = (
                hist, tuple(stats), _np_store(tc.gather_store(st, pmesh)))

    hot = tw.zipf_hot_keys(N, KPN, 0.99)
    for route in ROUTES:
        for mode in MODES:
            svc = elastic_service(ts, tp, hot, mode, mesh=pmesh,
                                  kernels=route)
            out[("elastic", route, mode)] = elastic_session(svc, pmesh)

    # durable: crash right after the REC_MOVE record, recover, take it up
    d = os.path.join(root, "elastic")
    mgr = DurabilityManager(d, **DURABLE)
    svc = elastic_service(ts, tp, hot, "step", durability=mgr, mesh=pmesh,
                          kernels="torch", ticks=ELASTIC_TICKS[:3],
                          move_at=3)
    mgr.crash()
    live = (_np_store(tc.gather_store(svc.store, pmesh)),
            int(svc.clock), svc.wave_idx, svc.gc.clock, svc.former.next_tid)
    recs = [recovered(recover(d, mesh=pmesh, use_snapshot=u), pmesh)
            for u in (True, False)]
    if pmesh.rank == 0:
        # the crashed log, kept as it is, and a copy the JAX package takes
        # up as the ranks take up ``d``
        for copy in ("-crashed", "-jax"):
            shutil.copytree(d, d + copy)
    torch.distributed.barrier(group=pmesh.host_group)
    mgr = DurabilityManager(d, **DURABLE)
    svc = elastic_service(ts, tp, hot, "step", durability=mgr, mesh=pmesh,
                          kernels="torch", ticks=[12] * 2, move_at=False,
                          gen_seed=32)
    mgr.close()
    out["durable"] = (live, recs, elastic_session(svc, pmesh))
    return out


# --------------------------------------------------------------- planner
PLANNER_SESSIONS = (("hybrid", "step", 6, 24), ("hybrid", "stream", 8, 24),
                    ("planned", "step", 7, 12))


def mixed_workload(pkg_workloads, seed, **extra):
    """Hot YCSB waves and RAW/WAR chains (the planner tests' workload)."""
    rng = np.random.RandomState(seed)
    waves = pkg_workloads.ycsb_waves(rng, 2, 12, N, KPN, theta=0.95,
                                     read_frac=0.3, dist_frac=0.2, n_ops=4,
                                     **extra)
    waves += pkg_workloads.chain_waves(rng, 2, 12, N, KPN, chain_len=4,
                                       kind="mixed", tid0=1 + 2 * 12,
                                       **extra)
    return waves


def hot_service(pkg, planner, mode, seed, n_ticks, **extra):
    """A planned or hybrid service on YCSB theta=0.99, 10% reads."""
    svc = pkg.TxnService(n_keys=P_KEYS, T=16, O=4, sched="postsi",
                         n_nodes=N, planner=planner, **extra)
    gen = pkg.ycsb_txn_gen(np.random.RandomState(seed), N, KPN, theta=0.99,
                           read_frac=0.1, n_ops=4)
    if mode == "step":
        svc.run_stream([8] * n_ticks, gen)
    else:
        svc.run_streaming([8] * n_ticks, gen, B=2, K=2)
    return svc


def planner_cases(pmesh):
    """``run_wave_planned`` on a hot wave, ``run_workload_planned`` on
    both routes, and planned / hybrid services."""
    from repro_torch.planner import run_wave_planned, run_workload_planned
    out = {}
    (wave,) = tw.ycsb_waves(np.random.RandomState(3), 1, 16, N, KPN,
                            theta=0.95, read_frac=0.3, device="cpu")
    store = tc.shard_store(tc.make_store(P_KEYS, 8, device="cpu"), pmesh)
    store, clock, pw = run_wave_planned(store, wave, 1, wave_idx0=1,
                                        next_tid=100, n_nodes=N, mesh=pmesh)
    out["wave"] = (pw.merged, pw.exec_tid, pw.stacked, pw.outs,
                   pw.waves_consumed, pw.tids_consumed, int(clock),
                   _np_store(tc.gather_store(store, pmesh)))
    for route in ROUTES:
        store = tc.shard_store(tc.make_store(P_KEYS, 8, device="cpu"), pmesh)
        st, hist, stats = run_workload_planned(
            store, mixed_workload(tw, 1, device="cpu"), n_nodes=N,
            mesh=pmesh, kernels=route)
        out[("workload", route)] = (hist, tuple(stats._replace(plan_s=0.0)),
                                    _np_store(tc.gather_store(st, pmesh)))
    for planner, mode, seed, n_ticks in PLANNER_SESSIONS:
        svc = hot_service(ts, planner, mode, seed, n_ticks, mesh=pmesh,
                          kernels="torch")
        out[("service", planner, mode)] = _session(svc)
    return out


def placement_planner_cases(pmesh, root):
    """``placement_cases`` and ``planner_cases`` in one spawn."""
    return {**placement_cases(pmesh, root), **planner_cases(pmesh)}
