"""Rank programs of the process-mesh tests (``test_torch_process_mesh*.py``).

Each function runs on one rank started by
``repro_torch.launch.mesh.spawn_ranks`` and returns numpy results for the
parent to hold against the JAX package, which only the parent imports:
this module imports torch, numpy and the port, never JAX.
"""
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


def _session(svc):
    rep = svc.report().as_dict()
    for k in WALL:
        rep.pop(k)
    return (fates(svc), svc.history, rep, _np_store(svc.store),
            _np_store(tc.gather_store(svc.store, svc.mesh)), svc.verify())


def service_cases(pmesh):
    """``TxnService(mesh=pmesh)`` stepped and streamed (B=4, K=2) on both
    routes, the watermark under pinned readers, and the options a
    ProcessMesh refuses."""
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
    out["refused"] = refused(pmesh)
    return out


def refused(pmesh):
    """The ValueError messages of every option a ProcessMesh refuses."""
    import repro_torch.placement as tp
    from repro_torch.durability import DurabilityManager, recover
    from repro_torch.planner.sched import run_wave_planned
    msgs = {}

    def expect(name, fn):
        try:
            fn()
        except ValueError as e:
            msgs[name] = str(e)
        else:
            msgs[name] = None
    kw = service_kwargs(ts)
    pm = lambda: tp.PlacementMap(N * KPN, N, headroom=2)
    expect("durability", lambda: ts.TxnService(
        **kw, mesh=pmesh, durability=DurabilityManager(".", fsync_every=1)))
    expect("placement", lambda: ts.TxnService(**kw, mesh=pmesh,
                                              placement=pm()))
    expect("replicas", lambda: ts.TxnService(**kw, mesh=pmesh,
                                             replicas=[0, 1]))
    expect("planner", lambda: ts.TxnService(**kw, mesh=pmesh,
                                            planner="planned"))
    svc = ts.TxnService(**kw, mesh=pmesh)
    expect("move_range", lambda: svc.move_range(0, 4, 1))
    store = tc.shard_store(tc.make_store(N * KPN, 8, device="cpu"), pmesh)
    (wave,) = smallbank(n_waves=1)
    expect("run_wave_planned", lambda: run_wave_planned(
        store, wave, 1, wave_idx0=1, next_tid=1, mesh=pmesh))
    expect("apply_move", lambda: tp.apply_move(
        store, pm().move(0, 4, 1), mesh=pmesh))
    expect("recover", lambda: recover("unused", mesh=pmesh))
    expect("driver placement", lambda: tc.run_wave_dist(
        store, wave, 1, 1, pmesh, placement=pm().device_arrays("cpu")))
    return msgs


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
