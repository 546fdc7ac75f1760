"""The port's elastic placement plane held against the JAX package's.

Case for case the tests of ``tests/test_placement.py``, each run through
both packages on the same seeded inputs, with exact equality (everything
on this path is int32 or a host counter):

* the map's tables, ranges, move records and capacity errors, and
  ``validate_routing`` on corrupted tables;
* the physical/logical store round trip, with moved ranges;
* any placement (identity, headroom, a pre-moved layout) bit-identical to
  the static run and to the JAX run, per scheduler and read-phase route;
* a live move mid-workload: the placed store after the same moves equals
  the JAX store row for row;
* ``LoadBalancer.plan`` equal to the JAX plan on the same counters
  (convergence, the fall-through past a full coldest node, committed-txn
  counting);
* replicas: staleness, never serving writers, cold or negative keys, the
  negative-key submit on every route;
* the elastic service (balancer moves, replicas) equal to the JAX elastic
  service per request and per wave, and its committed set equal to the
  static one's; the same under the planner and the streaming driver;
* the ``-1`` / last-row corner: a wave with live ops and padding on key
  ``-1`` and past the last key, before and after a move that fills the
  last physical row.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.core as jc
from repro.core import workloads as jw
import repro.placement as jp
import repro.service as js
import repro_torch.core as tc
import repro_torch.placement as tp
import repro_torch.service as ts
from repro_torch.core import workloads as tw
from repro_torch.core.commit_phase import NOP, READ, RMW, WRITE

from test_torch_engine import assert_same_history, assert_same_store

N_KEYS, N_NODES, V = 64, 4, 8
ROUTES = ["", "+fused"]


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """The plain commit loop runs many small tensor ops a step; on one
    intra-op thread they do not stall when the other test workers load
    every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same_map(tpm, jpm):
    assert (tpm.n_keys, tpm.n_nodes, tpm.capacity, tpm.n_slots) == \
        (jpm.n_keys, jpm.n_nodes, jpm.capacity, jpm.n_slots)
    np.testing.assert_array_equal(tpm.owner, jpm.owner)
    np.testing.assert_array_equal(tpm.slot, jpm.slot)
    assert tpm.ranges() == jpm.ranges()
    assert [tpm.free_slots(n) for n in range(tpm.n_nodes)] == \
        [jpm.free_slots(n) for n in range(jpm.n_nodes)]


def _same_record(a, b):
    assert (a.lo, a.hi, a.dst) == (b.lo, b.hi, b.dst)
    for f in ("keys", "old_slots", "new_slots"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype == np.int32, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    assert a.as_dict() == b.as_dict()


def _both_maps(headroom=2, moves=()):
    """The same map in both packages, after the same moves."""
    tpm = tp.PlacementMap(N_KEYS, N_NODES, headroom=headroom)
    jpm = jp.PlacementMap(N_KEYS, N_NODES, headroom=headroom)
    for lo, hi, dst in moves:
        tr, jr = tpm.move(lo, hi, dst), jpm.move(lo, hi, dst)
        _same_record(tr, jr)
        tpm.apply_record(tr)
        jpm.apply_record(jr)
    _same_map(tpm, jpm)
    return tpm, jpm


# --------------------------------------------------------------- map basics

def test_placement_map_invariants_and_ranges():
    tpm, jpm = _both_maps()
    tpm.validate()
    assert tpm.n_slots == N_KEYS * 2
    assert tpm.ranges() == [(0, 16, 0), (16, 32, 1), (32, 48, 2),
                            (48, 64, 3)]
    assert tpm.owner_of(0) == 0 and tpm.owner_of(63) == 3
    pm1 = tp.PlacementMap(N_KEYS, N_NODES, headroom=1)
    np.testing.assert_array_equal(pm1.slot, np.arange(N_KEYS))
    tr, jr = tpm.move(0, 8, 3), jpm.move(0, 8, 3)
    _same_record(tr, jr)
    assert tr.keys.size == 8
    tpm.apply_record(tr)
    jpm.apply_record(jr)
    tpm.validate()
    _same_map(tpm, jpm)
    assert tpm.ranges()[0] == (0, 8, 3)
    assert tpm.to_config() == jpm.to_config()
    pm2 = tp.PlacementMap.from_config(jpm.to_config())
    assert pm2.capacity == jpm.capacity and pm2.n_keys == jpm.n_keys
    # a record crosses in both directions through its dict form
    _same_record(tp.MoveRecord.from_dict(jr.as_dict()), jr)
    # the port's map in the JAX map's state, moved ranges included
    same = tp.PlacementMap.from_arrays(jpm.n_keys, jpm.n_nodes,
                                       jpm.capacity, jpm.owner, jpm.slot)
    _same_map(same, jpm)
    _same_record(same.move(16, 24, 0), jpm.move(16, 24, 0))


def test_device_arrays_cached_until_a_move():
    pm = tp.PlacementMap(N_KEYS, N_NODES, headroom=2)
    a = pm.device_arrays("cpu")
    assert a is pm.device_arrays("cpu")
    assert a.slot.dtype == a.owner.dtype == torch.int32
    np.testing.assert_array_equal(a.slot.numpy(), pm.slot)
    pm.apply_record(pm.move(0, 4, 2))
    b = pm.device_arrays("cpu")
    assert b is not a and b is pm.device_arrays("cpu")
    np.testing.assert_array_equal(b.slot.numpy(), pm.slot)
    np.testing.assert_array_equal(b.owner.numpy(), pm.owner)
    assert (a.slot[:4] < pm.capacity).all()     # the old copy is untouched


def test_placement_map_capacity_exhaustion_is_loud():
    pm = tp.PlacementMap(8, 2, headroom=1)       # 4 slots per node, all used
    with pytest.raises(tp.PlacementError):
        pm.move(0, 2, 1)
    with pytest.raises(jp.PlacementError):
        jp.PlacementMap(8, 2, headroom=1).move(0, 2, 1)


def test_validate_routing_detects_corruption():
    pm = tp.PlacementMap(N_KEYS, N_NODES, headroom=1)
    p = pm.device_arrays("cpu")
    tp.validate_routing(pm.n_slots, N_NODES, p)
    tp.validate_routing(pm.n_slots, N_NODES, p,
                        op_key=torch.tensor([[0, 5], [-1, 70]]))
    bad_slot = p.slot.clone()
    bad_slot[0] = pm.n_slots - 1
    bad_slot[N_KEYS - 1] = 0
    for check, err in ((tp.validate_routing, tp.PlacementError),
                       (jp.validate_routing, jp.PlacementError)):
        with pytest.raises(err, match="mis-routed"):
            check(pm.n_slots, N_NODES,
                  type(p)(p.owner.numpy(), bad_slot.numpy()))
    dup = p.slot.clone()
    dup[1] = dup[0]
    with pytest.raises(tp.PlacementError, match="duplicate"):
        tp.validate_routing(pm.n_slots, N_NODES, type(p)(p.owner, dup))
    far = p.slot.clone()
    far[3] = pm.n_slots
    with pytest.raises(tp.PlacementError, match="out of range"):
        tp.validate_routing(pm.n_slots, N_NODES, type(p)(p.owner, far))


def test_physical_logical_store_roundtrip():
    tpm, jpm = _both_maps(moves=[(4, 12, 2)])
    store = tc.make_store(N_KEYS, V, device="cpu")
    phys = tp.physical_store(store, tpm)
    assert phys.head.shape[0] == tpm.n_slots
    assert_same_store(phys, jp.physical_store(jc.make_store(N_KEYS, V), jpm))
    occupied = np.zeros(tpm.n_slots, bool)
    occupied[tpm.slot] = True
    assert (phys.tid.numpy()[~occupied] == -1).all()
    back = tp.logical_store(phys, tpm)
    for a, b in zip(back, store):
        assert torch.equal(a, b)
    assert tp.logical_store(store, None) is store
    with pytest.raises(ValueError):
        tp.physical_store(phys, tpm)


# ------------------------------------------------- engine placement-invariance

@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("sched", tc.SCHEDULERS)
def test_any_placement_bit_identical_per_sched(sched, route):
    """A pre-moved layout reproduces the static run exactly, history and
    logical store, and equals the JAX run under the same layout row for
    row."""
    kw = dict(n_ops=3, read_ratio=0.5, dist_frac=0.5, hot_frac=0.6,
              hot_per_node=2)
    jwaves = jw.micro_waves(np.random.RandomState(5), 3, 12, N_NODES,
                            N_KEYS // N_NODES, **kw)
    twaves = tw.micro_waves(np.random.RandomState(5), 3, 12, N_NODES,
                            N_KEYS // N_NODES, device="cpu", **kw)
    hs = np.array([0, 1, 0, 2], np.int32) if sched == "clocksi" else None
    run = dict(sched=sched, n_nodes=N_NODES, host_skew=hs, gc_track=True)
    ref_store, ref_h, ref_s = tc.run_workload(
        tc.make_store(N_KEYS, V, device="cpu"), twaves,
        kernels="torch" + route, **run)
    tpm, jpm = _both_maps(moves=[(0, 6, 3)])
    st, h, s = tc.run_workload(
        tp.physical_store(tc.make_store(N_KEYS, V, device="cpu"), tpm),
        twaves, kernels="torch" + route,
        placement=tpm.device_arrays("cpu"), **run)
    j_st, j_h, j_s = jc.run_workload(
        jp.physical_store(jc.make_store(N_KEYS, V), jpm), jwaves,
        kernels="jnp" + route, placement=jpm.device_arrays(), **run)
    assert s == ref_s == tuple(j_s), (sched, s, ref_s, j_s)
    assert_same_history(h, j_h, sched)
    assert_same_history(ref_h, h, sched)
    assert_same_store(st, j_st, sched)
    for a, b in zip(tp.logical_store(st, tpm), ref_store):
        assert torch.equal(a, b), sched


@pytest.mark.parametrize("route", ROUTES)
def test_live_move_mid_workload_bit_identical(route):
    """Moves between waves leave every later outcome and the logical store
    equal to the static run, and the placed store equal to the JAX store
    after the same moves."""
    kw = dict(n_ops=3, read_ratio=0.4, dist_frac=0.5, hot_frac=0.7,
              hot_per_node=2)
    jwaves = jw.micro_waves(np.random.RandomState(11), 6, 12, N_NODES,
                            N_KEYS // N_NODES, **kw)
    twaves = tw.micro_waves(np.random.RandomState(11), 6, 12, N_NODES,
                            N_KEYS // N_NODES, device="cpu", **kw)
    ref_store, ref_h, _ = tc.run_workload(
        tc.make_store(N_KEYS, V, device="cpu"), twaves, sched="postsi",
        n_nodes=N_NODES, kernels="torch" + route)
    tpm, jpm = _both_maps()
    t_st = tp.physical_store(tc.make_store(N_KEYS, V, device="cpu"), tpm)
    j_st = jp.physical_store(jc.make_store(N_KEYS, V), jpm)
    t_clock, j_clock = 1, jnp.int32(1)
    h = []
    for w, (tw_, jw_) in enumerate(zip(twaves, jwaves)):
        if w in (2, 4):
            lo, hi, dst = (0, 10, 2) if w == 2 else (32, 40, 0)
            tr, jr = tpm.move(lo, hi, dst), jpm.move(lo, hi, dst)
            _same_record(tr, jr)
            t_st = tp.apply_move(t_st, tr)
            j_st = jp.apply_move(j_st, jr)
            tpm.apply_record(tr)
            jpm.apply_record(jr)
            assert_same_store(t_st, j_st, f"after the move before wave {w}")
        t_st, out, t_clock = tc.step_wave(
            t_st, tw_, w + 1, t_clock, sched="postsi", n_nodes=N_NODES,
            kernels="torch" + route, placement=tpm.device_arrays("cpu"))
        j_st, _, j_clock = jc.step_wave(
            j_st, jw_, w + 1, j_clock, sched="postsi", n_nodes=N_NODES,
            kernels="jnp" + route, placement=jpm.device_arrays())
        h.append((tw_.tid.numpy(), out))
    assert_same_history(ref_h, h, "live-move")
    assert_same_store(t_st, j_st, "live-move")
    for a, b in zip(tp.logical_store(t_st, tpm), ref_store):
        assert torch.equal(a, b)
    _same_map(tpm, jpm)
    tpm.validate()


def test_move_on_store_with_empty_and_full_records():
    """``apply_move_local`` is in place and returns the same store; an
    empty record moves nothing; ``mesh=`` names the mesh item."""
    tpm, jpm = _both_maps()
    st = tp.physical_store(tc.make_store(N_KEYS, V, device="cpu"), tpm)
    none = tpm.move(0, 4, 0)                 # already on node 0
    assert none.keys.size == 0 and tp.apply_move(st, none) is st
    rec = tpm.move(0, 4, 1)
    assert tp.apply_move_local(st, rec) is st
    with pytest.raises(NotImplementedError, match="Mesh substrate"):
        tp.apply_move(st, rec, mesh=object())


# ----------------------------------------------------------------- balancer

def _counters(load):
    """Per-key traffic: zipf by key (node 0 scorching), the same curve
    over a random permutation of the keys, or two hot ranges."""
    if load == "two-hot":
        ops = np.ones(N_KEYS)
        ops[:8], ops[40:44] = 100.0, 80.0
        return ops
    ranks = (np.random.RandomState(1).permutation(N_KEYS)
             if load == "permuted" else np.arange(N_KEYS))
    return 1000.0 / (ranks + 1.0)


@pytest.mark.parametrize("load", ["zipf", "permuted", "two-hot"])
def test_balancer_plan_equals_jax(load):
    """Repeated plan/apply rounds on the same counters: the same moves,
    the same maps, the same imbalance at every round, converging below
    the trigger on the zipf load."""
    tpm, jpm = _both_maps()
    lbs = [mod.LoadBalancer(N_KEYS, N_NODES, every=1, trigger=1.25,
                            max_moves=2, decay=1.0) for mod in (tp, jp)]
    for lb in lbs:
        lb.key_ops = _counters(load)
    start = lbs[0].imbalance(tpm)
    assert start == lbs[1].imbalance(jpm) and start > 1.25
    for _ in range(12):
        t_moves, j_moves = lbs[0].plan(tpm), lbs[1].plan(jpm)
        assert t_moves == j_moves
        if not t_moves:
            break
        for lo, hi, dst in t_moves:
            tpm.apply_record(tpm.move(lo, hi, dst))
            jpm.apply_record(jpm.move(lo, hi, dst))
            tpm.validate()
        _same_map(tpm, jpm)
        assert all((tpm.owner == n).sum() >= 1 for n in range(N_NODES))
        assert lbs[0].imbalance(tpm) == lbs[1].imbalance(jpm)
    assert lbs[0].imbalance(tpm) < start
    assert lbs[0].report() == lbs[1].report()
    if load == "zipf":
        assert lbs[0].imbalance(tpm) < 1.25 + 0.35


def test_balancer_plan_falls_through_full_coldest():
    tpm, jpm = _both_maps(moves=[(32, 48, 1)])
    assert tpm.free_slots(1) == 0 and tpm.free_slots(2) == tpm.capacity
    lbs = [mod.LoadBalancer(N_KEYS, N_NODES, every=1, trigger=1.25,
                            max_moves=2) for mod in (tp, jp)]
    for lb in lbs:
        lb.key_ops = np.zeros(N_KEYS)
        lb.key_ops[:16] = 100.0
        lb.key_ops[48:] = 10.0
    moves = lbs[0].plan(tpm)
    assert moves == lbs[1].plan(jpm)
    assert moves and moves[0][2] == 2, moves
    for lo, hi, dst in moves:
        assert dst != 1 and tpm.free_slots(dst) >= hi - lo
        tpm.apply_record(tpm.move(lo, hi, dst))
        tpm.validate()
    assert lbs[0].imbalance(tpm) < N_NODES * 100.0 / 110.0


def test_balancer_counts_committed_txns_not_ops():
    pm = tp.PlacementMap(N_KEYS, N_NODES, headroom=1)
    op_key = np.array([[0, 1, 2, 3], [16, 17, 0, 0], [5, 6, 0, 0],
                       [-1, 70, 0, 0]])
    active = np.array([[1, 1, 1, 1], [1, 1, 0, 0], [1, 1, 0, 0],
                       [1, 1, 0, 0]], bool)
    committed = np.array([True, True, False, True])
    lbs = [mod.LoadBalancer(N_KEYS, N_NODES) for mod in (tp, jp)]
    for lb in lbs:
        lb.observe(op_key, active, committed, pm.owner)
    assert lbs[0].node_commits.tolist() == [1, 1, 0, 0]
    assert lbs[0].node_aborts.tolist() == [1, 0, 0, 0]
    assert lbs[0].key_ops.sum() == 6.0
    assert lbs[0].report() == lbs[1].report()
    np.testing.assert_array_equal(lbs[0].key_ops, lbs[1].key_ops)
    assert lbs[0].end_block() == lbs[1].end_block()


# ------------------------------------------------------------------ replicas

def _hot():
    return jw.zipf_hot_keys(N_NODES, N_KEYS // N_NODES, theta=0.99)


def _fates(svc):
    return [(r.status, tuple(r.tids), r.s, r.c, r.commit_tick, r.replica)
            for r in svc.requests]


def _same_service(t_svc, j_svc, msg):
    assert _fates(t_svc) == _fates(j_svc), msg
    assert_same_history(t_svc.history, j_svc.history, msg)
    assert_same_store(t_svc.store, j_svc.store, msg)
    t_rep, j_rep = t_svc.report().as_dict(), j_svc.report().as_dict()
    for d in (t_rep, j_rep):
        for k in ("wall_s", "txns_per_sec", "goodput_tps"):
            d.pop(k)
    assert t_rep == j_rep, msg
    if t_svc.placement is not None:
        _same_map(t_svc.placement, j_svc.placement)


def _service(side, **kw):
    if side == "jax":
        return js.TxnService(n_keys=N_KEYS, n_versions=V, sched="postsi",
                             n_nodes=N_NODES, kernels="jnp", **kw)
    return ts.TxnService(n_keys=N_KEYS, n_versions=V, sched="postsi",
                         n_nodes=N_NODES, kernels="torch", device="cpu", **kw)


def _placed(side, **kw):
    mod = jp if side == "jax" else tp
    return _service(side, placement=mod.PlacementMap(N_KEYS, N_NODES,
                                                     headroom=2), **kw)


@pytest.mark.parametrize("seed", [0, 3, 9])
def test_replica_staleness_property(seed):
    """A replica never serves state newer than its floor, the floor never
    passes the GC clock, a fresh refresh equals ``read_visible`` at the
    floor — and the whole session equals the JAX session."""
    hot = _hot()
    svcs = {}
    for side in ("torch", "jax"):
        rng = np.random.RandomState(seed)
        svc = _placed(side, T=16, O=4, replicas=hot, seed=seed)
        for _ in range(150):
            kind = np.full(4, NOP, np.int32)
            key = np.zeros(4, np.int32)
            val = np.zeros(4, np.int32)
            ks = rng.choice(hot, size=2, replace=False)
            if rng.rand() < 0.6:
                kind[:2] = READ
            else:
                kind[:2] = RMW
                val[:2] = rng.randint(1, 100, 2)
            key[:2] = ks
            svc.submit(kind, key, val, int(rng.randint(0, N_NODES)))
            if rng.rand() < 0.3:
                svc.step()
        svc.drain()
        svcs[side] = svc
    svc = svcs["torch"]
    _same_service(svc, svcs["jax"], f"seed {seed}")
    assert svc.verify() == [], svc.verify()
    rep = svc.replicas
    assert svc.replica_commits > 0
    assert rep.max_cid() <= rep.floor <= svc.gc.clock
    assert rep.report() == svcs["jax"].replicas.report()
    for r in svc.requests:
        if r.replica:
            assert r.s == r.c <= svc.gc.clock
    svc._refresh_replicas()
    svcs["jax"]._refresh_replicas()
    rows = torch.as_tensor(svc.placement.slot[rep.keys].astype(np.int32))
    vals, _, cids, _, _ = tc.read_visible(svc.store, rows, rep.floor)
    np.testing.assert_array_equal(rep._val[rep.keys], vals.numpy())
    np.testing.assert_array_equal(rep._cid[rep.keys], cids.numpy())
    np.testing.assert_array_equal(rep._val, svcs["jax"].replicas._val)
    np.testing.assert_array_equal(rep._cid, svcs["jax"].replicas._cid)


def test_replica_never_serves_writers_or_cold_keys():
    for mod in (tp, jp):
        rep = mod.HotKeyReplicas([1, 2, 3])
        assert not rep.can_serve(np.array([READ]), np.array([1]))
        rep.floor = 0
        assert rep.can_serve(np.array([READ, NOP]), np.array([1, 0]))
        assert not rep.can_serve(np.array([READ, WRITE]), np.array([1, 2]))
        assert not rep.can_serve(np.array([READ]), np.array([7]))
        assert not rep.can_serve(np.array([NOP]), np.array([0]))
        # negative keys never wrap into the dense table
        assert not rep.can_serve(np.array([READ]), np.array([-1]))
        assert not rep.can_serve(np.array([READ, READ]), np.array([1, -1]))
        assert not rep.can_serve(np.array([READ]),
                                 np.array([-rep._member.size]))
        assert rep.can_serve(np.array([READ, NOP]), np.array([2, -1]))
    empty = tp.HotKeyReplicas([])
    empty.refresh(None, 5)
    assert empty.floor == 5 and empty.refreshes == 0 and empty.max_cid() == 0


@pytest.mark.parametrize("kernels", ["torch", "torch+fused"])
def test_replica_negative_key_regression_all_kernels(kernels):
    """The negative-key submit goes to the engine, never the replica
    fast path, on both routes; the session verifies."""
    hot = _hot()
    svc = ts.TxnService(n_keys=N_KEYS, n_versions=V, T=8, O=4,
                        sched="postsi", n_nodes=N_NODES, replicas=hot,
                        kernels=kernels, device="cpu")
    kind = np.array([READ, READ, NOP, NOP], np.int32)
    key = np.array([int(hot[0]), -1, 0, 0], np.int32)
    req = svc.submit(kind, key, np.zeros(4, np.int32), 0)
    assert not req.replica and req.status == "queued"
    ok = svc.submit(np.array([READ, NOP, NOP, NOP], np.int32),
                    np.array([int(hot[0]), 0, 0, 0], np.int32),
                    np.zeros(4, np.int32), 0)
    assert ok.replica and ok.status == "committed"
    svc.drain()
    assert req.status == "committed" and svc.verify() == []


# ----------------------------------------------- the elastic service

def _mixed_txns(seed, n, hot_n=16):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        kind = np.full(4, NOP, np.int32)
        key = np.zeros(4, np.int32)
        val = np.zeros(4, np.int32)
        ks = rng.choice(hot_n, size=2, replace=False)
        if rng.rand() < 0.5:
            kind[:2] = READ
        else:
            kind[:2] = RMW
            val[:2] = rng.randint(1, 100, 2)
        key[:2] = ks
        out.append((kind, key, val, int(rng.randint(0, N_NODES))))
    return out


def _drain(svc, txns):
    for t in txns:
        svc.submit(*t)
    svc.drain()
    return svc


@pytest.mark.parametrize("replicas", [False, True])
def test_elastic_service_equals_static_and_jax(replicas):
    """Placement + balancer moves (+ replicas): the JAX elastic service's
    fates, history, store, report and map exactly; without replicas the
    committed set and history of the static service too."""
    txns = _mixed_txns(2, 150)
    kw = dict(T=16, O=4, balancer=True,
              replicas=_hot() if replicas else None, replica_refresh=3)
    t_el = _drain(_placed("torch", **kw), txns)
    j_el = _drain(_placed("jax", **kw), txns)
    _same_service(t_el, j_el, f"elastic replicas={replicas}")
    rep = t_el.report()
    assert rep.placement_moves > 0 and rep.moved_keys > 0
    assert t_el.verify() == []
    assert rep.occupancy and rep.imbalance >= 1.0
    assert sum(rep.occupancy) == rep.committed - rep.replica_commits
    if replicas:
        assert rep.replica_commits > 0 and rep.replica_refreshes > 1
        assert rep.tenants["0"]["replica_commits"] == rep.replica_commits
        return
    static = _drain(_service("torch", T=16, O=4), txns)
    cs = lambda s: sorted(r.req_id for r in s.requests
                          if r.status == "committed")
    assert cs(static) == cs(t_el)
    assert_same_history(static.history, t_el.history, "static")
    for a, b in zip(tp.logical_store(t_el.store, t_el.placement),
                    static.store):
        assert torch.equal(a, b)


def test_explicit_move_range_and_refusals():
    svc = _placed("torch", T=16, O=4)
    jsvc = _placed("jax", T=16, O=4)
    txns = _mixed_txns(6, 60)
    for i, t in enumerate(txns):
        svc.submit(*t)
        jsvc.submit(*t)
        if i == 30:
            _same_record(svc.move_range(0, 12, 2), jsvc.move_range(0, 12, 2))
            assert svc.move_range(0, 12, 2) is None     # nothing left to move
        if i % 4 == 0:
            svc.step()
            jsvc.step()
    svc.drain()
    jsvc.drain()
    _same_service(svc, jsvc, "explicit move")
    assert svc.verify() == []
    with pytest.raises(ValueError, match="elastic placement"):
        _service("torch", T=4).move_range(0, 2, 1)
    with pytest.raises(ValueError, match="needs an elastic placement"):
        _service("torch", T=4, balancer=True)
    with pytest.raises(ValueError, match="placement covers"):
        ts.TxnService(N_KEYS + 1, T=4, n_nodes=N_NODES, device="cpu",
                      placement=tp.PlacementMap(N_KEYS, N_NODES))


@pytest.mark.parametrize("mode", ["planned", "streaming"])
def test_elastic_planner_and_streaming_equal_jax(mode):
    """The planner's lanes and the streaming driver's blocks run under the
    placement; the session equals the JAX session, moves included."""
    txns = _mixed_txns(8, 120)
    svcs = []
    for side in ("torch", "jax"):
        kw = dict(T=16, O=4, balancer=True)
        if mode == "planned":
            kw["planner"] = "planned"
        svc = _placed(side, **kw)
        if mode == "planned":
            _drain(svc, txns[:60])
            svc.move_range(40, 52, 0)
            _drain(svc, txns[60:])
        else:
            gen = iter(txns)
            svc.run_streaming([30, 30], lambda: next(gen), B=2, K=2,
                              drain=False)
            svc.move_range(40, 52, 0)        # flushes the driver first
            svc.run_streaming([30, 30], lambda: next(gen), B=2, K=2)
        svcs.append(svc)
    _same_service(*svcs, mode)
    assert svcs[0].verify() == []
    assert svcs[0].placement_moves >= 1


# ------------------------------------------- the -1 / last physical row

def _corner_wave(mod, T=12, O=3, **extra):
    """A micro wave whose live reads and NOP padding carry key -1 and a
    key past the last one: -1 reaches the last physical row, the past key
    clamps to ``slot[n_keys - 1]``."""
    (wave,) = mod.micro_waves(np.random.RandomState(13), 1, T, N_NODES,
                              N_KEYS // N_NODES, n_ops=O, read_ratio=0.5,
                              dist_frac=0.5, hot_frac=0.5, hot_per_node=2,
                              **extra)
    kind, key, val = (np.array(tc.wave_to_numpy(wave)[f]) for f in range(3))
    kind[T - 2:], key[T - 2:], val[T - 2:] = NOP, -1, 0      # padding
    kind[0, 0], key[0, 0] = READ, -1                         # live reads
    kind[1, 0], key[1, 0] = READ, N_KEYS + 3
    kind[2, :], key[2, :] = READ, [-1, N_KEYS + 3, 7]
    return kind, key, val, wave


@pytest.mark.parametrize("route", ROUTES)
def test_negative_key_last_row_before_and_after_fill(route):
    """Before the move the last physical row is headroom; the move of 16
    keys onto node 3 fills it (key 15 lands at row n_slots - 1).  On both
    sides of the move the wave's outcomes and the placed store equal the
    JAX package's."""
    tpm, jpm = _both_maps()
    t_st = tp.physical_store(tc.make_store(N_KEYS, V, device="cpu"), tpm)
    j_st = jp.physical_store(jc.make_store(N_KEYS, V), jpm)
    clock_t, clock_j = 1, jnp.int32(1)
    for w in range(2):
        if w == 1:
            tr, jr = tpm.move(0, 16, 3), jpm.move(0, 16, 3)
            _same_record(tr, jr)
            assert tr.new_slots[-1] == tpm.n_slots - 1
            t_st, j_st = tp.apply_move(t_st, tr), jp.apply_move(j_st, jr)
            tpm.apply_record(tr)
            jpm.apply_record(jr)
        kind, key, val, jwave = _corner_wave(jw)
        jwave = jwave._replace(op_kind=jnp.asarray(kind),
                               op_key=jnp.asarray(key),
                               op_val=jnp.asarray(val),
                               tid=jnp.asarray(np.asarray(jwave.tid)
                                               + 100 * w))
        twave = tc.wave_from_numpy(jwave, "cpu")
        t_st, t_out, clock_t = tc.step_wave(
            t_st, twave, w + 1, clock_t, sched="postsi", n_nodes=N_NODES,
            kernels="torch" + route, placement=tpm.device_arrays("cpu"))
        j_st, j_out, clock_j = jc.step_wave(
            j_st, jwave, w + 1, clock_j, sched="postsi", n_nodes=N_NODES,
            kernels="jnp" + route, placement=jpm.device_arrays())
        assert_same_history([(twave.tid.numpy(), t_out)],
                            [(np.asarray(jwave.tid), j_out)], f"wave {w}")
        assert_same_store(t_st, j_st, f"wave {w}")
        assert int(clock_t) == int(clock_j)
