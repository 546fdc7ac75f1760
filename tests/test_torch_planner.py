"""The port's planner plane held against the JAX package's, exactly.

* ``conflict_graph`` (both constructions), ``color_lanes`` / ``plan_wave``
  (with and without a lane budget) and ``build_planned_block`` give the
  reference's arrays on random waves: they are numpy copies, and the test
  keeps them so.
* ``run_workload_planned`` equals the reference's (``kernels="jnp"``) in
  every history row, the merged outcomes, the final store and
  ``PlanRunStats`` but for ``plan_s``, under each of the six base
  schedulers; without a spill nothing aborts and the final values are the
  sequential oracle's (``core/seq.py`` replayed in tid order).
* ``HybridSwitch`` takes the reference's decisions on the same signals.
* ``TxnService(planner="planned"|"hybrid")`` serves what the reference
  serves, in ``run_stream`` and in ``run_streaming(B=2, K=2)``.
* A ``mesh`` that is not a ``NodeMesh`` raises ``TypeError``; a NodeMesh
  serves the planned lanes equal to the single device.
"""
import numpy as np
import pytest
import torch

import repro.core as jc
from repro.core import workloads as jw
from repro.core.seq import SeqScheduler
import repro.planner as jp
import repro.service as js
import repro_torch.core as tc
from repro_torch.core import workloads as tw
import repro_torch.planner as tp
import repro_torch.service as ts

from test_torch_engine import assert_same_history, assert_same_store
from test_torch_service import _fates

N_NODES, KPN = 4, 32
N_KEYS = N_NODES * KPN
WALL = ("wall_s", "txns_per_sec", "goodput_tps")


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """The plain commit loop runs ~170 small tensor ops a step; on one
    intra-op thread they do not stall when the other test workers load
    every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _random_waves(seed, n=40):
    rng = np.random.RandomState(seed)
    for _ in range(n):
        T, O = int(rng.randint(1, 24)), int(rng.randint(1, 6))
        op_kind = rng.randint(0, 4, (T, O)).astype(np.int32)
        op_key = rng.randint(0, int(rng.randint(2, 12)), (T, O)).astype(
            np.int32)
        yield op_kind, op_key


# ------------------------------------------------------- graph and lanes
@pytest.mark.parametrize("method", ["auto", "dense", "grouped"])
def test_conflict_graph_matches_jax(method):
    for op_kind, op_key in _random_waves(0):
        got = tp.conflict_graph(op_kind, op_key, method=method)
        want = jp.conflict_graph(op_kind, op_key, method=method)
        for f, a, b in zip(got._fields, got, want):
            np.testing.assert_array_equal(a, b, err_msg=f)
            assert a.dtype == b.dtype


@pytest.mark.parametrize("max_lanes", [None, 1, 3])
def test_plans_match_jax(max_lanes):
    spilled = 0
    for op_kind, op_key in _random_waves(1):
        got = tp.plan_wave(op_kind, op_key, max_lanes=max_lanes)
        want = jp.plan_wave(op_kind, op_key, max_lanes=max_lanes)
        np.testing.assert_array_equal(got.lane_of, want.lane_of)
        assert got.lane_of.dtype == want.lane_of.dtype
        assert len(got.lanes) == len(want.lanes)
        for a, b in zip(got.lanes, want.lanes):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(got.spill, want.spill)
        assert (got.conflicted, got.n_edges) == (want.conflicted,
                                                 want.n_edges)
        g = tp.conflict_graph(op_kind, op_key)
        assert tp.color_lanes(g, max_lanes=max_lanes).lane_of.tolist() == \
            got.lane_of.tolist()
        spilled += got.n_spilled
    assert (spilled > 0) == (max_lanes is not None)


def test_planned_block_matches_jax():
    waves = tw.ycsb_waves(np.random.RandomState(2), 4, 12, N_NODES, KPN,
                          theta=0.95, read_frac=0.3, device="cpu")
    for i, w in enumerate(waves):
        w = tc.wave_to_numpy(w)
        plan = tp.plan_wave(w.op_kind, w.op_key, max_lanes=2 + i % 2)
        got, rows, t_pad = tp.build_planned_block(w, plan, 100)
        want, j_rows, j_pad = jp.build_planned_block(w, plan, 100)
        assert t_pad == j_pad
        for f, a, b in zip(got._fields, got, want):
            np.testing.assert_array_equal(a, b, err_msg=f)
        assert [r.tolist() for r in rows] == [r.tolist() for r in j_rows]


# ------------------------------------- planned replay against the oracle
def _mixed_workload(mod, seed, **extra):
    rng = np.random.RandomState(seed)
    waves = mod.ycsb_waves(rng, 2, 12, N_NODES, KPN, theta=0.95,
                           read_frac=0.3, dist_frac=0.2, n_ops=4, **extra)
    waves += mod.chain_waves(rng, 2, 12, N_NODES, KPN, chain_len=4,
                             kind="mixed", tid0=1 + 2 * 12, **extra)
    return waves


def _oracle_values(waves):
    """Final per-key values of ``core/seq.py`` run one txn at a time in
    tid order (the serial baseline a spill-free planned run commits
    into)."""
    seq = SeqScheduler(N_KEYS)
    for w in waves:
        kinds, keys, vals = (np.asarray(w.op_kind), np.asarray(w.op_key),
                             np.asarray(w.op_val))
        for t in range(kinds.shape[0]):
            tid = seq.begin()
            for kind, k, v in zip(kinds[t].tolist(), keys[t].tolist(),
                                  vals[t].tolist()):
                if kind == jc.READ:
                    seq.read(tid, k)
                elif kind == jc.WRITE:
                    seq.write(tid, k, v)
                elif kind == jc.RMW:
                    seq.write(tid, k, seq.read(tid, k) + v)
            seq.commit(tid)
    return {k: seq.versions[k][-1].value
            for k in range(N_KEYS) if seq.versions[k]}


def _planned_pair(waves_j, waves_t, route="", **kw):
    j = jp.run_workload_planned(jc.make_store(N_KEYS, 8), waves_j,
                                n_nodes=N_NODES, kernels="jnp" + route, **kw)
    t = tp.run_workload_planned(tc.make_store(N_KEYS, 8, device="cpu"),
                                waves_t, n_nodes=N_NODES,
                                kernels="torch" + route, **kw)
    return t, j


def _assert_same_planned(t, j):
    (t_store, t_hist, t_stats), (j_store, j_hist, j_stats) = t, j
    assert_same_history(t_hist, j_hist)
    assert_same_store(t_store, j_store)
    assert t_stats._replace(plan_s=0.0) == j_stats._replace(plan_s=0.0)


@pytest.mark.parametrize("base,route", [(s, "") for s in tc.SCHEDULERS]
                         + [("postsi", "+fused")])
def test_run_workload_planned_matches_jax(base, route):
    waves_t = _mixed_workload(tw, 1, device="cpu")
    t, j = _planned_pair(_mixed_workload(jw, 1), waves_t, route, sched=base)
    _assert_same_planned(t, j)
    store, history, stats = t
    assert stats.aborted == 0 and stats.spilled_txns == 0
    assert stats.committed == sum(len(w.tid) for w in waves_t)
    assert tc.final_values_ok(store, history, N_KEYS) == []
    val, head = store.val.numpy(), store.head.numpy()
    for k, v in _oracle_values(waves_t).items():
        assert int(val[k, head[k]]) == v, f"key {k}"
    if base != "optimal":         # the paper's unchecked upper bound
        check = tc.verify_cv if base == "cv" else tc.verify_si
        assert check(history) == []


def test_planned_spill_matches_jax():
    """A lane budget of 3 under WAW chains of 6: the spill wave runs
    optimistically and may abort, exactly as in the reference."""
    rng = lambda: np.random.RandomState(4)
    waves_j = jw.chain_waves(rng(), 2, 12, N_NODES, KPN, chain_len=6,
                             kind="waw")
    waves_t = tw.chain_waves(rng(), 2, 12, N_NODES, KPN, chain_len=6,
                             kind="waw", device="cpu")
    t, j = _planned_pair(waves_j, waves_t, max_lanes=3)
    _assert_same_planned(t, j)
    stats = t[2]
    assert stats.spilled_txns > 0
    assert stats.committed + stats.aborted == 24
    assert stats.aborted <= stats.spilled_txns
    assert tc.verify_si(t[1]) == []


def test_run_workload_any_registry():
    assert tp.PLANNED in tp.ALL_SCHEDULERS
    assert tp.ALL_SCHEDULERS == jp.ALL_SCHEDULERS
    waves = tw.ycsb_waves(np.random.RandomState(5), 2, 8, N_NODES, KPN,
                          theta=0.9, read_frac=0.5, device="cpu")
    kw = dict(n_nodes=N_NODES, kernels="torch")
    _, _, planned = tp.run_workload_any(
        tc.make_store(N_KEYS, 8, device="cpu"), waves, tp.PLANNED, **kw)
    assert planned.aborted == 0
    _, _, opt = tp.run_workload_any(
        tc.make_store(N_KEYS, 8, device="cpu"), waves, "postsi", **kw)
    assert opt.committed + opt.aborted == planned.committed
    with pytest.raises(ValueError):
        tp.run_workload_any(tc.make_store(N_KEYS, 8, device="cpu"), waves,
                            "nope", **kw)


# ----------------------------------------------------------------- hybrid
def test_hybrid_switch_matches_jax():
    rng = np.random.RandomState(9)
    kw = dict(enter_high=0.3, exit_low=0.2, window=10)
    t, j = tp.HybridSwitch(**kw), jp.HybridSwitch(**kw)
    state = lambda s: (s.planned, s.to_planned, s.to_optimistic, s.switches)
    for _ in range(400):
        n = int(rng.randint(1, 8))
        k = int(rng.randint(0, n + 1))
        planned = rng.rand() < 0.5
        for s in (t, j):
            (s.observe_planned if planned else s.observe_optimistic)(n, k)
        assert state(t) == state(j)
    assert t.switches > 2
    pinned = tp.HybridSwitch.from_name("planned")
    pinned.observe_planned(1000, 0)        # conflict-free forever: stays
    assert pinned.planned
    for bad in (lambda: tp.HybridSwitch.from_name("sometimes"),
                lambda: tp.HybridSwitch(window=0)):
        with pytest.raises(ValueError):
            bad()


def _hot_service(pkg, planner, mode, seed, n_ticks):
    extra = (dict(kernels="jnp") if pkg is js
             else dict(kernels="torch", device="cpu"))
    svc = pkg.TxnService(n_keys=N_KEYS, T=16, O=4, sched="postsi",
                         n_nodes=N_NODES, planner=planner, **extra)
    gen = pkg.ycsb_txn_gen(np.random.RandomState(seed), N_NODES, KPN,
                           theta=0.99, read_frac=0.1, n_ops=4)
    if mode == "step":
        return svc, svc.run_stream([8] * n_ticks, gen)
    return svc, svc.run_streaming([8] * n_ticks, gen, B=2, K=2)


@pytest.mark.parametrize("planner,mode,seed,n_ticks", [
    ("hybrid", "step", 6, 40), ("hybrid", "stream", 8, 40),
    ("planned", "step", 7, 20)],
    ids=["hybrid-step", "hybrid-streaming", "planned-step"])
def test_planned_service_matches_jax(planner, mode, seed, n_ticks):
    t_svc, t_rep = _hot_service(ts, planner, mode, seed, n_ticks)
    j_svc, j_rep = _hot_service(js, planner, mode, seed, n_ticks)
    assert _fates(t_svc) == _fates(j_svc)
    assert_same_history(t_svc.history, j_svc.history)
    td, jd = t_rep.as_dict(), j_rep.as_dict()
    for k in WALL:
        td.pop(k), jd.pop(k)
    assert td == jd
    assert t_rep.planned_waves > 0
    assert t_rep.committed + t_rep.dropped == t_rep.admitted
    assert t_svc.verify() == []
    if planner == "hybrid":
        assert t_rep.planner_switches >= 1
    else:                      # pinned planned mode, no spill at this depth
        assert t_rep.retries == t_rep.planned_spilled == 0


# ----------------------------------------------------------- the mesh
def test_hybrid_service_mesh_is_a_node_mesh():
    with pytest.raises(TypeError, match="NodeMesh"):
        ts.TxnService(N_KEYS, T=4, n_nodes=N_NODES, device="cpu",
                      planner="hybrid", mesh=object())
    mesh = tc.make_node_mesh(N_NODES, "cpu")
    svc = ts.TxnService(N_KEYS, T=4, n_nodes=N_NODES, device="cpu",
                        planner="planned", mesh=mesh)
    gen = ts.ycsb_txn_gen(np.random.RandomState(5), N_NODES, KPN, theta=0.9)
    rep = svc.run_stream([4, 4], gen)
    assert rep.planned_waves > 0 and svc.verify() == []


def test_planned_mesh_branch():
    """``run_wave_planned(mesh=...)``: a non-NodeMesh raises; a NodeMesh
    runs the lanes through ``step_block_dist``, equal to the single
    device in outcomes and store."""
    (wave,) = tw.ycsb_waves(np.random.RandomState(3), 1, 4, N_NODES, KPN,
                            device="cpu")
    with pytest.raises(TypeError, match="NodeMesh"):
        tp.run_wave_planned(tc.make_store(N_KEYS, 4, device="cpu"), wave, 1,
                            wave_idx0=1, next_tid=100, mesh=object())
    runs = []
    for mesh in (None, tc.make_node_mesh(N_NODES, "cpu")):
        store, _, pw = tp.run_wave_planned(
            tc.make_store(N_KEYS, 4, device="cpu"), wave, 1, wave_idx0=1,
            next_tid=100, mesh=mesh)
        runs.append((store, pw.merged))
    assert_same_history([(0, runs[0][1])], [(0, runs[1][1])], "planned")
    for a, b in zip(runs[0][0], runs[1][0]):
        assert torch.equal(a, b)
