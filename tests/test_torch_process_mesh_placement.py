"""Elastic placement and the planner on the node mesh across processes,
held against the JAX single-device package and the port's emulated mesh.

``spawn_ranks`` starts 4 ``gloo`` ranks on the CPU once for the module
(``torch_process_mesh_ranks.placement_planner_cases``, which imports no
JAX); each holds only its block of the store.  The parent alone imports
JAX and checks, each in its own case:

* ``apply_move`` on the ranks (one ``all_reduce`` a move) after each of
  four moves of a random placed store, and on a padded store (102 rows on
  4 ranks), equals ``apply_move_mesh`` on the emulated mesh and the JAX
  ``apply_move_local``;
* a placed driver call (both mesh drivers, both routes, a moved layout)
  equals the JAX ``run_workload`` under the same layout;
* the elastic service (balancer, replicas refreshed through the mesh's
  merged read, one explicit ``move_range``), stepped and streamed on both
  routes, equals the JAX single-device service: fates, history, report,
  the store in key order, the map;
* durable: a session crashed right after its ``REC_MOVE`` record; its
  recoveries on the ranks (snapshot, full replay) equal the JAX
  ``recover`` of the same directory, and the ranks take it up and serve
  on as the JAX service does from a copy;
* ``run_wave_planned``, ``run_workload_planned`` (both routes) and
  ``TxnService(planner="planned" / "hybrid")`` equal the JAX runs.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest

import repro.core as jc
from repro.core import workloads as jw
import repro.durability as jd
import repro.placement as jp
import repro.planner as jpl
import repro.service as js
import repro_torch.core as tc
import repro_torch.placement as tp
from repro_torch.launch.mesh import spawn_ranks

import torch_process_mesh_ranks as R
from test_torch_engine import assert_same_history

N = R.N


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """(every rank's results, the directories' root)."""
    root = str(tmp_path_factory.mktemp("ranks"))
    return spawn_ranks(R.placement_planner_cases, N, device="cpu",
                       deadline=240.0, args=(root,)), root


def _jax_store(fields):
    return jc.MVStore(**{f: jnp.asarray(a) for f, a in fields.items()})


@pytest.mark.parametrize("upto", range(len(R.MOVES)))
def test_apply_move_equals_the_emulated_mesh_and_jax(ranks, upto):
    got = [res["moves"] for res in ranks[0]]
    fields = R.random_store(2 * R.P_KEYS, R.P_V, 11)
    j_store = _jax_store(fields)
    mesh = tc.make_node_mesh(N, "cpu")
    e_store = tc.shard_store(tc.store_from_numpy(fields, "cpu"), mesh)
    for i in range(upto + 1):
        rec = got[0][0][i][0]
        j_store = jp.apply_move_local(j_store, jp.MoveRecord.from_dict(rec))
        tp.apply_move_mesh(e_store, tp.MoveRecord.from_dict(rec), mesh)
    for rank, (wholes, block) in enumerate(got):
        rec, whole = wholes[upto]
        assert rec == got[0][0][upto][0], rank
        R.same_fields(whole, j_store, f"move {upto} rank {rank} vs JAX")
        R.same_fields(whole, e_store, f"move {upto} rank {rank} vs emulated")
        if upto == len(R.MOVES) - 1:
            n_local = 2 * R.P_KEYS // N
            for f, a in block.items():
                np.testing.assert_array_equal(
                    a, whole[f][rank * n_local:(rank + 1) * n_local])


def test_apply_move_on_a_padded_store(ranks):
    fields = R.random_store(R.PAD_ROWS, R.P_V, 12)
    j_store = jp.apply_move_local(_jax_store(fields), R.pad_record(jp))
    mesh = tc.make_node_mesh(N, "cpu")
    e_store = tc.shard_store(tc.store_from_numpy(fields, "cpu"), mesh)
    tp.apply_move_mesh(e_store, R.pad_record(tp), mesh)
    for rank, res in enumerate(ranks[0]):
        n_local, whole = res["padded"]
        assert n_local * N == R.PAD_ROWS + 2
        R.same_fields(whole, e_store, f"rank {rank} vs emulated")
        R.same_fields({f: a[:R.PAD_ROWS] for f, a in whole.items()}, j_store,
                 f"rank {rank} vs JAX")
        assert (whole["tid"][R.PAD_ROWS:] == -1).all()


@pytest.mark.parametrize("drv", R.DRIVERS)
@pytest.mark.parametrize("route", R.ROUTES)
def test_placed_driver_equals_jax(ranks, route, drv):
    jpm = R.placed_map(jp)
    j_st, j_h, j_s = jc.run_workload(
        jp.physical_store(jc.make_store(R.P_KEYS, 8), jpm),
        R.placed_waves(jw), sched="postsi", n_nodes=N, gc_track=True,
        kernels="jnp" + route[5:], placement=jpm.device_arrays())
    for rank, res in enumerate(ranks[0]):
        hist, stats, whole = res[("placed", route, drv)]
        msg = f"{route}/{drv} rank {rank}"
        assert stats == tuple(j_s), msg
        assert_same_history(hist, j_h, msg)
        R.same_fields(whole, j_st, msg)


def _jax_elastic(mode, route="torch", **kw):
    hot = jw.zipf_hot_keys(N, R.KPN, 0.99)
    return R.elastic_service(js, jp, hot, mode, kernels="jnp" + route[5:],
                             **kw)


def _same_elastic(got, j_svc, msg):
    fates, hist, rep, logical, (slot, owner), errors = got
    assert fates == R.elastic_fates(j_svc), msg
    assert_same_history(hist, j_svc.history, msg)
    assert rep == R.report(j_svc), msg
    R.same_fields(logical, jp.logical_store(j_svc.store, j_svc.placement), msg)
    np.testing.assert_array_equal(slot, j_svc.placement.slot, err_msg=msg)
    np.testing.assert_array_equal(owner, j_svc.placement.owner,
                                  err_msg=msg)
    assert errors == [], msg


@pytest.mark.parametrize("mode", R.MODES)
@pytest.mark.parametrize("route", R.ROUTES)
def test_elastic_service_equals_jax(ranks, route, mode):
    j_svc = _jax_elastic(mode, route)
    rep = R.report(j_svc)
    assert rep["placement_moves"] >= 1 and rep["replica_commits"] > 0
    # the streaming driver's ticks do not refresh: the bootstrap only
    assert rep["replica_refreshes"] > (1 if mode == "step" else 0)
    for rank, res in enumerate(ranks[0]):
        _same_elastic(res[("elastic", route, mode)], j_svc,
                      f"{route}/{mode} rank {rank}")


_DURABLE = {}


def _jax_durable_elastic(tmp_path_factory):
    """The JAX twin of the ranks' crashed durable elastic session."""
    if not _DURABLE:
        d = str(tmp_path_factory.mktemp("jax_elastic"))
        mgr = jd.DurabilityManager(d, **R.DURABLE)
        svc = _jax_elastic("step", durability=mgr,
                           ticks=R.ELASTIC_TICKS[:3], move_at=3)
        mgr.crash()
        _DURABLE["svc"] = svc
    return _DURABLE["svc"]


@pytest.mark.parametrize("use_snapshot", [True, False])
def test_durable_elastic_crash_recovers_on_the_ranks(ranks, use_snapshot,
                                                     tmp_path_factory):
    j_svc = _jax_durable_elastic(tmp_path_factory)
    d = os.path.join(ranks[1], "elastic-crashed")
    kinds = [rt for rt, _ in jd.wal.scan(jd.wal_path(d)).records]
    assert kinds[-1] == jd.wal.REC_MOVE
    st = jd.recover(d, use_snapshot=use_snapshot)
    for rank, res in enumerate(ranks[0]):
        live, recs, _ = res["durable"]
        msg = f"rank {rank} snapshot={use_snapshot}"
        whole, clock, wave_idx, gc_clock, next_tid = live
        R.same_fields(whole, j_svc.store, msg + " live")
        assert (clock, wave_idx, gc_clock, next_tid) == (
            int(j_svc.clock), j_svc.wave_idx, j_svc.gc.clock,
            j_svc.former.next_tid), msg
        got = recs[0 if use_snapshot else 1]
        R.same_fields(got[0], st.store, msg)
        R.same_fields(got[0], j_svc.store, msg)
        assert got[2][:4] == (st.clock, st.wave_idx, st.gc_clock,
                              st.next_tid), msg
        assert (got[2][6] is not None) == use_snapshot, msg
        assert_same_history(got[3], st.history, msg)
        for a, b in zip(got[4], (st.placement_map.slot,
                                 st.placement_map.owner)):
            np.testing.assert_array_equal(a, b, err_msg=msg)


def test_durable_elastic_taken_up_on_the_ranks_equals_jax(ranks):
    d = os.path.join(ranks[1], "elastic-jax")
    mgr = jd.DurabilityManager(d, **R.DURABLE)
    j_svc = _jax_elastic("step", durability=mgr, ticks=[12] * 2,
                         move_at=False, gen_seed=32)
    mgr.close()
    for rank, res in enumerate(ranks[0]):
        _same_elastic(res["durable"][2], j_svc, f"rank {rank}")


def test_run_wave_planned_equals_jax(ranks):
    (wave,) = jw.ycsb_waves(np.random.RandomState(3), 1, 16, N, R.KPN,
                            theta=0.95, read_frac=0.3)
    j_st, j_clock, j_pw = jpl.run_wave_planned(
        jc.make_store(R.P_KEYS, 8), wave, 1, wave_idx0=1, next_tid=100,
        n_nodes=N, kernels="jnp")
    assert j_pw.lane_waves > 1
    for rank, res in enumerate(ranks[0]):
        merged, exec_tid, stacked, outs, n_waves, n_tids, clock, whole = \
            res["wave"]
        msg = f"rank {rank}"
        assert_same_history([(exec_tid, merged)],
                            [(j_pw.exec_tid, j_pw.merged)], msg)
        for f, a in zip(stacked._fields, stacked):
            np.testing.assert_array_equal(a, getattr(j_pw.stacked, f),
                                          err_msg=f"{msg} stacked.{f}")
        for f, a in zip(outs._fields, outs):
            np.testing.assert_array_equal(a, np.asarray(getattr(j_pw.outs,
                                                                f)),
                                          err_msg=f"{msg} outs.{f}")
        assert (n_waves, n_tids, clock) == (j_pw.waves_consumed,
                                            j_pw.tids_consumed,
                                            int(j_clock)), msg
        R.same_fields(whole, j_st, msg)


@pytest.mark.parametrize("route", R.ROUTES)
def test_run_workload_planned_equals_jax(ranks, route):
    j_st, j_h, j_s = jpl.run_workload_planned(
        jc.make_store(R.P_KEYS, 8), R.mixed_workload(jw, 1), n_nodes=N,
        kernels="jnp" + route[5:])
    assert j_s.aborted == 0 and j_s.lane_waves > j_s.waves
    for rank, res in enumerate(ranks[0]):
        hist, stats, whole = res[("workload", route)]
        msg = f"{route} rank {rank}"
        assert stats == tuple(j_s._replace(plan_s=0.0)), msg
        assert_same_history(hist, j_h, msg)
        R.same_fields(whole, j_st, msg)


@pytest.mark.parametrize("planner,mode,seed,n_ticks", R.PLANNER_SESSIONS,
                         ids=[f"{p}-{m}" for p, m, _, _ in
                              R.PLANNER_SESSIONS])
def test_planned_services_equal_jax(ranks, planner, mode, seed, n_ticks):
    j_svc = R.hot_service(js, planner, mode, seed, n_ticks, kernels="jnp")
    j_rep = R.report(j_svc)
    assert j_rep["planned_waves"] > 0
    if planner == "hybrid":
        assert j_rep["planner_switches"] >= 1
    for rank, res in enumerate(ranks[0]):
        fates, hist, rep, block, whole, errors = \
            res[("service", planner, mode)]
        msg = f"{planner}/{mode} rank {rank}"
        assert fates == R.fates(j_svc), msg
        assert_same_history(hist, j_svc.history, msg)
        assert rep == j_rep, msg
        R.same_fields(whole, j_svc.store, msg)
        assert errors == [], msg
