"""The durability plane on the node mesh: what a mesh-served session logs
recovers to the same bits on any substrate and in either package.

* For the six schedulers, a durable mesh session (N=8, B=2, K=2,
  ``snapshot_every=3``) recovers onto a fresh mesh, onto the port's single
  device and through the JAX package's single-device ``recover()``, each
  equal to the live store and meta.
* An elastic mesh session (balancer moves and one explicit
  ``move_range``), whose log holds REC_MOVE frames between the blocks,
  recovers the same way with and without a snapshot, with the map's
  ``slot`` and ``owner``.
* A ``drop_node`` fault: the crashed log is a prefix of the uninterrupted
  one, it recovers onto a fresh mesh of the same arity, and a service
  started there takes it up, serves on and verifies.
"""
import shutil

import numpy as np
import pytest
import torch

from repro.core.workloads import poisson_arrivals
import repro.durability as jd
import repro_torch.core as tc
import repro_torch.durability as td
import repro_torch.placement as tp
import repro_torch.service as ts
from repro_torch.runtime import faults as tf

from test_torch_engine import assert_same_history, assert_same_store

N, KPN, T = 8, 8, 8
FIELDS = ("val", "tid", "cid", "sid", "head", "wave")


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """The plain loop on the mesh runs N times the small tensor ops of the
    local loop; on one intra-op thread they do not stall when the other
    test workers load every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _session(d, sched, mesh, faults=None, seed=3, n_ticks=6):
    hs = (np.round(np.linspace(0, 2, N)).astype(np.int32)
          if sched == "clocksi" else None)
    mgr = td.DurabilityManager(str(d), fsync_every=1, snapshot_every=3)
    svc = ts.TxnService(n_keys=N * KPN, T=T, sched=sched, n_nodes=N,
                        retry=ts.RetryPolicy(max_attempts=6), host_skew=hs,
                        seed=0, mesh=mesh, durability=mgr, faults=faults)
    gen = ts.ycsb_txn_gen(np.random.RandomState(seed + 100), N, KPN,
                          theta=0.6, read_frac=0.5)
    arr = poisson_arrivals(np.random.RandomState(seed + 200), 0.8 * T,
                           n_ticks)
    try:
        svc.run_streaming(arr, gen, B=2, K=2)
    except tf.InjectedCrash:
        mgr.crash()
        faults.mutilate_wal(mgr.wal_path, mgr.crash_synced_bytes)
        return svc, True
    mgr.close()
    return svc, False


def _same_state(st, svc, msg):
    assert_same_store(svc.store, st.store, msg)
    assert st.clock == int(svc.clock), msg
    assert (st.wave_idx, st.gc_clock, st.next_tid) == \
        (svc.wave_idx, svc.gc.clock, svc.former.next_tid), msg


@pytest.mark.parametrize("sched", tc.SCHEDULERS)
def test_mesh_wal_recovers_on_every_substrate(tmp_path, sched):
    mesh = tc.make_node_mesh(N, "cpu")
    svc, crashed = _session(tmp_path, sched, mesh)
    assert not crashed and svc.committed > 0
    assert td.wal.scan(td.wal_path(str(tmp_path))).config["n_slots"] == \
        N * KPN
    on_mesh = td.recover(str(tmp_path), mesh=tc.make_node_mesh(N, "cpu"))
    _same_state(on_mesh, svc, f"{sched} onto a fresh mesh")
    assert on_mesh.snapshot_seq is not None
    _same_state(td.recover(str(tmp_path), device="cpu"), svc,
                f"{sched} onto one device")
    full = td.recover(str(tmp_path), device="cpu", use_snapshot=False)
    _same_state(full, svc, f"{sched} full replay")
    assert_same_history(full.history, svc.history, f"{sched} history")
    _same_state(jd.recover(str(tmp_path)), svc, f"{sched} JAX recover")


def _elastic(d, mesh, snapshot_every, explicit_at=2):
    n_keys = N * 16
    mgr = td.DurabilityManager(str(d), fsync_every=1,
                               snapshot_every=snapshot_every)
    svc = ts.TxnService(n_keys=n_keys, n_versions=8, T=16, sched="postsi",
                        n_nodes=N, seed=1, mesh=mesh,
                        placement=tp.PlacementMap(n_keys, N, headroom=2),
                        balancer=True, durability=mgr)
    gen = ts.ycsb_txn_gen(np.random.RandomState(9), N, 16, theta=0.99)
    for tick in range(5):
        if tick == explicit_at:
            svc.move_range(100, 116, 2)
        svc.run_stream([12], gen, drain=False)
    svc.drain()
    mgr.crash()
    return svc


@pytest.mark.parametrize("snapshot_every", [None, 2])
def test_elastic_mesh_wal_with_moves_recovers_everywhere(tmp_path,
                                                          snapshot_every):
    svc = _elastic(tmp_path, tc.make_node_mesh(N, "cpu"), snapshot_every)
    kinds = [rt for rt, _ in td.wal.scan(td.wal_path(str(tmp_path))).records]
    assert kinds.count(td.wal.REC_MOVE) >= 2
    assert td.wal.REC_BLOCK in kinds[kinds.index(td.wal.REC_MOVE):]
    assert svc.report().placement_moves >= 2 and svc.verify() == []
    for label, st in (
            ("mesh", td.recover(str(tmp_path),
                                mesh=tc.make_node_mesh(N, "cpu"))),
            ("one device", td.recover(str(tmp_path), device="cpu")),
            ("JAX", jd.recover(str(tmp_path)))):
        _same_state(st, svc, label)
        np.testing.assert_array_equal(st.placement_map.slot,
                                      svc.placement.slot, err_msg=label)
        np.testing.assert_array_equal(st.placement_map.owner,
                                      svc.placement.owner, err_msg=label)
        if snapshot_every is None:
            assert_same_history(svc.history, st.history, label)


def test_drop_node_recovers_onto_a_fresh_mesh(tmp_path):
    mesh = tc.make_node_mesh(N, "cpu")
    ref_d, c_d = tmp_path / "ref", tmp_path / "crash"
    _, crashed = _session(ref_d, "postsi", mesh, n_ticks=10)
    assert not crashed
    faults = tf.FaultSchedule([tf.Fault("drop_node", "retire", 3)])
    _, crashed = _session(c_d, "postsi", mesh, faults=faults, n_ticks=10)
    assert crashed
    ref_blocks = td.wal.scan(td.wal_path(str(ref_d))).blocks
    c_blocks = td.wal.scan(td.wal_path(str(c_d))).blocks
    assert 0 < len(c_blocks) < len(ref_blocks)
    for i, (a, b) in enumerate(zip(c_blocks, ref_blocks)):
        for k in ("op_kind", "op_key", "op_val", "host", "tid", "status",
                  "s", "c"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{i}:{k}")
        assert (a["clock"], a["gc_clock"]) == (b["clock"], b["gc_clock"])
    replacement = tc.make_node_mesh(N, "cpu")
    st = td.recover(str(c_d), mesh=replacement)
    assert st.n_blocks == len(c_blocks)
    mgr = td.DurabilityManager(str(c_d), fsync_every=1)
    svc = ts.TxnService(n_keys=N * KPN, T=T, sched="postsi", n_nodes=N,
                        retry=ts.RetryPolicy(max_attempts=6), seed=0,
                        mesh=replacement, durability=mgr)
    assert_same_store(svc.store, st.store, "reattached")
    svc.run_streaming([4] * 4, ts.ycsb_txn_gen(np.random.RandomState(999),
                                               N, KPN, theta=0.6),
                      B=2, K=2)
    assert svc.verify() == []
    mgr.close()
    shutil.rmtree(ref_d)
