"""The port's node mesh across processes held against the JAX single-device
engine and the port's emulated mesh, bit for bit.

``repro_torch.launch.mesh.spawn_ranks`` starts 4 ``gloo`` ranks on the CPU
ONCE for the module; each is one node of a ``ProcessMesh`` holding only
its block of the store, and runs every case of
``torch_process_mesh_ranks.engine_cases`` (which imports no JAX).  The
parent alone imports JAX and checks each result in its own case:

* six schedulers x {``run_workload_fused_dist``, ``run_workload_dist``} x
  {``torch``, ``torch+fused``} at N=4, 32 keys a node, W=2 waves of T=16,
  ``gc_track`` and clocksi skew: every rank's ``WaveOut`` fields and
  statistics equal each other and the JAX ``run_workload``; the store
  ``gather_store`` gives equals every rank's block and the port's
  emulated ``make_node_mesh(4, "cpu")`` run;
* a padded store (102 keys on 4 ranks: 104 rows, the pads untouched);
* ``run_block_dist`` equals ``step_block_dist`` and the local
  ``step_block``;
* ``mesh_watermark`` is the min of the floors each rank gives for its
  own node;
* the guards: ``nccl`` on the CPU and two ``nccl`` ranks on one card
  raise before any rank starts, nothing switches backends, a rank that
  raises fails the run with its traceback.
"""
import time

import numpy as np
import pytest

import repro.core as jc
from repro.core import workloads as jw
import repro_torch.core as tc
from repro_torch.launch.mesh import RankFailure, spawn_ranks

import torch_process_mesh_ranks as R
from test_torch_engine import assert_same_history, assert_same_store

N, KPN = R.N, R.KPN
DEADLINE = 240.0


@pytest.fixture(scope="module")
def ranks():
    return spawn_ranks(R.engine_cases, N, device="cpu", deadline=DEADLINE)


def _jax_waves(seed=7, n_waves=R.W, n_nodes=N, kpn=KPN):
    return jw.smallbank_waves(np.random.RandomState(seed), n_waves, R.T,
                              n_nodes, kpn, dist_frac=0.5, hot_frac=0.5,
                              hot_per_node=4)


_JAX = {}


def _jax_run(sched):
    if sched not in _JAX:
        hs = R.SKEW if sched == "clocksi" else None
        _JAX[sched] = jc.run_workload(jc.make_store(N * KPN, 8), _jax_waves(),
                                      sched=sched, n_nodes=N, host_skew=hs,
                                      gc_track=True, kernels="jnp")
    return _JAX[sched]


def test_ranks_are_the_mesh_nodes(ranks):
    assert [r["mesh"] for r in ranks] == [(N, i, "cpu", "gloo")
                                          for i in range(N)]


@pytest.mark.parametrize("route", R.ROUTES)
@pytest.mark.parametrize("driver", R.DRIVERS)
@pytest.mark.parametrize("sched", tc.SCHEDULERS)
def test_process_mesh_equals_jax_and_emulated_mesh(ranks, sched, driver,
                                                   route):
    j_st, j_h, j_s = _jax_run(sched)
    hs = R.SKEW if sched == "clocksi" else None
    mesh = tc.make_node_mesh(N, "cpu")
    e_st, e_h, e_s = getattr(tc, driver)(
        tc.shard_store(tc.make_store(N * KPN, 8, device="cpu"), mesh),
        R.smallbank(), mesh, sched=sched, host_skew=hs, gc_track=True,
        kernels=route)
    e_np = tc.store_to_numpy(e_st)
    n_local = N * KPN // N
    for rank, res in enumerate(ranks):
        hist, stats, block, whole = res[(sched, driver, route)]
        msg = f"{sched}/{driver}/{route} rank {rank}"
        assert stats == tuple(j_s) == tuple(e_s), (msg, stats, j_s)
        assert_same_history(hist, j_h, msg)
        assert_same_history(hist, e_h, msg + " emulated")
        assert_same_store(tc.store_from_numpy(whole, "cpu"), j_st, msg)
        for f in whole:
            np.testing.assert_array_equal(whole[f], e_np[f],
                                          err_msg=f"{msg} emulated {f}")
            np.testing.assert_array_equal(
                block[f], whole[f][rank * n_local:(rank + 1) * n_local],
                err_msg=f"{msg} block {f}")


def test_padded_process_mesh(ranks):
    j_st, j_h, j_s = jc.run_workload(
        jc.make_store(R.PAD_KEYS, 4), _jax_waves(3, 2, 2, R.PAD_KEYS // 2),
        sched="postsi", n_nodes=2, kernels="jnp")
    for rank, res in enumerate(ranks):
        hist, stats, n_local, whole = res["padded"]
        assert n_local == 26
        assert stats == tuple(j_s)
        assert_same_history(hist, j_h, f"padded rank {rank}")
        assert whole["tid"].shape[0] == 104
        assert_same_store(tc.MVStore(*(tc.store_from_numpy(whole, "cpu")
                                       [i][:R.PAD_KEYS] for i in range(6))),
                          j_st, f"padded rank {rank}")
        assert (whole["tid"][R.PAD_KEYS:] == tc.NO_TID).all()  # untouched


def test_run_block_dist_equals_step_block_dist(ranks):
    s3, o3, c3 = tc.step_block(tc.make_store(N * 4, 4, device="cpu"),
                               R.block_waves(), 1, 1, sched="postsi",
                               n_nodes=4)
    for rank, res in enumerate(ranks):
        o1, o2, c1, c2, s1, s2 = res["block"]
        for a, b, c, name in zip(o1, o2, o3, o3._fields):
            np.testing.assert_array_equal(a, b, err_msg=f"{rank} {name}")
            np.testing.assert_array_equal(c, b, err_msg=f"{rank} {name}")
        assert c1 == c2 == int(c3)
        for f, a in tc.store_to_numpy(s3).items():
            np.testing.assert_array_equal(s1[f], a, err_msg=f)
            np.testing.assert_array_equal(s2[f], a, err_msg=f)


def test_mesh_watermark_is_the_min_of_the_node_floors(ranks):
    for res in ranks:
        for want, got in res["watermark"]:
            assert got == want


def test_nccl_refusals_raise_before_any_rank_starts(monkeypatch):
    t0 = time.perf_counter()
    with pytest.raises(ValueError, match="gloo"):
        spawn_ranks(R.fail_on_rank, 2, args=(0,), backend="nccl",
                    device="cpu")
    monkeypatch.setattr("torch.cuda.is_available", lambda: True)
    monkeypatch.setattr("torch.cuda.device_count", lambda: 1)
    with pytest.raises(ValueError, match="two ranks on one card"):
        spawn_ranks(R.fail_on_rank, 2, args=(0,), backend="nccl")
    tc.dist_engine.check_backend("gloo", "cuda", 8)      # gloo: any count
    monkeypatch.setattr("torch.cuda.device_count", lambda: 2)
    tc.dist_engine.check_backend("nccl", "cuda", 2)      # one card a rank
    with pytest.raises(ValueError, match="gloo"):
        spawn_ranks(R.fail_on_rank, 2, args=(0,), backend="mpi",
                    device="cpu")
    assert time.perf_counter() - t0 < 1.0          # no rank was started
    with pytest.raises(RuntimeError, match="process group"):
        tc.make_process_mesh(device="cpu")


def test_a_failed_rank_fails_the_run_with_its_traceback():
    t0 = time.perf_counter()
    with pytest.raises(RankFailure, match="rank 1 failed(.|\n)*on purpose"):
        spawn_ranks(R.fail_on_rank, 2, args=(1,), device="cpu",
                    deadline=60.0)
    assert time.perf_counter() - t0 < 60.0
