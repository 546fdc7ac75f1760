"""The port's service planes on the node mesh held against one device.

``TxnService(mesh=...)`` shards the store over the mesh's emulated nodes
and serves every wave or block through the mesh drivers; what it serves
must be what one device serves, request for request:

* the mesh service equals the JAX single-device service on the same stream
  (every request's fate, the history, the report but for its wall-clock
  fields, p50/p95/p99 included) and the port's single-device store, with
  ``verify() == []``; the merged GC watermark equals the tracker's;
* streaming on the mesh: B=1, K=1 equals the mesh step loop for the six
  schedulers, and B=2, K=2 equals single-device streaming; a dispatched
  block (``run_block_dist``) equals ``step_block_dist``;
* elastic placement on the mesh (live balancer moves) equals the static
  mesh session at zipf theta=0.99 for the seven schedulers;
* hot-key replicas on the mesh never answer above the watermark's clock;
* same-key RMW folding on the mesh is commit-set-equal to the unfolded
  session and to the single-device one.
"""
import numpy as np
import pytest
import torch

from repro.core.workloads import poisson_arrivals
import repro.service as js
import repro_torch.core as tc
from repro_torch.core import workloads as tw
import repro_torch.placement as tp
import repro_torch.service as ts

from test_torch_engine import assert_same_history, assert_same_store
from test_torch_service import WALL, _fates

N, KPN = 8, 32


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """The plain loop on the mesh runs N times the small tensor ops of the
    local loop; on one intra-op thread they do not stall when the other
    test workers load every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mesh():
    return tc.make_node_mesh(N, "cpu")


def _report(svc):
    rep = svc.report().as_dict()
    for k in WALL:
        rep.pop(k)
    return rep


@pytest.mark.parametrize("route", ["", "+fused"])
def test_mesh_service_equals_single_device(mesh, route):
    def serve(pkg, kernels, **kw):
        svc = pkg.TxnService(n_keys=N * KPN, n_versions=8, T=16,
                             sched="postsi", n_nodes=N,
                             retry=pkg.RetryPolicy(max_attempts=6), seed=0,
                             kernels=kernels, **kw)
        arr = poisson_arrivals(np.random.RandomState(100), 0.9 * 16, 8)
        gen = pkg.smallbank_txn_gen(np.random.RandomState(200), N, KPN,
                                    dist_frac=0.3, hot_frac=0.6,
                                    hot_per_node=3)
        svc.run_stream(arr, gen)
        return svc
    j_svc = serve(js, "jnp" + route)
    local = serve(ts, "torch" + route, device="cpu")
    m_svc = serve(ts, "torch" + route, mesh=mesh)
    assert m_svc.store.head.shape[0] == N * KPN
    assert _fates(m_svc) == _fates(j_svc)
    assert_same_history(m_svc.history, j_svc.history, "mesh service")
    assert _report(m_svc) == _report(j_svc)
    assert_same_store(m_svc.store, j_svc.store, "mesh service")
    assert_same_store(m_svc.store, local.store, "mesh service, local")
    assert m_svc.verify() == [] and m_svc.committed > 0
    h = m_svc.gc.pin(3, node=5)
    assert m_svc._watermark() == m_svc.gc.watermark() == 3
    m_svc.gc.release(h)
    assert m_svc._watermark() is None


def _stream_session(mesh, sched, mode, B=1, K=1):
    hs = (np.round(np.linspace(0, 2, N)).astype(np.int32)
          if sched == "clocksi" else None)
    extra = dict(device="cpu") if mesh is None else dict(mesh=mesh)
    svc = ts.TxnService(n_keys=N * KPN, T=8, sched=sched, n_nodes=N,
                        retry=ts.RetryPolicy(max_attempts=6), host_skew=hs,
                        seed=0, **extra)
    arr = poisson_arrivals(np.random.RandomState(100), 0.8 * 8, 5)
    gen = ts.ycsb_txn_gen(np.random.RandomState(200), N, KPN, theta=0.9,
                          read_frac=0.5, dist_frac=0.3)
    rep = (svc.run_stream(arr, gen) if mode == "step"
           else svc.run_streaming(arr, gen, B=B, K=K))
    return svc, rep


@pytest.mark.parametrize("sched", tc.SCHEDULERS)
def test_mesh_streaming_b1k1_equals_mesh_step_loop(mesh, sched):
    a, ra = _stream_session(mesh, sched, "step")
    b, rb = _stream_session(mesh, sched, "stream")
    assert_same_history(b.history, a.history, sched)
    assert _fates(b) == _fates(a)
    assert (ra.committed, ra.dropped, ra.retries) == \
        (rb.committed, rb.dropped, rb.retries)
    assert ra.committed > 0


def test_mesh_streaming_blocks_equal_local_streaming(mesh):
    c, _ = _stream_session(mesh, "postsi", "stream", B=2, K=2)
    d, _ = _stream_session(None, "postsi", "stream", B=2, K=2)
    assert_same_history(c.history, d.history, "B=2 K=2")
    assert _fates(c) == _fates(d)
    assert_same_store(c.store, d.store, "B=2 K=2")
    assert c.verify() == [] and c.report().blocks > 0


def test_run_block_dist_equals_step_block_dist(mesh):
    stacked = tc.stack_waves(tw.ycsb_waves(
        np.random.RandomState(0), 3, 4, N, 4, theta=0.9, read_frac=0.3,
        device="cpu"))
    fresh = lambda: tc.shard_store(tc.make_store(N * 4, 4, device="cpu"),
                                   mesh)
    s1, o1, c1 = tc.run_block_dist(fresh(), stacked, 1, 1, mesh,
                                   sched="postsi", n_nodes=4)
    s2, o2, c2 = tc.step_block_dist(fresh(), stacked, 1, 1, mesh,
                                    sched="postsi", n_nodes=4)
    s3, o3, c3 = tc.step_block(tc.make_store(N * 4, 4, device="cpu"),
                               stacked, 1, 1, sched="postsi", n_nodes=4)
    assert all(isinstance(leaf, np.ndarray) for leaf in o2)
    for a, b, c, name in zip(o1, o2, o3, o2._fields):
        np.testing.assert_array_equal(a.numpy(), b, err_msg=name)
        np.testing.assert_array_equal(c, b, err_msg=name)
    for a, b, c in zip(s1, s2, s3):
        assert torch.equal(a, b) and torch.equal(c, b)
    assert int(c1) == int(c2) == int(c3)


ELASTIC = [("postsi", ""), ("postsi", "+fused"), ("cv", ""), ("si", ""),
           ("optimal", ""), ("dsi", ""), ("clocksi", ""), ("planned", ""),
           ("planned", "+fused")]


@pytest.mark.parametrize("sched,route", ELASTIC)
def test_elastic_mesh_equals_static_theta099(mesh, sched, route):
    n_keys = N * 16

    def serve(placement, balancer):
        hs = (np.array([0, 1, 1, 2, 0, 1, 2, 0], np.int32)
              if sched == "clocksi" else None)
        svc = ts.TxnService(n_keys=n_keys, n_versions=8, T=16,
                            sched="postsi" if sched == "planned" else sched,
                            n_nodes=N, host_skew=hs, seed=0, mesh=mesh,
                            kernels="torch" + route,
                            planner="planned" if sched == "planned" else None,
                            placement=placement, balancer=balancer)
        gen = ts.ycsb_txn_gen(np.random.RandomState(42), N, 16, theta=0.99)
        svc.run_stream([12] * 4, gen)
        return svc
    a = serve(None, None)
    b = serve(tp.PlacementMap(n_keys, N, headroom=2), True)
    assert b.store.head.shape[0] == 2 * n_keys
    cs = lambda s: sorted(r.req_id for r in s.requests
                          if r.status == "committed")
    assert cs(a) == cs(b) and a.committed > 0
    assert_same_history(b.history, a.history, f"{sched}{route}")
    assert_same_store(tp.logical_store(b.store, b.placement), a.store,
                      f"{sched}{route}")
    if sched != "clocksi":       # skewed hosts read stale snapshots by design
        assert b.verify() == []
    assert b.report().placement_moves >= 1


def test_mesh_replicas_never_run_ahead_of_the_watermark(mesh):
    n_keys = N * 16
    hot = tw.zipf_hot_keys(N, 16, theta=0.99)
    svc = ts.TxnService(n_keys=n_keys, n_versions=8, T=16, sched="postsi",
                        n_nodes=N, seed=0, mesh=mesh,
                        placement=tp.PlacementMap(n_keys, N, headroom=2),
                        replicas=hot, balancer=True)
    floors = []
    refresh = svc._refresh_replicas

    def checked():
        refresh()
        floors.append(svc.replicas.floor)
        assert svc.replicas.max_cid() <= svc.replicas.floor <= svc.gc.clock
    svc._refresh_replicas = checked
    svc.run_stream([12] * 4, ts.ycsb_txn_gen(np.random.RandomState(7), N, 16,
                                             theta=0.99))
    assert svc.verify() == []
    assert svc.replica_commits > 0 and len(floors) > 1
    for r in svc.requests:
        if r.replica:
            assert r.s == r.c <= svc.gc.clock


def test_mesh_rmw_folding_commit_set_equal_local():
    mesh = tc.make_node_mesh(4, "cpu")
    n_keys = 40

    def run(fold, mesh_):
        gen = ts.rmw_txn_gen(np.random.RandomState(7), 4, n_keys // 4,
                             theta=0.99)
        extra = dict(device="cpu") if mesh_ is None else dict(mesh=mesh_)
        svc = ts.TxnService(n_keys, T=8, n_nodes=4, fold_rmw=fold,
                            max_queue=10_000, seed=3,
                            retry=ts.RetryPolicy(max_attempts=30,
                                                 jitter=False), **extra)
        svc.run_stream([5] * 8, gen)
        assert svc.verify() == []
        head, val = svc.store.head.numpy(), svc.store.val.numpy()
        ids = sorted(r.req_id for r in svc.requests
                     if r.status == "committed")
        return ids, [int(val[k, head[k]]) for k in range(n_keys)], svc
    a, b, c = run(False, mesh), run(True, mesh), run(True, None)
    assert a[:2] == b[:2] == c[:2]
    assert b[2].report().folded_requests > 0
    assert_same_history(b[2].history, c[2].history, "fold")
