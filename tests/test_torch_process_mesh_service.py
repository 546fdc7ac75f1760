"""``TxnService`` on the node mesh across processes held against the JAX
single-device service.

``spawn_ranks`` starts 4 ``gloo`` ranks on the CPU ONCE for the module;
every rank runs the same service loop on the same seeded arrivals, its
store holding only its block (``torch_process_mesh_ranks.service_cases``,
which imports no JAX).  The parent alone imports JAX and checks, each in
its own case:

* the step loop and ``run_streaming`` (B=4, K=2) on the ``torch`` and
  ``torch+fused`` routes: every rank's request fates, history and report
  (but for its wall-clock fields) equal each other and the JAX
  single-device session, the gathered store equals the JAX store and each
  rank's block, and ``verify() == []``;
* the watermark under pinned readers: a pin every rank holds, a pin on
  one rank only (each rank gives its own node's floor), none;
* a rank that hangs fails the run at its deadline, every rank killed.
"""
import time

import numpy as np
import pytest

import repro.service as js
from repro_torch.launch.mesh import RankFailure, spawn_ranks

import torch_process_mesh_ranks as R
from test_torch_engine import assert_same_history

N, KPN = R.N, R.KPN


@pytest.fixture(scope="module")
def ranks():
    return spawn_ranks(R.service_cases, N, device="cpu", deadline=240.0)


def _jax_session(route, mode):
    svc = js.TxnService(**R.service_kwargs(js), kernels="jnp" + route[5:])
    arr, gen = R.stream_inputs(js)
    if mode == "step":
        svc.run_stream(arr, gen)
    else:
        svc.run_streaming(arr, gen, B=4, K=2)
    rep = svc.report().as_dict()
    for k in R.WALL:
        rep.pop(k)
    return svc, rep


@pytest.mark.parametrize("mode", ["step", "stream"])
@pytest.mark.parametrize("route", R.ROUTES)
def test_process_mesh_service_equals_jax_single_device(ranks, route, mode):
    j_svc, j_rep = _jax_session(route, mode)
    n_local = N * KPN // N
    for rank, res in enumerate(ranks):
        fates, hist, rep, block, whole, errors = res[(route, mode)]
        msg = f"{route}/{mode} rank {rank}"
        assert fates == R.fates(j_svc), msg
        assert_same_history(hist, j_svc.history, msg)
        assert rep == j_rep, msg
        assert errors == [], msg
        assert rep["committed"] > 0 and (mode == "step") == \
            (rep["blocks"] == 0)
        for f, a in whole.items():
            np.testing.assert_array_equal(
                a, np.asarray(getattr(j_svc.store, f)), err_msg=f"{msg} {f}")
            np.testing.assert_array_equal(
                block[f], a[rank * n_local:(rank + 1) * n_local],
                err_msg=f"{msg} block {f}")


def test_process_mesh_watermark_under_pinned_readers(ranks):
    for rank, res in enumerate(ranks):
        marks, errors, committed = res["watermark"]
        # none, a pin everyone holds, released, a pin on rank 2 alone,
        # and that pin still held after a stream
        assert marks == [None, 3, None, 5, 5], (rank, marks)
        assert errors == [] and committed > 0


def test_a_hung_rank_fails_the_run_at_its_deadline():
    t0 = time.perf_counter()
    with pytest.raises(RankFailure,
                       match=r"ranks \[0, 1\] gave no result within the 12 s"):
        spawn_ranks(R.hang_on_rank, 2, args=(1,), device="cpu",
                    timeout=300.0, deadline=12.0)
    assert 12.0 <= time.perf_counter() - t0 < 40.0
