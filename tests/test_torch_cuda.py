"""The port's CUDA kernels on the card (marked ``cuda``; skipped without a
CUDA device).

Run on a machine with one: ``PYTHONPATH=src python -m pytest -m cuda
tests/test_torch_cuda.py``.  Each kernel must equal its plain PyTorch
version bit for bit on seeded inputs (pad keys 0 / -1 / hot, all-invisible
rows, T not a multiple of 32), the ``cuda`` routes of the engine must equal
the ``torch`` routes, and every launch must be counted.
"""
import numpy as np
import pytest
import torch

import repro_torch.core as tc
from repro_torch.core import workloads as tw
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.interval_negotiate import (potential_matrix_cuda,
                                                    potential_matrix_ref)
from repro_torch.kernels.version_scan import (version_scan_cuda,
                                              version_scan_plain)
from repro_torch.kernels.wave_commit import (wave_commit_cuda,
                                             wave_commit_plain)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU form")
    return torch.device("cuda")


def _inputs(dev, seed, n_keys, V, T, O, pad):
    rng = np.random.RandomState(seed)
    cid = (np.argsort(rng.rand(n_keys, V), 1) * 3
           + rng.randint(0, 3, (n_keys, 1)))
    tid = np.where(rng.rand(n_keys, V) < 0.3, -1,
                   rng.randint(1, 99, (n_keys, V)))
    sid = rng.randint(0, 40, (n_keys, V))
    val = rng.randint(-100, 100, (n_keys, V))
    keys = rng.randint(0, n_keys, (T, O))
    keys.reshape(-1)[::5] = pad
    mc = rng.randint(-1, 3 * V, (T, O))
    is_r, is_w = rng.rand(T, O) < 0.5, rng.rand(T, O) < 0.4
    t = lambda a, dt=torch.int32: torch.as_tensor(np.asarray(a),
                                                  dtype=dt, device=dev)
    return ([t(a) for a in (cid, tid, sid, val)], t(keys), t(mc),
            t(np.where(is_r, keys, -1)), t(np.where(is_w, keys, -1)),
            t(is_r, torch.bool))


def _same(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("pad", [0, -1, 7])
@pytest.mark.parametrize("T,O,V", [(40, 4, 8), (64, 3, 2), (130, 5, 4)])
def test_kernels_equal_plain_versions(dev, T, O, V, pad):
    (cid, tid, sid, val), keys, mc, rk, wk, rvalid = _inputs(
        dev, T + V, 512, V, T, O, pad)
    before = dict(LAUNCHES)
    flat = (cid, tid, mc.view(-1), keys.view(-1))
    _same(version_scan_cuda(*flat), version_scan_plain(*flat))
    _same((potential_matrix_cuda(rk, wk),), (potential_matrix_ref(rk, wk),))
    args = (cid, tid, sid, val, mc, rk, wk, rvalid)
    _same(wave_commit_cuda(*args, keys=keys),
          wave_commit_plain(*args, keys=keys))
    torch.cuda.synchronize()
    assert {k: LAUNCHES[k] - before[k] for k in LAUNCHES} == {
        "version_scan": 1, "potential_matrix": 1, "wave_commit": 1}


@pytest.mark.parametrize("sched", tc.SCHEDULERS)
def test_engine_cuda_routes_equal_torch_routes(dev, sched):
    waves = tw.smallbank_waves(np.random.RandomState(1), 3, 40, 4, 16,
                               hot_frac=0.5, hot_per_node=3, device=dev)
    results = {}
    for route in ("torch", "cuda", "torch+fused", "cuda+fused"):
        st, hist, stats = tc.run_workload_fused(
            tc.make_store(64, 4, device=dev), waves, sched=sched, n_nodes=4,
            gc_track=True, kernels=route)
        results[route] = (tc.store_to_numpy(st), hist, stats)
    ref_store, ref_hist, ref_stats = results["torch"]
    for route, (st, hist, stats) in results.items():
        assert stats == ref_stats, route
        for f in st:
            np.testing.assert_array_equal(st[f], ref_store[f])
        for (_, a), (_, b) in zip(hist, ref_hist):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
