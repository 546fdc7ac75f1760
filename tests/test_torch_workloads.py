"""The port's workload generators against the JAX package's: the same
``RandomState`` seed must give array-equal waves (int32 leaves, equal
values) for SmallBank, TPC-C-lite, the microbenchmark, YCSB, dependency
chains and the write-hot RMW stream, and equal arrival processes."""
import numpy as np
import pytest
import torch

import repro.core.workloads as jw
import repro.service as js
import repro_torch.core.workloads as tw
import repro_torch.service as ts
from repro_torch.core import wave_to_numpy

N_NODES, KPN = 4, 64
BATCH = {
    "smallbank": dict(hot_frac=0.3),
    "tpcc": dict(),
    "micro": dict(n_ops=5, blind_frac=0.5, hot_frac=0.4),
    "ycsb": dict(theta=0.99),
    "chain": dict(kind="mixed", chain_len=3),
}


def _assert_waves_equal(twaves, jwaves):
    assert len(twaves) == len(jwaves)
    for tw_, jw_ in zip(twaves, jwaves):
        for f, a, b in zip(jw_._fields, wave_to_numpy(tw_), jw_):
            b = np.asarray(b)
            assert a.dtype == np.int32 and a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.parametrize("name", sorted(BATCH))
def test_batch_generators_match_jax(name):
    kw = BATCH[name]
    mk = lambda mod, **extra: getattr(mod, f"{name}_waves")(
        np.random.RandomState(11), 3, 24, N_NODES, KPN, **kw, tid0=5,
        **extra)
    twaves = mk(tw, device="cpu")
    assert all(w.op_kind.device == torch.device("cpu") for w in twaves)
    _assert_waves_equal(twaves, mk(jw))


@pytest.mark.parametrize("gen", ["smallbank", "ycsb", "rmw"])
def test_stream_generators_match_jax(gen):
    """The open-stream request factories (including ``rmw_txn_gen`` over
    ``workloads.rmw_hot_txn``) draw the same requests."""
    rj, rt = np.random.RandomState(4), np.random.RandomState(4)
    gj = getattr(js, f"{gen}_txn_gen")(rj, N_NODES, KPN)
    gt = getattr(ts, f"{gen}_txn_gen")(rt, N_NODES, KPN)
    for _ in range(50):
        for a, b in zip(gt(), gj()):
            np.testing.assert_array_equal(a, b)


def test_arrival_processes_match_jax():
    for fn, args in ((tw.poisson_arrivals, (7.5, 40)),
                     (tw.bursty_arrivals, (5.0, 40)),
                     (tw.tenant_poisson_arrivals, ([2.0, 6.0], 40))):
        got = fn(np.random.RandomState(3), *args)
        want = getattr(jw, fn.__name__)(np.random.RandomState(3), *args)
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tw.zipf_hot_keys(4, 64, 0.99),
                                  jw.zipf_hot_keys(4, 64, 0.99))


def test_generators_keep_in_txn_key_dedup():
    """The engine assumes distinct write keys per txn: duplicates are
    NOP-ed out with zeroed key and value, as in the reference."""
    for w in tw.smallbank_waves(np.random.RandomState(0), 4, 64, 2, 3,
                                device="cpu"):
        kind, key, val = (t.numpy() for t in w[:3])
        for t in range(kind.shape[0]):
            live = key[t][kind[t] != 0]
            assert len(set(live.tolist())) == len(live)
            assert (key[t][kind[t] == 0] == 0).all()
            assert (val[t][kind[t] == 0] == 0).all()
