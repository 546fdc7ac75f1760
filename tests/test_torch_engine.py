"""The port's wave engine held against the JAX engine, bit for bit.

Same seeded waves (each package's own generator, same ``RandomState``
seed), same fresh store: for all six schedulers, both read-phase routes
(three dispatches / ``+fused``) and SmallBank, TPC-C-lite and YCSB at
θ=0.99, every ``WaveOut`` field (values and dtypes) and every final store
field must equal the JAX engine's on its ``jnp`` / ``jnp+fused`` backend.
The port's per-wave (``run_workload``), fused (``run_workload_fused``)
and block (``step_block``) drivers are each checked.  The JAX reference
runs its per-wave driver, which its own suite pins to its fused one.
"""
import numpy as np
import pytest

import repro.core as jc
from repro.core import workloads as jw
import repro_torch.core as tc
from repro_torch.core import workloads as tw

N_NODES, T, V, N_WAVES = 4, 16, 4, 3
WORKLOADS = {
    "smallbank": (dict(), 8),
    "ycsb": (dict(theta=0.99), 8),
    "tpcc": (dict(), 64),
}


def _waves(mod, name, seed, **extra):
    kw, kpn = WORKLOADS[name]
    return getattr(mod, f"{name}_waves")(np.random.RandomState(seed),
                                         N_WAVES, T, N_NODES, kpn, **kw,
                                         **extra)


def assert_same_history(h_torch, h_jax, msg=""):
    assert len(h_torch) == len(h_jax)
    for w, ((ta, oa), (tb, ob)) in enumerate(zip(h_torch, h_jax)):
        np.testing.assert_array_equal(ta, np.asarray(tb))
        for f, a, b in zip(oa._fields, oa, ob):
            b = np.asarray(b)
            assert a.dtype == b.dtype, (msg, w, f, a.dtype, b.dtype)
            np.testing.assert_array_equal(a, b, err_msg=f"{msg} w{w}.{f}")


def assert_same_store(st_torch, st_jax, msg=""):
    for f, a in tc.store_to_numpy(st_torch).items():
        np.testing.assert_array_equal(a, np.asarray(getattr(st_jax, f)),
                                      err_msg=f"{msg} store.{f}")


def check_engine_matches_jax(workload, sched, route, drivers):
    """Run ``workload`` through the JAX per-wave driver and each of the
    port's ``drivers`` ("perwave", "fused", "block"); require equal
    histories, stores and stats."""
    kpn = WORKLOADS[workload][1]
    n_keys = N_NODES * kpn
    hs = np.array([0, 1, 0, 2], np.int32) if sched == "clocksi" else None
    kw = dict(sched=sched, n_nodes=N_NODES, host_skew=hs, gc_track=True)
    j_store, j_hist, j_stats = jc.run_workload(
        jc.make_store(n_keys, V), _waves(jw, workload, 3),
        kernels="jnp" + route, **kw)
    waves = _waves(tw, workload, 3, device="cpu")
    msg = f"{workload}/{sched}{route}"
    replay = {"perwave": tc.run_workload, "fused": tc.run_workload_fused}
    for name in drivers:
        if name == "block":
            # all waves as one [B] block (gc_track defaults on)
            st, outs, _ = tc.step_block(
                tc.make_store(n_keys, V, device="cpu"),
                tc.stack_waves(waves), 1, 1, sched=sched, n_nodes=N_NODES,
                host_skew=hs, kernels="torch" + route)
            hist = [(w.tid.numpy(), tc.WaveOut(*(f[i] for f in outs)))
                    for i, w in enumerate(waves)]
        else:
            st, hist, stats = replay[name](
                tc.make_store(n_keys, V, device="cpu"), waves,
                kernels="torch" + route, **kw)
            assert stats == j_stats
        assert_same_history(hist, j_hist, f"{msg} {name}")
        assert_same_store(st, j_store, f"{msg} {name}")


@pytest.mark.parametrize("route", ["", "+fused"])
@pytest.mark.parametrize("sched", tc.SCHEDULERS)
def test_smallbank_all_drivers_match_jax(sched, route):
    check_engine_matches_jax("smallbank", sched, route,
                             ("perwave", "fused", "block"))


@pytest.mark.parametrize("route", ["", "+fused"])
@pytest.mark.parametrize("sched", tc.SCHEDULERS)
def test_ycsb_skewed_matches_jax(sched, route):
    check_engine_matches_jax("ycsb", sched, route, ("fused",))
