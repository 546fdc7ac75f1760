"""The port's closed-loop service held against the JAX service.

Same arrival stream, same request generator seed, same backoff seed: every
request must meet the same fate (status, every execution TID, commit tick,
attempts, interval), the served histories must be equal field by field,
and the ``ServiceReport`` must match except its wall-clock fields.  Both
histories must get the same verdict from ``verify()``, and that verdict
is ``[]`` wherever the reference's is.  Covers contended SmallBank
under several schedulers and both read-phase routes, zipfian YCSB, clocksi
with host skew, GC blocking on shallow rings, and two weighted tenants
with same-key RMW folding.
"""
import numpy as np
import pytest

from repro.core.workloads import poisson_arrivals, tenant_poisson_arrivals
import repro.service as js
import repro_torch.service as ts

from test_torch_engine import assert_same_history

N_NODES, KPN, T = 4, 40, 16
WALL = ("wall_s", "txns_per_sec", "goodput_tps")


def _fates(svc):
    return [(r.req_id, r.status, r.arrive_tick, r.commit_tick, r.attempts,
             tuple(r.tids), r.s, r.c, r.tenant, r.latency)
            for r in svc.requests]


def _serve(pkg, backend, arrivals, gen_name, gen_kw, svc_kw, seed=7):
    rng = np.random.RandomState(seed)
    if gen_name == "tenant":
        gen = pkg.tenant_txn_gen([
            pkg.smallbank_txn_gen(rng, N_NODES, KPN, hot_frac=0.6,
                                  hot_per_node=3),
            pkg.rmw_txn_gen(rng, N_NODES, KPN)])
    else:
        gen = getattr(pkg, f"{gen_name}_txn_gen")(rng, N_NODES, KPN,
                                                  **gen_kw)
    extra = {} if pkg is js else {"device": "cpu"}
    svc = pkg.TxnService(N_NODES * KPN, T=T, n_nodes=N_NODES,
                         kernels=backend, seed=3, **svc_kw, **extra)
    report = svc.run_stream(arrivals, gen)
    return svc, report


CASES = {
    "postsi-hot": ("postsi", "smallbank", dict(hot_frac=0.6, hot_per_node=3),
                   dict()),
    "si-hot": ("si", "smallbank", dict(hot_frac=0.6, hot_per_node=3),
               dict()),
    "cv-ycsb": ("cv", "ycsb", dict(theta=0.99), dict()),
    "clocksi-skew": ("clocksi", "smallbank", dict(dist_frac=0.6),
                     dict(host_skew=np.array([0, 2, 1, 3], np.int32))),
    "dsi-gc-block": ("dsi", "ycsb", dict(theta=0.9),
                     dict(n_versions=2, gc_block=True)),
}


@pytest.mark.parametrize("route", ["", "+fused"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_service_matches_jax(case, route):
    sched, gen_name, gen_kw, svc_kw = CASES[case]
    arrivals = poisson_arrivals(np.random.RandomState(1), 14.0, 10)
    j_svc, j_rep = _serve(js, "jnp" + route, arrivals, gen_name, gen_kw,
                          dict(sched=sched, **svc_kw))
    t_svc, t_rep = _serve(ts, "torch" + route, arrivals, gen_name, gen_kw,
                          dict(sched=sched, **svc_kw))
    assert _fates(t_svc) == _fates(j_svc)
    assert_same_history(t_svc.history, j_svc.history, case)
    jd, td = j_rep.as_dict(), t_rep.as_dict()
    for k in WALL:
        jd.pop(k), td.pop(k)
    assert td == jd
    assert t_rep.committed > 0
    # host skew gives clocksi stale snapshots that verify_si rejects in the
    # reference too; the verdicts must still agree
    assert t_svc.verify() == j_svc.verify()
    if case != "clocksi-skew":
        assert t_svc.verify() == []


def test_service_tenants_and_folding_match_jax():
    """Two weighted tenants (DRR packing), a write-hot single-RMW stream
    folded by (tenant, host, key): same fates, same fold accounting."""
    arrivals = tenant_poisson_arrivals(np.random.RandomState(2), [8.0, 10.0],
                                       10)
    kw = dict(sched="postsi", tenants={0: 2.0, 1: 1.0}, fold_rmw=True)
    j_svc, j_rep = _serve(js, "jnp", arrivals, "tenant", {}, kw)
    t_svc, t_rep = _serve(ts, "torch", arrivals, "tenant", {}, kw)
    assert _fates(t_svc) == _fates(j_svc)
    assert_same_history(t_svc.history, j_svc.history, "tenants")
    jd, td = j_rep.as_dict(), t_rep.as_dict()
    for k in WALL:
        jd.pop(k), td.pop(k)
    assert td == jd
    assert t_rep.fold_groups > 0 and set(t_rep.tenants) == {"0", "1"}
    assert t_svc.verify() == []
