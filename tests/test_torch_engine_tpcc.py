"""The port's wave engine against the JAX engine on TPC-C-lite waves (12
ops per txn, hot district/warehouse rows), bit for bit, for all six
schedulers and both read-phase routes — the per-wave and fused drivers
(see ``test_torch_engine.py``)."""
import pytest

import repro_torch.core as tc

from test_torch_engine import check_engine_matches_jax


@pytest.mark.parametrize("route", ["", "+fused"])
@pytest.mark.parametrize("sched", tc.SCHEDULERS)
def test_tpcc_matches_jax(sched, route):
    check_engine_matches_jax("tpcc", sched, route, ("perwave", "fused"))
