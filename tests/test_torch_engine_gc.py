"""The port's engine against the JAX engine on the GC, skew, placement and
padding paths, bit for bit.

* ``gc_track`` / ``gc_block`` over a V=2 store whose rings are all wrapped,
  under an explicit GC watermark (evictions are real and counted or
  blocked);
* ``host_skew`` under clocksi (stale snapshots and skew waits);
* an explicit placement array (a random injective key -> row map);
* the pad-key regression of ``tests/test_kernel_backend.py``: a wave
  NOP-padded with key 0, -1 or a hot key gives the same ``WaveOut`` and
  store as the reference, and as each other.
"""
import numpy as np
import pytest

import jax.numpy as jnp

import repro.core as jc
from repro.core import workloads as jw
from repro.core.store import PlacementArrays as JPlacement
import repro_torch.core as tc
from repro_torch.core import workloads as tw

from test_torch_engine import assert_same_history, assert_same_store

ROUTES = ["", "+fused"]


def _wrapped_stores(n_keys, V=2):
    """Identical JAX / port stores with every ring wrapped three times."""
    js = jc.make_store(n_keys, V)
    ts = tc.make_store(n_keys, V, device="cpu")
    for v in range(3):
        js, _ = jc.store.install_version(
            js, jnp.arange(n_keys), jnp.full((n_keys,), v), jnp.int32(1),
            jnp.int32(v + 1), jnp.int32(0))
        ts, _ = tc.install_version(ts, np.arange(n_keys),
                                   np.full((n_keys,), v), 1, v + 1, 0)
    return js, ts


def _micro(mod, seed, n_waves=2, T=12, **extra):
    return mod.micro_waves(np.random.RandomState(seed), n_waves, T, 4, 4,
                           n_ops=3, read_ratio=0.4, dist_frac=0.5,
                           hot_frac=0.6, hot_per_node=2, blind_frac=0.5,
                           **extra)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("gc", ["track", "block"])
@pytest.mark.parametrize("sched", ["postsi", "si", "cv"])
def test_gc_track_and_block_match_jax(sched, gc, route):
    js, ts = _wrapped_stores(16)
    kw = dict(n_nodes=4, sched=sched, gc_track=gc == "track",
              gc_block=gc == "block")
    jwaves = _micro(jw, 5)
    twaves = _micro(tw, 5, device="cpu")
    clock_j, clock_t = jnp.int32(10), 10
    for w, (jwv, twv) in enumerate(zip(jwaves, twaves)):
        js, jo, clock_j = jc.run_wave(js, jwv, jnp.int32(w + 1), clock_j,
                                      watermark=jnp.int32(1),
                                      kernels="jnp" + route, **kw)
        ts, to, clock_t = tc.run_wave(ts, twv, w + 1, clock_t, watermark=1,
                                      kernels="torch" + route, **kw)
        assert_same_history([(twv.tid.numpy(), tc.wave_to_numpy(to))],
                            [(jwv.tid, jo)], f"{sched}/{gc}{route} w{w}")
        assert int(clock_t) == int(clock_j)
    assert_same_store(ts, js)


@pytest.mark.parametrize("route", ROUTES)
def test_clocksi_host_skew_matches_jax(route):
    hs = np.array([0, 2, 1, 3], np.int32)
    jwaves = jw.smallbank_waves(np.random.RandomState(8), 4, 16, 4, 6,
                                dist_frac=0.6)
    twaves = tw.smallbank_waves(np.random.RandomState(8), 4, 16, 4, 6,
                                dist_frac=0.6, device="cpu")
    js, jh, jstats = jc.run_workload(jc.make_store(24, 4), jwaves,
                                     sched="clocksi", host_skew=hs,
                                     n_nodes=4, kernels="jnp" + route)
    ts, th, tstats = tc.run_workload_fused(
        tc.make_store(24, 4, device="cpu"), twaves, sched="clocksi",
        host_skew=hs, n_nodes=4, kernels="torch" + route)
    assert_same_history(th, jh, "clocksi")
    assert_same_store(ts, js)
    assert tstats == jstats and tstats.waits > 0


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("sched", ["postsi", "dsi"])
def test_explicit_placement_matches_jax(sched, route):
    """Rings at rows ``slot[k]`` of a random permutation: outcomes equal
    the reference's under the same placement (and the store rows are
    permuted identically)."""
    n_keys = 32
    rng = np.random.RandomState(4)
    slot = rng.permutation(n_keys).astype(np.int32)
    owner = (np.arange(n_keys) % 4).astype(np.int32)
    jwaves = jw.smallbank_waves(np.random.RandomState(2), 3, 16, 4, 8)
    twaves = tw.smallbank_waves(np.random.RandomState(2), 3, 16, 4, 8,
                                device="cpu")
    jp = JPlacement(jnp.asarray(owner), jnp.asarray(slot))
    js, jh, _ = jc.run_workload(jc.make_store(n_keys, 4), jwaves,
                                sched=sched, n_nodes=4, gc_track=True,
                                kernels="jnp" + route, placement=jp)
    ts, th, _ = tc.run_workload_fused(
        tc.make_store(n_keys, 4, device="cpu"), twaves, sched=sched,
        n_nodes=4, gc_track=True, kernels="torch" + route,
        placement=(owner, slot))
    assert_same_history(th, jh, f"placement/{sched}")
    assert_same_store(ts, js)


def _nop_padded(mod, pad_key, T=8, O=3, **extra):
    """Half-real wave: rows T//2.. are NOP padding carrying ``pad_key``."""
    (wave,) = mod.micro_waves(np.random.RandomState(9), 1, T, 2, 8,
                              n_ops=O, read_ratio=0.4, dist_frac=0.5,
                              hot_frac=0.5, hot_per_node=2, **extra)
    kind, key, val = (np.array(tc.wave_to_numpy(wave)[f]) for f in range(3))
    kind[T // 2:], key[T // 2:], val[T // 2:] = 0, pad_key, 0
    return kind, key, val, wave


@pytest.mark.parametrize("route", ROUTES)
def test_negative_key_nop_padding_regression(route):
    """NOP padding with key 0, -1 or a hot key: identical WaveOut, store
    and GC accounting to the reference's and to each other's."""
    outs = []
    for pad_key in (0, -1, 3):
        kind, key, val, jwave = _nop_padded(jw, pad_key)
        jwave = jwave._replace(op_kind=jnp.asarray(kind),
                               op_key=jnp.asarray(key),
                               op_val=jnp.asarray(val))
        js, _ = _wrapped_stores(16)
        js, jo, _ = jc.run_wave(js, jwave, jnp.int32(1), jnp.int32(10),
                                jnp.int32(2), sched="postsi", gc_track=True,
                                watermark=jnp.int32(0),
                                kernels="jnp" + route)
        twave = tc.wave_from_numpy(jwave, "cpu")
        _, ts = _wrapped_stores(16)
        ts, to, _ = tc.run_wave(ts, twave, 1, 10, 2, sched="postsi",
                                gc_track=True, watermark=0,
                                kernels="torch" + route)
        assert_same_history([(twave.tid.numpy(), tc.wave_to_numpy(to))],
                            [(np.asarray(jwave.tid), jo)], f"pad {pad_key}")
        assert_same_store(ts, js, f"pad {pad_key}")
        outs.append((tc.wave_to_numpy(to), tc.store_to_numpy(ts)))
    for o, s in outs[1:]:
        for a, b in zip(outs[0][0], o):
            np.testing.assert_array_equal(a, b)
        for f in s:
            np.testing.assert_array_equal(outs[0][1][f], s[f])
