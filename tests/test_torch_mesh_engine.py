"""The port's node mesh held against the JAX single-device engine, bit for
bit.

The mesh (``repro_torch.core.dist_engine``: the store's rows split into N
blocks, each node's reads answered from its block and merged by a sum over
the node dimension, installs on the owner only) must give what one device
gives.  The oracle is the JAX package's single-device engine, in process;
the reference's own tests hold its mesh equal to it.  Checked here:

* all six schedulers x the per-wave and fused mesh drivers x the ``torch``
  and ``torch+fused`` routes at N=8, 32 keys a node, W=2 waves of T=16,
  ``gc_track`` and clocksi skew: every ``WaveOut`` field, the statistics
  and the store equal the JAX ``run_workload`` and the port's local
  engine;
* a store that does not divide the node count is padded with empty rows
  (100 keys on 8 nodes: 104 rows) and serves a 4-node logical cluster,
  its first 100 rows equal to the JAX unpadded run;
* a hypothesis differential over random micro waves and schedulers;
* the planned scheduler on the mesh equals the JAX planned run;
* the key -1 / last physical row corner on a placed mesh whose last row
  is headroom, before and after a move fills it;
* ``mesh_watermark`` is the min of the node floors; the guards of
  ``make_node_mesh`` and ``shard_store``; ``REPRO_PLACEMENT_CHECK=1``
  catches a mis-routed placement before dispatch; a ``cuda`` mesh over
  CPU tensors raises and nothing degrades;
* one cross-check against the JAX 8-device mesh, in a child python.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import jax.numpy as jnp

import repro.core as jc
from repro.core import workloads as jw
import repro.placement as jp
import repro.planner as jpl
import repro_torch.core as tc
from repro_torch.core import workloads as tw
from repro_torch.core.commit_phase import NOP, READ
import repro_torch.placement as tp
import repro_torch.planner as tpl
import repro_torch.service as ts

from test_torch_engine import assert_same_history, assert_same_store

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, KPN, W, T = 8, 32, 2, 16
SKEW = np.array([0, 1, 1, 2, 0, 1, 2, 0], np.int32)


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


def _same_stats(a, b):
    assert tuple(a) == tuple(b), (a, b)


@pytest.mark.parametrize("route", ["torch", "torch+fused"])
@pytest.mark.parametrize("sched", tc.SCHEDULERS)
def test_mesh_engine_equals_jax_and_local(mesh, sched, route):
    hs = SKEW if sched == "clocksi" else None
    kw = dict(sched=sched, host_skew=hs, gc_track=True)
    jwaves = jw.smallbank_waves(np.random.RandomState(7), W, T, N, KPN,
                                dist_frac=0.5, hot_frac=0.5, hot_per_node=4)
    twaves = tw.smallbank_waves(np.random.RandomState(7), W, T, N, KPN,
                                dist_frac=0.5, hot_frac=0.5, hot_per_node=4,
                                device="cpu")
    j_st, j_h, j_s = jc.run_workload(jc.make_store(N * KPN, 8), jwaves,
                                     n_nodes=N, kernels="jnp", **kw)
    l_st, l_h, l_s = tc.run_workload_fused(
        tc.make_store(N * KPN, 8, device="cpu"), twaves, n_nodes=N,
        kernels=route, **kw)
    for drv in (tc.run_workload_dist, tc.run_workload_fused_dist):
        st, h, s = drv(tc.shard_store(tc.make_store(N * KPN, 8, device="cpu"),
                                      mesh), twaves, mesh, kernels=route, **kw)
        msg = f"{sched}/{route}/{drv.__name__}"
        _same_stats(s, j_s)
        _same_stats(s, l_s)
        assert_same_history(h, j_h, msg)
        assert_same_history(h, l_h, msg + " local")
        assert_same_store(st, j_st, msg)
        assert_same_store(st, l_st, msg + " local")


def test_padded_mesh_serves_a_smaller_logical_cluster(mesh):
    pad = tc.shard_store(tc.make_store(100, 4, device="cpu"), mesh)
    assert pad.head.shape[0] == 104
    assert (pad.tid.numpy()[100:] == tc.NO_TID).all()
    kw = dict(dist_frac=0.5, hot_frac=0.5, hot_per_node=4)
    waves = lambda mod, **dev: mod.smallbank_waves(
        np.random.RandomState(3), 2, 16, 4, 25, **kw, **dev)
    j_st, j_h, j_s = jc.run_workload(jc.make_store(100, 4), waves(jw),
                                     sched="postsi", n_nodes=4, kernels="jnp")
    st, h, s = tc.run_workload_dist(pad, waves(tw, device="cpu"), mesh,
                                    sched="postsi", n_nodes=4)
    _same_stats(s, j_s)
    assert_same_history(h, j_h, "padded")
    assert_same_store(tc.MVStore(*(f[:100] for f in st)), j_st, "padded")
    assert (st.tid.numpy()[100:] == tc.NO_TID).all()     # pads untouched


@settings(max_examples=10, deadline=None, derandomize=True)
@given(seed=st.integers(0, 2 ** 16), sched=st.sampled_from(tc.SCHEDULERS),
       read_ratio=st.sampled_from([0.2, 0.6]),
       blind_frac=st.sampled_from([0.0, 0.8]))
def test_mesh_hypothesis_differential(seed, sched, read_ratio, blind_frac):
    n, kpn = 4, 16
    mesh = tc.make_node_mesh(n, "cpu")
    kw = dict(n_ops=3, read_ratio=read_ratio, dist_frac=0.5, hot_frac=0.6,
              hot_per_node=2, blind_frac=blind_frac)
    hs = np.array([0, 1, 0, 2], np.int32) if sched == "clocksi" else None
    _, j_h, j_s = jc.run_workload(
        jc.make_store(n * kpn, 4),
        jw.micro_waves(np.random.RandomState(seed), 1, 12, n, kpn, **kw),
        sched=sched, n_nodes=n, host_skew=hs, kernels="jnp")
    _, h, s = tc.run_workload_dist(
        tc.shard_store(tc.make_store(n * kpn, 4, device="cpu"), mesh),
        tw.micro_waves(np.random.RandomState(seed), 1, 12, n, kpn, **kw,
                       device="cpu"), mesh, sched=sched, host_skew=hs)
    _same_stats(s, j_s)
    assert_same_history(h, j_h, f"{sched}/{seed}")


def test_planned_mesh_equals_planned_local(mesh):
    def waves(mod, **dev):
        rng = np.random.RandomState(11)
        w = mod.ycsb_waves(rng, 2, 8, N, 16, theta=0.95, read_frac=0.3,
                           dist_frac=0.2, n_ops=4, **dev)
        return w + mod.chain_waves(rng, 1, 8, N, 16, chain_len=4,
                                   kind="waw", tid0=17, **dev)
    j_st, j_h, j_s = jpl.run_workload_planned(
        jc.make_store(N * 16, 8), waves(jw), n_nodes=N, kernels="jnp")
    st, h, s = tpl.run_workload_planned(
        tc.shard_store(tc.make_store(N * 16, 8, device="cpu"), mesh),
        waves(tw, device="cpu"), n_nodes=N, mesh=mesh)
    assert s.aborted == j_s.aborted == 0
    assert s._replace(plan_s=0) == j_s._replace(plan_s=0)
    assert_same_history(h, j_h, "planned")
    assert_same_store(st, j_st, "planned")
    assert tc.verify_si(h) == []
    assert tc.final_values_ok(st, h, N * 16) == []


@pytest.mark.parametrize("route", ["", "+fused"])
def test_negative_key_last_row_on_placed_mesh(route):
    """A wave whose NOP padding carries key -1 and whose live reads carry
    a key past the last one, over a placed store whose last physical row
    is headroom (empty), then after a move of 16 keys onto node 3 fills
    it.  No node owns -1, so the mesh reads 0 for it and drops its
    installs where one device wraps it to the last row; the NOP ops mask
    both, and the mesh equals the JAX single device in outcomes and in
    the placed store.  (A live op on key -1 is outside the engine's
    contract: no generator makes one.)"""
    n, n_keys = 4, 64
    tpm = tp.PlacementMap(n_keys, n, headroom=2)
    jpm = jp.PlacementMap(n_keys, n, headroom=2)
    mesh = tc.make_node_mesh(n, "cpu")
    t_st = tc.shard_store(tp.physical_store(
        tc.make_store(n_keys, 8, device="cpu"), tpm), mesh)
    assert t_st.head.shape[0] == tpm.n_slots
    assert t_st.tid.numpy()[-1, 0] == tc.NO_TID            # headroom row
    j_st = jp.physical_store(jc.make_store(n_keys, 8), jpm)
    clock_t, clock_j = 1, jnp.int32(1)
    for w in range(2):
        if w == 1:
            tr, jr = tpm.move(0, 16, 3), jpm.move(0, 16, 3)
            assert tr.new_slots[-1] == tpm.n_slots - 1     # fills the row
            t_st = tp.apply_move(t_st, tr, mesh=mesh)
            j_st = jp.apply_move(j_st, jr)
            tpm.apply_record(tr)
            jpm.apply_record(jr)
        (jwave,) = jw.micro_waves(np.random.RandomState(13 + w), 1, 12, n,
                                  n_keys // n, n_ops=3, read_ratio=0.5,
                                  dist_frac=0.5, hot_frac=0.5,
                                  hot_per_node=2, tid0=1 + 100 * w)
        kind, key, val = (np.array(f) for f in jwave[:3])
        kind[-2:], key[-2:], val[-2:] = NOP, -1, 0          # padding
        kind[1, 0], key[1, 0] = READ, n_keys + 3            # live reads
        jwave = jwave._replace(op_kind=jnp.asarray(kind),
                               op_key=jnp.asarray(key),
                               op_val=jnp.asarray(val))
        t_st, t_out, clock_t = tc.step_wave_dist(
            t_st, tc.wave_from_numpy(jwave, "cpu"), w + 1, clock_t, mesh,
            sched="postsi", kernels="torch" + route,
            placement=tpm.device_arrays("cpu"))
        j_st, j_out, clock_j = jc.step_wave(
            j_st, jwave, w + 1, clock_j, sched="postsi", n_nodes=n,
            kernels="jnp" + route, placement=jpm.device_arrays())
        assert_same_history([(0, t_out)], [(0, j_out)], f"corner w{w}")
        assert_same_store(t_st, j_st, f"corner w{w}")
        assert int(clock_t) == int(clock_j)


def test_mesh_watermark_is_the_min_of_the_node_floors(mesh):
    rng = np.random.RandomState(0)
    for _ in range(5):
        floors = rng.randint(0, 1000, N)
        assert tc.mesh_watermark(mesh, floors) == int(floors.min())
        assert tc.mesh_watermark(mesh, floors.tolist()) == int(floors.min())
    with pytest.raises(ValueError):
        tc.mesh_watermark(mesh, [1, 2, 3])
    gc = ts.VisibilityGC(n_nodes=N)
    gc.clock = 40
    handles = [gc.pin(12, node=5), gc.pin(30, node=1)]
    assert tc.mesh_watermark(mesh, gc.node_floors(N)) == gc.watermark() == 12
    gc.release(handles[0])
    assert tc.mesh_watermark(mesh, gc.node_floors(N)) == gc.watermark() == 30


def test_mesh_guards(mesh, monkeypatch):
    for bad in (0, -1):
        with pytest.raises(ValueError, match="node"):
            tc.make_node_mesh(bad, "cpu")
    assert tc.make_node_mesh(64, "cpu").n_nodes == 64   # one device, any N
    store = tc.make_store(100, 4, device="cpu")
    with pytest.raises(ValueError, match="multiple"):
        tc.shard_store(store, mesh, n_slots=108)
    with pytest.raises(ValueError, match="shrink"):
        tc.shard_store(store, mesh, n_slots=96)
    big = tc.shard_store(store, mesh, n_slots=128)
    assert big.head.shape[0] == 128 and (big.tid.numpy()[100:] == -1).all()
    assert all(torch.equal(a[:100], b) for a, b in zip(big, store))
    same = tc.make_store(N * 4, 4, device="cpu")
    assert all(a is b for a, b in zip(tc.shard_store(same, mesh), same))
    (wave,) = tw.ycsb_waves(np.random.RandomState(0), 1, 4, N, 4,
                            device="cpu")
    with pytest.raises(TypeError, match="NodeMesh"):
        tc.run_wave_dist(same, wave, 1, 1, object())
    with pytest.raises(ValueError, match="divide"):
        tc.run_wave_dist(tc.make_store(N * 4 + 1, 4, device="cpu"), wave,
                         1, 1, mesh)
    # the placement gate: key 0's ring moved onto node 3's block
    pm = tp.PlacementMap(N * 4, N, headroom=1)
    slot = pm.slot.copy()
    slot[0], slot[-1] = slot[-1], slot[0]
    bad = (pm.owner, slot)
    monkeypatch.setenv("REPRO_PLACEMENT_CHECK", "1")
    kw = dict(sched="postsi", placement=bad)
    with pytest.raises(tp.PlacementError, match="mis-routed"):
        tc.run_wave_dist(same, wave._replace(op_key=torch.zeros_like(
            wave.op_key)), 1, 1, mesh, **kw)
    with pytest.raises(tp.PlacementError, match="mis-routed"):
        tc.run_block_dist(same, [wave._replace(op_key=torch.zeros_like(
            wave.op_key))], 1, 1, mesh, **kw)


def test_cuda_mesh_over_cpu_tensors_raises(mesh):
    for spec in ("cuda", "cuda+fused"):
        with pytest.raises(ValueError, match="cuda"):
            tc.MeshSubstrate(N, spec, device="cpu")
        with pytest.raises(ValueError, match="cuda"):
            tc.mesh_kernels(spec, "cpu")
        with pytest.raises(ValueError, match="cuda"):
            tc.run_workload_dist(
                tc.shard_store(tc.make_store(N * 4, 4, device="cpu"), mesh),
                tw.ycsb_waves(np.random.RandomState(0), 1, 4, N, 4,
                              device="cpu"), mesh, kernels=spec)
        with pytest.raises(ValueError, match="cuda"):
            ts.TxnService(N * 4, T=4, n_nodes=N, mesh=mesh, kernels=spec)
    assert ts.TxnService(N * 4, T=4, n_nodes=N, mesh=mesh,
                         device="cpu").store.device == mesh.device
    assert tc.effective_mesh_backend("auto", "cpu") == "torch"
    assert tc.effective_mesh_backend("torch+fused", "cpu") == "torch+fused"
    assert tc.mesh_degrade_count() == 0


def test_mesh_equals_the_jax_eight_device_mesh(tmp_path):
    """The one cross-check of the JAX mesh itself: the reference's
    ``run_workload_fused_dist`` on 8 forced XLA devices (a child python,
    since the device count locks when jax starts) and the port's, postsi
    and clocksi, histories and stores equal."""
    code = r"""
import sys
import numpy as np
import repro.core as jc
from repro.core import workloads as jw
from repro.core.dist_engine import (make_node_mesh, run_workload_fused_dist,
                                    shard_store)
import repro_torch.core as tc
from repro_torch.core import workloads as tw
sys.path.insert(0, sys.argv[1])
from test_torch_engine import assert_same_history, assert_same_store
jmesh, tmesh = make_node_mesh(8), tc.make_node_mesh(8, "cpu")
skew = np.array([0, 1, 1, 2, 0, 1, 2, 0], np.int32)
for sched in ("postsi", "clocksi"):
    hs = skew if sched == "clocksi" else None
    kw = dict(dist_frac=0.5, hot_frac=0.5, hot_per_node=4)
    waves = lambda mod, **dev: mod.smallbank_waves(
        np.random.RandomState(7), 2, 16, 8, 32, **kw, **dev)
    j_st, j_h, j_s = run_workload_fused_dist(
        shard_store(jc.make_store(256, 8), jmesh), waves(jw), jmesh,
        sched=sched, host_skew=hs, gc_track=True, kernels="jnp+fused")
    t_st, t_h, t_s = tc.run_workload_fused_dist(
        tc.shard_store(tc.make_store(256, 8, device="cpu"), tmesh),
        waves(tw, device="cpu"), tmesh, sched=sched, host_skew=hs,
        gc_track=True, kernels="torch+fused")
    assert tuple(t_s) == tuple(j_s), (t_s, j_s)
    assert_same_history(t_h, j_h, sched)
    assert_same_store(t_st, j_st, sched)
    print("JAX-MESH-OK", sched, t_s.committed)
"""
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code,
                          os.path.join(ROOT, "tests")], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.count("JAX-MESH-OK") == 2
