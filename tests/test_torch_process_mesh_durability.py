"""The durability plane on the node mesh across processes, held against the
JAX single-device service and the port's emulated mesh.

The module spawns 4 ``gloo`` ranks on the CPU twice: the first spawn
serves and logs (``torch_process_mesh_ranks.durability_cases``), the
second, fresh, recovers what the first left (``recovery_cases``), as the
reference's replacement mesh does after a ``drop_node``.  The ranks import
no JAX; the parent alone does and checks, each in its own case:

* the durable step loop and ``run_streaming`` (B=4, K=2) on ``torch`` and
  ``torch+fused``: every rank's fates, history and report (wall-clock
  fields aside) equal the JAX single-device durable session, the gathered
  store its store; rank 0 alone wrote, every rank's record count and
  snapshot cadence agree;
* the WAL's bytes and the last snapshot equal those the port's emulated
  ``make_node_mesh(4, "cpu")`` session writes;
* the fresh ranks' ``recover(mesh=...)`` from the snapshot and by full
  replay equals the live store; the JAX ``recover`` of the ranks'
  directory equals it too, and the ranks recover a directory the JAX
  package wrote to the JAX live store;
* a ``drop_node`` crash leaves a log that is a prefix of the uninterrupted
  one; the fresh ranks recover it, reattach and serve on exactly as the
  JAX service reattached to a copy of it;
* a group-commit crash: every rank reports rank 0's fsync barrier and
  at-risk records, rank 0 alone tears the tail, and the fresh ranks
  recover what the JAX package recovers;
* ``compressed_psum(x_i, group=...)`` equals the JAX ``compressed_psum``
  over a ``vmap``-ped axis and the emulated stacked ``compressed_psum(x)``
  bit for bit, total and error.
"""
import os
import shutil

import jax
import numpy as np
import pytest
import torch

import repro.durability as jd
import repro.optim.compress as jc
import repro.service as js
import repro_torch.core as tc
import repro_torch.durability as td
import repro_torch.service as ts
from repro_torch.launch.mesh import spawn_ranks
from repro_torch.optim.compress import compressed_psum

import torch_process_mesh_ranks as R
from test_torch_engine import assert_same_history

N = R.N
CASES = [(route, mode) for route in R.ROUTES for mode in R.MODES]
IDS = [f"{route}-{mode}" for route, mode in CASES]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """(first spawn's results, second spawn's, the directories' root)."""
    root = str(tmp_path_factory.mktemp("ranks"))
    _jax_durable("torch", "stream", os.path.join(root, "jax"))
    first = spawn_ranks(R.durability_cases, N, device="cpu", deadline=240.0,
                        args=(root, os.path.join(root, "jax")))
    # the JAX reattach serves on from a copy of the crashed directory
    shutil.copytree(os.path.join(root, "crash"),
                    os.path.join(root, "crash-jax"))
    second = spawn_ranks(R.recovery_cases, N, device="cpu", deadline=240.0,
                         args=(root,))
    return first, second, root


_JAX = {}


def _jax_durable(route, mode, d=None):
    """The JAX single-device durable session (cached by route and mode)
    and its report without the wall-clock fields."""
    if (route, mode) not in _JAX:
        mgr = jd.DurabilityManager(d, **R.DURABLE)
        svc = js.TxnService(**R.service_kwargs(js),
                            kernels="jnp" + route[5:], durability=mgr)
        R.serve(svc, js, mode)
        mgr.close()
        _JAX[(route, mode)] = (svc, R.report(svc))
    return _JAX[(route, mode)]


def _same_recovered(got, st, msg):
    """A rank's ``recovered`` tuple against a ``RecoveredState`` of one
    device (either package)."""
    whole, _, meta, hist, _ = got
    R.same_fields(whole, st.store, msg)
    assert meta[:4] == (st.clock, st.wave_idx, st.gc_clock, st.next_tid), \
        msg
    assert meta[4] == st.n_blocks and meta[7] == st.n_records, msg
    assert_same_history(hist, st.history, msg)


def _wal_bytes(d):
    with open(td.wal_path(d), "rb") as f:
        return f.read()


@pytest.mark.parametrize("route,mode", CASES, ids=IDS)
def test_durable_session_equals_jax_single_device(ranks, route, mode,
                                                  tmp_path):
    j_svc, j_rep = _jax_durable(route, mode, str(tmp_path))
    counters = set()
    for rank, res in enumerate(ranks[0]):
        fates, hist, rep, block, whole, errors, mgr = \
            res[("durable", route, mode)]
        msg = f"{route}/{mode} rank {rank}"
        assert fates == R.fates(j_svc), msg
        assert_same_history(hist, j_svc.history, msg)
        assert rep == j_rep, msg
        assert errors == [] and rep["committed"] > 0, msg
        R.same_fields(whole, j_svc.store, msg)
        seq, snaps, since, writes = mgr
        assert writes == (rank == 0), msg
        counters.add((seq, snaps, since))
    assert len(counters) == 1
    (seq, snaps, _), = counters
    scan = td.wal.scan(td.wal_path(os.path.join(ranks[2],
                                                f"{route}-{mode}")))
    assert snaps >= 1 and seq == len(scan.records)


@pytest.mark.parametrize("route,mode", CASES, ids=IDS)
def test_wal_and_snapshot_bytes_equal_the_emulated_mesh(ranks, route, mode,
                                                        tmp_path):
    mgr = td.DurabilityManager(str(tmp_path), **R.DURABLE)
    svc = ts.TxnService(**R.service_kwargs(ts), kernels=route,
                        mesh=tc.make_node_mesh(N, "cpu"), durability=mgr)
    R.serve(svc, ts, mode)
    mgr.close()
    d = os.path.join(ranks[2], f"{route}-{mode}")
    assert _wal_bytes(d) == _wal_bytes(str(tmp_path))
    n_slots = R.N * R.KPN
    got = td.SnapshotStore(d, n_slots, 8).restore_latest()
    want = td.SnapshotStore(str(tmp_path), n_slots, 8).restore_latest()
    assert got is not None and want is not None
    assert (got.clock, got.wave_idx, got.wal_seq, got.gc_clock,
            got.next_tid, got.snap_id) == (
        want.clock, want.wave_idx, want.wal_seq, want.gc_clock,
        want.next_tid, want.snap_id)
    for f, a in got.store.items():
        np.testing.assert_array_equal(a, want.store[f], err_msg=f)


@pytest.mark.parametrize("route,mode", CASES, ids=IDS)
def test_fresh_ranks_and_jax_recover_the_live_store(ranks, route, mode):
    first, second, root = ranks
    d = os.path.join(root, f"{route}-{mode}")
    j_st = jd.recover(d, use_snapshot=False)
    live = first[0][("durable", route, mode)]
    R.same_fields(live[4], j_st.store, f"JAX recover of {d}")
    for use_snapshot in (True, False):
        st = jd.recover(d, use_snapshot=use_snapshot)
        for rank, res in enumerate(second):
            whole, block, meta, hist, _ = res[(route, mode, use_snapshot)]
            msg = f"{route}/{mode} snapshot={use_snapshot} rank {rank}"
            _same_recovered(res[(route, mode, use_snapshot)], st, msg)
            for f, a in whole.items():
                np.testing.assert_array_equal(a, live[4][f], err_msg=msg)
                n_local = a.shape[0] // N
                np.testing.assert_array_equal(
                    block[f], a[rank * n_local:(rank + 1) * n_local])
            assert (meta[6] is not None) == use_snapshot, msg
            if not use_snapshot:
                assert_same_history(hist, live[1], msg)


@pytest.mark.parametrize("use_snapshot", [True, False])
def test_ranks_recover_a_directory_the_jax_package_wrote(ranks,
                                                         use_snapshot):
    j_svc, _ = _jax_durable("torch", "stream")
    st = jd.recover(os.path.join(ranks[2], "jax"),
                    use_snapshot=use_snapshot)
    for rank, res in enumerate(ranks[0]):
        got = res[("jax dir", use_snapshot)]
        _same_recovered(got, st, f"rank {rank}")
        R.same_fields(got[0], j_svc.store, f"rank {rank} live")


def test_drop_node_prefix_and_recovery_on_fresh_ranks(ranks):
    first, second, root = ranks
    assert {res["crash"] for res in first} == {(True, R.CRASH_AT)}
    ref = td.wal.scan(td.wal_path(os.path.join(root, "torch-stream")))
    crashed = td.wal.scan(td.wal_path(os.path.join(root, "crash-jax")))
    assert 0 < len(crashed.blocks) < len(ref.blocks)
    for i, (a, b) in enumerate(zip(crashed.blocks, ref.blocks)):
        for k in ("op_kind", "op_key", "op_val", "host", "tid", "status",
                  "s", "c"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{i}:{k}")
        assert (a["clock"], a["gc_clock"]) == (b["clock"], b["gc_clock"])
    # the replacement: JAX reattaches to the copy and serves the same
    st = jd.recover(os.path.join(root, "crash-jax"))
    mgr = jd.DurabilityManager(os.path.join(root, "crash-jax"),
                               fsync_every=1)
    j_svc = js.TxnService(**R.service_kwargs(js), kernels="jnp",
                          durability=mgr)
    attached = {f: np.asarray(a).copy()
                for f, a in zip(j_svc.store._fields, j_svc.store)}
    R.resume(j_svc, js)
    mgr.close()
    for rank, res in enumerate(second):
        msg = f"rank {rank}"
        _same_recovered(res["crash"], st, msg)
        at, fates, hist, rep, _, whole, errors = res["served on"]
        for f, a in at.items():
            np.testing.assert_array_equal(a, attached[f], err_msg=msg)
        assert fates == R.fates(j_svc), msg
        assert_same_history(hist, j_svc.history, msg)
        assert rep == R.report(j_svc), msg
        R.same_fields(whole, j_svc.store, msg)
        assert errors == [] and rep["committed"] > 0, msg


def test_group_commit_crash_tears_on_rank_zero_only(ranks):
    first, second, root = ranks
    got = [res["group"] for res in first]
    assert got[0] is not None
    at_risk, synced, torn, seq = got[0]
    assert at_risk == 2 and seq == 5 and torn == 40 and synced > 0
    for rank, g in enumerate(got[1:], 1):
        assert g == (at_risk, synced, 0, seq), rank
    st = jd.recover(os.path.join(root, "group"))
    assert st.n_blocks == 4 and st.torn_bytes > 0
    for rank, res in enumerate(second):
        _same_recovered(res["group"], st, f"rank {rank}")


@pytest.mark.parametrize("case", range(2 * len(R.PSUM_SHAPES)))
def test_compressed_psum_over_a_group_equals_the_stacked_form(ranks, case):
    """Each rank's total and error equal the JAX ``compressed_psum`` over a
    ``vmap``-ped axis of the ranks' stacked tensors bit for bit, and the
    port's emulated stacked form as a second witness."""
    per_rank = [res["psum"][case] for res in ranks[0]]
    x = np.stack([p[0] for p in per_rank])
    res = (None if per_rank[0][1] is None
           else np.stack([p[1] for p in per_rank]))
    if res is None:
        j_total, j_err = jax.vmap(
            lambda a: jc.compressed_psum(a, "pod"), axis_name="pod")(x)
    else:
        j_total, j_err = jax.vmap(
            lambda a, b: jc.compressed_psum(a, "pod", b),
            axis_name="pod")(x, res)
    total, err = compressed_psum(
        torch.as_tensor(x), None if res is None else torch.as_tensor(res))
    for rank, (_, _, t, e) in enumerate(per_rank):
        assert t.dtype == np.float32 and e.dtype == np.float32
        for name, got, want in (("total", t, j_total[rank]),
                                ("error", e, j_err[rank]),
                                ("stacked total", t, total[rank].numpy()),
                                ("stacked error", e, err[rank].numpy())):
            np.testing.assert_array_equal(got, np.asarray(want),
                                          err_msg=f"{name} rank {rank}")
