"""The port's durability plane under an elastic placement, held against the
JAX package's.

An elastic session (``PlacementMap(64, 4, headroom=2)``, ``balancer=True``,
an explicit ``move_range`` late in the stream, postsi, T=16) is served
durably by the JAX ``TxnService`` (``kernels="jnp"``) and by the port's
(``device="cpu"``) on the same requests:

* the two logs are byte for byte equal past the CONFIG record, whose
  dicts differ only in ``backend`` (the route's name): REC_MOVE frames,
  block frames, and a CONFIG with ``placement`` and ``n_slots``;
* recovery with ``snapshot_every`` None and 2 (moves before the snapshot
  folded into the map only, moves after it replayed through
  ``apply_move_local`` between the blocks) gives the live store, ``slot``,
  ``owner`` and history;
* the port recovers the JAX directory, and the JAX package the port's, bit
  for bit in store, ``slot``, ``owner``, history and ``base_store``;
* a crash right after the first logged moves recovers to the live
  state at the crash, and a restarted service adopts the replayed map,
  serves on and verifies.
"""
import numpy as np
import pytest
import torch

import repro.durability as jd
import repro.placement as jp
import repro.service as js
import repro_torch.core as tc
import repro_torch.durability as td
import repro_torch.placement as tp
import repro_torch.service as ts
from repro_torch.core.commit_phase import NOP, READ, RMW

from test_torch_engine import assert_same_history

N_KEYS, N_NODES, V, T = 64, 4, 8, 16
STORE_FIELDS = ("val", "tid", "cid", "sid", "head", "wave")
PKG = {"jax": (js, jd, jp), "torch": (ts, td, tp)}


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """The plain commit loop runs many small tensor ops a step; on one
    intra-op thread they do not stall when the other test workers load
    every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _txns(seed, n, hot_n=16):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        kind = np.full(4, NOP, np.int32)
        key = np.zeros(4, np.int32)
        val = np.zeros(4, np.int32)
        ks = rng.choice(hot_n, size=2, replace=False)
        if rng.rand() < 0.5:
            kind[:2] = READ
        else:
            kind[:2] = RMW
            val[:2] = rng.randint(1, 100, 2)
        key[:2] = ks
        out.append((kind, key, val, int(rng.randint(0, N_NODES))))
    return out


def _service(side, d, snapshot_every=None):
    pkg, dur, pl = PKG[side]
    mgr = dur.DurabilityManager(str(d), fsync_every=1,
                                snapshot_every=snapshot_every)
    extra = (dict(kernels="jnp") if side == "jax"
             else dict(kernels="torch", device="cpu"))
    svc = pkg.TxnService(n_keys=N_KEYS, n_versions=V, T=T, O=4,
                         sched="postsi", n_nodes=N_NODES,
                         placement=pl.PlacementMap(N_KEYS, N_NODES,
                                                   headroom=2),
                         balancer=True, durability=mgr, **extra)
    return svc, mgr


def _serve(svc, txns, crash_after_move=False):
    """Submit the requests four a tick, an explicit move at two thirds;
    with ``crash_after_move`` stop right after the first move."""
    for i, t in enumerate(txns):
        svc.submit(*t)
        if i == 2 * len(txns) // 3:
            svc.move_range(20, 30, 3)
        if i % 4 == 3:
            svc.step()
        if crash_after_move and svc.placement_moves:
            return
    svc.drain()


def _store_np(store):
    if isinstance(store.val, torch.Tensor):
        return tc.store_to_numpy(store)
    return {f: np.asarray(getattr(store, f)) for f in STORE_FIELDS}


def _assert_state(st, svc):
    """A recovered state equals a live service: store rows, map, meta."""
    got, want = _store_np(st.store), _store_np(svc.store)
    for f in STORE_FIELDS:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f"store.{f}")
    np.testing.assert_array_equal(st.placement_map.slot, svc.placement.slot)
    np.testing.assert_array_equal(st.placement_map.owner,
                                  svc.placement.owner)
    assert st.clock == int(np.asarray(svc.clock))
    assert st.wave_idx == svc.wave_idx
    assert st.gc_clock == svc.gc.clock
    assert st.next_tid == svc.former.next_tid


def _assert_same_recovery(a, b):
    """Two recovered states equal in every durable field."""
    sa, sb = _store_np(a.store), _store_np(b.store)
    for f in STORE_FIELDS:
        np.testing.assert_array_equal(sa[f], sb[f], err_msg=f"store.{f}")
    for f in ("slot", "owner"):
        np.testing.assert_array_equal(getattr(a.placement_map, f),
                                      getattr(b.placement_map, f))
    assert (a.clock, a.wave_idx, a.gc_clock, a.next_tid, a.n_blocks,
            a.n_records, a.snapshot_seq) == \
        (b.clock, b.wave_idx, b.gc_clock, b.next_tid, b.n_blocks,
         b.n_records, b.snapshot_seq)
    assert_same_history(a.history, b.history, "recovered history")
    assert (a.base_store is None) == (b.base_store is None)
    if a.base_store is not None:
        for f in STORE_FIELDS:
            np.testing.assert_array_equal(a.base_store[f], b.base_store[f])


def _both(tmp_path, snapshot_every=None, crash_after_move=False, seed=4):
    live = {}
    for side in PKG:
        svc, mgr = _service(side, tmp_path / side, snapshot_every)
        _serve(svc, _txns(seed, 120), crash_after_move)
        if crash_after_move:
            mgr.crash()
        else:
            mgr.close()
        live[side] = svc
    return live


@pytest.mark.parametrize("snapshot_every", [None, 2])
def test_move_recovery_replay(tmp_path, snapshot_every):
    """Moves and blocks interleave in one seq space; recovery rebuilds the
    store, the map and the history bit for bit, with and without a
    snapshot (a snapshot after a move re-applies it to the map only)."""
    svc, mgr = _service("torch", tmp_path, snapshot_every)
    _serve(svc, _txns(4, 120))
    svc.move_range(0, 4, 2)          # a move past the last snapshot
    assert svc.report().placement_moves > 1
    assert svc.verify() == []
    mgr.crash()
    scan = td.wal.scan(td.wal_path(str(tmp_path)))
    assert len(scan.moves) == svc.placement_moves
    assert [r["seq"] for _, r in scan.records] == list(
        range(len(scan.records)))
    st = td.recover(str(tmp_path), device="cpu")
    _assert_state(st, svc)
    assert st.n_records == len(scan.records) == mgr.seq
    if snapshot_every is None:
        assert_same_history(st.history, svc.history, "full replay")
    else:
        assert st.snapshot_seq is not None and st.base_store is not None
        snap = td.SnapshotStore(str(tmp_path), st.placement_map.n_slots,
                                V).restore_latest()
        assert snap.store["head"].shape == (2 * N_KEYS,)
        moved_before = [r for rt, r in scan.records[:snap.wal_seq]
                        if rt == td.wal.REC_MOVE]
        assert moved_before, "no move fell before the snapshot"
        assert any(rt == td.wal.REC_MOVE
                   for rt, _ in scan.records[snap.wal_seq:])
    full = td.recover(str(tmp_path), device="cpu", use_snapshot=False)
    _assert_state(full, svc)
    # a restart with a fresh map adopts the replayed one and verifies
    svc2, mgr2 = _service("torch", tmp_path)
    assert svc2.placement is not None
    np.testing.assert_array_equal(svc2.placement.slot, svc.placement.slot)
    assert svc2.verify() == []
    mgr2.close()


@pytest.mark.parametrize("snapshot_every", [None, 2])
def test_elastic_wal_bytes_equal_jax(tmp_path, snapshot_every):
    live = _both(tmp_path, snapshot_every)
    paths = {s: td.wal_path(str(tmp_path / s)) for s in PKG}
    scans = {"torch": td.wal.scan(paths["torch"]),
             "jax": jd.wal.scan(paths["jax"])}
    t_cfg, j_cfg = scans["torch"].config, scans["jax"].config
    assert t_cfg["placement"] == j_cfg["placement"] == {
        "n_keys": N_KEYS, "n_nodes": N_NODES, "capacity": 2 * N_KEYS // 4}
    assert t_cfg["n_slots"] == j_cfg["n_slots"] == 2 * N_KEYS
    assert (t_cfg["backend"], j_cfg["backend"]) == ("torch", "jnp")
    assert {k: v for k, v in t_cfg.items() if k not in ("backend",
                                                        "host_skew")} == \
        {k: v for k, v in j_cfg.items() if k not in ("backend", "host_skew")}
    with open(paths["torch"], "rb") as f_t, open(paths["jax"], "rb") as f_j:
        t_bytes, j_bytes = f_t.read(), f_j.read()
    head = len(td.wal._frame(td.wal.REC_CONFIG, t_cfg))
    j_head = len(jd.wal._frame(jd.wal.REC_CONFIG, j_cfg))
    assert t_bytes[head:] == j_bytes[j_head:]
    assert len(scans["torch"].moves) == live["torch"].placement_moves > 1
    for (rt, a), (_, b) in zip(scans["torch"].records,
                               scans["jax"].records):
        if rt == td.wal.REC_MOVE:
            assert list(a) == list(b) == [
                "seq", "clock", "lo", "hi", "dst", "keys", "old_slots",
                "new_slots"]
            assert all(a[k].dtype == np.int32 for k in
                       ("keys", "old_slots", "new_slots"))
    assert live["torch"].report().moved_keys == \
        live["jax"].report().moved_keys


@pytest.mark.parametrize("use_snapshot", [True, False])
def test_cross_package_recovery(tmp_path, use_snapshot):
    """Each package recovers the other's elastic directory to the same
    store, map, history and snapshot rings."""
    live = _both(tmp_path, snapshot_every=2)
    t_of_j = td.recover(str(tmp_path / "jax"), device="cpu",
                        use_snapshot=use_snapshot)
    j_of_t = jd.recover(str(tmp_path / "torch"), use_snapshot=use_snapshot)
    t_of_t = td.recover(str(tmp_path / "torch"), device="cpu",
                        use_snapshot=use_snapshot)
    j_of_j = jd.recover(str(tmp_path / "jax"), use_snapshot=use_snapshot)
    for st in (t_of_j, j_of_t, t_of_t, j_of_j):
        _assert_state(st, live["torch"])
        _assert_state(st, live["jax"])
        assert (st.snapshot_seq is not None) == use_snapshot
    assert isinstance(t_of_j.store.val, torch.Tensor)
    _assert_same_recovery(t_of_j, j_of_j)
    _assert_same_recovery(t_of_t, j_of_t)
    if not use_snapshot:
        assert_same_history(t_of_j.history, live["jax"].history, "history")


def test_crash_after_first_move_and_restart(tmp_path):
    """A crash right after the tick that logged the first REC_MOVE records
    (a balancer round): both packages' directories recover to the live state at the crash; a restarted port
    service adopts the map, serves on, and equals the JAX restart."""
    live = _both(tmp_path, snapshot_every=2, crash_after_move=True, seed=5)
    t_svc = live["torch"]
    assert t_svc.placement_moves >= 1
    scan = td.wal.scan(td.wal_path(str(tmp_path / "torch")))
    assert scan.records[-1][0] == td.wal.REC_MOVE
    for side in PKG:
        st = td.recover(str(tmp_path / side), device="cpu")
        _assert_state(st, t_svc)
        _assert_state(jd.recover(str(tmp_path / side)), live["jax"])
    restarted = {}
    more = _txns(9, 24)
    for side in PKG:
        svc, mgr = _service(side, tmp_path / side, snapshot_every=2)
        assert mgr.last_recovery is not None
        np.testing.assert_array_equal(svc.placement.slot, t_svc.placement.slot)
        for t in more:
            svc.submit(*t)
        svc.step()
        svc.step()
        svc.drain()
        mgr.close()
        assert svc.verify() == []
        restarted[side] = svc
    t2, j2 = restarted["torch"], restarted["jax"]
    assert_same_history(t2.history, j2.history, "restart")
    for f, a in tc.store_to_numpy(t2.store).items():
        np.testing.assert_array_equal(a, np.asarray(getattr(j2.store, f)))
    np.testing.assert_array_equal(t2.placement.slot, j2.placement.slot)


def test_placement_config_must_match(tmp_path):
    """A directory written under one layout refuses a service with
    another (or none)."""
    svc, mgr = _service("torch", tmp_path)
    _serve(svc, _txns(4, 20))
    mgr.close()
    with pytest.raises(td.WalError, match="n_slots|placement"):
        ts.TxnService(n_keys=N_KEYS, n_versions=V, T=T, O=4,
                      sched="postsi", n_nodes=N_NODES, device="cpu",
                      durability=td.DurabilityManager(str(tmp_path)))
    with pytest.raises(td.WalError, match="n_slots|placement"):
        ts.TxnService(n_keys=N_KEYS, n_versions=V, T=T, O=4,
                      sched="postsi", n_nodes=N_NODES, device="cpu",
                      placement=tp.PlacementMap(N_KEYS, N_NODES, headroom=3),
                      durability=td.DurabilityManager(str(tmp_path)))
