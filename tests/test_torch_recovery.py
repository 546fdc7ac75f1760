"""The port's durability plane held against the JAX package's.

The stream of ``tests/test_recovery.py`` (4 nodes x 16 keys, T=8, YCSB
theta=0.6, B=2, K=2) is served by the JAX ``TxnService`` (``kernels="jnp"``)
and by the port's (``device="cpu"``), each with a ``DurabilityManager``:

* the two write-ahead logs are equal record by record in every field
  (inputs, outcomes, wave origin, watermark, clocks, fold), and their
  block frames byte for byte, for the six schedulers, for step-loop
  sessions and for a ``planner="planned"`` session with folded RMW rows;
* the port's ``recover`` of the JAX directory and the JAX ``recover`` of
  the port's, with a snapshot and without, give the live store and meta
  bit for bit;
* under the same fault schedule (kills at dispatch, at retire and after
  the log record, a torn tail, a delayed retire) the crashed logs are
  equal, a pure kill leaves a prefix of the uninterrupted log, and the
  resubmission harness of ``tests/test_recovery.py`` commits every
  request exactly once across the port's restart; so do the pinned chaos
  seeds 11, 23 and 47;
* what the port does not serve yet raises: ``mesh=``.  (Logs under an
  elastic placement: ``tests/test_torch_placement_recovery.py``.)
"""
import numpy as np
import pytest
import torch

from repro.core.workloads import poisson_arrivals
import repro.durability as jd
import repro.service as js
from repro.runtime import faults as jf
import repro_torch.core as tc
import repro_torch.durability as td
import repro_torch.service as ts
from repro_torch.runtime import faults as tf

T, N_NODES, KPN = 8, 4, 16
N_KEYS = N_NODES * KPN
STORE_FIELDS = ("val", "tid", "cid", "sid", "head", "wave")
PKG = {"jax": (js, jd, jf), "torch": (ts, td, tf)}


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """The plain commit loop runs many small tensor ops a step; on one
    intra-op thread they do not stall when the other test workers load
    every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _host_skew(sched):
    return (np.round(np.linspace(0, 2, N_NODES)).astype(np.int32)
            if sched == "clocksi" else None)


def _service(side, d, sched="postsi", fsync_every=1, snapshot_every=None,
             faults=None, seed=0, max_queue=None, **kw):
    pkg, dur, _ = PKG[side]
    mgr = dur.DurabilityManager(str(d), fsync_every=fsync_every,
                                snapshot_every=snapshot_every)
    extra = (dict(kernels="jnp") if side == "jax"
             else dict(kernels="torch", device="cpu"))
    svc = pkg.TxnService(n_keys=N_KEYS, T=T, sched=sched, n_nodes=N_NODES,
                         retry=pkg.RetryPolicy(max_attempts=6),
                         host_skew=_host_skew(sched), seed=seed,
                         max_queue=max_queue, durability=mgr, faults=faults,
                         **extra, **kw)
    return svc, mgr


def _serve(side, svc, mgr, n_ticks=10, rate=6.0, seed=3, B=2, K=2):
    """Serve one YCSB stream; on an injected crash model the kill (the
    unsynced tail, the scheduled tears).  True when the session crashed."""
    pkg, _, faults = PKG[side]
    gen = pkg.ycsb_txn_gen(np.random.RandomState(seed + 100), N_NODES, KPN,
                           theta=0.6, read_frac=0.5, dist_frac=0.3)
    arr = poisson_arrivals(np.random.RandomState(seed + 200), rate, n_ticks)
    try:
        svc.run_streaming(arr, gen, B=B, K=K)
    except faults.InjectedCrash:
        mgr.crash()
        svc.faults.mutilate_wal(mgr.wal_path, mgr.crash_synced_bytes)
        return True
    mgr.close()
    return False


def _blocks(d):
    return td.wal.scan(td.wal_path(str(d))).blocks


def _assert_same_records(a, b):
    """Two block-record lists equal in every field, type and dtype, and
    their frames byte for byte."""
    assert len(a) == len(b) and a
    for i, (x, y) in enumerate(zip(a, b)):
        assert x.keys() == y.keys(), i
        for k in x:
            if isinstance(y[k], np.ndarray):
                assert isinstance(x[k], np.ndarray), (i, k, type(x[k]))
                assert x[k].dtype == y[k].dtype == np.int32, (i, k)
                np.testing.assert_array_equal(x[k], y[k],
                                              err_msg=f"block {i} {k}")
            else:
                assert type(x[k]) is type(y[k]) and x[k] == y[k], (i, k)
        assert td.wal._frame(td.wal.REC_BLOCK, x) == \
            jd.wal._frame(jd.wal.REC_BLOCK, y), i


def _store_np(store):
    if isinstance(store.val, torch.Tensor):
        return tc.store_to_numpy(store)
    return {f: np.asarray(getattr(store, f)) for f in STORE_FIELDS}


def _assert_state_matches_live(st, svc):
    """Recovered state equals the live service: store bits and every meta
    scalar the engine resumes from."""
    got, want = _store_np(st.store), _store_np(svc.store)
    for f in STORE_FIELDS:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f"store.{f}")
    assert st.clock == int(np.asarray(svc.clock))
    assert st.wave_idx == svc.wave_idx
    assert st.gc_clock == svc.gc.clock
    assert st.next_tid == svc.former.next_tid


def _assert_wal_invariants(blocks):
    """GC clock and engine clock monotone, wave origins contiguous."""
    prev_gc, prev_clock, next_wave = -1, 0, 1
    for rec in blocks:
        assert rec["gc_clock"] >= prev_gc, "GC watermark went backwards"
        assert rec["clock"] >= prev_clock, "engine clock went backwards"
        assert rec["wave_idx0"] == next_wave, "wave origin not contiguous"
        next_wave = rec["wave_idx0"] + rec["tid"].shape[0]
        prev_gc, prev_clock = rec["gc_clock"], rec["clock"]


def _committed_tids(blocks):
    C = set()
    for rec in blocks:
        C.update(int(t) for t, s in zip(rec["tid"].ravel(),
                                        rec["status"].ravel())
                 if s == tc.COMMITTED)
    return C


_PREFIX_KEYS = ("op_kind", "op_key", "op_val", "host", "tid",
                "status", "s", "c")


def _assert_wal_prefix(crashed_blocks, ref_blocks):
    """Pure-kill conformance: the crashed log is a bit-identical prefix of
    the uninterrupted run's."""
    assert len(crashed_blocks) <= len(ref_blocks)
    for i, (a, b) in enumerate(zip(crashed_blocks, ref_blocks)):
        for k in _PREFIX_KEYS:
            np.testing.assert_array_equal(a[k], b[k],
                                          err_msg=f"block {i} field {k}")
        assert (a["wave_idx0"], a["wm"], a["clock"], a["gc_clock"]) == \
               (b["wave_idx0"], b["wm"], b["clock"], b["gc_clock"]), i


def _restart_exactly_once(d, crashed, sched="postsi"):
    """``tests/test_recovery.py``'s resubmission harness on the port:
    restart on the recovered directory, resubmit exactly the requests that
    are neither acked nor committed in the durable log, drain, and assert
    every request committed exactly once across the crash — or ended
    dropped/rejected."""
    C = _committed_tids(_blocks(d))
    for r in crashed.requests:
        if r.status == "committed":       # durable-before-ack (fsync=1)
            assert r.tid in C, f"acked commit req {r.req_id} not durable"
    svc2, mgr2 = _service("torch", d, sched, max_queue=10_000)
    assert mgr2.last_recovery is not None
    resub = {}
    for r in crashed.requests:
        if r.status in ("committed", "dropped", "rejected"):
            continue
        if any(t in C for t in r.tids):
            continue                      # durable-but-unacked: no resubmit
        resub[r.req_id] = svc2.submit(r.op_kind, r.op_key, r.op_val, r.host)
    svc2.drain()
    for r in crashed.requests:
        pre = any(t in C for t in r.tids)
        r2 = resub.get(r.req_id)
        post = r2 is not None and r2.status == "committed"
        assert not (pre and post), f"req {r.req_id} double-committed"
        if r2 is not None:
            assert r2.status in ("committed", "dropped")
        if r.status == "committed":
            assert pre
        if r.status not in ("dropped", "rejected") and r2 is None:
            assert pre                    # skipped resubmit => durable
    assert svc2.verify() == []
    mgr2.close()
    return svc2


# ------------------------------------------- the JAX log, record by record
@pytest.mark.parametrize("sched", tc.SCHEDULERS)
def test_durable_stream_matches_jax_and_cross_recovers(sched, tmp_path):
    """Six schedulers: equal logs; each side recovers the other's
    directory to the live state, from the snapshot and by full replay."""
    live = {}
    for side in PKG:
        svc, mgr = _service(side, tmp_path / side, sched, snapshot_every=4)
        assert not _serve(side, svc, mgr)
        assert svc.committed > 0 and mgr.snapshots_taken > 0
        live[side] = svc
    _assert_same_records(_blocks(tmp_path / "torch"),
                         _blocks(tmp_path / "jax"))
    _assert_wal_invariants(_blocks(tmp_path / "torch"))
    assert td.wal.scan(td.wal_path(str(tmp_path / "torch"))).config[
        "backend"] == "torch"
    for use_snapshot in (True, False):
        st = td.recover(str(tmp_path / "jax"), device="cpu",
                        use_snapshot=use_snapshot)
        assert (st.snapshot_seq is not None) == use_snapshot
        assert st.n_replayed < st.n_blocks if use_snapshot else \
            st.n_replayed == st.n_blocks
        assert isinstance(st.store.val, torch.Tensor)
        _assert_state_matches_live(st, live["torch"])
        _assert_state_matches_live(st, live["jax"])
        back = jd.recover(str(tmp_path / "torch"), use_snapshot=use_snapshot)
        _assert_state_matches_live(back, live["jax"])
        if not use_snapshot:
            assert len(st.history) == len(live["torch"].history)


@pytest.mark.parametrize("mode", ["step", "planned"])
def test_step_and_planned_logs_match_jax(mode, tmp_path):
    """The step loop logs B=1 blocks; a planned session logs each planned
    block with the fold multiplicities at each request's executed row.
    Both logs equal the JAX package's and recover to the live state."""
    logs = {}
    for side in PKG:
        pkg = PKG[side][0]
        kw = (dict(planner="planned", fold_rmw=True) if mode == "planned"
              else {})
        svc, mgr = _service(side, tmp_path / side, "si", snapshot_every=5,
                            **kw)
        rng = np.random.RandomState(7)
        gen = (pkg.rmw_txn_gen(rng, N_NODES, KPN) if mode == "planned"
               else pkg.ycsb_txn_gen(rng, N_NODES, KPN, theta=0.6))
        svc.run_stream(poisson_arrivals(np.random.RandomState(8), 5.0, 8),
                       gen)
        mgr.close()
        assert svc.verify() == []
        logs[side] = svc
    blocks = _blocks(tmp_path / "torch")
    _assert_same_records(blocks, _blocks(tmp_path / "jax"))
    if mode == "step":
        assert all(rec["tid"].shape[0] == 1 for rec in blocks)
    else:
        assert logs["torch"].report().planned_waves > 0
        assert any((rec["fold"] > 1).any() for rec in blocks)
    st = td.recover(str(tmp_path / "torch"), device="cpu")
    _assert_state_matches_live(st, logs["torch"])
    full = td.recover(str(tmp_path / "jax"), device="cpu",
                      use_snapshot=False)
    _assert_state_matches_live(full, logs["jax"])
    assert full.folded_requests == jd.recover(
        str(tmp_path / "jax"), use_snapshot=False).folded_requests
    assert (full.folded_requests > 0) == (mode == "planned")


# --------------------------------------------------- crash and restart
CRASHES = {
    "kill-dispatch": ([("kill", "dispatch", 3, 0)], 1),
    "kill-retire-k3": ([("kill", "retire", 2, 0)], 1),
    "kill-post-log": ([("kill", "post_log", 1, 0)], 1),
    "torn-tail": ([("kill", "retire", 3, 0), ("torn_tail", "wal", 0, 10)], 4),
    "delay-retire": ([("delay_retire", "retire", 0, 3)], 1),
}


@pytest.mark.parametrize("case", sorted(CRASHES))
def test_crash_schedules_match_jax(case, tmp_path):
    """The same schedule crashes both packages at the same block and leaves
    equal logs; the port's crashed log is a prefix of its uninterrupted
    run's (pure kills), recovers with its outcomes checked, and the
    restart commits every request exactly once."""
    spec, fsync_every = CRASHES[case]
    K = 3 if case == "kill-retire-k3" else 2
    crashed = {}
    for side in PKG:
        faults = PKG[side][2]
        sched = faults.FaultSchedule([faults.Fault(*f) for f in spec])
        svc, mgr = _service(side, tmp_path / side, fsync_every=fsync_every,
                            faults=sched)
        crashed[side] = (_serve(side, svc, mgr, n_ticks=12, K=K), svc, mgr)
    assert crashed["torch"][0] == crashed["jax"][0] == (case != "delay-retire")
    path = td.wal_path(str(tmp_path / "torch"))
    with open(path, "rb") as f_t, \
            open(td.wal_path(str(tmp_path / "jax")), "rb") as f_j:
        t_bytes, j_bytes = f_t.read(), f_j.read()
    scan = td.wal.scan(path)
    head = len(td.wal._frame(td.wal.REC_CONFIG, scan.config))
    j_head = len(jd.wal._frame(jd.wal.REC_CONFIG, jd.wal.scan(
        jd.wal_path(str(tmp_path / "jax"))).config))
    assert t_bytes[head:] == j_bytes[j_head:]      # same blocks, same tear
    _, svc, mgr = crashed["torch"]
    _assert_wal_invariants(scan.blocks)
    st = td.recover(str(tmp_path / "torch"), device="cpu")
    assert st.n_blocks == len(scan.blocks)
    if case == "delay-retire":
        assert svc.faults.delays_taken > 0 and not svc.faults.pure_kill
        rep = svc.report()
        assert rep.committed + rep.dropped == rep.admitted
        assert svc.verify() == []
        _assert_state_matches_live(st, svc)
        return
    ref, ref_mgr = _service("torch", tmp_path / "ref",
                            fsync_every=fsync_every)
    assert not _serve("torch", ref, ref_mgr, n_ticks=12, K=K)
    assert 0 < st.n_blocks < len(_blocks(tmp_path / "ref"))
    _assert_wal_prefix(scan.blocks, _blocks(tmp_path / "ref"))
    if case == "torn-tail":
        assert scan.torn_bytes > 0 and st.torn_bytes == scan.torn_bytes
        assert scan.valid_bytes >= mgr.crash_synced_bytes
        # the tear costs acked commits (fsync_every=4): resume, no claim
        svc2, mgr2 = _service("torch", tmp_path / "torch")
        assert not _serve("torch", svc2, mgr2, seed=9)
        final = td.wal.scan(path)
        assert final.torn_bytes == 0
        assert len(final.blocks) > len(scan.blocks)
        _assert_wal_invariants(final.blocks)
        return
    if case == "kill-retire-k3":
        assert svc.blocks > st.n_blocks     # blocks were in flight
    if case == "kill-post-log":
        C = _committed_tids(scan.blocks)
        assert any(r.status not in ("committed", "dropped", "rejected")
                   and any(t in C for t in r.tids) for r in svc.requests)
    _restart_exactly_once(tmp_path / "torch", svc)


@pytest.mark.parametrize("seed", [11, 23, 47])
def test_chaos_pinned_failure_schedule(seed, tmp_path):
    """``tests/test_recovery.py``'s chaos leg on the port, seeds 11, 23
    and 47: the log keeps the watermark rules, recovery replays it
    exactly, and the restart commits everything exactly once or drops it;
    pure kills also leave a prefix of the uninterrupted log."""
    ref, ref_mgr = _service("torch", tmp_path / "ref", snapshot_every=4)
    assert not _serve("torch", ref, ref_mgr, n_ticks=12)
    faults = tf.FaultSchedule.random(seed)
    svc, mgr = _service("torch", tmp_path / "chaos", snapshot_every=4,
                        faults=faults)
    crashed = _serve("torch", svc, mgr, n_ticks=12)
    blocks = _blocks(tmp_path / "chaos")
    _assert_wal_invariants(blocks)
    st = td.recover(str(tmp_path / "chaos"), device="cpu")
    assert st.n_blocks == len(blocks)
    if crashed:
        if faults.pure_kill:
            _assert_wal_prefix(blocks, _blocks(tmp_path / "ref"))
        _restart_exactly_once(tmp_path / "chaos", svc)
    else:
        _assert_state_matches_live(st, svc)
        assert svc.verify() == []


def test_reattach_resumes_and_verifies_across_restart(tmp_path):
    """A fresh port service on a JAX-written directory comes back as the
    JAX service (store, TID counter), keeps serving, and its suffix
    history verifies against the snapshot's rings."""
    j_svc, j_mgr = _service("jax", tmp_path, "postsi", snapshot_every=4)
    assert not _serve("jax", j_svc, j_mgr)
    svc2, mgr2 = _service("torch", tmp_path, "postsi")
    assert mgr2.last_recovery.snapshot_seq is not None
    assert svc2.base_store is not None
    assert svc2.clock.dtype == torch.int32 and svc2.clock.device == \
        svc2.device
    _assert_state_matches_live(mgr2.last_recovery, j_svc)
    assert svc2.former.next_tid == j_svc.former.next_tid
    assert not _serve("torch", svc2, mgr2, seed=9)
    assert svc2.committed > 0
    assert svc2.verify() == []


def test_wal_replay_equivalent_across_routes(tmp_path):
    """A log recovers to the same bits through ``torch`` and
    ``torch+fused`` (both checked against the logged outcomes)."""
    svc, mgr = _service("torch", tmp_path, "postsi")
    assert not _serve("torch", svc, mgr)
    for route in ("torch", "torch+fused"):
        st = td.recover(str(tmp_path), kernels=route, device="cpu")
        _assert_state_matches_live(st, svc)


# ------------------------------------------------------ config & refusals
def test_config_mismatch_rejected_with_clear_error(tmp_path):
    svc, mgr = _service("torch", tmp_path, "postsi")
    assert not _serve("torch", svc, mgr, n_ticks=4)
    with pytest.raises(td.WalError, match="sched='postsi' logged vs 'si'"):
        _service("torch", tmp_path, "si")
    with pytest.raises(td.WalError, match="host_skew"):
        ts.TxnService(n_keys=N_KEYS, T=T, sched="postsi", n_nodes=N_NODES,
                      host_skew=np.arange(N_NODES, dtype=np.int32),
                      durability=td.DurabilityManager(str(tmp_path)),
                      device="cpu")


@pytest.mark.parametrize("what", ["mesh"])
def test_unported_durability_planes_raise(what, tmp_path):
    svc, mgr = _service("torch", tmp_path / "log", "postsi")
    assert not _serve("torch", svc, mgr, n_ticks=4)
    with pytest.raises(NotImplementedError, match="Mesh substrate"):
        td.recover(str(tmp_path / "log"), mesh=object(), device="cpu")
