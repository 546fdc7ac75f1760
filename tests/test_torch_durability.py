"""Units of the port's durability plane: the write-ahead log, the PostSI
checkpointer, the snapshot store and the fault schedule, each held to the
JAX package's on the same inputs.

* WAL: ``tests/test_recovery.py``'s ``TestWal`` on the port's ``wal``, the
  frames byte for byte the reference's, and each package scanning the
  other's log;
* checkpointer: ``tests/test_checkpoint.py`` on the port's
  ``PostSICheckpointer``, its leaf paths the reference's ``_leaf_paths``,
  each package restoring the other's directory (byte-equal files and
  meta), and a process that restores a JAX-written directory through the
  port without importing ``repro``;
* snapshots: ``TestSnapshots`` on port services (``device="cpu"``);
* faults: the fault tests of ``tests/test_runtime.py`` on the port's
  ``FaultSchedule``, and ``FaultSchedule.random(seed)`` equal to the
  reference's for seeds 0-63.
"""
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.checkpoint import PostSICheckpointer as JaxCheckpointer
from repro.checkpoint.postsi_store import _leaf_paths as jax_leaf_paths
from repro.durability import wal as jwal
from repro.durability.snapshot import SnapshotStore as JaxSnapshotStore
from repro.runtime import faults as jf
from repro_torch.checkpoint import PostSICheckpointer
from repro_torch.checkpoint.postsi_store import _leaf_paths
from repro_torch.durability import (DurabilityManager, RecoveryError,
                                    WalError, recover, wal)
from repro_torch.durability.snapshot import SnapshotStore, _tree_example
from repro_torch.runtime import Fault, FaultSchedule, InjectedCrash
from repro_torch.service import TxnService

from test_torch_recovery import (N_KEYS, N_NODES, T,
                                 _assert_state_matches_live,
                                 _serve, _service)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------------- WAL
class TestWal:
    def _fill(self, p, n=4, w=None):
        w = w or wal.WalWriter(str(p))
        w.append(wal.REC_CONFIG, {"format": 1, "sched": "postsi"})
        for i in range(n):
            w.append(wal.REC_BLOCK, {"seq": i,
                                     "x": np.arange(6, dtype=np.int32) + i})
        w.close()

    def test_round_trip(self, tmp_path):
        p = tmp_path / "wal.log"
        self._fill(p)
        s = wal.scan(str(p))
        assert s.config["sched"] == "postsi" and len(s.blocks) == 4
        assert s.torn_bytes == 0 and s.valid_bytes == p.stat().st_size
        np.testing.assert_array_equal(s.blocks[2]["x"],
                                      np.arange(6, dtype=np.int32) + 2)

    def test_missing_file_scans_empty(self, tmp_path):
        s = wal.scan(str(tmp_path / "absent.log"))
        assert s.config is None and s.blocks == [] and s.valid_bytes == 0

    def test_torn_tail_tolerated_and_truncated_on_reopen(self, tmp_path):
        p = tmp_path / "wal.log"
        self._fill(p)
        whole = p.stat().st_size
        assert wal.torn_tail(str(p), 7) == 7
        s = wal.scan(str(p))
        assert len(s.blocks) == 3                 # last record destroyed
        assert s.valid_bytes < whole - 7 and s.torn_bytes > 0
        w = wal.WalWriter(str(p), valid_bytes=s.valid_bytes)
        w.append(wal.REC_BLOCK, {"seq": 3, "x": np.int32(9)})
        w.close()
        s2 = wal.scan(str(p))
        assert len(s2.blocks) == 4 and s2.torn_bytes == 0

    def test_midlog_bitrot_ends_the_trusted_prefix(self, tmp_path):
        p = tmp_path / "wal.log"
        self._fill(p)
        s = wal.scan(str(p))
        data = bytearray(p.read_bytes())
        off = s.valid_bytes - (s.valid_bytes // 3)
        data[off] ^= 0xFF
        p.write_bytes(bytes(data))
        damaged = wal.scan(str(p))
        assert len(damaged.blocks) < 4 and damaged.torn_bytes > 0

    def test_config_must_head_the_log(self, tmp_path):
        p = tmp_path / "wal.log"
        w = wal.WalWriter(str(p))
        w.append(wal.REC_BLOCK, {"seq": 0})
        w.append(wal.REC_CONFIG, {"format": 1})
        w.close()
        with pytest.raises(WalError, match="CONFIG record not at log head"):
            wal.scan(str(p))

    def test_noncontiguous_seq_rejected(self, tmp_path):
        p = tmp_path / "wal.log"
        w = wal.WalWriter(str(p))
        w.append(wal.REC_BLOCK, {"seq": 0})
        w.append(wal.REC_BLOCK, {"seq": 2})
        w.close()
        with pytest.raises(WalError, match="not a contiguous retire order"):
            wal.scan(str(p))

    def test_fsync_batching_and_simulated_crash(self, tmp_path):
        p = tmp_path / "wal.log"
        w = wal.WalWriter(str(p), fsync_every=3)
        w.append(wal.REC_BLOCK, {"seq": 0})
        w.append(wal.REC_BLOCK, {"seq": 1})
        assert w.unsynced_records == 2           # buffered, not in the OS
        assert len(wal.scan(str(p)).blocks) == 0
        assert w.drop_unsynced() == 2            # the crash loses them
        assert len(wal.scan(str(p)).blocks) == 0
        w2 = wal.WalWriter(str(p), fsync_every=3)
        for i in range(3):                        # batch boundary: auto-sync
            w2.append(wal.REC_BLOCK, {"seq": i})
        assert w2.unsynced_records == 0
        assert len(wal.scan(str(p)).blocks) == 3
        w2.close()

    def test_fsync_barrier_bounds_the_tearable_suffix(self, tmp_path):
        p = tmp_path / "wal.log"
        w = wal.WalWriter(str(p), fsync_every=4)
        w.append(wal.REC_BLOCK, {"seq": 0})
        w.sync()                                  # explicit barrier
        barrier = w.synced_bytes
        assert barrier == p.stat().st_size
        w.append(wal.REC_BLOCK, {"seq": 1})
        w.append(wal.REC_BLOCK, {"seq": 2})
        assert w.synced_bytes == barrier          # barrier did not move
        assert w.simulate_crash() == 2            # flushed, never fsynced
        assert len(wal.scan(str(p)).blocks) == 3  # gentle crash: all there
        at_risk = p.stat().st_size - barrier
        assert wal.torn_tail(str(p), at_risk) == at_risk
        s = wal.scan(str(p))
        assert len(s.blocks) == 1 and s.valid_bytes == barrier
        w1 = wal.WalWriter(str(p), fsync_every=1, valid_bytes=s.valid_bytes)
        w1.append(wal.REC_BLOCK, {"seq": 1})
        assert w1.simulate_crash() == 0           # nothing ever at risk

    def test_fsync_every_validated(self, tmp_path):
        with pytest.raises(ValueError, match="fsync_every"):
            wal.WalWriter(str(tmp_path / "w.log"), fsync_every=0)

    def test_frames_are_the_reference_bytes(self):
        rng = np.random.RandomState(5)
        payloads = [
            {"format": 1, "sched": "postsi", "host_skew": None, "T": 8},
            {"seq": 3, "wave_idx0": 7, "wm": None, "clock": 40,
             "op_key": rng.randint(-1, 64, (2, 8, 4)).astype(np.int32),
             "fold": np.ones((2, 8), np.int32)},
            {"seq": 0, "wm": 12, "x": np.int32(9)}]
        for rtype, payload in zip((wal.REC_CONFIG, wal.REC_BLOCK,
                                   wal.REC_BLOCK), payloads):
            assert wal._frame(rtype, payload) == jwal._frame(rtype, payload)

    @pytest.mark.parametrize("writer", ["jax", "torch"])
    def test_each_package_scans_the_others_log(self, writer, tmp_path):
        p = tmp_path / "wal.log"
        mod, other = (jwal, wal) if writer == "jax" else (wal, jwal)
        self._fill(p, w=mod.WalWriter(str(p)))
        wal.torn_tail(str(p), 3)
        a, b = other.scan(str(p)), mod.scan(str(p))
        assert (a.valid_bytes, a.torn_bytes) == (b.valid_bytes, b.torn_bytes)
        assert a.config == b.config and len(a.blocks) == len(b.blocks) == 3
        for x, y in zip(a.blocks, b.blocks):
            assert x["seq"] == y["seq"]
            np.testing.assert_array_equal(x["x"], y["x"])


# ---------------------------------------------------------- checkpointer
def _tree(seed: int = 0):
    rng = np.random.RandomState(seed)
    return {"layer": {"w": rng.randint(0, 100, (4, 3)).astype(np.int32),
                      "b": rng.randint(0, 100, (3,)).astype(np.int32)},
            "step_scale": np.float32(seed + 0.5)}


def _assert_tree_equal(a, b):
    """``a`` restored by the port (tensors), ``b`` numpy."""
    assert set(a) == set(b)
    for k in ("w", "b"):
        assert a["layer"][k].dtype == torch.int32
        np.testing.assert_array_equal(a["layer"][k].numpy(), b["layer"][k])
    np.testing.assert_allclose(a["step_scale"].numpy(), b["step_scale"])


def test_save_restore_round_trip(tmp_path):
    ck = PostSICheckpointer(str(tmp_path), _tree())
    assert ck.save(7, _tree(1))
    step, got = ck.restore(_tree(), device="cpu")
    assert step == 7
    _assert_tree_equal(got, _tree(1))


def test_restore_empty_dir_is_none(tmp_path):
    ck = PostSICheckpointer(str(tmp_path), _tree())
    assert ck.restore(_tree(), device="cpu") == (None, None)


def test_latest_snapshot_wins_and_reopen_sees_it(tmp_path):
    ck = PostSICheckpointer(str(tmp_path), _tree())
    for step in (1, 2, 3):
        assert ck.save(step, _tree(step))
    step, got = ck.restore(_tree(), device="cpu")
    assert step == 3
    _assert_tree_equal(got, _tree(3))
    ck2 = PostSICheckpointer(str(tmp_path), _tree())
    step2, got2 = ck2.restore(_tree(), device="cpu")
    assert step2 == 3
    _assert_tree_equal(got2, _tree(3))


def test_gc_keep_latest_prunes_unreachable_files(tmp_path):
    ck = PostSICheckpointer(str(tmp_path), _tree())
    n_leaves = len(ck.paths)
    for step in range(1, 6):
        assert ck.save(step, _tree(step))
    n_files = lambda: sum(f.endswith(".npy") for f in os.listdir(tmp_path))
    assert n_files() == 5 * n_leaves
    assert ck.gc(keep_latest=2) == 3 * n_leaves
    assert n_files() == 2 * n_leaves
    step, got = ck.restore(_tree(), device="cpu")
    assert step == 5
    _assert_tree_equal(got, _tree(5))
    assert ck.gc(keep_latest=2) == 0          # idempotent


def test_corrupted_meta_degrades_to_empty(tmp_path):
    ck = PostSICheckpointer(str(tmp_path), _tree())
    assert ck.save(1, _tree(1))
    (tmp_path / PostSICheckpointer.META).write_bytes(b"\x80garbage")
    ck2 = PostSICheckpointer(str(tmp_path), _tree())
    assert ck2.meta_corrupt
    assert ck2.restore(_tree(), device="cpu") == (None, None)
    assert ck2.save(2, _tree(2))
    assert not PostSICheckpointer(str(tmp_path), _tree()).meta_corrupt


def test_meta_missing_required_keys_degrades(tmp_path):
    ck = PostSICheckpointer(str(tmp_path), _tree())
    assert ck.save(1, _tree(1))
    with open(tmp_path / PostSICheckpointer.META, "wb") as f:
        pickle.dump({"sched": None}, f)       # valid pickle, wrong schema
    ck2 = PostSICheckpointer(str(tmp_path), _tree())
    assert ck2.meta_corrupt
    assert ck2.restore(_tree(), device="cpu") == (None, None)


def test_meta_naming_a_foreign_class_is_refused(tmp_path):
    """A meta pickle that names any class but the scheduler's is refused
    (the directory degrades to empty); nothing is imported."""
    ck = PostSICheckpointer(str(tmp_path), _tree())
    assert ck.save(1, _tree(1))
    with open(tmp_path / PostSICheckpointer.META, "wb") as f:
        pickle.dump({"sched": Path("x"), "next_file": 2, "paths": ck.paths},
                    f)
    assert PostSICheckpointer(str(tmp_path), _tree()).meta_corrupt


def test_restore_rejects_mismatched_tree_with_clear_error(tmp_path):
    ck = PostSICheckpointer(str(tmp_path), _tree())
    assert ck.save(1, _tree(1))
    wrong = {"layer": {"w": np.zeros((4, 3), np.int32),
                       "extra": np.zeros(2, np.int32)},
             "step_scale": np.float32(0)}
    with pytest.raises(ValueError, match="leaf paths do not match"):
        ck.restore(wrong, device="cpu")
    with pytest.raises(ValueError, match=r"\['b'\]"):
        ck.restore(wrong, device="cpu")
    with pytest.raises(ValueError, match=r"\['extra'\]"):
        ck.restore(wrong, device="cpu")


def test_init_rejects_mismatched_tree_against_saved_meta(tmp_path):
    ck = PostSICheckpointer(str(tmp_path), _tree())
    assert ck.save(1, _tree(1))
    with pytest.raises(ValueError, match="does not match tree_example"):
        PostSICheckpointer(str(tmp_path), {"other": np.zeros(3, np.int32)})


@pytest.mark.parametrize("tree", ["snapshot", "nested"])
def test_leaf_paths_are_the_reference(tree):
    ex = (_tree_example(16, 4) if tree == "snapshot"
          else {"b": {"c": np.zeros(1), "a": {"z": 0, "y": np.ones(2)}},
                "a": np.zeros(3)})
    assert _leaf_paths(ex) == jax_leaf_paths(ex)
    if tree == "snapshot":
        assert _leaf_paths(ex) == [
            "['meta']", "['store']['cid']", "['store']['head']",
            "['store']['sid']", "['store']['tid']", "['store']['val']",
            "['store']['wave']"]


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoint_directories_cross_restore(writer, tmp_path):
    """Each package restores the other's checkpoints; the two directories
    a save sequence writes are equal file by file, meta included."""
    dirs = {w: tmp_path / w for w in ("jax", "torch")}
    cks = {"jax": JaxCheckpointer(str(dirs["jax"]), _tree()),
           "torch": PostSICheckpointer(str(dirs["torch"]), _tree())}
    for step in (1, 2, 3):
        for ck in cks.values():
            assert ck.save(step, _tree(step))
    for ck in cks.values():
        ck.gc(keep_latest=2)
    names = sorted(os.listdir(dirs["jax"]))
    assert names == sorted(os.listdir(dirs["torch"]))
    for n in names:
        assert (dirs["jax"] / n).read_bytes() == \
            (dirs["torch"] / n).read_bytes(), n
    if writer == "jax":
        step, got = PostSICheckpointer(str(dirs["jax"]), _tree()).restore(
            _tree(), device="cpu")
        _assert_tree_equal(got, _tree(3))
    else:
        step, got = JaxCheckpointer(str(dirs["torch"]), _tree()).restore(
            _tree())
        _assert_tree_equal({"layer": {k: torch.tensor(np.asarray(v))
                                      for k, v in got["layer"].items()},
                            "step_scale": torch.tensor(
                                np.asarray(got["step_scale"]))}, _tree(3))
    assert step == 3


def test_restoring_a_jax_directory_imports_no_repro(tmp_path):
    """A snapshot the JAX package wrote restores through the port in a
    process that never imports ``repro`` (nor ``jax``)."""
    snaps = JaxSnapshotStore(str(tmp_path), 16, 4)
    store = {f: np.full(s.shape, i, s.dtype)
             for i, (f, s) in enumerate(_tree_example(16, 4)["store"].items())}
    snaps.save(type("S", (), store), 5, 6, 7, 8, 9)
    code = f"""
import sys
from repro_torch.durability.snapshot import SnapshotStore
st = SnapshotStore({str(tmp_path)!r}, 16, 4).restore_latest()
assert st is not None and (st.clock, st.wave_idx, st.wal_seq, st.gc_clock,
                           st.next_tid) == (5, 6, 7, 8, 9), st
assert [int(st.store[f][0, 0]) for f in ("val", "tid", "cid", "sid")] == \\
    [0, 1, 2, 3]
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("repro", "jax"))
assert not bad, bad
print("RESTORED-WITHOUT-REPRO")
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "RESTORED-WITHOUT-REPRO" in out.stdout


def test_entry_points_default_to_the_card(monkeypatch, tmp_path):
    """Without a CUDA device, recovery and a restore with no device named
    are refused loudly; they never run on the CPU unasked."""
    svc, mgr = _service("torch", tmp_path / "d", "postsi")
    assert not _serve("torch", svc, mgr, n_ticks=2)
    ck = PostSICheckpointer(str(tmp_path / "ck"), _tree())
    assert ck.save(1, _tree(1))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        recover(str(tmp_path / "d"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ck.restore(_tree())
    with pytest.raises(ValueError, match="cuda"):
        recover(str(tmp_path / "d"), kernels="cuda", device="cpu")


def test_staged_inputs_read_the_staging_buffer():
    """A block's WAL inputs come from its staging buffer (on the card the
    page-locked ``host``, read through the staging layout): for blocks of
    1-4 ragged waves they equal the stacked host arrays bit for bit, and
    on the CPU the block itself is read."""
    import repro_torch.core as tc
    from repro_torch.core import workloads as tw
    for B, T, O in ((1, 8, 4), (3, 5, 3), (4, 64, 4)):
        waves = [tc.wave_to_numpy(w) for w in tw.ycsb_waves(
            np.random.RandomState(B), B, T, N_NODES, 16, n_ops=O,
            device="cpu")]
        blk = tc.stage_block(waves, 1, None, device="cpu")
        flat = torch.empty(0, dtype=torch.int32).set_(
            blk.wave.op_kind.untyped_storage())
        for staged in (blk, blk._replace(host=flat)):
            got = tc.staged_inputs(staged)
            for f, col in zip(got, zip(*waves)):
                assert isinstance(f, np.ndarray) and f.dtype == np.int32
                np.testing.assert_array_equal(f, np.stack(col))


# -------------------------------------------------------------- snapshots
class TestSnapshots:
    def test_damaged_snapshot_degrades_to_full_replay(self, tmp_path):
        svc, mgr = _service("torch", tmp_path, "postsi", snapshot_every=3)
        assert not _serve("torch", svc, mgr)
        meta = os.path.join(str(tmp_path), SnapshotStore.SUBDIR,
                            "postsi_meta.pkl")
        with open(meta, "wb") as f:
            f.write(b"rotten")
        st = recover(str(tmp_path), device="cpu")
        assert st.snapshot_seq is None           # fell back, did not die
        assert st.n_replayed == st.n_blocks
        _assert_state_matches_live(st, svc)

    def test_snapshot_ahead_of_wal_is_rejected(self, tmp_path):
        svc, mgr = _service("torch", tmp_path, "postsi")
        assert not _serve("torch", svc, mgr, n_ticks=4)
        snaps = SnapshotStore(str(tmp_path), N_KEYS, svc.store.n_versions)
        snaps.save(svc.store, int(svc.clock), svc.wave_idx,
                   wal_seq=10_000, gc_clock=svc.gc.clock,
                   next_tid=svc.former.next_tid)
        with pytest.raises(RecoveryError, match="wal_seq=10000"):
            recover(str(tmp_path), device="cpu")

    def test_snapshots_only_at_pipeline_empty_boundaries(self, tmp_path):
        mgr = DurabilityManager(str(tmp_path), snapshot_every=1)
        svc = TxnService(n_keys=N_KEYS, T=T, n_nodes=N_NODES,
                         durability=mgr, device="cpu")
        mgr._since_snap = 5
        assert not mgr.maybe_snapshot(svc, pipeline_empty=False)
        assert mgr.maybe_snapshot(svc, pipeline_empty=True)
        assert mgr.snapshots_taken == 1
        mgr.close()


# ------------------------------------------------------------ fault plane
class TestFaultSchedule:
    def test_kill_fires_on_nth_visit_only(self):
        s = FaultSchedule([Fault("kill", "retire", 2)])
        s.at_retire()
        s.at_retire()
        with pytest.raises(InjectedCrash, match="kill at retire#2"):
            s.at_retire()
        assert s.crashed is not None and s.crashed.at == 2

    def test_seams_counted_independently(self):
        s = FaultSchedule([Fault("kill", "post_log", 1)])
        for _ in range(5):
            s.at_dispatch()
            s.at_retire()
        s.post_log()
        with pytest.raises(InjectedCrash):
            s.post_log()

    def test_delay_budget_is_finite(self):
        s = FaultSchedule([Fault("delay_retire", "retire", 0, arg=3)])
        s.at_retire()                         # arms the budget
        assert [s.delay_retire() for _ in range(5)] == \
            [True, True, True, False, False]
        assert s.delays_taken == 3

    def test_fault_fires_once(self):
        s = FaultSchedule([Fault("delay_retire", "retire", 0, arg=1)])
        s.at_retire()
        assert s.delay_retire()
        s.at_retire()                         # visit 1: fault already fired
        assert not s.delay_retire()

    def test_unknown_kind_rejected(self):
        with pytest.raises(ValueError, match="unknown fault kind"):
            Fault("segfault", "retire", 0)

    def test_pure_kill_classification(self):
        assert FaultSchedule([Fault("kill", "retire", 1),
                              Fault("torn_tail", "wal", 0, arg=9)]).pure_kill
        assert not FaultSchedule(
            [Fault("delay_retire", "retire", 0, arg=1),
             Fault("kill", "retire", 1)]).pure_kill

    def test_random_is_seed_deterministic(self):
        a, b = FaultSchedule.random(123), FaultSchedule.random(123)
        assert [(f.kind, f.point, f.at, f.arg) for f in a.faults] == \
            [(f.kind, f.point, f.at, f.arg) for f in b.faults]
        c = FaultSchedule.random(124)
        assert a.faults != c.faults or a.seed != c.seed
        for seed in range(30):
            s = FaultSchedule.random(seed)
            assert sum(f.kind == "kill" for f in s.faults) == 1

    def test_random_equals_the_reference(self):
        for seed in range(64):
            for allow_delay in (True, False):
                a = FaultSchedule.random(seed, allow_delay=allow_delay)
                b = jf.FaultSchedule.random(seed, allow_delay=allow_delay)
                assert [(f.kind, f.point, f.at, f.arg) for f in a.faults] \
                    == [(f.kind, f.point, f.at, f.arg) for f in b.faults]
                assert a.pure_kill == b.pure_kill

    def test_mutilate_wal_tears_scheduled_bytes(self, tmp_path):
        p = tmp_path / "wal.log"
        p.write_bytes(b"x" * 100)
        s = FaultSchedule([Fault("kill", "retire", 0),
                           Fault("torn_tail", "wal", 0, arg=30)])
        assert s.mutilate_wal(str(p)) == 30
        assert p.stat().st_size == 70
        assert FaultSchedule([Fault("kill", "retire", 0)]) \
            .mutilate_wal(str(p)) == 0        # no tear scheduled
        assert FaultSchedule([Fault("torn_tail", "wal", 0, arg=50)]) \
            .mutilate_wal(str(p), synced_bytes=60) == 10   # the barrier
