"""The corners the ``commit_loop`` kernel is held to, pinned on the CPU.

Each case runs the same numpy-seeded waves through the JAX package's
``run_wave`` (its ``jnp`` backend) and the port's ``run_wave`` on the
``torch`` route, whose commit loop is ``engine._commit_loop_plain``, the
kernel's plain version; every ``WaveOut`` field, the clock and the final
store must be bit-identical:

* V=2 rings wrapped before and during the wave, with transactions that
  read and read-modify-write the same key;
* ``gc_block`` (and ``gc_track``) under a watermark that evicts;
* T=1, T=33 (not a multiple of a warp) and O=12 (TPC-C-lite);
* an explicit placement, and clocksi with ``host_skew``.

``ops.commit_loop(use_kernel=True)`` on CPU tensors must return what
``_commit_loop_plain`` returns (the kernel has no CPU form).  The kernel
itself is held to the same loop on the card (``tests/test_torch_cuda.py``).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.core as jc
from repro.core.store import PlacementArrays as JPlacement
import repro_torch.core as tc
from repro_torch.core import workloads as tw
from repro_torch.core.engine import _commit_loop_plain, wave_read_phase
from repro_torch.core.substrate import LocalSubstrate
from repro_torch.kernels import LAUNCHES, ops

from test_torch_engine import assert_same_history, assert_same_store

N_NODES = 4


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """The plain loop runs ~170 small tensor ops a step; on one intra-op
    thread they are as fast alone and do not stall when the other test
    workers load every core (a T=256 wave took 80x longer then)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


def _read_rmw_waves(seed, n_waves=2, T=12, n_keys=6):
    """numpy waves over a few hot keys in which every other txn reads a
    key at op 0 and read-modify-writes the same key at op 1."""
    rng = np.random.RandomState(seed)
    waves = []
    for w in range(n_waves):
        kind = rng.randint(0, 4, (T, 3)).astype(np.int32)
        key = rng.randint(0, n_keys, (T, 3)).astype(np.int32)
        kind[::2, 0], kind[::2, 1] = 1, 3               # READ k, RMW k
        key[::2, 1] = key[::2, 0]
        val = rng.randint(1, 9, (T, 3)).astype(np.int32)
        host = rng.randint(0, N_NODES, T).astype(np.int32)
        tid = (1 + w * T + np.arange(T)).astype(np.int32)
        waves.append((kind, key, val, host, tid))
    return waves


def _run_both(waves, js, ts, sched, clock=10, watermark=None,
              host_skew=None, placement=None, **kw):
    """Every wave through the JAX engine and the port's torch route; the
    histories, clocks and final stores must be equal.  Returns the port's
    WaveOuts as numpy."""
    kw = dict(n_nodes=N_NODES, sched=sched, **kw)
    jp = tp = None
    if placement is not None:
        owner, slot = placement
        jp = JPlacement(jnp.asarray(owner), jnp.asarray(slot))
        tp = (owner, slot)
    clock_j, clock_t, outs = jnp.int32(clock), clock, []
    jwm = None if watermark is None else jnp.int32(watermark)
    jhs = None if host_skew is None else jnp.asarray(host_skew)
    for w, wave in enumerate(waves):
        jwave = jc.Wave(*(jnp.asarray(a) for a in wave))
        js, jo, clock_j = jc.run_wave(js, jwave, jnp.int32(w + 1), clock_j,
                                      watermark=jwm, host_skew=jhs,
                                      placement=jp, kernels="jnp", **kw)
        twave = tc.wave_from_numpy(wave, "cpu")
        ts, to, clock_t = tc.run_wave(ts, twave, w + 1, clock_t,
                                      watermark=watermark,
                                      host_skew=host_skew, placement=tp,
                                      kernels="torch", **kw)
        to = tc.wave_to_numpy(to)
        assert_same_history([(np.asarray(wave[4]), to)],
                            [(np.asarray(wave[4]), jo)], f"{sched} w{w}")
        assert int(clock_t) == int(clock_j)
        outs.append(to)
    assert_same_store(ts, js, sched)
    return outs


def _np_waves(waves):
    return [tuple(np.asarray(a) for a in tc.wave_to_numpy(w)) for w in waves]


@pytest.mark.parametrize("sched", tc.SCHEDULERS)
def test_ring_wrap_with_read_and_rmw_of_one_key(sched):
    """V=2: every install reuses the slot a peer may have read, so the
    order inside a step (read_newest and the SID re-gather before the
    install, the bump's TID guard after it) shows any slip."""
    js, ts = _wrapped_stores(6)
    outs = _run_both(_read_rmw_waves(1), js, ts, sched, gc_track=True)
    committed = sum(int((o.status == tc.COMMITTED).sum()) for o in outs)
    assert 0 < committed < 24


@pytest.mark.parametrize("sched", tc.SCHEDULERS)
def test_gc_block_under_a_watermark_that_evicts(sched):
    js, ts = _wrapped_stores(8)
    waves = _np_waves(tw.micro_waves(
        np.random.RandomState(5), 2, 12, N_NODES, 2, n_ops=3,
        read_ratio=0.3, dist_frac=0.5, blind_frac=0.5, device="cpu"))
    blocked = _run_both(waves, js, ts, sched, watermark=1, gc_block=True)
    js, ts = _wrapped_stores(8)
    tracked = _run_both(waves, js, ts, sched, watermark=1, gc_track=True)
    # the watermark is real: tracking counts evictions, blocking aborts
    assert sum(int(o.evicted_visible) for o in tracked) > 0
    assert sum(int((o.status == tc.ABORTED).sum()) for o in blocked) > \
        sum(int((o.status == tc.ABORTED).sum()) for o in tracked)


@pytest.mark.parametrize("shape", ["T=1", "T=33", "tpcc O=12"])
@pytest.mark.parametrize("sched", tc.SCHEDULERS)
def test_wave_shapes(sched, shape):
    rng = np.random.RandomState(7)
    if shape == "tpcc O=12":
        waves = tw.tpcc_waves(rng, 2, 16, N_NODES, 64, device="cpu")
        n_keys = N_NODES * 64
    else:
        T = int(shape[2:])
        waves = tw.smallbank_waves(rng, 3, T, N_NODES, 4, dist_frac=0.5,
                                   device="cpu")
        n_keys = N_NODES * 4
    _run_both(_np_waves(waves), jc.make_store(n_keys, 4),
              tc.make_store(n_keys, 4, device="cpu"), sched, clock=1,
              gc_track=True)


@pytest.mark.parametrize("sched", tc.SCHEDULERS)
def test_placement_and_clocksi_host_skew(sched):
    """Rings at rows ``slot[k]`` of a random permutation (dsi remoteness
    stays the logical key's node), with clocksi's stale snapshots."""
    n_keys = 24
    rng = np.random.RandomState(4)
    slot = rng.permutation(n_keys).astype(np.int32)
    owner = (np.arange(n_keys) % N_NODES).astype(np.int32)
    hs = np.array([0, 2, 1, 3], np.int32)
    waves = _np_waves(tw.smallbank_waves(np.random.RandomState(8), 3, 16,
                                         N_NODES, 6, dist_frac=0.6,
                                         device="cpu"))
    _run_both(waves, jc.make_store(n_keys, 4),
              tc.make_store(n_keys, 4, device="cpu"), sched, clock=1,
              host_skew=hs if sched == "clocksi" else None,
              placement=(owner, slot), gc_track=True)


@pytest.mark.parametrize("gc", ["none", "track", "block"])
@pytest.mark.parametrize("sched", tc.SCHEDULERS)
def test_ops_commit_loop_on_cpu_is_the_plain_loop(sched, gc):
    """The wrapper serves CPU tensors with the plain loop, also on a wave
    whose transactions write one key twice, and launches nothing."""
    _, ts = _wrapped_stores(6)
    kind, key, val, host, tid = _read_rmw_waves(3, n_waves=1)[0]
    kind[1::2, 2], key[1::2, 2] = 2, key[1::2, 1]        # duplicate writes
    kind[1::2, 1] = 3
    wave = tc.wave_from_numpy((kind, key, val, host, tid), "cpu")
    sub = LocalSubstrate("torch", "cpu")
    inputs = wave_read_phase(sub, ts, wave, 2, 9, sched=sched, watermark=3)
    kw = dict(sched=sched, n_nodes=N_NODES, gc_track=gc == "track",
              gc_block=gc == "block")
    stores = [tc.MVStore(*(t.clone() for t in ts)) for _ in range(2)]
    before = dict(LAUNCHES)
    got = ops.commit_loop(stores[0], inputs, use_kernel=True, **kw)
    want = _commit_loop_plain(sub, stores[1], inputs, **kw)
    assert LAUNCHES == before
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    for a, b in zip(stores[0], stores[1]):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert int((want[0] == tc.COMMITTED).sum()) > 0


def test_commit_loop_shared_memory_budget():
    """The path's wave (T=256, O=4, V=8) runs the ``staged`` variant: its
    rows, bit matrices and op records fit in shared memory.  T=1040 runs
    ``global``.  At T=256, O=4 the largest V that stages is 14; at O=4,
    V=8 the largest T is 362.  A variant can be forced; a wave whose
    interval state alone does not fit is refused before any launch."""
    import pytest
    from repro_torch.kernels.build import SMEM_LIMIT
    from repro_torch.kernels.commit_loop import commit_loop_smem_bytes
    assert commit_loop_smem_bytes(256, 4, 8) == (155_912, "staged")
    assert commit_loop_smem_bytes(256, 4, 8, "global") == (4_560, "global")
    assert commit_loop_smem_bytes(1040, 4, 4)[1] == "global"
    assert commit_loop_smem_bytes(1040, 12, 8) == (18_240, "global")
    assert commit_loop_smem_bytes(256, 4, 14)[1] == "staged"
    assert commit_loop_smem_bytes(256, 4, 15)[1] == "global"
    assert commit_loop_smem_bytes(362, 4, 8) == (231_960, "staged")
    assert commit_loop_smem_bytes(363, 4, 8)[1] == "global"
    assert commit_loop_smem_bytes(15_000, 4, 8)[0] > SMEM_LIMIT
    for T, O, V in ((1, 1, 1), (33, 12, 4), (600, 2, 2)):
        smem, variant = commit_loop_smem_bytes(T, O, V)
        assert variant == "staged" and smem <= SMEM_LIMIT
    # the global variant's shared memory does not grow with V (its rings
    # stay in device memory)
    g = [commit_loop_smem_bytes(1040, O, V, "global")[0]
         for O, V in ((1, 2), (12, 8), (12, 64))]
    assert g[0] < g[1] == g[2] < SMEM_LIMIT
    with pytest.raises(ValueError, match="variant"):
        commit_loop_smem_bytes(256, 4, 8, "shared")



def test_commit_loop_layout_is_the_kernel_struct():
    """The host's layout of a launch, which the C entry compares byte for
    byte with the kernel's own (``make_layout``), is ``struct Layout`` of
    csrc/commit_loop.cu: the two declare the same fields in the same
    order, all 64-bit; the regions of a staged launch follow one another
    and end at its shared memory."""
    import ctypes
    import re
    from pathlib import Path

    from repro_torch.kernels import commit_loop as cl
    src = (Path(cl.__file__).parent / "csrc" / "commit_loop.cu").read_text()
    body = re.search(r"struct Layout \{(.*?)\n\};", src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    names = [n.strip() for decl in re.findall(r"long long ([^;]+);", body)
             for n in decl.split(",")]
    assert names == [n for n, _ in cl.Layout._fields_]
    assert all(t is ctypes.c_longlong for _, t in cl.Layout._fields_)
    L = cl._layout(256, 4, 8, True)
    offsets = [L.slo, L.shi, L.clo, L.ttid, L.cmask, L.dh, L.misc, L.P,
               L.PT, L.ops, L.row_of, L.uni, L.total]
    assert offsets == sorted(offsets) and L.scratch == 0
    assert 4 * L.total == cl.commit_loop_smem_bytes(256, 4, 8)[0]
    assert cl._layout(1040, 12, 8, False).scratch > 0

def _chip_smoke():
    import sys
    from pathlib import Path
    root = str(Path(__file__).resolve().parents[1])
    sys.path.insert(0, root)
    try:
        import chip_smoke
    finally:
        sys.path.remove(root)
    return chip_smoke


class _NoBump(LocalSubstrate):
    """A substrate that skips rule 4(c): a slip the checks must catch."""

    def bump_sid(self, store, mask, keys, slots, expect_tid, s_val):
        return store


@pytest.mark.parametrize("sched", ["postsi", "dsi"])
def test_smoke_commit_loop_checks_pass_the_plain_loop(sched):
    """chip_smoke's commit-loop cases at a small size, the plain loop
    standing in for the kernel: every case and GC mode runs and agrees."""
    import torch
    from repro_torch.kernels.commit_loop import commit_loop_plain
    cs = _chip_smoke()
    cfg = cs.Config(nodes=2, kpn=40, V=4, T=16)
    cases = cs.commit_loop_cases(np, cfg)
    assert [c[0] for c in cases][-1] == "path T=16"
    for case in cases:
        for gc in ("none", "track", "block"):
            assert cs.check_commit_loop(torch, np, torch.device("cpu"), case,
                                        sched, gc, commit_loop_plain,
                                        commit_loop_plain) == 0


def test_smoke_commit_loop_checks_catch_a_skipped_sid_bump():
    import torch
    from repro_torch.kernels.commit_loop import commit_loop_plain
    cs = _chip_smoke()
    (case,) = [c for c in cs.commit_loop_cases(np, cs.Config(nodes=2, kpn=40,
                                                             V=4, T=16))
               if c[0] == "V=2 read+RMW of one key"]

    def slipped(store, inputs, **kw):
        return _commit_loop_plain(_NoBump("torch", "cpu"), store, inputs,
                                  **kw)
    with pytest.raises(AssertionError, match="differs from the plain loop"):
        cs.check_commit_loop(torch, np, torch.device("cpu"), case, "postsi",
                             "none", slipped, commit_loop_plain)
