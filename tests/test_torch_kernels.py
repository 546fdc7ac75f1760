"""The port's kernel plane held against the JAX package's, bit for bit.

Every plain PyTorch version in ``repro_torch.kernels`` (``version_scan``,
``potential_matrix``, ``wave_commit`` and the commit-phase
``sid_regather`` / ``masked_install`` / ``masked_sid_bump`` scatters) gets
the same seeded numpy inputs as ``repro.kernels.ops`` — its Pallas kernels
run in interpret mode — and ``repro.kernels.ref``, and must agree exactly:
everything is int32.  The adversarial cases mirror ``tests/test_kernels.py``:
NOP pad keys 0 / -1 / hot, all-invisible rows and T not a multiple of 32.
On the CPU the wrappers take the plain versions; the CUDA kernels are held
to them on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import store as jstore
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import store as tstore
from repro_torch.kernels import ops, ref
from repro_torch.kernels.version_scan import version_scan_plain
from repro_torch.kernels.wave_commit import wave_commit_plain


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _eq(got, want, msg=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype, (msg, got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want, err_msg=msg)


def _ring_inputs(seed, T, O, V, n_keys=64):
    """Random gathered rings with the store invariants the kernels rely
    on (per-ring CIDs unique and >= 0, empty slots tid = -1) — the
    reference suite's generator, as numpy."""
    rng = np.random.RandomState(seed)
    cids = np.argsort(rng.rand(T, O, V), axis=2) * 3 + \
        rng.randint(0, 3, (T, O, 1))
    tids = np.where(rng.rand(T, O, V) < 0.3, -1,
                    rng.randint(1, 99, (T, O, V)))
    sids = rng.randint(0, 40, (T, O, V))
    vals = rng.randint(-100, 100, (T, O, V))
    mc = rng.randint(-1, 3 * V, (T, O))     # includes all-invisible ceilings
    keys = rng.randint(0, n_keys, (T, O))
    is_r = rng.rand(T, O) < 0.5
    is_w = rng.rand(T, O) < 0.4
    i32 = lambda a: np.asarray(a, np.int32)
    return (i32(cids), i32(tids), i32(sids), i32(vals), i32(mc),
            i32(np.where(is_r, keys, -1)), i32(np.where(is_w, keys, -1)),
            is_r)


# ------------------------------------------------------------ version_scan
@pytest.mark.parametrize("V", [2, 4, 8])
@pytest.mark.parametrize("M", [16, 40])
def test_version_scan_vs_jax(M, V):
    cids, tids, _, _, mc, _, _, _ = _ring_inputs(M * V, M, 1, V)
    cids, tids, mc = cids[:, 0], tids[:, 0], mc[:, 0]
    want_k = jops.version_scan(jnp.asarray(cids), jnp.asarray(tids),
                               jnp.asarray(mc), use_pallas=True,
                               interpret=True)
    want_r = jref.version_scan_ref(jnp.asarray(cids), jnp.asarray(tids),
                                   jnp.asarray(mc))
    got = ops.version_scan(_t(cids), _t(tids), _t(mc))
    for name, g, wk, wr in zip(("slot", "best"), got, want_k, want_r):
        _eq(g, wk, f"{name} vs pallas")
        _eq(g, wr, f"{name} vs ref")


@pytest.mark.parametrize("pad", [0, -1, 5])
def test_version_scan_keyed_gather_clips_pad_keys(pad):
    """The keyed form gathers ring rows itself; negative padding clips to
    row 0 and never wraps to the last row (``substrate.py:131``)."""
    n_keys, V = 8, 4
    cids, tids, _, _, _, _, _, _ = _ring_inputs(3, n_keys, 1, V)
    cids, tids = cids[:, 0], tids[:, 0]
    keys = np.array([pad, 3, pad, 7, 0, pad], np.int32)
    mc = np.array([40, 40, -1, 5, 40, 2], np.int32)
    kc = np.clip(keys, 0, n_keys - 1)
    want = jref.version_scan_ref(jnp.asarray(cids[kc]),
                                 jnp.asarray(tids[kc]), jnp.asarray(mc))
    got = ops.version_scan(_t(cids), _t(tids), _t(mc), keys=_t(keys))
    _eq(got[0], want[0], "slot")
    _eq(got[1], want[1], "best")
    plain = ops.version_scan(_t(cids), _t(tids), _t(mc), keys=_t(keys),
                             use_kernel=False)
    _eq(plain[0], want[0], "slot (plain)")


def test_version_scan_all_invisible_and_ties():
    """An all-invisible row selects slot 0 with best -1; ties go to the
    first slot attaining the max (also for negative CIDs)."""
    cids = np.array([[4, 9, 2], [7, 7, 1], [-5, -3, -3], [1, 2, 3]],
                    np.int32)
    tids = np.array([[1, 1, 1], [1, 1, 1], [1, 1, 1], [-1, -1, -1]],
                    np.int32)
    mc = np.array([-1, 8, 0, 10], np.int32)
    got = ref.version_scan_ref(_t(cids), _t(tids), _t(mc))
    want = jref.version_scan_ref(jnp.asarray(cids), jnp.asarray(tids),
                                 jnp.asarray(mc))
    _eq(got[0], want[0], "slot")
    _eq(got[1], want[1], "best")
    _eq(got[0], np.array([0, 0, 1, 0], np.int32))


# -------------------------------------------------------- potential matrix
@pytest.mark.parametrize("T,O", [(16, 4), (40, 4), (40, 12)])
def test_potential_matrix_vs_jax(T, O):
    rng = np.random.RandomState(5 + T)
    rk = rng.randint(-1, 20, (T, O)).astype(np.int32)
    wk = rng.randint(-1, 20, (T, O)).astype(np.int32)
    rk[::3] = -1                                 # interleaved NOP rows
    want_k = jops.potential_matrix(jnp.asarray(rk), jnp.asarray(wk),
                                   use_pallas=True, interpret=True,
                                   block_t=8)
    want_r = jref.potential_matrix_ref(jnp.asarray(rk), jnp.asarray(wk))
    got = ops.potential_matrix(_t(rk), _t(wk))
    _eq(got, want_k, "vs pallas")
    _eq(got, want_r, "vs ref")
    _eq(ops.potential_matrix(_t(rk), _t(wk), use_kernel=False), want_r)


# ------------------------------------------------------------- wave_commit
@pytest.mark.parametrize("T,O,V", [(16, 3, 2), (16, 4, 4), (40, 5, 8)])
def test_wave_commit_vs_jax(T, O, V):
    args = _ring_inputs(7 + T + V, T, O, V)
    jargs = [jnp.asarray(a) for a in args]
    want_k = jops.wave_commit(*jargs, use_pallas=True, interpret=True)
    want_r = jops.wave_commit(*jargs, use_pallas=False)
    got = ops.wave_commit(*(_t(a) for a in args))
    names = ("slot", "r_val", "r_tid", "r_cid", "r_sid", "s_lo0",
             "potential")
    for name, g, wk, wr in zip(names, got, want_k, want_r):
        _eq(g, wk, f"{name} vs pallas")
        _eq(g, wr, f"{name} vs ref")


def test_wave_commit_keyed_equals_gathered_rings():
    """The keyed form (rings gathered from the store tables by clipped
    key, as the kernel does) equals the same call on pre-gathered rings."""
    T, O, V, n_keys = 40, 4, 4, 16
    tables = _ring_inputs(21, n_keys, 1, V)
    tables = [_t(a[:, 0]) for a in tables[:4]]
    rng = np.random.RandomState(22)
    keys = rng.randint(-1, n_keys, (T, O)).astype(np.int32)
    mc = rng.randint(-1, 3 * V, (T, O)).astype(np.int32)
    is_r = rng.rand(T, O) < 0.5
    is_w = rng.rand(T, O) < 0.5
    rk = np.where(is_r, keys, -1).astype(np.int32)
    wk = np.where(is_w, keys, -1).astype(np.int32)
    rest = (_t(mc), _t(rk), _t(wk), _t(is_r))
    keyed = wave_commit_plain(*tables, *rest, keys=_t(keys))
    kc = np.clip(keys, 0, n_keys - 1)
    rings = [jnp.asarray(np.asarray(t)[kc]) for t in tables]
    want = jref.wave_commit_ref(*rings, *(jnp.asarray(a) for a in
                                          (mc, rk, wk, is_r)))
    for g, w in zip(keyed, want):
        _eq(g, w)


@pytest.mark.parametrize("pad_key", [0, -1, 5])
def test_wave_commit_nop_padding_no_false_edges(pad_key):
    """Interleaved NOP rows whose raw key is the adversarial pad key grow
    no anti-dependency edge and contribute 0 to s_lo0, exactly as in the
    reference."""
    T, O, V = 16, 3, 4
    cids, tids, sids, vals, mc, rk, wk, rvalid = _ring_inputs(13, T, O, V,
                                                              n_keys=8)
    nop_rows = np.arange(0, T, 3)
    rk[nop_rows] = -1
    wk[nop_rows] = -1
    rvalid[nop_rows] = False
    hot = max(pad_key, 0)
    rk[1, 0], wk[1, 1], rvalid[1, 0] = hot, hot, True
    args = (cids, tids, sids, vals, mc, rk, wk, rvalid)
    got = ops.wave_commit(*(_t(a) for a in args))
    want = jops.wave_commit(*(jnp.asarray(a) for a in args),
                            use_pallas=True, interpret=True)
    for g, w in zip(got, want):
        _eq(g, w)
    pot = got[6].bool().numpy()
    assert not pot[nop_rows].any() and not pot[:, nop_rows].any()
    assert (got[5].numpy()[nop_rows] == 0).all()


# ------------------------------------------- commit-phase scatter / gather
def _store_np(seed, n_keys, V):
    rng = np.random.RandomState(seed)
    f = dict(val=rng.randint(-50, 50, (n_keys, V)),
             tid=np.where(rng.rand(n_keys, V) < 0.2, -1,
                          rng.randint(1, 30, (n_keys, V))),
             cid=rng.randint(0, 40, (n_keys, V)),
             sid=rng.randint(0, 40, (n_keys, V)),
             head=rng.randint(0, V, n_keys), wave=rng.randint(0, 5, n_keys))
    return {k: v.astype(np.int32) for k, v in f.items()}


@pytest.mark.parametrize("V", [2, 4, 8])
def test_sid_regather_vs_jax(V):
    st = _store_np(V, 16, V)
    rng = np.random.RandomState(1)
    keys = rng.randint(-1, 16, (5, 3)).astype(np.int32)   # -1 wraps in JAX
    slots = rng.randint(0, V, (5, 3)).astype(np.int32)
    want = jops.sid_regather(jnp.asarray(st["sid"]), jnp.asarray(keys),
                             jnp.asarray(slots))
    _eq(ops.sid_regather(_t(st["sid"]), _t(keys), _t(slots)), want)


@pytest.mark.parametrize("V", [2, 4])
@pytest.mark.parametrize("pad", [0, -1, 3])
def test_masked_install_vs_jax(V, pad):
    """Masked install, including masked-off padding rows that share a cell
    with a live install (pad key == a live key): JAX drops them at the
    sentinel row; the port must leave exactly the live writes."""
    n_keys = 8
    st = _store_np(10 + V, n_keys, V)
    keys = np.array([pad, 3, 6, pad, 0], np.int32)
    mask = np.array([False, True, True, False, pad != 0])
    values = np.array([11, 12, 13, 14, 15], np.int32)
    jout = jops.masked_install(
        *(jnp.asarray(st[f]) for f in tstore.MVStore._fields),
        mask=jnp.asarray(mask), keys=jnp.asarray(keys),
        values=jnp.asarray(values), new_tid=jnp.int32(77),
        new_cid=jnp.int32(88), wave_idx=jnp.int32(4))
    tout = ops.masked_install(
        *(_t(st[f]).clone() for f in tstore.MVStore._fields),
        mask=_t(mask), keys=_t(keys), values=_t(values),
        new_tid=torch.tensor(77, dtype=torch.int32),
        new_cid=torch.tensor(88, dtype=torch.int32), wave_idx=4)
    for f, g, w in zip(tstore.MVStore._fields, tout, jout):
        _eq(g, w, f)


@pytest.mark.parametrize("pad", [0, -1, 3])
def test_masked_sid_bump_vs_jax(pad):
    n_keys, V = 8, 4
    st = _store_np(30, n_keys, V)
    keys = np.array([pad, 3, 6, pad, 3], np.int32)
    slots = np.array([1, 2, 0, 3, 2], np.int32)
    expect = st["tid"][np.clip(keys, 0, n_keys - 1), slots].copy()
    expect[2] += 1                                 # recycled slot: skip
    mask = np.array([False, True, True, False, True])
    want = jops.masked_sid_bump(
        jnp.asarray(st["sid"]), jnp.asarray(st["tid"]),
        mask=jnp.asarray(mask), keys=jnp.asarray(keys),
        slots=jnp.asarray(slots), expect_tid=jnp.asarray(expect),
        s_val=jnp.int32(33))
    got = ops.masked_sid_bump(
        _t(st["sid"]).clone(), _t(st["tid"]), mask=_t(mask), keys=_t(keys),
        slots=_t(slots), expect_tid=_t(expect),
        s_val=torch.tensor(33, dtype=torch.int32))
    _eq(got, want)


# ----------------------------------------------------------- store helpers
def test_store_helpers_vs_jax():
    """read_visible / read_newest / evicting_visible / install_version /
    bump_sid on identical state."""
    n_keys, V = 8, 2
    jst = jstore.make_store(n_keys, V)
    tst = tstore.make_store(n_keys, V, device="cpu")
    for v in range(3):                       # wrap every ring
        jst, jev = jstore.install_version(
            jst, jnp.arange(n_keys), jnp.full((n_keys,), v), jnp.int32(1),
            jnp.int32(v + 1), jnp.int32(0))
        tst, tev = tstore.install_version(
            tst, torch.arange(n_keys), torch.full((n_keys,), v), 1, v + 1, 0)
        _eq(tev, jev, "evicted")
    for f, g in tstore.store_to_numpy(tst).items():
        _eq(g, getattr(jst, f), f)
    keys = np.array([-1, -8, 0, 7, 3], np.int32)
    for wm in (0, 2, 5):
        _eq(tstore.evicting_visible(tst, _t(keys), wm),
            jstore.evicting_visible(jst, jnp.asarray(keys), jnp.int32(wm)))
    k = np.arange(n_keys, dtype=np.int32)
    mc = np.array([0, 1, 2, 3, 0, 1, 2, 3], np.int32)
    for g, w in zip(tstore.read_visible(tst, _t(k), _t(mc)),
                    jstore.read_visible(jst, jnp.asarray(k),
                                        jnp.asarray(mc))):
        _eq(g, np.asarray(w).astype(np.int32))
    for g, w in zip(tstore.read_newest(tst, _t(k)),
                    jstore.read_newest(jst, jnp.asarray(k))):
        _eq(g, np.asarray(w).astype(np.int32))
    tst = tstore.bump_sid(tst, 3, 1, 9)
    jst = jstore.bump_sid(jst, jnp.int32(3), jnp.int32(1), jnp.int32(9))
    _eq(tst.sid, jst.sid)


def test_store_numpy_round_trip():
    st = _store_np(2, 8, 4)
    tst = tstore.store_from_numpy(st, device="cpu")
    back = tstore.store_to_numpy(tst)
    for f in tstore.MVStore._fields:
        _eq(back[f], st[f], f)
    jst = jstore.make_store(8, 4)
    tst2 = tstore.store_from_numpy(jst, device="cpu")
    for f in tstore.MVStore._fields:
        _eq(getattr(tst2, f), getattr(jst, f), f)
