"""The port's CUDA kernels on the card (marked ``cuda``; skipped without a
CUDA device).

Run on a machine with one: ``PYTHONPATH=src python -m pytest -m cuda
tests/test_torch_cuda.py``.  Each engine kernel must equal its plain
PyTorch version bit for bit on seeded inputs (pad keys 0 / -1 / hot,
all-invisible rows, T not a multiple of 32, ``chip_smoke.py``'s read-phase
corners, key sets off a 16-byte boundary, ``version_scan`` at ragged M and
V from 1 to 40), the ``cuda`` routes of the
engine must equal the ``torch`` routes, and every launch must be counted:
one ``commit_loop`` a wave on both CUDA routes, one ``version_scan`` a wave
on ``cuda`` and none on ``cuda+fused``.  ``commit_loop`` must equal the
engine's plain loop bit for bit, in its outputs and the store, for the six
schedulers x {no GC, ``gc_track``, ``gc_block``} on ``chip_smoke.py``'s
corner waves, in both of its variants (``staged``, ``global``).
The model plane's ``flash_attention`` and ``ssd_scan`` must agree with
their plain versions within the tolerances of ``tests/test_kernels.py``
(2e-5 fp32 / 2e-2 bf16 for attention, 1e-3 for the SSD scan, 2e-2 for its
bf16 output: one bf16 rounding), also at 128-row attention q tiles, in the
model's strided layout, at N=128 and with slow decay (where every block of
the scan carries weight), the bf16 outputs also against the plain versions
in float32 on the same inputs, and reduced zamba2 behind ``Server`` on the
``cuda`` route must serve what the ``torch`` route serves.  The block
dispatch (``run_block`` on a staged or a host block) must run under
``torch.cuda.set_sync_debug_mode("error")``, which must raise on a known
blocking copy; a block's page-locked staging must stay alive, unchanged,
until the block retires; ``run_streaming`` (B=4, K=2, with and without the
hybrid planner) and ``run_workload_planned`` on ``cuda`` and
``cuda+fused`` must equal ``torch``.  A durable ``run_streaming`` on each
CUDA route must dispatch under sync debug mode "error" and write the
write-ahead log the ``torch`` route writes, record for record, and
``recover`` on both CUDA routes (from the snapshot and by full replay,
one ``commit_loop`` launch a replayed wave) must give the ``torch``
route's state.  Under an elastic placement (headroom 2, the balancer's
live moves, an explicit ``move_range``, hot-key replicas) a session on
``cuda`` and ``cuda+fused`` must equal ``torch`` per request, per wave and
in the placed store, a placed streaming session's block dispatches must
run under sync debug mode "error" after a move, and ``apply_move_local``
on the card must equal the CPU, including a move that fills the last
physical row.  On the node mesh emulated on the card (8 nodes), the
``cuda`` and ``cuda+fused`` routes must equal the mesh's ``torch`` route
and the single-device ``cuda`` route, launching ``version_scan`` N (T + 1)
times and ``potential_matrix`` once a wave on ``cuda``, ``wave_commit`` N
and ``version_scan`` N T times a wave on ``cuda+fused`` and ``commit_loop``
never; also where the node blocks start off a 16-byte boundary (odd rows a
node, V=3); a mesh block dispatch must run under sync debug mode "error";
and ``apply_move_mesh`` on the card must equal the CPU.
"""
import numpy as np
import pytest
import torch

import repro_torch.core as tc
from repro_torch.core import workloads as tw
from repro_torch.configs import get_reduced
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.commit_loop import commit_loop_cuda, commit_loop_plain
from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                 flash_attention_plain)
from repro_torch.kernels.ssd_scan import ssd_cuda, ssd_plain
from repro_torch.launch.serve import Server
import repro_torch.service as ts
from repro_torch.models.model import build
from repro_torch.kernels.interval_negotiate import (potential_matrix_cuda,
                                                    potential_matrix_ref)
from repro_torch.kernels.version_scan import (version_scan_cuda,
                                              version_scan_plain)
from repro_torch.kernels.wave_commit import (wave_commit_cuda,
                                             wave_commit_plain)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU form")
    return torch.device("cuda")


def _inputs(dev, seed, n_keys, V, T, O, pad):
    rng = np.random.RandomState(seed)
    cid = (np.argsort(rng.rand(n_keys, V), 1) * 3
           + rng.randint(0, 3, (n_keys, 1)))
    tid = np.where(rng.rand(n_keys, V) < 0.3, -1,
                   rng.randint(1, 99, (n_keys, V)))
    sid = rng.randint(0, 40, (n_keys, V))
    val = rng.randint(-100, 100, (n_keys, V))
    keys = rng.randint(0, n_keys, (T, O))
    keys.reshape(-1)[::5] = pad
    mc = rng.randint(-1, 3 * V, (T, O))
    is_r, is_w = rng.rand(T, O) < 0.5, rng.rand(T, O) < 0.4
    t = lambda a, dt=torch.int32: torch.as_tensor(np.asarray(a),
                                                  dtype=dt, device=dev)
    return ([t(a) for a in (cid, tid, sid, val)], t(keys), t(mc),
            t(np.where(is_r, keys, -1)), t(np.where(is_w, keys, -1)),
            t(is_r, torch.bool))


def _same(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("pad", [0, -1, 7])
@pytest.mark.parametrize("T,O,V", [(40, 4, 8), (64, 3, 2), (130, 5, 4)])
def test_kernels_equal_plain_versions(dev, T, O, V, pad):
    (cid, tid, sid, val), keys, mc, rk, wk, rvalid = _inputs(
        dev, T + V, 512, V, T, O, pad)
    before = dict(LAUNCHES)
    flat = (cid, tid, mc.view(-1), keys.view(-1))
    _same(version_scan_cuda(*flat), version_scan_plain(*flat))
    _same((potential_matrix_cuda(rk, wk),), (potential_matrix_ref(rk, wk),))
    args = (cid, tid, sid, val, mc, rk, wk, rvalid)
    _same(wave_commit_cuda(*args, keys=keys),
          wave_commit_plain(*args, keys=keys))
    torch.cuda.synchronize()
    assert {k: LAUNCHES[k] - before[k] for k in LAUNCHES} == {
        "version_scan": 1, "potential_matrix": 1, "wave_commit": 1,
        "commit_loop": 0, "flash_attention": 0, "ssd_scan": 0}


@pytest.mark.parametrize("sched", tc.SCHEDULERS)
def test_engine_cuda_routes_equal_torch_routes(dev, sched):
    waves = tw.smallbank_waves(np.random.RandomState(1), 3, 40, 4, 16,
                               hot_frac=0.5, hot_per_node=3, device=dev)
    results = {}
    for route in ("torch", "cuda", "torch+fused", "cuda+fused"):
        before = dict(LAUNCHES)
        st, hist, stats = tc.run_workload_fused(
            tc.make_store(64, 4, device=dev), waves, sched=sched, n_nodes=4,
            gc_track=True, kernels=route)
        results[route] = (tc.store_to_numpy(st), hist, stats)
        cuda = route.startswith("cuda")
        assert LAUNCHES["commit_loop"] - before["commit_loop"] == (
            len(waves) if cuda else 0), route
        assert LAUNCHES["version_scan"] - before["version_scan"] == (
            len(waves) if route == "cuda" else 0), route
    ref_store, ref_hist, ref_stats = results["torch"]
    for route, (st, hist, stats) in results.items():
        assert stats == ref_stats, route
        for f in st:
            np.testing.assert_array_equal(st[f], ref_store[f])
        for (_, a), (_, b) in zip(hist, ref_hist):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)


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


CS = _chip_smoke()


@pytest.mark.parametrize("pad", CS.CORNER_PADS)
@pytest.mark.parametrize("T,O,V", CS.READ_CORNERS)
def test_read_phase_corners_equal_plain_versions(dev, T, O, V, pad):
    """chip_smoke.py's read-phase corners: rings whose visible CIDs tie
    (the first slot must win), empty rings, V = 1 / 3 (lanes an op past V),
    V = 16 / 40 (groups of 16 and 32 lanes, two slots a lane at 40),
    O = 12 (s_lo0 through shared memory), T = 1 and ragged T (the potential
    matrix's byte stores), pad keys 0 / -1 / hot / past the last row; each
    kernel bit-equal to its plain version, one launch a call."""
    tabs, keys, mc, rk, wk, rv = (
        [torch.as_tensor(a, device=dev) for a in x] if isinstance(x, tuple)
        else torch.as_tensor(x, device=dev)
        for x in CS.read_phase_corner(np, T, O, V, pad))
    before = dict(LAUNCHES)
    args = (*tabs, mc, rk, wk, rv)
    _same(wave_commit_cuda(*args, keys=keys),
          wave_commit_plain(*args, keys=keys))
    _same((potential_matrix_cuda(rk, wk),), (potential_matrix_ref(rk, wk),))
    flat = (tabs[0], tabs[1], mc.view(-1), keys.view(-1))
    _same(version_scan_cuda(*flat), version_scan_plain(*flat))
    torch.cuda.synchronize()
    assert {k: LAUNCHES[k] - before[k] for k in LAUNCHES} == {
        "version_scan": 1, "potential_matrix": 1, "wave_commit": 1,
        "commit_loop": 0, "flash_attention": 0, "ssd_scan": 0}


@pytest.mark.parametrize("V", [1, 3, 8, 16, 40])
@pytest.mark.parametrize("M", [1, 5, 1023, 1025])
def test_version_scan_ragged_requests_and_ring_widths(dev, M, V):
    """version_scan_cuda bit-equal to version_scan_plain where M is not a
    multiple of the requests a warp holds (the groups past M stay in the
    kernel for the reductions), at one-lane groups (V = 1), lanes past V
    (V = 3), full sectors (V = 8), 16-lane groups and lanes holding two
    slots (V = 40); CIDs tie, some rings are empty, pad keys -1 and past
    the last row."""
    rng = np.random.RandomState(10 * M + V)
    n = 64
    tid = np.where(rng.rand(n, V) < 0.3, -1, rng.randint(1, 99, (n, V)))
    tid[::8] = -1
    keys = rng.randint(0, n, M)
    keys[::5] = -1
    keys[2::7] = n + 3
    t = lambda a: torch.as_tensor(np.asarray(a, np.int32), device=dev)
    args = (t(rng.randint(0, 4, (n, V))), t(tid), t(rng.randint(-1, 4, M)),
            t(keys))
    before = LAUNCHES["version_scan"]
    _same(version_scan_cuda(*args), version_scan_plain(*args))
    torch.cuda.synchronize()
    assert LAUNCHES["version_scan"] - before == 1


@pytest.mark.parametrize("T", [40, 256])
def test_read_phase_kernels_take_unaligned_keys(dev, T):
    """Key sets that start 4 bytes past a 16-byte boundary (views into a
    larger buffer): the potential matrix stages them with 4-byte loads in
    place of its 16-byte ones and still equals the plain version."""
    O = 4
    tabs, keys, mc, rk, wk, rv = CS.read_phase_corner(np, T, O, 8, -1)
    def shifted(a):
        buf = torch.empty(a.size + 1, dtype=torch.int32, device=dev)
        view = buf[1:].view(a.shape)
        view.copy_(torch.as_tensor(a, device=dev))
        assert view.data_ptr() % 16
        return view
    tabs = [torch.as_tensor(a, device=dev) for a in tabs]
    keys, mc, rk, wk = (shifted(a) for a in (keys, mc, rk, wk))
    rv = torch.as_tensor(rv, device=dev)
    _same((potential_matrix_cuda(rk, wk),), (potential_matrix_ref(rk, wk),))
    args = (*tabs, mc, rk, wk, rv)
    _same(wave_commit_cuda(*args, keys=keys),
          wave_commit_plain(*args, keys=keys))


@pytest.mark.parametrize("gc", ["none", "track", "block"])
@pytest.mark.parametrize("sched", tc.SCHEDULERS)
def test_commit_loop_kernel_equals_plain_loop(dev, sched, gc):
    """Every corner case of chip_smoke.py (V=2 rings read and RMW'd in one
    wave, duplicate write keys, T=1, T=33, O=12, T=1040 past the shared-
    memory budget, placement with clocksi skew, negative and out-of-range
    rows on live ops, one row from two heads, one hot key at T=256, T=256
    O=4 at the largest V that stages and the next) and a T=256 SmallBank
    wave over a 256-key store, each wave from an aged store under a
    watermark that evicts: outputs and store bit-equal to the plain loop in
    the variant the wrapper picks and, where that is ``staged``, in the
    ``global`` one too; one launch a wave and variant."""
    from functools import partial
    from repro_torch.kernels.commit_loop import commit_loop_smem_bytes
    cs = _chip_smoke()
    cases = cs.commit_loop_cases(np, cs.Config(nodes=4, kpn=64, V=8, T=256))
    before, launches, variants = LAUNCHES["commit_loop"], 0, set()
    for case in cases:
        T, O = case[4][0][0].shape
        auto = commit_loop_smem_bytes(T, O, case[2])[1]
        kernels = (commit_loop_cuda,)
        if auto == "staged":
            kernels += (partial(commit_loop_cuda, variant="global"),)
        variants |= {auto, "global"}
        assert cs.check_commit_loop(torch, np, dev, case, sched, gc, kernels,
                                    commit_loop_plain) == 0
        launches += len(kernels) * len(case[4])
    torch.cuda.synchronize()
    assert variants == {"staged", "global"}
    assert LAUNCHES["commit_loop"] - before == launches


def _close(got, want, tol):
    assert got.shape == want.shape and got.dtype == want.dtype
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("B,S,H,KH,D,causal", [
    (2, 256, 4, 2, 128, True), (2, 512, 4, 2, 64, False),
    (1, 100, 4, 2, 80, True), (2, 1000, 14, 2, 64, True),
    (1, 1, 2, 2, 16, True), (1, 70, 3, 1, 48, False),
    (4, 1024, 32, 32, 80, True)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_vs_plain(dev, B, S, H, KH, D, causal, dtype):
    """q and k at scale 2 (a peaked softmax, outputs of the order of v).
    In bf16 also against the plain version in float32 on the same bf16
    inputs: the kernel computes in float32 and rounds once, so within one
    bf16 rounding (rtol 1e-2) plus 1e-3 * max|o|."""
    g = torch.Generator(device=dev).manual_seed(S + D)
    q, k, v = ((torch.randn((B, S, h, D), generator=g, device=dev) * sc)
               .to(dtype) for h, sc in ((H, 2.0), (KH, 2.0), (KH, 1.0)))
    before = LAUNCHES["flash_attention"]
    got = flash_attention_cuda(q, k, v, causal)
    _close(got, flash_attention_plain(q, k, v, causal),
           2e-2 if dtype == torch.bfloat16 else 2e-5)
    assert LAUNCHES["flash_attention"] == before + 1
    if dtype == torch.bfloat16:
        want = flash_attention_plain(q.float(), k.float(), v.float(), causal)
        torch.testing.assert_close(got.float(), want, rtol=1e-2,
                                   atol=1e-3 * float(want.abs().max()))


@pytest.mark.parametrize("Bg,H,S,P,N,chunk,with_h0", [
    (2, 3, 256, 64, 64, 128, False), (2, 3, 300, 32, 64, 64, True),
    (1, 4, 77, 16, 16, 16, True), (2, 2, 50, 64, 64, 128, False),
    (1, 80, 1024, 64, 64, 128, True)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel_vs_plain(dev, Bg, H, S, P, N, chunk, with_h0, dtype):
    g = torch.Generator(device=dev).manual_seed(S + P)
    rn = lambda *shape: torch.randn(shape, generator=g, device=dev)
    x = (rn(Bg * H, S, P) * 0.5).to(dtype)
    dA = -torch.rand((Bg * H, S), generator=g, device=dev) * 0.8
    Bm, Cm = ((rn(Bg, S, N) * 0.3).to(dtype) for _ in range(2))
    h0 = rn(Bg * H, N, P) * 0.2 if with_h0 else None
    before = LAUNCHES["ssd_scan"]
    y, h = ssd_cuda(x, dA, Bm, Cm, H, chunk, h0)
    yp, hp = ssd_plain(x, dA, Bm, Cm, H, chunk, h0)
    _close(y, yp, 2e-2 if dtype == torch.bfloat16 else 1e-3)
    _close(h, hp, 1e-3)
    assert LAUNCHES["ssd_scan"] == before + 1


@pytest.mark.parametrize("B,S,H,KH,D", [(1, 2048, 32, 8, 128),
                                        (4, 1000, 32, 32, 80)])
def test_flash_attention_kernel_wide_q_tiles(dev, B, S, H, KH, D):
    """bf16 at the kernel's 128-row q tiles (four warps of two 16-row
    m-tiles), long with GQA at D=128 and ragged at the path's width:
    against the plain version and the float32 oracle as above."""
    g = torch.Generator(device=dev).manual_seed(S + D)
    q, k, v = ((torch.randn((B, S, h, D), generator=g, device=dev) * sc)
               .to(torch.bfloat16) for h, sc in ((H, 2.0), (KH, 2.0),
                                                 (KH, 1.0)))
    got = flash_attention_cuda(q, k, v, True)
    _close(got, flash_attention_plain(q, k, v, True), 2e-2)
    want = flash_attention_plain(q.float(), k.float(), v.float(), True)
    torch.testing.assert_close(got.float(), want, rtol=1e-2,
                               atol=1e-3 * float(want.abs().max()))


def _ssd_oracle(y, x, dA, Bm, Cm, H, chunk, h0):
    """A bf16 scan output against the plain version in float32 on the same
    bf16 inputs: within one bf16 rounding (rtol 1e-2) plus 1e-3 * max|y|,
    as chip_smoke.py's ssd_oracle_err."""
    want, _ = ssd_plain(x.float(), dA, Bm.float(), Cm.float(), H, chunk, h0)
    torch.testing.assert_close(y.float(), want, rtol=1e-2,
                               atol=1e-3 * float(want.abs().max()))


@pytest.mark.parametrize("Bg,H,S,P,N,chunk", [
    (4, 80, 1024, 64, 64, 128), (2, 24, 1000, 64, 128, 128),
    (2, 3, 300, 32, 64, 64)])
def test_ssd_kernel_slow_decay(dev, Bg, H, S, P, N, chunk):
    """bf16 with dA ~ -U(0, 0.01), as trained SSM heads decay, and an
    initial state: every row tile of the state product and every block
    below the diagonal of (C B^T .* L) x carries weight, so a wrong or
    skipped block shows (at -U(0, 0.8), rows 16 back add under e^-6).  At
    the path's shape, at N=128 and ragged; against the plain version and
    the float32 oracle."""
    g = torch.Generator(device=dev).manual_seed(S + N + 1)
    rn = lambda *shape: torch.randn(shape, generator=g, device=dev)
    x = (rn(Bg * H, S, P) * 0.5).to(torch.bfloat16)
    dA = -torch.rand((Bg * H, S), generator=g, device=dev) * 0.01
    Bm, Cm = ((rn(Bg, S, N) * 0.3).to(torch.bfloat16) for _ in range(2))
    h0 = rn(Bg * H, N, P) * 0.2
    y, h = ssd_cuda(x, dA, Bm, Cm, H, chunk, h0)
    yp, hp = ssd_plain(x, dA, Bm, Cm, H, chunk, h0)
    _close(y, yp, 2e-2)
    _close(h, hp, 1e-3)
    _ssd_oracle(y, x, dA, Bm, Cm, H, chunk, h0)


@pytest.mark.parametrize("Bg,H,S,P,N,chunk,with_h0", [
    (2, 3, 300, 64, 64, 128, True), (1, 80, 1024, 64, 64, 128, True),
    (2, 4, 77, 16, 16, 16, False)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("decay", [0.8, 0.01])
def test_ssd_kernel_model_layout(dev, Bg, H, S, P, N, chunk, with_h0,
                                 dtype, decay):
    """x and dA as the [B, H, S, .] views of the model's [B, S, H, .], as
    models/ssm.py:ssd passes them: y comes back as such a view, equal to
    the folded call's and within the tolerances of the plain version (in
    bf16 also of the float32 oracle); with the decay of the other cases
    and slow."""
    g = torch.Generator(device=dev).manual_seed(S + N)
    rn = lambda *shape: torch.randn(shape, generator=g, device=dev)
    x = (rn(Bg, S, H, P) * 0.5).to(dtype)
    dA = -torch.rand((Bg, S, H), generator=g, device=dev) * decay
    Bm, Cm = ((rn(Bg, S, N) * 0.3).to(dtype) for _ in range(2))
    h0 = rn(Bg * H, N, P) * 0.2 if with_h0 else None
    xv, av = x.transpose(1, 2), dA.transpose(1, 2)
    y, h = ssd_cuda(xv, av, Bm, Cm, H, chunk, h0)
    assert y.shape == (Bg, H, S, P) and y.transpose(1, 2).is_contiguous()
    yf, hf = ssd_cuda(xv.reshape(Bg * H, S, P).contiguous(),
                      av.reshape(Bg * H, S).contiguous(), Bm, Cm, H, chunk,
                      h0)
    assert torch.equal(y.reshape(Bg * H, S, P), yf) and torch.equal(h, hf)
    yp, hp = ssd_plain(xv, av, Bm, Cm, H, chunk, h0)
    _close(y, yp, 2e-2 if dtype == torch.bfloat16 else 1e-3)
    _close(h, hp, 1e-3)
    if dtype == torch.bfloat16:
        _ssd_oracle(y, xv, av, Bm, Cm, H, chunk, h0)


def test_ssd_kernel_bf16_state_128(dev):
    """mamba2-130m's state size, N=128 with P=64 at chunk 128, which only
    the bf16 kernel's shared-memory budget admits; with an initial state
    (slow decay at N=128: test_ssd_kernel_slow_decay)."""
    g = torch.Generator(device=dev).manual_seed(128)
    rn = lambda *shape: torch.randn(shape, generator=g, device=dev)
    Bg, H, S, P, N = 2, 24, 1000, 64, 128
    x = (rn(Bg * H, S, P) * 0.5).to(torch.bfloat16)
    dA = -torch.rand((Bg * H, S), generator=g, device=dev) * 0.8
    Bm, Cm = ((rn(Bg, S, N) * 0.3).to(torch.bfloat16) for _ in range(2))
    h0 = rn(Bg * H, N, P) * 0.2
    before = LAUNCHES["ssd_scan"]
    y, h = ssd_cuda(x, dA, Bm, Cm, H, 128, h0)
    yp, hp = ssd_plain(x, dA, Bm, Cm, H, 128, h0)
    _close(y, yp, 2e-2)
    _close(h, hp, 1e-3)
    _ssd_oracle(y, x, dA, Bm, Cm, H, 128, h0)
    assert LAUNCHES["ssd_scan"] == before + 1


def test_ssd_kernel_refuses_too_much_shared_memory(dev):
    x = torch.zeros((2, 256, 64), device=dev)
    bc = torch.zeros((1, 256, 128), device=dev)
    with pytest.raises(ValueError, match="shared memory"):
        ssd_cuda(x, torch.zeros((2, 256), device=dev), bc, bc, 2, 128)


def test_server_cuda_route_serves_what_torch_serves(dev):
    """Reduced zamba2 (float32) behind Server: the cuda route and the
    torch route give the same ids and versions; each prefill launches
    flash_attention once per group and ssd_scan once per layer."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_reduced("zamba2-2.7b").replace(compute_dtype=torch.float32)
    model = build(cfg)
    g = torch.Generator(device=dev).manual_seed(0)
    versions = [model.init(g) for _ in range(2)]
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size, (2, S)).astype(np.int32)
               for S in (64, 37)]
    served = {}
    for route in ("torch", "cuda"):
        srv = Server(cfg, versions[0], batch_size=2, kernels=route,
                     device=dev)
        before = dict(LAUNCHES)
        out = []
        for i, toks in enumerate(prompts):
            if i == 1:
                assert srv.publish(versions[1])
            out.append(srv.serve_batch(toks, max_new_tokens=4))
        launched = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
        served[route] = (out, srv.stats, launched)
    (t_out, t_stats, t_l), (c_out, c_stats, c_l) = served["torch"], \
        served["cuda"]
    assert t_l["flash_attention"] == t_l["ssd_scan"] == 0
    assert c_l["flash_attention"] == 2 * (cfg.n_layers // cfg.attn_every)
    assert c_l["ssd_scan"] == 2 * cfg.n_layers
    assert c_stats == t_stats and c_stats.versions_served == [0, 1]
    for a, b in zip(c_out, t_out):
        assert a["weight_version"] == b["weight_version"]
        np.testing.assert_array_equal(a["generated"], b["generated"])


# ------------------------------------------ streaming plane and planner
def _host_block(n_waves, T=16, seed=3):
    waves = tw.ycsb_waves(np.random.RandomState(seed), n_waves, T, 4, 40,
                          theta=0.9, read_frac=0.3, device="cpu")
    return [tc.wave_to_numpy(w) for w in waves]


@pytest.mark.parametrize("route", ["cuda", "cuda+fused"])
@pytest.mark.parametrize("sched", ["postsi", "clocksi", "si"])
def test_run_block_dispatches_without_host_waits(dev, route, sched):
    """The dispatch half of a block (staging, copies, every wave's read
    phase, commit loop and statistics) runs under sync debug mode "error";
    the same mode raises on a known blocking copy."""
    hs = np.array([0, 1, 0, 2], np.int32) if sched == "clocksi" else None
    store = tc.make_store(160, 4, device=dev)
    clock = torch.ones((), dtype=torch.int32, device=dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with pytest.raises(RuntimeError, match="synchroniz"):
            torch.as_tensor(np.zeros(4, np.int32), device=dev)
        for wm in (None, 1):
            blk = tc.stage_block(_host_block(4), 1, wm, device=dev)
            store, outs, clock = tc.run_block(
                store, blk, None, clock, sched=sched, n_nodes=4,
                host_skew=hs, kernels=route)
            store, outs, clock = tc.run_block(
                store, tc.Wave(*(np.stack(f) for f in zip(*_host_block(
                    2, seed=4)))), 5, clock, sched=sched, n_nodes=4,
                host_skew=hs, watermark=wm, kernels=route)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert blk.host.is_pinned()
    assert outs.status.shape == (2, 16)


def _stream(route, dev, B=4, K=2, planner=None, seed=2):
    svc = ts.TxnService(160, T=16, n_nodes=4, kernels=route, device=dev,
                        planner=planner)
    gen = ts.ycsb_txn_gen(np.random.RandomState(seed), 4, 40, theta=0.99,
                          read_frac=0.2)
    rep = svc.run_streaming([12] * 12, gen, B=B, K=K, sizer="auto")
    fates = [(r.status, tuple(r.tids), r.s, r.c) for r in svc.requests]
    return svc, rep, fates


@pytest.mark.parametrize("planner", [None, "hybrid"])
def test_streaming_cuda_routes_equal_torch(dev, planner):
    ref_svc, ref_rep, ref_fates = _stream("torch", dev, planner=planner)
    assert ref_svc.verify() == [] and ref_rep.blocks > 0
    for route in ("cuda", "cuda+fused"):
        before = LAUNCHES["commit_loop"]
        svc, rep, fates = _stream(route, dev, planner=planner)
        assert LAUNCHES["commit_loop"] - before >= rep.blocks
        assert fates == ref_fates, route
        assert rep.blocks == ref_rep.blocks
        for (ta, oa), (tb, ob) in zip(svc.history, ref_svc.history):
            np.testing.assert_array_equal(ta, tb)
            for x, y in zip(oa, ob):
                np.testing.assert_array_equal(x, y)
        for a, b in zip(svc.store, ref_svc.store):
            assert torch.equal(a, b), route


def test_planned_replay_cuda_routes_equal_torch(dev):
    from repro_torch.planner import run_workload_planned
    waves = tw.smallbank_waves(np.random.RandomState(5), 2, 64, 4, 16,
                               hot_frac=0.6, hot_per_node=2, device=dev)
    runs = {}
    for route in ("torch", "cuda", "cuda+fused"):
        st, hist, stats = run_workload_planned(
            tc.make_store(64, 8, device=dev), waves, n_nodes=4,
            kernels=route)
        assert stats.aborted == 0 and stats.max_lanes_seen > 1
        runs[route] = (tc.store_to_numpy(st), hist, stats._replace(
            plan_s=0.0))
    ref_store, ref_hist, ref_stats = runs["torch"]
    for route, (st, hist, stats) in runs.items():
        assert stats == ref_stats, route
        for f in st:
            np.testing.assert_array_equal(st[f], ref_store[f])
        for (_, a), (_, b) in zip(hist, ref_hist):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)


def test_staging_stays_alive_until_retire(dev):
    """Each in-flight block keeps its page-locked staging until it retires:
    the same buffer, pinned, with the same contents, after the K-1 further
    dispatches that retire it."""
    K = 3
    svc = ts.TxnService(160, T=16, n_nodes=4, kernels="cuda", device=dev)
    drv = ts.StreamingDriver(svc, B=2, K=K)
    svc.stream = drv
    seen, dispatched, retired = {}, [0], []
    run = svc._run_block

    def run_block(waves):
        outs, clock, staged = run(waves)
        dispatched[0] += 1
        seen[id(staged)] = (staged.host.data_ptr(), dispatched[0],
                            staged.host.numpy().copy())
        return outs, clock, staged
    svc._run_block = run_block
    retire = drv._retire_one

    def retire_one(allow_delay=False):
        host = drv._inflight[0].staged.host
        ptr, at, content = seen[id(drv._inflight[0].staged)]
        assert host.is_pinned() and host.data_ptr() == ptr
        np.testing.assert_array_equal(host.numpy(), content)
        retired.append(dispatched[0] - at)
        retire(allow_delay)
    drv._retire_one = retire_one
    gen = ts.ycsb_txn_gen(np.random.RandomState(0), 4, 40, theta=0.5)
    for _ in range(10):
        for _ in range(40):
            svc.submit(*gen())
        drv.tick()
    drv.drain()
    assert svc.verify() == []
    assert max(retired) == K - 1 and len(retired) == svc.blocks


# ------------------------------------------------ durability and recovery
def _durable_stream(route, dev, d, checked=None):
    from repro_torch.durability import DurabilityManager
    mgr = DurabilityManager(str(d), snapshot_every=3)
    svc = ts.TxnService(160, T=16, n_nodes=4, kernels=route, device=dev,
                        durability=mgr)
    if checked is not None:
        run = svc._run_block

        def run_checked(waves):
            torch.cuda.set_sync_debug_mode("error")
            try:
                out = run(waves)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            checked[0] += 1
            return out
        svc._run_block = run_checked
    gen = ts.ycsb_txn_gen(np.random.RandomState(2), 4, 40, theta=0.9,
                          read_frac=0.3)
    svc.run_streaming([12] * 12, gen, B=4, K=2, sizer="auto")
    mgr.close()
    assert svc.verify() == [] and mgr.snapshots_taken > 0
    return svc


@pytest.mark.parametrize("route", ["cuda", "cuda+fused"])
def test_durable_streaming_logs_what_torch_logs(dev, route, tmp_path):
    from repro_torch.durability import wal, wal_path
    ref = _durable_stream("torch", dev, tmp_path / "torch")
    checked = [0]
    svc = _durable_stream(route, dev, tmp_path / "cuda", checked)
    assert checked[0] == svc.blocks > 0
    for a, b in zip(svc.store, ref.store):
        assert torch.equal(a, b)
    got = wal.scan(wal_path(str(tmp_path / "cuda"))).blocks
    want = wal.scan(wal_path(str(tmp_path / "torch"))).blocks
    assert len(got) == len(want) == svc.blocks
    for x, y in zip(got, want):
        assert x.keys() == y.keys()
        for k in x:
            if isinstance(y[k], np.ndarray):
                assert x[k].dtype == y[k].dtype == np.int32
                np.testing.assert_array_equal(x[k], y[k])
            else:
                assert type(x[k]) is type(y[k]) and x[k] == y[k], k
        assert wal._frame(wal.REC_BLOCK, x) == wal._frame(wal.REC_BLOCK, y)


def test_recovery_cuda_routes_equal_torch(dev, tmp_path):
    from repro_torch.durability import recover
    live = _durable_stream("cuda", dev, tmp_path)
    for use_snapshot in (True, False):
        ref = recover(str(tmp_path), kernels="torch", device=dev,
                      use_snapshot=use_snapshot)
        for route in ("cuda", "cuda+fused"):
            before = LAUNCHES["commit_loop"]
            st = recover(str(tmp_path), kernels=route, device=dev,
                         use_snapshot=use_snapshot)
            assert LAUNCHES["commit_loop"] - before == len(st.history)
            if not use_snapshot:
                assert st.n_replayed == st.n_blocks > 0
            for state in (ref, st):
                for a, b in zip(state.store, live.store):
                    assert torch.equal(a, b), route
                assert (state.clock, state.wave_idx, state.gc_clock,
                        state.next_tid) == (int(live.clock), live.wave_idx,
                                            live.gc.clock,
                                            live.former.next_tid)


# ------------------------------------------------ elastic placement
def _placed_session(route, dev, replicas=False, streaming=False,
                    checked=None):
    from repro_torch.core.workloads import zipf_hot_keys
    from repro_torch.placement import PlacementMap
    svc = ts.TxnService(
        160, T=16, O=2, n_nodes=4, kernels=route, device=dev,
        placement=PlacementMap(160, 4, headroom=2), balancer=True,
        replicas=zipf_hot_keys(4, 40, 0.99, mass=0.95, max_frac=0.4)
        if replicas else None, replica_refresh=4)
    if checked is not None:
        run = svc._run_block

        def run_checked(waves):
            torch.cuda.set_sync_debug_mode("error")
            try:
                out = run(waves)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            checked[0] += 1
            return out
        svc._run_block = run_checked
    gen = ts.ycsb_txn_gen(np.random.RandomState(31), 4, 40, theta=0.99,
                          read_frac=0.97, n_ops=2)
    if streaming:
        svc.run_streaming([48] * 6, gen, B=4, K=2, drain=False)
        svc.move_range(0, 10, 1)           # flushes, then the next blocks
        svc.run_streaming([48] * 6, gen, B=4, K=2)
    else:
        svc.run_stream([48] * 6, gen, drain=False)
        svc.move_range(0, 10, 1)
        svc.run_stream([48] * 6, gen)
    assert svc.verify() == [] and svc.placement_moves > 0
    fates = [(r.status, tuple(r.tids), r.s, r.c, r.replica)
             for r in svc.requests]
    return svc, fates


@pytest.mark.parametrize("replicas", [False, True])
def test_placed_session_cuda_routes_equal_torch(dev, replicas):
    ref, ref_fates = _placed_session("torch", dev, replicas)
    for route in ("cuda", "cuda+fused"):
        before = LAUNCHES["commit_loop"]
        svc, fates = _placed_session(route, dev, replicas)
        assert LAUNCHES["commit_loop"] - before == svc.wave_idx
        assert fates == ref_fates, route
        assert svc.report().placement_moves == ref.report().placement_moves
        np.testing.assert_array_equal(svc.placement.slot, ref.placement.slot)
        for (ta, oa), (tb, ob) in zip(svc.history, ref.history):
            np.testing.assert_array_equal(ta, tb)
            for x, y in zip(oa, ob):
                np.testing.assert_array_equal(x, y)
        for a, b in zip(svc.store, ref.store):
            assert torch.equal(a, b), route
        if replicas:
            assert svc.replica_commits > 0
            assert svc.replicas.max_cid() <= svc.replicas.floor


def test_placed_block_dispatch_without_host_waits(dev):
    """Every block dispatch of a placed streaming session, moves between
    them, runs under sync debug mode "error": the placement tables are on
    the card before the dispatch, remade by the move, never copied in it."""
    ref, ref_fates = _placed_session("torch", dev, streaming=True)
    for route in ("cuda", "cuda+fused"):
        checked = [0]
        svc, fates = _placed_session(route, dev, streaming=True,
                                     checked=checked)
        assert checked[0] == svc.blocks > 0
        assert fates == ref_fates, route
        for a, b in zip(svc.store, ref.store):
            assert torch.equal(a, b), route


def test_apply_move_on_card_equals_cpu(dev):
    """The in-place move on the card equals the CPU's, field by field,
    for a move within a block, one that fills the last physical row, and
    moves back."""
    from repro_torch.placement import PlacementMap, apply_move_local
    pm = PlacementMap(64, 4, headroom=2)
    rng = np.random.RandomState(1)
    fields = {f: rng.randint(-5, 50, (pm.n_slots, 4) if f in (
        "val", "tid", "cid", "sid") else (pm.n_slots,)).astype(np.int32)
        for f in tc.MVStore._fields}
    cpu = tc.store_from_numpy(fields, "cpu")
    card = tc.store_from_numpy(fields, dev)
    for lo, hi, dst in ((4, 12, 2), (0, 16, 3), (0, 4, 0), (48, 56, 1)):
        rec = pm.move(lo, hi, dst)
        apply_move_local(cpu, rec)
        apply_move_local(card, rec)
        pm.apply_record(rec)
        for f, a, b in zip(tc.MVStore._fields, cpu, card):
            assert torch.equal(a, b.cpu()), (lo, hi, dst, f)
    assert (pm.slot == pm.n_slots - 1).any()


# ------------------------------------------------------------- node mesh
def _mesh_run(dev, route, drv, n=8, kpn=16, V=8, W=2, T=32, sched="postsi",
              seed=4):
    mesh = tc.make_node_mesh(n, dev)
    waves = tw.smallbank_waves(np.random.RandomState(seed), W, T, n, kpn,
                               dist_frac=0.5, hot_frac=0.5, hot_per_node=3,
                               device=dev)
    hs = (np.array([0, 1, 1, 2, 0, 1, 2, 0][:n], np.int32)
          if sched == "clocksi" else None)
    before = dict(LAUNCHES)
    st, hist, stats = drv(tc.shard_store(tc.make_store(n * kpn, V,
                                                       device=dev), mesh),
                          waves, mesh, sched=sched, host_skew=hs,
                          gc_track=True, kernels=route)
    torch.cuda.synchronize()
    got = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
    return st, hist, stats, got


def _same_runs(a, b, label):
    assert a[2] == b[2], label
    for (ta, oa), (tb, ob) in zip(a[1], b[1]):
        np.testing.assert_array_equal(ta, tb)
        for f, x, y in zip(oa._fields, oa, ob):
            np.testing.assert_array_equal(x, y, err_msg=f"{label} {f}")
    for f, x, y in zip(tc.MVStore._fields, a[0], b[0]):
        assert torch.equal(x, y), (label, f)


@pytest.mark.parametrize("sched", ["postsi", "clocksi", "si"])
def test_mesh_cuda_routes_equal_torch_and_one_card(dev, sched):
    n, T, W = 8, 32, 2
    ref = _mesh_run(dev, "torch", tc.run_workload_fused_dist, sched=sched)
    assert not any(ref[3].values())
    hs = (np.array([0, 1, 1, 2, 0, 1, 2, 0], np.int32)
          if sched == "clocksi" else None)
    one = tc.run_workload_fused(
        tc.make_store(n * 16, 8, device=dev),
        tw.smallbank_waves(np.random.RandomState(4), W, T, n, 16,
                           dist_frac=0.5, hot_frac=0.5, hot_per_node=3,
                           device=dev), sched=sched, n_nodes=n, host_skew=hs,
        gc_track=True, kernels="cuda")
    _same_runs(ref, one, f"{sched} mesh torch vs one card cuda")
    want = {"cuda": {"version_scan": W * n * (T + 1), "potential_matrix": W,
                     "wave_commit": 0, "commit_loop": 0},
            "cuda+fused": {"version_scan": W * n * T, "potential_matrix": 0,
                           "wave_commit": W * n, "commit_loop": 0}}
    for route in ("cuda", "cuda+fused"):
        for drv in (tc.run_workload_fused_dist, tc.run_workload_dist):
            run = _mesh_run(dev, route, drv, sched=sched)
            _same_runs(run, ref, f"{sched} {route} {drv.__name__}")
            got = {k: run[3][k] for k in want[route]}
            assert got == want[route], (route, drv.__name__, got)


def test_mesh_block_views_off_a_16_byte_boundary(dev):
    """37 rows a node and V=3: node i's block starts 444 i bytes into the
    ring tables, off a 16-byte boundary for most nodes."""
    ref = _mesh_run(dev, "torch", tc.run_workload_fused_dist, kpn=37, V=3,
                    T=24)
    offsets = [(i * 37 * 3 * 4) % 16 for i in range(8)]
    assert any(offsets)
    for route in ("cuda", "cuda+fused"):
        run = _mesh_run(dev, route, tc.run_workload_fused_dist, kpn=37, V=3,
                        T=24)
        _same_runs(run, ref, f"odd blocks {route}")


@pytest.mark.parametrize("route", ["cuda", "cuda+fused"])
def test_mesh_run_block_dispatches_without_host_waits(dev, route):
    mesh = tc.make_node_mesh(4, dev)
    store = tc.shard_store(tc.make_store(160, 4, device=dev), mesh)
    ref = tc.make_store(160, 4, device=dev)
    clock = torch.ones((), dtype=torch.int32, device=dev)
    ref_clock = clock.clone()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for wm in (None, 1):
            blk = tc.stage_block(_host_block(4), 1, wm, device=dev)
            store, outs, clock = tc.run_block_dist(
                store, blk, None, clock, mesh, sched="postsi",
                kernels=route)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for wm in (None, 1):
        ref, ref_outs, ref_clock = tc.run_block(
            ref, tc.stage_block(_host_block(4), 1, wm, device=dev), None,
            ref_clock, sched="postsi", n_nodes=4, kernels=route)
    for x, y in zip(outs, ref_outs):
        assert torch.equal(x, y)
    for x, y in zip(store, ref):
        assert torch.equal(x, y)


def test_apply_move_mesh_on_card_equals_cpu(dev):
    from repro_torch.placement import (PlacementMap, apply_move_local,
                                       apply_move_mesh)
    pm = PlacementMap(64, 4, headroom=2)
    rng = np.random.RandomState(1)
    fields = {f: rng.randint(-5, 50, (pm.n_slots, 4) if f in (
        "val", "tid", "cid", "sid") else (pm.n_slots,)).astype(np.int32)
        for f in tc.MVStore._fields}
    cpu = tc.store_from_numpy(fields, "cpu")
    cpu_mesh = tc.store_from_numpy(fields, "cpu")
    card = tc.store_from_numpy(fields, dev)
    m_cpu, m_card = tc.make_node_mesh(4, "cpu"), tc.make_node_mesh(4, dev)
    for lo, hi, dst in ((4, 12, 2), (0, 16, 3), (0, 4, 0), (48, 56, 1)):
        rec = pm.move(lo, hi, dst)
        apply_move_local(cpu, rec)
        apply_move_mesh(cpu_mesh, rec, m_cpu)
        apply_move_mesh(card, rec, m_card)
        pm.apply_record(rec)
        for f, a, b, c in zip(tc.MVStore._fields, cpu, cpu_mesh, card):
            assert torch.equal(a, b) and torch.equal(a, c.cpu()), (lo, f)
    assert (pm.slot == pm.n_slots - 1).any()
