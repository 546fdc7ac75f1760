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
bf16 output: one bf16 rounding), attention's Hopper kernel (bf16 at D =
64, 80, 128) also with its lse, at Sq = 1, Sq != Sk and ragged S, two
calls bit-equal, also at 128-row attention q tiles, in the
model's strided layout, at N=128 and with slow decay (where every block of
the scan carries weight), the bf16 outputs also against the plain versions
in float32 on the same inputs, the SSD scan's Hopper kernel (bf16, P = 64,
N = 64 and 128) also at 9, 16 and 24 chunks with h0, at S < 128 and S = 1,
two calls bit-equal, and reduced zamba2 behind ``Server`` on the
``cuda`` route must serve what the ``torch`` route serves; so must the
reduced decoder models (dense, MoE, VLM with a head dim of 32; the
reduced VLM's 24 is refused on ``cuda``), their logits within 1e-3 of
scale, and ``moe_ffn`` must run under sync debug mode "error".  The
float32 SSD kernel must take mamba2-130m's N=128 at chunk 128 (both
layouts), ``flash_attention`` must hold at Sq != Sk and Sq = 1
(cross-attention), and the reduced mamba2-130m and seamless behind
``Server`` on ``cuda`` must serve what ``torch`` serves, with their
launches counted, in float32 (logits within 1e-3 of scale, the same ids)
and bf16 (logits within 0.06 of scale).  The block
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
and ``apply_move_mesh`` on the card must equal the CPU.  Training: the
attention backward's two kernels must agree with
``flash_attention_bwd_plain`` on the forward kernel's o and lse (bf16
within one bf16 rounding plus 1e-3 of the largest |want|, float32 within
1e-4), one launch each a call, two calls bit-equal (the training shape,
G = 1, 3 and 7), also where the bf16 Hopper kernels split their walks (an
odd count of pairs a kv tile, D = 128 at G = 7, causal with Sk > Sq and
zero dk and dv past the last query); ``ops.flash_attention`` under a gradient
must run the forward and both backward kernels once each, its float32
gradients those of autograd through the plain version; the SSD scan's
three backward kernels must agree with their plain versions at
``chip_smoke.py``'s ``SSD_BWD_CASES`` (float32 within 1e-3 of scale, bf16
within 2e-2 and one bf16 rounding of the float32 oracle, two calls
bit-equal; the fused states and scan kernel also equal to the states and
scan kernels, hprev, G and dh0 bit for bit), ``ops.ssd`` under a
gradient must run ``SsdScanFn``: the forward kernel and each backward
kernel once (in bf16 the fused one in place of the states and scan
kernels), its gradients those of autograd through the plain scan; and
one float32 loss and gradient of the
reduced qwen2-0.5b, deepseek-moe-16b, seamless, mamba2-130m and
zamba2-2.7b models on ``cuda`` must equal the ``torch`` route's (every
leaf within 1e-3 of its scale) with the launches of
``chip_smoke.train_launches``.
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
        "commit_loop": 0, "flash_attention": 0, "ssd_scan": 0,
        "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkdv": 0,
        "ssd_scan_bwd_states": 0, "ssd_scan_bwd_scan": 0,
        "ssd_scan_bwd_states_scan": 0, "ssd_scan_bwd_grads": 0}


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
        "commit_loop": 0, "flash_attention": 0, "ssd_scan": 0,
        "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkdv": 0,
        "ssd_scan_bwd_states": 0, "ssd_scan_bwd_scan": 0,
        "ssd_scan_bwd_states_scan": 0, "ssd_scan_bwd_grads": 0}


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


@pytest.mark.parametrize("B,Sq,Sk,H,KH,causal", [
    (2, 1024, 1024, 14, 2, True), (1, 1000, 1000, 7, 1, True),
    (1, 200, 512, 10, 2, True), (2, 1, 1000, 5, 1, False),
    (2, 300, 77, 4, 4, False), (1, 50, 300, 4, 2, True)])
@pytest.mark.parametrize("D", [64, 80, 128])
def test_flash_attention_hopper_forward(dev, B, Sq, Sk, H, KH, D, causal):
    """bf16 at the Hopper kernel's head dims (D = 64, 80, 128): ragged S,
    G = 5 and 7, Sq = 1, Sq != Sk both ways (causal top-left) and a q tile
    whose second consumer group has no rows; o against the plain version
    and the float32 oracle as above, lse against the plain version's
    (1e-3), one launch a call, and two calls bit-equal."""
    g = torch.Generator(device=dev).manual_seed(Sq + Sk + D)
    q = (torch.randn((B, Sq, H, D), generator=g, device=dev) * 2.0).to(
        torch.bfloat16)
    k, v = ((torch.randn((B, Sk, KH, D), generator=g, device=dev) * sc)
            .to(torch.bfloat16) for sc in (2.0, 1.0))
    before = LAUNCHES["flash_attention"]
    o, lse = flash_attention_cuda(q, k, v, causal, with_lse=True)
    assert LAUNCHES["flash_attention"] == before + 1
    want, lse_p = flash_attention_plain(q, k, v, causal, with_lse=True)
    _close(o, want, 2e-2)
    torch.testing.assert_close(lse, lse_p, rtol=1e-5, atol=1e-3)
    oracle = flash_attention_plain(q.float(), k.float(), v.float(), causal)
    torch.testing.assert_close(o.float(), oracle, rtol=1e-2,
                               atol=1e-3 * float(oracle.abs().max()))
    again = flash_attention_cuda(q, k, v, causal, with_lse=True)
    assert torch.equal(o, again[0]) and torch.equal(lse, again[1])


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
    """mamba2-130m's state size, N=128 with P=64 at chunk 128, in bf16;
    with an initial state (slow decay at N=128: test_ssd_kernel_slow_decay;
    float32: test_ssd_kernel_fp32_state_128)."""
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


@pytest.mark.parametrize("model_layout", [False, True])
def test_ssd_kernel_fp32_state_128(dev, model_layout):
    """The float32 kernel at mamba2-130m's N=128, P=64, chunk 128 (its
    [M | C] rows staged in strips of 64 fit the shared memory a block may
    use), ragged S with an initial state, folded and as the views of the
    model's layout; slow decay in the latter, so every block carries
    weight."""
    from repro_torch.kernels.build import SMEM_LIMIT
    from repro_torch.kernels.ssd_scan import ssd_smem_bytes
    assert ssd_smem_bytes(64, 128, 128, torch.float32) <= SMEM_LIMIT
    g = torch.Generator(device=dev).manual_seed(129)
    rn = lambda *shape: torch.randn(shape, generator=g, device=dev)
    Bg, H, S, P, N = 2, 24, 1000, 64, 128
    x = rn(Bg * H, S, P) * 0.5
    dA = -torch.rand((Bg * H, S), generator=g, device=dev) * (
        0.01 if model_layout else 0.3)
    if model_layout:
        x = x.reshape(Bg, H, S, P).transpose(1, 2).contiguous().transpose(1, 2)
        dA = dA.reshape(Bg, H, S).transpose(1, 2).contiguous().transpose(1, 2)
    Bm, Cm = (rn(Bg, S, N) * 0.3 for _ in range(2))
    h0 = rn(Bg * H, N, P) * 0.2
    before = LAUNCHES["ssd_scan"]
    y, h = ssd_cuda(x, dA, Bm, Cm, H, 128, h0)
    assert LAUNCHES["ssd_scan"] == before + 1
    yp, hp = ssd_plain(x, dA, Bm, Cm, H, 128, h0)
    _close(y, yp, 1e-3)
    _close(h, hp, 1e-3)


# The Hopper SSD kernel's edges (ssd_scan_wgmma_kernel: P = 64, N = 64 or
# 128, chunks of 128 rows, a thread block cluster of up to 8 blocks a
# batch*head): (Bg, H, S, N, h0, dA scale, model layout): the path's two
# shapes; 16 chunks (two rounds a block) with h0 at both N; 9 chunks (block
# 0's second round alone, the state wrapping from block 7); 24 ragged
# chunks (three rounds); one chunk of S < 128 rows; S = 1 at both N; a
# ragged tail.  Slow decay (dA ~ -U(0, 0.01)) where far blocks must carry
# weight.
SSD_HOPPER_CASES = [
    (4, 80, 1024, 64, False, 1.4, True),
    (4, 24, 1024, 128, True, 0.01, True),
    (1, 4, 2048, 64, True, 0.01, True),
    (1, 3, 2048, 128, True, 0.01, False),
    (2, 3, 1100, 64, True, 0.01, False),
    (1, 2, 3000, 128, True, 0.01, True),
    (2, 3, 100, 64, True, 0.01, True),
    (2, 3, 1, 64, True, 0.8, False),
    (2, 3, 1, 128, False, 0.8, True),
    (2, 5, 1000, 64, True, 0.01, False)]


@pytest.mark.parametrize("Bg,H,S,N,with_h0,decay,model", SSD_HOPPER_CASES)
def test_ssd_hopper_kernel_cases(dev, Bg, H, S, N, with_h0, decay, model):
    """The Hopper kernel against the plain version (y within one bf16
    rounding, h 1e-3) and the float32 oracle, one launch a call, two calls
    bit-equal; the mma.sync kernel at the same shape (as the timings call
    it) within the same tolerance."""
    from repro_torch.kernels.ssd_scan import ssd_kernel
    P = 64
    assert ssd_kernel(P, N, min(128, S), S, torch.bfloat16) == "wgmma"
    g = torch.Generator(device=dev).manual_seed(S + N + 7)
    rn = lambda *shape: torch.randn(shape, generator=g, device=dev)
    x = (rn(Bg * H, S, P) * 0.5).to(torch.bfloat16)
    dA = -torch.rand((Bg * H, S), generator=g, device=dev) * decay
    if model:
        x = x.reshape(Bg, H, S, P).transpose(1, 2).contiguous().transpose(1, 2)
        dA = dA.reshape(Bg, H, S).transpose(1, 2).contiguous().transpose(1, 2)
    Bm, Cm = ((rn(Bg, S, N) * 0.3).to(torch.bfloat16) for _ in range(2))
    h0 = rn(Bg * H, N, P) * 0.2 if with_h0 else None
    before = LAUNCHES["ssd_scan"]
    y, h = ssd_cuda(x, dA, Bm, Cm, H, 128, h0)
    assert LAUNCHES["ssd_scan"] == before + 1
    yp, hp = ssd_plain(x, dA, Bm, Cm, H, 128, h0)
    _close(y, yp, 2e-2)
    _close(h, hp, 1e-3)
    _ssd_oracle(y, x, dA, Bm, Cm, H, 128, h0)
    again = ssd_cuda(x, dA, Bm, Cm, H, 128, h0)
    assert torch.equal(y, again[0]) and torch.equal(h, again[1])
    ym, hm = ssd_cuda(x, dA, Bm, Cm, H, 128, h0, kernel="mma")
    _close(ym, yp, 2e-2)
    _close(hm, hp, 1e-3)


def test_ssd_kernel_refuses_too_much_shared_memory(dev):
    x = torch.zeros((2, 256, 64), device=dev)
    bc = torch.zeros((1, 256, 256), device=dev)
    with pytest.raises(ValueError, match="shared memory"):
        ssd_cuda(x, torch.zeros((2, 256), device=dev), bc, bc, 2, 128)


@pytest.mark.parametrize("B,Sq,Sk,H,KH,D", [
    (2, 128, 1000, 4, 4, 64), (2, 1, 1000, 4, 4, 64), (1, 130, 77, 4, 2, 64),
    (2, 1, 16, 4, 4, 16), (1, 300, 1024, 16, 16, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_cross_shapes(dev, B, Sq, Sk, H, KH, D, dtype):
    """Non-causal attention of Sq query rows over Sk key rows, Sq != Sk,
    as cross-attention calls it (one query row in decode): the key tail
    past Sk is masked in the last tile.  Against the plain version and, in
    bf16, the float32 oracle."""
    g = torch.Generator(device=dev).manual_seed(Sq + Sk + D)
    q = (torch.randn((B, Sq, H, D), generator=g, device=dev) * 2.0).to(dtype)
    k, v = ((torch.randn((B, Sk, KH, D), generator=g, device=dev) * sc)
            .to(dtype) for sc in (2.0, 1.0))
    before = LAUNCHES["flash_attention"]
    got = flash_attention_cuda(q, k, v, False)
    assert LAUNCHES["flash_attention"] == before + 1
    _close(got, flash_attention_plain(q, k, v, False),
           2e-2 if dtype == torch.bfloat16 else 2e-5)
    if dtype == torch.bfloat16:
        want = flash_attention_plain(q.float(), k.float(), v.float(), False)
        torch.testing.assert_close(got.float(), want, rtol=1e-2,
                                   atol=1e-3 * float(want.abs().max()))


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


# ------------------------------------------------ the decoder family
# reduced configurations with a head dim the attention kernel takes (the
# reduced qwen2-vl-2b's 24 is not a multiple of 16: refused, below)
DECODER_CARD = {
    "qwen2-0.5b": {},
    "qwen3-14b": {},
    "qwen2-vl-2b": {"d_head": 32, "mrope_sections": (4, 6, 6)},
    "deepseek-moe-16b": {},
    "phi3.5-moe-42b-a6.6b": {},
}


@pytest.mark.parametrize("arch", sorted(DECODER_CARD))
def test_decoder_cuda_route_serves_what_torch_serves(dev, arch):
    """A reduced decoder model (float32) behind Server across a publish:
    the cuda route gives the torch route's ids and versions, its logits
    teacher-forced within 1e-3 * scale of the torch route's, and each
    prefill launches flash_attention once a layer."""
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.launch.serve import prompt_batch
    cfg = get_reduced(arch).replace(compute_dtype=torch.float32,
                                    **DECODER_CARD[arch])
    model = build(cfg)
    g = torch.Generator(device=dev).manual_seed(0)
    versions = [model.init(g) for _ in range(2)]
    for p in versions:              # bias and norms off their init values
        for blk in (p["blocks"]["attn"], p["blocks"]):
            for k in ("bq", "bk", "bv", "q_norm", "k_norm", "ln1", "ln2"):
                if k in blk:
                    blk[k].add_(0.3 * torch.randn(blk[k].shape,
                                                  generator=g, device=dev))
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
    assert t_l["flash_attention"] == 0
    assert c_l["flash_attention"] == 2 * cfg.n_layers
    assert c_l["ssd_scan"] == 0
    assert c_stats == t_stats and c_stats.versions_served == [0, 1]
    for i, (a, b) in enumerate(zip(c_out, t_out)):
        assert a["weight_version"] == b["weight_version"]
        np.testing.assert_array_equal(a["generated"], b["generated"])
        toks = torch.as_tensor(prompts[i], device=dev)
        forced = torch.as_tensor(a["generated"], device=dev)
        lg = []
        for route in ("cuda", "torch"):
            m = build(cfg, kernels=route)
            logits, cache = m.prefill(versions[i], prompt_batch(cfg, toks),
                                      toks.shape[1] + 4)
            steps = [logits]
            for j in range(3):
                logits, cache = m.decode(versions[i], cache,
                                         {"token": forced[:, j:j + 1]})
                steps.append(logits)
            lg.append(torch.cat(steps, dim=1))
        scale = max(float(lg[1].abs().max()), 1.0)
        assert float((lg[0] - lg[1]).abs().max()) <= 1e-3 * scale


def test_reduced_vlm_head_dim_is_refused_on_cuda(dev):
    """The reduced qwen2-vl-2b's head dim of 24 is refused by the kernel
    on the cuda route (no fallback); the torch route serves it."""
    cfg = get_reduced("qwen2-vl-2b")
    assert cfg.head_dim == 24
    params = build(cfg).init(torch.Generator(device=dev).manual_seed(0))
    toks = np.zeros((2, 16), np.int32)
    before = LAUNCHES["flash_attention"]
    with pytest.raises(ValueError, match="head dim 24"):
        Server(cfg, params, batch_size=2, kernels="cuda",
               device=dev).serve_batch(toks, max_new_tokens=2)
    assert LAUNCHES["flash_attention"] == before
    out = Server(cfg, params, batch_size=2, kernels="torch",
                 device=dev).serve_batch(toks, max_new_tokens=2)
    assert out["generated"].shape == (2, 2)


@pytest.mark.parametrize("cf", [1.25, 0.25])
def test_moe_ffn_runs_without_host_waits(dev, cf):
    """moe_ffn (routing, stable sort, capacity drops through the scratch
    row, combine) runs under sync debug mode "error" on the card, and
    equals its run on the CPU."""
    from repro_torch.models.layers import moe_ffn
    cfg = get_reduced("deepseek-moe-16b").replace(
        compute_dtype=torch.float32, capacity_factor=cf)
    params = build(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    lp = {k: v[0] for k, v in params["blocks"]["moe"].items()
          if not isinstance(v, dict)}
    lp["shared"] = {k: v[0] for k, v in
                    params["blocks"]["moe"]["shared"].items()}
    x = torch.randn((3, 64, cfg.d_model), generator=torch.Generator()
                    .manual_seed(1))
    want, want_aux = moe_ffn(lp, x, cfg)
    lp_d = {k: v.to(dev) if torch.is_tensor(v) else
            {kk: vv.to(dev) for kk, vv in v.items()} for k, v in lp.items()}
    x_d = x.to(dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got, aux = moe_ffn(lp_d, x_d, cfg)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert float((got.cpu() - want).abs().max()) <= 1e-4 * max(
        float(want.abs().max()), 1.0)
    assert abs(float(aux) - float(want_aux)) <= 1e-5


# ------------------------------------ the SSM and encoder-decoder families
@pytest.mark.parametrize("fp32", [True, False], ids=["fp32", "bf16"])
@pytest.mark.parametrize("arch", ["mamba2-130m", "seamless-m4t-large-v2"])
def test_ssm_and_encdec_cuda_route_serves_what_torch_serves(dev, arch, fp32):
    """A reduced SSM or encoder-decoder model behind Server across a
    publish, on the cuda and the torch route: one version a batch, the
    launches of the cuda route (ssd_scan once a layer a prefill; attention
    once an encoder layer and twice a decoder layer a prefill, once a
    decoder layer a decode step) and none on torch; the logits,
    teacher-forced with the cuda route's tokens, within 1e-3 * scale in
    float32 (where the generated ids are equal too) and 0.06 * scale in
    bf16.  Prompts of 64 and 37 tokens (ragged against the chunk), 40 and
    27 encoder frames."""
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.launch.serve import prompt_batch
    cfg = get_reduced(arch)
    if fp32:
        cfg = cfg.replace(compute_dtype=torch.float32)
    g = torch.Generator(device=dev).manual_seed(0)
    versions = [build(cfg).init(g) for _ in range(2)]
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size, (2, S)).astype(np.int32)
               for S in (64, 37)]
    enc = [None, None]
    if cfg.family == "encdec":
        enc = [(rng.randn(2, S, cfg.d_model) * 0.05).astype(np.float32)
               for S in (40, 27)]
    new = 4
    served = {}
    for route in ("torch", "cuda"):
        srv = Server(cfg, versions[0], batch_size=2, kernels=route,
                     device=dev)
        before = dict(LAUNCHES)
        out = []
        for i, toks in enumerate(prompts):
            if i == 1:
                assert srv.publish(versions[1])
            out.append(srv.serve_batch(toks, max_new_tokens=new,
                                       enc_embeds=enc[i]))
        launched = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
        served[route] = (out, srv.stats, launched)
    (t_out, t_stats, t_l), (c_out, c_stats, c_l) = served["torch"], \
        served["cuda"]
    assert t_l["flash_attention"] == t_l["ssd_scan"] == 0
    if cfg.family == "ssm":
        want = {"ssd_scan": 2 * cfg.n_layers, "flash_attention": 0}
    else:
        want = {"ssd_scan": 0, "flash_attention": 2 * (
            cfg.n_enc_layers + 2 * cfg.n_layers
            + (new - 1) * cfg.n_layers)}
    assert {k: c_l[k] for k in want} == want
    assert c_stats == t_stats and c_stats.versions_served == [0, 1]
    for i, (a, b) in enumerate(zip(c_out, t_out)):
        assert a["weight_version"] == b["weight_version"] == i
        if fp32:
            np.testing.assert_array_equal(a["generated"], b["generated"])
        batch = prompt_batch(cfg, torch.as_tensor(prompts[i], device=dev),
                             enc[i])
        forced = torch.as_tensor(a["generated"], device=dev)
        lg = [CS.forced_logits(torch, build(cfg, kernels=route), versions[i],
                               batch, forced, prompts[i].shape[1] + new)
              for route in ("cuda", "torch")]
        scale = max(float(lg[1].abs().max()), 1.0)
        assert float((lg[0] - lg[1]).abs().max()) <= (
            1e-3 if fp32 else 0.06) * scale


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


# ----------------------------------------------------------------- training
@pytest.mark.parametrize("B,Sq,Sk,H,KH,D,causal", [
    (2, 1024, 1024, 14, 2, 64, True), (2, 1000, 1000, 4, 4, 64, True),
    (1, 256, 256, 7, 1, 128, True), (2, 128, 1000, 16, 16, 64, False),
    (2, 1, 300, 4, 2, 32, False), (1, 70, 70, 3, 1, 48, True),
    (1, 100, 100, 4, 2, 80, False)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_backward_kernels_vs_plain(dev, B, Sq, Sk, H, KH, D,
                                                   causal, dtype):
    """dq, dk and dv of the two backward kernels against
    ``flash_attention_bwd_plain`` on the forward kernel's o and lse (lse
    also against the plain version's): float32 within 1e-4 relative plus
    1e-5 of the largest |want|; bf16 within one bf16 rounding (rtol 1e-2)
    plus 1e-3 of it.  One launch of each kernel a call."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd_cuda, flash_attention_bwd_plain)
    g = torch.Generator(device=dev).manual_seed(Sq + Sk + D)
    rn = lambda s, sc: (torch.randn(s, generator=g, device=dev) * sc).to(
        dtype)
    q, do = rn((B, Sq, H, D), 2.0), rn((B, Sq, H, D), 1.0)
    k, v = rn((B, Sk, KH, D), 2.0), rn((B, Sk, KH, D), 1.0)
    o, lse = flash_attention_cuda(q, k, v, causal, with_lse=True)
    _, lse_p = flash_attention_plain(q, k, v, causal, with_lse=True)
    torch.testing.assert_close(lse, lse_p, rtol=1e-5, atol=1e-4)
    before = dict(LAUNCHES)
    got = flash_attention_bwd_cuda(q, k, v, o, lse, do, causal)
    torch.cuda.synchronize()
    assert {k_: LAUNCHES[k_] - before[k_] for k_ in LAUNCHES} == {
        **dict.fromkeys(LAUNCHES, 0), "flash_attention_bwd_dq": 1,
        "flash_attention_bwd_dkdv": 1}
    bf16 = dtype == torch.bfloat16
    for a, w in zip(got, flash_attention_bwd_plain(q, k, v, o, lse, do,
                                                   causal)):
        assert a.dtype == dtype and a.shape == w.shape
        torch.testing.assert_close(
            a.float(), w.float(), rtol=1e-2 if bf16 else 1e-4,
            atol=(1e-3 if bf16 else 1e-5) * float(w.float().abs().max()))


def _bwd_inputs(dev, B, Sq, Sk, H, KH, D, dtype, causal, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    rn = lambda s, sc: (torch.randn(s, generator=g, device=dev) * sc).to(
        dtype)
    q, do = rn((B, Sq, H, D), 2.0), rn((B, Sq, H, D), 1.0)
    k, v = rn((B, Sk, KH, D), 2.0), rn((B, Sk, KH, D), 1.0)
    o, lse = flash_attention_cuda(q, k, v, causal, with_lse=True)
    return q, k, v, o, lse, do


@pytest.mark.parametrize("B,S,H,KH,D", [
    (4, 1024, 14, 2, 64), (2, 512, 4, 4, 64), (2, 200, 3, 1, 64),
    (1, 256, 7, 1, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_backward_is_deterministic(dev, B, S, H, KH, D,
                                                   dtype):
    """Two calls of the backward kernels on the same inputs give the same
    bits: at qwen2-0.5b's training shape and at G = 1, 3 and 7 (bf16 at
    D = 64 and 128: the Hopper kernels, whose dk/dv sums meet in a fixed
    order across four consumer groups)."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd_cuda
    args = _bwd_inputs(dev, B, S, S, H, KH, D, dtype, True, S + H)
    first = flash_attention_bwd_cuda(*args, True)
    for _ in range(2):
        again = flash_attention_bwd_cuda(*args, True)
        for a, b in zip(first, again):
            assert torch.equal(a, b)


@pytest.mark.parametrize("B,Sq,Sk,H,KH,D,causal", [
    (2, 200, 200, 3, 1, 64, True), (1, 70, 70, 3, 1, 64, True),
    (2, 512, 512, 7, 1, 128, True), (1, 300, 300, 7, 1, 128, False),
    (1, 200, 512, 4, 2, 64, True), (1, 200, 512, 14, 2, 128, True)])
def test_flash_attention_backward_hopper_split_cases(dev, B, Sq, Sk, H, KH,
                                                     D, causal):
    """The bf16 Hopper kernels where their split shows: an odd count of
    (query head, q tile) pairs a kv tile (G = 3, ragged Sq), D = 128 at
    G = 7, and causal with Sk > Sq, where the kv rows no query reaches
    must get zero dk and dv.  Against ``flash_attention_bwd_plain`` at the
    bf16 tolerance of ``test_flash_attention_backward_kernels_vs_plain``;
    one launch of each kernel a call."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd_cuda, flash_attention_bwd_plain)
    args = _bwd_inputs(dev, B, Sq, Sk, H, KH, D, torch.bfloat16, causal,
                       Sq + Sk + H)
    before = dict(LAUNCHES)
    got = flash_attention_bwd_cuda(*args, causal)
    torch.cuda.synchronize()
    assert {k_: LAUNCHES[k_] - before[k_] for k_ in LAUNCHES} == {
        **dict.fromkeys(LAUNCHES, 0), "flash_attention_bwd_dq": 1,
        "flash_attention_bwd_dkdv": 1}
    if causal and Sk > Sq:
        for t in got[1:]:
            assert not bool(t[:, Sq:].any())
    for a, w in zip(got, flash_attention_bwd_plain(*args, causal)):
        assert a.dtype == torch.bfloat16 and a.shape == w.shape
        torch.testing.assert_close(
            a.float(), w.float(), rtol=1e-2,
            atol=1e-3 * float(w.float().abs().max()))


@pytest.mark.parametrize("causal", [True, False])
def test_attention_gradient_goes_through_the_kernels(dev, causal):
    """``ops.flash_attention`` on the kernel route under a gradient:
    ``FlashAttentionFn``, one forward launch (with lse) and one of each
    backward kernel; float32 gradients within 1e-4 of scale of autograd's
    through the plain version."""
    from repro_torch.kernels import ops
    g = torch.Generator(device=dev).manual_seed(3)
    shapes = ((2, 200, 4, 32), (2, 200 if causal else 300, 2, 32),
              (2, 200 if causal else 300, 2, 32))
    base = [torch.randn(s, generator=g, device=dev) for s in shapes]
    do = torch.randn((2, 200, 4, 32), generator=g, device=dev)
    grads = []
    for use_kernel in (True, False):
        leaves = [t.clone().requires_grad_(True) for t in base]
        before = dict(LAUNCHES)
        o = ops.flash_attention(*leaves, causal=causal,
                                use_kernel=use_kernel)
        grads.append(torch.autograd.grad(o, leaves, do))
        torch.cuda.synchronize()
        n = int(use_kernel)
        assert {k: LAUNCHES[k] - before[k] for k in (
            "flash_attention", "flash_attention_bwd_dq",
            "flash_attention_bwd_dkdv")} == dict.fromkeys(
            ("flash_attention", "flash_attention_bwd_dq",
             "flash_attention_bwd_dkdv"), n)
    for a, b in zip(*grads):
        _close(a, b, 1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("model", [False, True])
def test_ssd_kernel_route_refuses_a_gradient_on_the_card(dev, dtype, model):
    """(Named for the refusal it replaced.)  ``ops.ssd`` on the kernel
    route under a gradient trains on the card: ``SsdScanFn`` launches
    ``ssd_scan`` once and each backward kernel once a call (in bf16, at
    three chunks, the states and the scan as one launch,
    ``ssd_scan_bwd_states_scan``); its gradients
    (x, dA, B, C, h0, with the final state's gradient) are those of
    autograd through the plain scan on the same inputs: float32 within
    1e-3 of scale, bf16 within one bf16 rounding plus 1e-3 of scale of the
    float32 plain gradient on the same bf16 inputs."""
    from repro_torch.kernels import ops
    g = torch.Generator(device=dev).manual_seed(5)
    Bg, H, S, P, N, Q = 2, 3, 300, 64, 64, 128
    x = torch.randn((Bg, S, H, P), generator=g, device=dev).to(dtype) * 0.5
    dA = -torch.rand((Bg, S, H), generator=g, device=dev)
    bc = (torch.randn((Bg, S, 3 * N), generator=g, device=dev) * 0.3).to(
        dtype)
    h0 = torch.randn((Bg * H, N, P), generator=g, device=dev) * 0.2
    dy = torch.randn((Bg, S, H, P), generator=g, device=dev).to(dtype)
    dh = torch.randn((Bg * H, N, P), generator=g, device=dev) * 0.2
    if model:
        x, dA, dy = x.transpose(1, 2), dA.transpose(1, 2), dy.transpose(1, 2)
    else:
        x, dA, dy = (t.transpose(1, 2).reshape(Bg * H, S, *t.shape[3:])
                     .contiguous() for t in (x, dA, dy))
    Bm, Cm = bc[..., N:2 * N], bc[..., 2 * N:]   # row-strided, as xBC's

    def grads(use_kernel, cast):
        leaves = [cast(t).detach().requires_grad_(True)
                  for t in (x, dA, Bm, Cm, h0)]
        y, h = ops.ssd(*leaves[:4], n_heads_per_group=H, chunk=Q,
                       h0=leaves[4], use_kernel=use_kernel)
        if use_kernel:
            assert type(y.grad_fn).__name__ == "SsdScanFnBackward"
        return torch.autograd.grad((y.float() * cast(dy).float()).sum()
                                   + (h * dh).sum(), leaves)

    pair = ("ssd_scan_bwd_states", "ssd_scan_bwd_scan")
    fused = dtype == torch.bfloat16
    want = {"ssd_scan": 1, **dict.fromkeys(pair, 0 if fused else 1),
            "ssd_scan_bwd_states_scan": int(fused), "ssd_scan_bwd_grads": 1}
    before = dict(LAUNCHES)
    got = grads(True, lambda t: t)
    torch.cuda.synchronize()
    assert {k: LAUNCHES[k] - before[k] for k in want} == want
    want = grads(False, lambda t: t.float())
    for a, w, like in zip(got, want, (x, dA, Bm, Cm, h0)):
        assert a.shape == like.shape and a.dtype == like.dtype
        scale = float(w.abs().max())
        rtol = 1e-2 if a.dtype == torch.bfloat16 else 0.0
        err = (a.float() - w).abs() - rtol * w.abs()
        assert float(err.max()) <= 1e-3 * scale


@pytest.mark.parametrize("case", CS.SSD_BWD_CASES)
def test_ssd_backward_kernels_vs_plain(dev, case):
    """``chip_smoke.py``'s phase-3 check of one SSD backward case: each
    kernel against its plain version, bf16 also the chain against the
    float32 oracle, each kernel's two calls bit-equal (raises otherwise);
    where the fused states and scan kernel takes the case, it too."""
    from repro_torch.kernels import ssd_scan as ss
    g = torch.Generator(device=dev).manual_seed(6)

    def rn(shape, scale, dtype):
        return (torch.randn(shape, generator=g, device=dev)
                * scale).to(dtype)
    errs = {name: [] for name in CS.SSD_BWD_KERNELS}
    fused = CS.ssd_bwd_check(torch, dev, rn, g, case, errs, {})
    Bg, H, S, P, N, Q, dt = case[:7]
    assert fused == ss.ssd_bwd_fused(
        P, N, min(Q, S), S,
        torch.bfloat16 if dt == "bf16" else torch.float32)
    assert all(len(v) for n, v in errs.items()
               if fused or n != CS.SSD_BWD_FUSED)


# (Bg, H, S, P, N, chunk, dtype, h0, dh_final, decay, model layout) where
# the bf16 Hopper forms split their work: both training shapes; a ragged
# tail at H = 5 (a cluster of four blocks taking 2, 1, 1, 1 heads); one
# chunk of S < 128 at N = 128 and H = 3 (three one-head blocks); H = 10
# (slices of 2 and 3 heads) over three chunks
SSD_BWD_HOPPER_CASES = (
    (4, 80, 1024, 64, 64, 128, "bf16", False, False, 1.4, True),
    (4, 24, 1024, 64, 128, 128, "bf16", False, False, 0.01, True),
    (1, 5, 1000, 64, 128, 128, "bf16", True, True, 1.4, False),
    (2, 3, 100, 64, 128, 128, "bf16", True, False, 0.01, True),
    (3, 10, 300, 64, 64, 128, "bf16", False, True, 0.3, True))


@pytest.mark.parametrize("case", SSD_BWD_HOPPER_CASES)
def test_ssd_backward_hopper_split_cases(dev, case):
    """The states and grads kernels on their Hopper forms: against the
    plain stages (``chip_smoke.ssd_bwd_check``: two calls bit-equal), and
    against the mma.sync forms on the same inputs (float32 outputs within
    1e-3 of scale, bf16 within 2e-2); the grads kernel's Hopper form
    allocates no float32 scratch of the heads' rows (its peak memory stays
    under that scratch's size, which the mma.sync form takes)."""
    from repro_torch.kernels import ssd_scan as ss
    Bg, H, S, P, N, Q = case[:6]
    assert ss.ssd_bwd_kernel(P, N, min(Q, S), S, torch.bfloat16) == "wgmma"
    g = torch.Generator(device=dev).manual_seed(8)

    def rn(shape, scale, dtype):
        return (torch.randn(shape, generator=g, device=dev)
                * scale).to(dtype)
    errs = {name: [] for name in CS.SSD_BWD_KERNELS}
    CS.ssd_bwd_check(torch, dev, rn, g, case, errs, {})
    x, dA, Bm, Cm, dy, h0, dh = CS.ssd_bwd_inputs(torch, dev, rn, g, case)

    def near(got, want, tols):
        for a, w, t in zip(got, want, tols):
            scale = float(w.float().abs().max())
            assert float((a.float() - w.float()).abs().max()) <= t * scale
    st = ss.ssd_bwd_states_cuda(x, dA, Bm, Cm, dy, H, Q)
    near(st, ss.ssd_bwd_states_cuda(x, dA, Bm, Cm, dy, H, Q, kernel="mma"),
         (1e-3,) * 3)
    hp, G, _, sc = ss.ssd_bwd_scan_cuda(st[0].clone(), st[1].clone(), st[2],
                                        h0, dh)
    args = (x, dA, Bm, Cm, dy, hp, G, sc, H, Q)
    scratch = 2 * Bg * H * S * N * 4
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    got = ss.ssd_bwd_grads_cuda(*args)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - base < scratch
    near(got, ss.ssd_bwd_grads_cuda(*args, kernel="mma"),
         (2e-2, 1e-3, 2e-2, 2e-2))


# (Bg, H, S, P, N, chunk, dtype, h0, dh_final, decay, model layout) the
# fused states and scan kernel takes (bf16 at P = 64, N = 64 and 128, at
# most 8 chunks of 128 rows): both training shapes, clusters of 8 at a
# ragged S with h0 and dh, of 3 and 5 blocks, of one block (S < 128, S = 1)
SSD_BWD_FUSED_CASES = (
    (4, 80, 1024, 64, 64, 128, "bf16", False, False, 1.4, True),
    (4, 24, 1024, 64, 128, 128, "bf16", False, False, 0.01, True),
    (1, 5, 1000, 64, 128, 128, "bf16", True, True, 1.4, False),
    (2, 3, 300, 64, 64, 128, "bf16", True, False, 0.3, True),
    (3, 2, 640, 64, 128, 128, "bf16", False, True, 0.01, False),
    (2, 3, 100, 64, 64, 128, "bf16", True, True, 0.01, True),
    (2, 3, 1, 64, 128, 128, "bf16", True, True, 0.8, False))


@pytest.mark.parametrize("case", SSD_BWD_FUSED_CASES)
def test_ssd_backward_fused_states_scan(dev, case):
    """The fused states and scan kernel (``ssd_bwd_states_scan_cuda``):
    against the plain states and scan, against the states and scan kernels
    on the card (hprev, G and dh0 bit-equal, sc within
    ``chip_smoke.SSD_SC_ORDER_TOL``), two calls bit-equal
    (``chip_smoke.ssd_bwd_check``); ``ssd_bwd_cuda`` launches it once and
    the grads kernel once, neither the states nor the scan kernel, and
    its clusters fit on the card."""
    from repro_torch.kernels import ssd_scan as ss
    Bg, H, S, P, N, Q = case[:6]
    assert ss.ssd_bwd_fused(P, N, min(Q, S), S, torch.bfloat16)
    g = torch.Generator(device=dev).manual_seed(9)

    def rn(shape, scale, dtype):
        return (torch.randn(shape, generator=g, device=dev)
                * scale).to(dtype)
    errs = {name: [] for name in CS.SSD_BWD_KERNELS}
    assert CS.ssd_bwd_check(torch, dev, rn, g, case, errs, {})
    assert errs[CS.SSD_BWD_FUSED]
    x, dA, Bm, Cm, dy, h0, dh = CS.ssd_bwd_inputs(torch, dev, rn, g, case)
    keys = ("ssd_scan_bwd_states", "ssd_scan_bwd_scan",
            "ssd_scan_bwd_states_scan", "ssd_scan_bwd_grads")
    before = dict(LAUNCHES)
    ss.ssd_bwd_cuda(x, dA, Bm, Cm, dy, H, Q, h0, dh)
    torch.cuda.synchronize()
    assert [LAUNCHES[k] - before[k] for k in keys] == [0, 0, 1, 1]
    assert ss.ssd_bwd_states_scan_clusters(N, -(-S // Q)) >= 1


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "deepseek-moe-16b",
                                  "seamless-m4t-large-v2", "mamba2-130m",
                                  "zamba2-2.7b"])
def test_train_step_cuda_route_equals_torch_route(dev, arch):
    """One float32 loss and gradient of the reduced model on ``cuda``
    against ``torch`` on the same weights and batch: the loss within 1e-4
    of its size, every gradient leaf within 1e-3 of its scale; the
    attention and SSD launches of ``chip_smoke.train_launches`` (remat
    runs each forward twice, each backward kernel once)."""
    import pathlib
    import sys
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke
    from repro_torch.data import TokenStream
    from repro_torch.launch.train import loss_and_grads
    from repro_torch.models.module import tree_leaves
    cfg = get_reduced(arch).replace(compute_dtype=torch.float32)
    params = build(cfg).init(torch.Generator(device=dev).manual_seed(0), dev)
    batch = TokenStream(cfg, 2, 48, seed=1, device=dev).next()
    out = []
    for route in ("cuda", "torch"):
        before = dict(LAUNCHES)
        out.append(loss_and_grads(build(cfg, route), params, batch))
        torch.cuda.synchronize()
        want = chip_smoke.train_launches(cfg) if route == "cuda" else \
            dict.fromkeys(chip_smoke.train_launches(cfg), 0)
        assert {k: LAUNCHES[k] - before[k] for k in want} == want
    (l1, _, g1), (l2, _, g2) = out
    assert abs(float(l1) - float(l2)) <= 1e-4 * abs(float(l2))
    assert len(tree_leaves(g1)) == len(tree_leaves(params))
    for a, b in zip(tree_leaves(g1), tree_leaves(g2)):
        assert float((a - b).abs().max()) <= 1e-3 * float(b.abs().max())
