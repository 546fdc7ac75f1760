"""The SSD backward's states and scan as one launch, on the CPU
(``ssd_scan_bwd_states_scan_wgmma_kernel``: bf16 at P = 64, N = 64 or
128, chunks of 128 rows, at most 8 of them; ``ssd_bwd_fused`` is the
route table).

The kernel takes a batch*head's nc chunks as a cluster of nc blocks.
Block c computes st_c and U_c as the states kernel does and keeps them in
its shared memory; then block r owns float2s [r F / nc, (r + 1) F / nc)
of the F = N P / 2 of a state, reads that slice of every block's st_c and
U_c, and runs both recurrences over it (h_c = exp(a_L) h_{c-1} + st_c from
h0; G_{c-1} = U_c + exp(a_L) G_c from dh), writing hprev, G and dh0 for
its slice; sc_c = exp(a_L_c) <h_{c-1}, G_c> is each block's partial sum
over its slice, added by block c over the ranks in order.
``_scan_decomposed`` writes that split out in torch; it is held to the
plain scan (``ssd_bwd_scan_plain``): hprev, G and dh0 bit for bit (the
same elementwise expressions), sc within float32 rounding, at clusters of
1, 3 and 8 blocks, ragged S, with and without h0 and dh; chained through
the plain grads stage, to ``jax.vjp`` of the reference's
``models/ssm.py`` ``ssd_chunked``.  Also: the route table and
``ssd_bwd_cuda``'s choice by it, the kernel's shared memory (two blocks
an SM; st and U parked exactly over B's and C's tiles), the wrapper's
refusals, ``chip_smoke.py``'s cases on both routes, its launch counts of
a training step and its names of the kernel.

Inputs are seeded numpy in float32.  The kernel itself runs only on the
card (``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 3).
"""
import pathlib

import pytest
import torch

from repro_torch.kernels import ssd_scan as ss
from repro_torch.kernels.build import LAUNCHES
from test_torch_ssd_bwd_hopper import _close, _inputs, _jax_grads

ROOT = pathlib.Path(__file__).resolve().parents[1]
Q, P = 128, 64
# sc against the plain scan: the same products summed in another order,
# each sum within far fewer than 80 roundings of 2^-24 of exp(a_L)
# sum |h||G| (8,192 products at most, summed pairwise)
SC_TOL = 1e-5


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Small eager ops: on one intra-op thread they do not stall when the
    other test workers load every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def chip_smoke(monkeypatch):
    monkeypatch.syspath_prepend(str(ROOT))
    import chip_smoke
    return chip_smoke


def _slices(F, nc):
    """The float2s [r F / nc, (r + 1) F / nc) block r of a cluster of nc
    owns, as element ranges of the flattened state."""
    return [(2 * (r * F // nc), 2 * ((r + 1) * F // nc)) for r in range(nc)]


def _scan_decomposed(st, U, aL, h0, dh):
    """The fused kernel's scans over its cluster: each rank's slice of the
    state through both recurrences, sc from the ranks' partials in rank
    order.  st, U [BH, nc, N, P], aL [BH, nc]; returns (hprev, G, dh0,
    sc) as ``ssd_bwd_scan_plain``."""
    BH, nc, N, P_ = st.shape
    flat = lambda t: t.reshape(BH, nc, N * P_)
    st, U = flat(st), flat(U)
    d = torch.exp(aL)[..., None]
    hprev, G = torch.empty_like(st), torch.empty_like(st)
    dh0 = torch.empty(BH, N * P_)
    partial = []
    for lo, hi in _slices(N * P_ // 2, nc):     # block r's slice
        h = (torch.zeros(BH, hi - lo) if h0 is None
             else h0.reshape(BH, -1)[:, lo:hi])
        for c in range(nc):
            hprev[:, c, lo:hi] = h
            h = d[:, c] * h + st[:, c, lo:hi]
        g = (torch.zeros(BH, hi - lo) if dh is None
             else dh.reshape(BH, -1)[:, lo:hi])
        for c in reversed(range(nc)):
            G[:, c, lo:hi] = g
            g = U[:, c, lo:hi] + d[:, c] * g
        dh0[:, lo:hi] = g
        partial.append((hprev[..., lo:hi] * G[..., lo:hi]).sum(-1))
    total = partial[0]
    for p in partial[1:]:                       # rank order
        total = total + p
    back = lambda t: t.reshape(BH, nc, N, P_)
    return (back(hprev), back(G), dh0.reshape(BH, N, P_),
            torch.exp(aL) * total)


def test_slices_cover_the_state_once():
    """The ranks' slices partition a state's float2s in order, differing
    by at most one float2, each at least one a thread of the block's 256,
    at every cluster size and both N."""
    for N in (64, 128):
        F = N * P // 2
        for nc in range(1, ss.SSD_BWD_FUSED_CHUNKS + 1):
            s = _slices(F, nc)
            assert s[0][0] == 0 and s[-1][1] == 2 * F
            assert all(a[1] == b[0] for a, b in zip(s, s[1:]))
            sizes = [hi - lo for lo, hi in s]
            assert min(sizes) >= 2 * 256 and max(sizes) - min(sizes) <= 2


# (G, H, S, N, decay, h0, dh_final): clusters of 1 (S = 100 and 1), 3
# (S = 300) and 8 (S = 1,024; S = 1,000 ragged) blocks, both N
CASES = [(1, 2, 100, 64, 0.01, False, False),
         (2, 1, 1, 128, 1.4, True, True),
         (1, 2, 300, 128, 1.4, True, False),
         (1, 2, 1024, 64, 0.3, False, True),
         (1, 3, 1000, 64, 1.4, True, True),
         (1, 1, 1000, 128, 0.01, False, False)]


@pytest.mark.parametrize("G,H,S,N,decay,with_h0,with_dh", CASES)
def test_decomposition_matches_the_plain_scan(G, H, S, N, decay, with_h0,
                                              with_dh):
    """The fused kernel's split against the plain scan on the plain
    states: hprev, G, dh0 equal to the bit, sc within float32 rounding;
    ``ssd_bwd_states_scan_plain`` is the two plain stages chained."""
    x, dA, Bm, Cm, dy, h0, dh = _inputs(S + 5 * H, G, H, S, N, decay,
                                        with_h0, with_dh)
    Qc = min(Q, S)
    st, U, aL = ss.ssd_bwd_states_plain(x, dA, Bm, Cm, dy, H, Qc)
    assert st.shape[1] == -(-S // Q) <= ss.SSD_BWD_FUSED_CHUNKS
    want = ss.ssd_bwd_scan_plain(st, U, aL, h0, dh)
    got = _scan_decomposed(st, U, aL, h0, dh)
    for name, a, w in zip(("hprev", "G", "dh0"), got, want):
        assert torch.equal(a, w), name
    mag = torch.exp(aL) * (want[0].abs() * want[1].abs()).sum((-1, -2))
    assert bool(((got[3] - want[3]).abs() <= SC_TOL * mag).all())
    chained = ss.ssd_bwd_states_scan_plain(x, dA, Bm, Cm, dy, H, Qc, h0, dh)
    for a, w in zip(chained, want):
        assert torch.equal(a, w)


def test_decomposition_chained_matches_jax_vjp_of_ssd_chunked():
    """The split, on the plain states and chained through the plain grads
    stage, against jax.vjp of the reference's ssd_chunked: a ragged S of 8
    chunks with h0 and the final state's gradient."""
    G, H, S, N = 1, 3, 1000, 64
    x, dA, Bm, Cm, dy, h0, dh = _inputs(17, G, H, S, N, 1.4, True, True)
    st, U, aL = ss.ssd_bwd_states_plain(x, dA, Bm, Cm, dy, H, Q)
    hp, Gs, dh0, sc = _scan_decomposed(st, U, aL, h0, dh)
    got = (*ss.ssd_bwd_grads_plain(x, dA, Bm, Cm, dy, hp, Gs, sc, H, Q),
           dh0)
    want = _jax_grads(x, dA, Bm, Cm, dy, h0, dh)
    for name, a, w in zip(("dx", "ddA", "dB", "dC", "dh0"), got, want):
        _close(a, w, name)


@pytest.mark.parametrize("P_,N,Qc,S,dtype,fused", [
    (64, 64, 128, 1024, torch.bfloat16, True),       # zamba2-2.7b
    (64, 128, 128, 1024, torch.bfloat16, True),      # mamba2-130m
    (64, 64, 128, 1000, torch.bfloat16, True),       # ragged, 8 chunks
    (64, 128, 100, 100, torch.bfloat16, True),       # one chunk
    (64, 64, 1, 1, torch.bfloat16, True),            # S = 1
    (64, 64, 128, 1025, torch.bfloat16, False),      # 9 chunks
    (64, 128, 128, 2048, torch.bfloat16, False),     # 16 chunks
    (64, 64, 64, 512, torch.bfloat16, False),        # chunks of 64
    (32, 64, 128, 1024, torch.bfloat16, False),      # the mma.sync form
    (64, 64, 128, 1024, torch.float32, False)])      # the FMA form
def test_route_table(P_, N, Qc, S, dtype, fused):
    """Fused where the Hopper forms run with at most 8 chunks; two
    launches everywhere else."""
    assert ss.ssd_bwd_fused(P_, N, Qc, S, dtype) is fused
    if fused:
        assert ss.ssd_bwd_kernel(P_, N, Qc, S, dtype) == "wgmma"


@pytest.mark.parametrize("S,dtype,fused", [(1024, torch.bfloat16, True),
                                           (2048, torch.bfloat16, False),
                                           (1024, torch.float32, False)])
def test_ssd_bwd_cuda_follows_the_table(monkeypatch, S, dtype, fused):
    """``ssd_bwd_cuda`` calls the fused wrapper where the table says so
    and the states and scan wrappers otherwise, never both (no fallback);
    the grads wrapper always, on what the first stage returned."""
    called = []

    def stub(name, ret):
        def fn(*a, **k):
            called.append(name)
            return ret
        return fn
    st = torch.zeros(1)
    monkeypatch.setattr(ss, "ssd_bwd_states_scan_cuda",
                        stub("states_scan", (st, st, st, st)))
    monkeypatch.setattr(ss, "ssd_bwd_states_cuda",
                        stub("states", (st, st, st)))
    monkeypatch.setattr(ss, "ssd_bwd_scan_cuda", stub("scan", (st,) * 4))
    monkeypatch.setattr(ss, "ssd_bwd_grads_cuda", stub("grads", (st,) * 4))
    x = torch.zeros((2, S, P), dtype=dtype)
    bc = torch.zeros((1, S, 64), dtype=dtype)
    out = ss.ssd_bwd_cuda(x, torch.zeros((2, S)), bc, bc, x, 2, Q)
    assert len(out) == 5
    assert called == (["states_scan", "grads"] if fused
                      else ["states", "scan", "grads"])


def test_fused_kernel_shared_memory():
    """The states kernel's tiles and arrays plus sc's barrier and sums and
    a_L:
    still two blocks an SM at both N; st and U, float32 [N][64] each,
    parked exactly over B's and C's boxes (N / 64 boxes of 128 rows of
    64 bf16 each)."""
    bf = torch.bfloat16
    got = [ss.ssd_bwd_smem_bytes(64, n, Q, bf, "wgmma", "states_scan")
           for n in (64, 128)]
    states = [ss.ssd_bwd_smem_bytes(64, n, Q, bf, "wgmma", "states")
              for n in (64, 128)]
    assert got == [67_408, 100_176]
    assert [g - s for g, s in zip(got, states)] == [312, 312]
    assert 2 * (max(got) + 1024) <= 228 * 1024
    for n in (64, 128):
        assert n * 64 * 4 == (n // 64) * Q * 64 * 2   # a state, B's boxes


def test_wrapper_refuses_cpu_tensors_and_shapes_off_its_table():
    """No fallback: the fused wrapper refuses a shape the table sends to
    two launches, and CPU tensors, before anything launches."""
    before = dict(LAUNCHES)
    a = torch.zeros((2, 1024))
    for S, dtype, N in ((2048, torch.bfloat16, 64), (1024, torch.float32, 64),
                        (1024, torch.bfloat16, 32)):
        x = torch.zeros((2, S, P), dtype=dtype)
        bc = torch.zeros((1, S, N), dtype=dtype)
        with pytest.raises(ValueError, match="the fused kernel takes"):
            ss.ssd_bwd_states_scan_cuda(x, a, bc, bc, x, 2, Q)
    x = torch.zeros((2, 1024, P), dtype=torch.bfloat16)
    bc = torch.zeros((1, 1024, 128), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ss.ssd_bwd_states_scan_cuda(x, a, bc, bc, x, 2, Q)
    assert LAUNCHES == before


def test_chip_smoke_ssd_bwd_cases_reach_both_routes(chip_smoke):
    """Phase 3 holds the fused kernel at both training shapes, at nc = 1
    (S < 128 and S = 1) and at nc = 8 ragged with h0 and dh, and keeps a
    Hopper case of 16 chunks on the two launches."""
    nc = lambda c: -(-c[2] // min(c[5], c[2]))
    dt = lambda c: torch.bfloat16 if c[6] == "bf16" else torch.float32
    fused = [c for c in chip_smoke.SSD_BWD_CASES
             if ss.ssd_bwd_fused(c[3], c[4], min(c[5], c[2]), c[2], dt(c))]
    for N in (64, 128):
        assert any(c[2] == 1024 and c[4] == N and c[0] == 4 for c in fused)
    assert any(nc(c) == 1 and 1 < c[2] < 128 for c in fused)
    assert any(c[2] == 1 for c in fused)
    assert any(nc(c) == 8 and c[2] % 128 and c[7] and c[8] for c in fused)
    assert any(nc(c) == 16 and ss.ssd_bwd_kernel(
        c[3], c[4], c[5], c[2], dt(c)) == "wgmma"
        for c in chip_smoke.SSD_BWD_CASES if c not in fused)
    assert chip_smoke.SSD_BWD_FUSED in chip_smoke.SSD_BWD_KERNELS


def test_train_launches_route_the_fused_kernel(chip_smoke):
    """A bf16 step at S = 1,024 of mamba2-130m and of zamba2-2.7b launches
    the fused kernel once a layer and neither the states nor the scan
    kernel; its float32 step and a bf16 step past 8 chunks the two."""
    from repro_torch.configs import get_config
    for arch, layers in (("mamba2-130m", 24), ("zamba2-2.7b", 6)):
        cfg = get_config(arch).replace(n_layers=layers)
        assert cfg.compute_dtype == torch.bfloat16
        w = chip_smoke.train_launches(cfg, 1024)
        assert (w["ssd_scan_bwd_states"], w["ssd_scan_bwd_scan"],
                w["ssd_scan_bwd_states_scan"],
                w["ssd_scan_bwd_grads"]) == (0, 0, layers, layers)
        for other in (chip_smoke.train_launches(cfg.replace(
                compute_dtype=torch.float32), 1024),
                chip_smoke.train_launches(cfg, 2048)):
            assert (other["ssd_scan_bwd_states"], other["ssd_scan_bwd_scan"],
                    other["ssd_scan_bwd_states_scan"]) == (layers, layers, 0)


def test_kernel_of_names_the_fused_kernel(chip_smoke):
    """The profiler's and the disassembly's names of the fused kernel map
    to it, not to the states or scan kernel."""
    for sym in ("void ssd_scan_bwd_states_scan_wgmma_kernel<2>(CUtensorMap",
                "_Z37ssd_scan_bwd_states_scan_wgmma_kernelILi1EEv14CU"):
        assert chip_smoke.kernel_of(sym) == "ssd_scan_bwd_states_scan"
    assert chip_smoke.kernel_of(
        "void ssd_scan_bwd_states_wgmma_kernel<1>(") == "ssd_scan_bwd_states"
    assert chip_smoke.KERNELS["ssd_scan_bwd_states_scan"] == (
        "src/repro_torch/kernels/csrc/ssd_scan_bwd.cu",
        "src/repro/models/ssm.py:70")
