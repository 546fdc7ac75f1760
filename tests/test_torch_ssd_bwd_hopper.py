"""The SSD backward where its bf16 Hopper kernels split their work, on the
CPU (``ssd_scan_bwd_states_wgmma_kernel`` and
``ssd_scan_bwd_grads_wgmma_kernel``: P = 64, N = 64 or 128, chunks of 128
rows; a single chunk of S < 128 rows is that chunk with zero rows after
S).

The grads kernel takes a (group, chunk) as a cluster of csz <= min(H, 8)
blocks (the launch picks csz by the clusters that fit on the card at
once), block r walking the heads [r H / csz, (r + 1) H / csz) in order:
for each head the state products (dCst = e^a .* (dy h^T), dBst = w .*
(x G^T), dx = w .* (B G)), then the column walk on its own products
(W^T = (x dy^T) .* L^T, S^T = B C^T: dx += (S .* L)^T dy, dB += W^T C),
then the row walk (W = (dy x^T) .* L: dC += W B), da from the row and
column terms and dA its reverse cumsum.  dB and dC are summed over the
block's heads in head order, then over the blocks in rank order.
``_grads_decomposed`` writes that split out in torch (C B^T once a
(group, chunk)), ``_states_decomposed`` the states kernel's (a warp
group's 64 state rows at a time); both are held to the plain stages
(``ssd_bwd_states_plain``, ``ssd_bwd_grads_plain``) and, chained with
the plain scan, to ``jax.vjp`` of the reference's ``models/ssm.py``
``ssd_chunked``.  Cases: H = 1, 3, 4 and 10 (clusters of 1 to 8 blocks:
unequal slices, one-head slices), S = 1, 100, 1,000 (ragged) and 2,048
(16 chunks), h0 and dh_final each given or None, decays 0.01 and 1.4
(a_cum reaches -179: no factored exponential may appear).  Also: the new
kernels' shared memory and the blocks an SM it leaves, the route table
(``ssd_bwd_kernel``), that ``chip_smoke.py``'s ``SSD_BWD_CASES`` reach
the new kernels' edges, and its disassembly check of them.

Inputs are seeded numpy in float32.  Tolerance 1e-4 * scale (scale = max
|reference|): float32 sums in another order.  The kernels themselves run
only on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase
3).
"""
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.ssm import ssd_chunked as j_ssd_chunked
from repro_torch.kernels import ssd_scan as ss
from repro_torch.kernels.build import SMEM_LIMIT

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL = 1e-4
Q = 128          # rows of the Hopper kernels' chunk (SBW_Q)
CLUSTER = 8      # blocks of a grads cluster, at most (SBW_CLUSTER)
P = 64


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


def _close(got, want, label=""):
    got = np.asarray(got.detach().float() if torch.is_tensor(got) else got)
    want = np.asarray(want.detach().float() if torch.is_tensor(want)
                      else want, np.float32)
    assert got.shape == want.shape, (label, got.shape, want.shape)
    scale = max(float(np.abs(want).max()) if want.size else 0.0, 1e-30)
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= TOL * scale, (label, err, TOL * scale)


def _chunks(x4, dA4, Bm, Cm, dy4):
    """Float32 chunks of 128 rows, zeros past S: x, dy [G, H, nc, Q, P],
    a = the chunks' cumsums [G, H, nc, Q], B, C [G, nc, Q, N]."""
    G, H, S, _ = x4.shape
    nc = -(-S // Q)
    pad = nc * Q - S
    rows = lambda t, d: torch.nn.functional.pad(
        t.float(), (0, 0) * d + (0, pad))
    xc = rows(x4, 1).reshape(G, H, nc, Q, -1)
    dyc = rows(dy4, 1).reshape(G, H, nc, Q, -1)
    a = torch.cumsum(rows(dA4, 0).reshape(G, H, nc, Q), -1)
    Bc = rows(Bm, 1).reshape(G, nc, Q, -1)
    Cc = rows(Cm, 1).reshape(G, nc, Q, -1)
    return xc, dyc, a, Bc, Cc


def _states_decomposed(x4, dA4, Bm, Cm, dy4):
    """The states kernel's split: each block a (batch*head, chunk) of 128
    rows, a warp group's 64 state rows at a time, st = (w .* B)^T x,
    U = (e^a .* C)^T dy.  Returns (st, U [BH, nc, N, P], aL [BH, nc])."""
    G, H, S, _ = x4.shape
    xc, dyc, a, Bc, Cc = _chunks(x4, dA4, Bm, Cm, dy4)
    N = Bc.shape[-1]
    w, ea = torch.exp(a[..., -1:] - a), torch.exp(a)
    st = torch.empty(G, H, a.shape[2], N, P)
    U = torch.empty_like(st)
    for u in range(N // 64):       # the 64 state rows of a warp group
        b, c = Bc[..., 64 * u:64 * u + 64], Cc[..., 64 * u:64 * u + 64]
        st[..., 64 * u:64 * u + 64, :] = (
            w[..., None] * b[:, None]).transpose(-1, -2) @ xc
        U[..., 64 * u:64 * u + 64, :] = (
            ea[..., None] * c[:, None]).transpose(-1, -2) @ dyc
    flat = lambda t: t.reshape(G * H, *t.shape[2:])
    return flat(st), flat(U), flat(a[..., -1])


def _grads_decomposed(x4, dA4, Bm, Cm, dy4, hprev, Gs, sc, csz):
    """The grads kernel's split (see the module's docstring) over clusters
    of csz blocks.  x4, dA4, dy4: [G, H, S, .]; hprev, Gs [BH, nc, N, P],
    sc [BH, nc].  Returns (dx, ddA [G, H, S, .], dB, dC [G, S, N])."""
    G, H, S, _ = x4.shape
    xc, dyc, a, Bc, Cc = _chunks(x4, dA4, Bm, Cm, dy4)
    nc, N = a.shape[2], Bc.shape[-1]
    hp = hprev.reshape(G, H, nc, N, P)
    gs = Gs.reshape(G, H, nc, N, P)
    scs = sc.reshape(G, H, nc)
    low = torch.tril(torch.ones(Q, Q, dtype=torch.bool))
    Sm = Cc @ Bc.transpose(-1, -2)          # C B^T, once a (group, chunk)
    St = Bc @ Cc.transpose(-1, -2)          # the column walk's S^T
    dx = torch.empty_like(xc)
    dda = torch.empty_like(a)
    partial = []
    for r in range(csz):                    # the blocks of a cluster
        sb = torch.zeros(G, nc, Q, N)
        sc_ = torch.zeros(G, nc, Q, N)
        for h in range(r * H // csz, (r + 1) * H // csz):   # head order
            ah, x, dy = a[:, h], xc[:, h], dyc[:, h]
            L = torch.where(low, torch.exp(torch.where(
                low, ah[..., :, None] - ah[..., None, :], 0.0)), 0.0)
            ea, w = torch.exp(ah), torch.exp(ah[..., -1:] - ah)
            # the state products
            dCst = ea[..., None] * (dy @ hp[:, h].transpose(-1, -2))
            dBst = w[..., None] * (x @ gs[:, h].transpose(-1, -2))
            dxh = w[..., None] * (Bc @ gs[:, h])
            rt = (Cc * dCst).sum(-1)
            stm = (Bc * dBst).sum(-1)
            sc_ = sc_ + dCst
            sb = sb + dBst
            # the column walk: rows j, columns i
            Lt = L.transpose(-1, -2)
            Wt = (x @ dy.transpose(-1, -2)) * Lt
            cs = -(Wt * St).sum(-1)
            dxh = dxh + (St * Lt) @ dy
            sb = sb + Wt @ Cc
            # the row walk
            W = (dy @ x.transpose(-1, -2)) * L
            rt = rt + (W * Sm).sum(-1)
            sc_ = sc_ + W @ Bc
            da = rt + cs - stm
            da[..., -1] += stm.sum(-1) + scs[:, h]
            dda[:, h] = torch.flip(torch.cumsum(torch.flip(da, (-1,)), -1),
                                   (-1,))
            dx[:, h] = dxh
        partial.append((sb, sc_))
    dB, dC = partial[0]
    for sb, sc_ in partial[1:]:             # rank order
        dB, dC = dB + sb, dC + sc_
    unrows = lambda t: t.reshape(*t.shape[:-3], nc * Q, t.shape[-1])[
        ..., :S, :]
    return (unrows(dx), unrows(dda[..., None])[..., 0], unrows(dB),
            unrows(dC))


def _inputs(seed, G, H, S, N, decay, with_h0, with_dh):
    """Seeded float32 inputs in the port's layout: x, dy as the [G, H, S,
    P] views of the model's [G, S, H, P], dA likewise, B, C [G, S, N],
    h0 and dh [G H, N, P] or None."""
    rng = np.random.RandomState(seed)
    f = lambda *s: torch.tensor(rng.randn(*s).astype(np.float32))
    x = (f(G, S, H, P) * 0.5).transpose(1, 2)
    dy = f(G, S, H, P).transpose(1, 2)
    dA = -torch.tensor(rng.rand(G, S, H).astype(np.float32) * decay
                       ).transpose(1, 2)
    Bm, Cm = f(G, S, N) * 0.3, f(G, S, N) * 0.3
    h0 = f(G * H, N, P) * 0.2 if with_h0 else None
    dh = f(G * H, N, P) * 0.2 if with_dh else None
    return x, dA, Bm, Cm, dy, h0, dh


def _jax_grads(x, dA, Bm, Cm, dy, h0, dh):
    """jax.vjp of the reference's ssd_chunked in its own layout, back in
    the port's: (dx, ddA, dB, dC, dh0)."""
    G, H, S, _ = x.shape
    N = Bm.shape[-1]
    j = lambda t: jnp.asarray(t.detach().numpy())
    args = [j(x.transpose(1, 2)), j(dA.transpose(1, 2)), j(Bm[:, :, None]),
            j(Cm[:, :, None])]
    if h0 is not None:
        args.append(j(h0.reshape(G, H, N, P).transpose(-1, -2)))
    fwd = lambda *a: j_ssd_chunked(*a[:4], chunk=Q,
                                   init_state=a[4] if len(a) > 4 else None)
    out, vjp = jax.vjp(fwd, *args)
    cot = (j(dy.transpose(1, 2)),
           jnp.zeros_like(out[1]) if dh is None
           else j(dh.reshape(G, H, N, P).transpose(-1, -2)))
    got = [torch.tensor(np.asarray(t)) for t in vjp(cot)]
    dx, da, db, dc = (got[0].transpose(1, 2), got[1].transpose(1, 2),
                      got[2][:, :, 0], got[3][:, :, 0])
    dh0 = (None if h0 is None
           else got[4].transpose(-1, -2).reshape(G * H, N, P))
    return dx, da, db, dc, dh0


# (G, H, S, N, decay, h0, dh_final): H = 1, 3, 4, 10 (clusters of 1, 3,
# 4, 4 blocks; 10 heads in slices of 2 and 3); S = 1, 100 (one chunk of
# S < 128), 1,000 (ragged) and 2,048 (16 chunks)
CASES = [(1, 1, 1, 64, 1.4, True, True),
         (2, 3, 100, 64, 0.01, False, True),
         (1, 4, 1000, 128, 1.4, True, False),
         (1, 10, 2048, 64, 0.01, False, False),
         (1, 3, 2048, 128, 1.4, True, True),
         (2, 10, 100, 128, 0.01, True, True)]


@pytest.mark.parametrize("G,H,S,N,decay,with_h0,with_dh", CASES)
def test_decomposition_matches_the_plain_stages(G, H, S, N, decay, with_h0,
                                                with_dh):
    """Each kernel's split against its plain stage on the same inputs (the
    grads kernel's on the plain scan's outputs)."""
    x, dA, Bm, Cm, dy, h0, dh = _inputs(S + 7 * H, G, H, S, N, decay,
                                        with_h0, with_dh)
    Qp = min(Q, S)
    want = ss.ssd_bwd_states_plain(x, dA, Bm, Cm, dy, H, Qp)
    got = _states_decomposed(x, dA, Bm, Cm, dy)
    for name, a, w in zip(("st", "U", "aL"), got, want):
        _close(a, w, name)
    hp, Gs, _, sc = ss.ssd_bwd_scan_plain(*want, h0, dh)
    want = ss.ssd_bwd_grads_plain(x, dA, Bm, Cm, dy, hp, Gs, sc, H, Qp)
    for csz in sorted({1, min(H, 3), min(H, 4), min(H, CLUSTER)}):
        got = _grads_decomposed(x, dA, Bm, Cm, dy, hp, Gs, sc, csz)
        for name, a, w in zip(("dx", "ddA", "dB", "dC"), got, want):
            _close(a, w, f"{name}, clusters of {csz}")


@pytest.mark.parametrize("G,H,S,N,decay,with_h0,with_dh",
                         [CASES[0], CASES[2], CASES[3], CASES[4]])
def test_decomposition_matches_jax_vjp_of_ssd_chunked(G, H, S, N, decay,
                                                      with_h0, with_dh):
    """Both kernels' splits, chained by the plain scan, against jax.vjp of
    the reference's ssd_chunked (ragged S, h0 and the final state's
    gradient allowed)."""
    x, dA, Bm, Cm, dy, h0, dh = _inputs(S + 11 * H, G, H, S, N, decay,
                                        with_h0, with_dh)
    st, U, aL = _states_decomposed(x, dA, Bm, Cm, dy)
    hp, Gs, dh0, sc = ss.ssd_bwd_scan_plain(st, U, aL, h0, dh)
    got = (*_grads_decomposed(x, dA, Bm, Cm, dy, hp, Gs, sc, min(H, 3)),
           dh0)
    want = _jax_grads(x, dA, Bm, Cm, dy, h0, dh)
    for name, a, w in zip(("dx", "ddA", "dB", "dC", "dh0"), got, want):
        if w is not None:
            _close(a, w, name)


def test_head_slices_of_a_cluster():
    """Block r of a (group, chunk)'s cluster of csz <= min(H, 8) blocks
    takes heads [r H / csz, (r + 1) H / csz): every head once, in order,
    the slices differing by at most one head and none empty."""
    assert ss.SSD_BWD_CLUSTER == CLUSTER
    for H in (1, 2, 3, 4, 5, 10, 24, 80):
        for csz in range(1, min(H, CLUSTER) + 1):
            slices = [range(r * H // csz, (r + 1) * H // csz)
                      for r in range(csz)]
            assert [h for s in slices for h in s] == list(range(H))
            assert min(map(len, slices)) >= 1
            assert max(map(len, slices)) - min(map(len, slices)) <= 1


def test_hopper_kernels_shared_memory():
    """The grads kernel's B, C, x and dy twice, hprev and G, dx's tiles
    and its arrays fit one block an SM at both N (its dB and dC sums in
    registers leave no room for two); the states kernel's x, dy, B, C
    two blocks an SM.  The mma.sync forms' budgets are as they were."""
    bf = torch.bfloat16
    grads = [ss.ssd_bwd_smem_bytes(64, n, 128, bf, "wgmma", "grads")
             for n in (64, 128)]
    states = [ss.ssd_bwd_smem_bytes(64, n, 128, bf, "wgmma", "states")
              for n in (64, 128)]
    assert grads == [152_112, 217_648]
    assert states == [67_096, 99_864]
    assert max(grads) <= SMEM_LIMIT
    assert 2 * (max(states) + 1024) <= 228 * 1024
    # the float32 dC and dB sums, [128][N + 8], fit where the tiles were
    for n, used in zip((64, 128), grads):
        assert 2 * 128 * (n + 8) * 4 <= used
    assert ss.ssd_bwd_smem_bytes(64, 64, 128, bf, "mma", "grads") == 101_376
    assert ss.ssd_bwd_smem_bytes(64, 128, 128, bf, "mma",
                                 "states") == 99_840


@pytest.mark.parametrize("P_,N,Qc,S,dtype,want", [
    (64, 64, 128, 1024, torch.bfloat16, "wgmma"),
    (64, 128, 128, 1024, torch.bfloat16, "wgmma"),
    (64, 64, 100, 100, torch.bfloat16, "wgmma"),     # one chunk, S < 128
    (64, 128, 1, 1, torch.bfloat16, "wgmma"),        # S = 1
    (64, 64, 64, 1000, torch.bfloat16, "mma"),       # chunks of 64
    (64, 32, 128, 1024, torch.bfloat16, "mma"),
    (32, 64, 64, 300, torch.bfloat16, "mma"),
    (16, 16, 16, 77, torch.bfloat16, "mma"),
    (64, 64, 128, 1024, torch.float32, "fma"),
    (64, 128, 128, 1000, torch.float32, "fma")])
def test_route_table(P_, N, Qc, S, dtype, want):
    """The backward's states and grads kernels take the forward's table:
    Hopper at the full configs' (P, N) in chunks of 128 rows (or one chunk
    of S < 128), mma.sync for the other bf16 shapes, FMA in float32."""
    assert ss.ssd_bwd_kernel(P_, N, Qc, S, dtype) == want


def test_wrappers_refuse_cpu_tensors_and_a_form_off_the_table():
    """No fallback: CPU tensors and a form asked for off its table are
    refused before anything launches."""
    x = torch.zeros((2, 256, 64), dtype=torch.bfloat16)
    bc = torch.zeros((1, 256, 64), dtype=torch.bfloat16)
    a = torch.zeros((2, 256))
    st = torch.zeros((2, 2, 64, 64))
    for kernel in (None, "mma", "wgmma"):
        with pytest.raises(ValueError, match="CUDA tensor"):
            ss.ssd_bwd_states_cuda(x, a, bc, bc, x, 2, 128, kernel=kernel)
        with pytest.raises(ValueError, match="CUDA tensor"):
            ss.ssd_bwd_grads_cuda(x, a, bc, bc, x, st, st, a[:, :2], 2, 128,
                                  kernel=kernel)
    with pytest.raises(ValueError, match="the wgmma form does not take"):
        ss._bwd_route("ssd_scan_bwd_grads", 64, 64, 64, 1000,
                      torch.bfloat16, "wgmma")
    with pytest.raises(ValueError, match="the mma form does not take"):
        ss._bwd_route("ssd_scan_bwd_states", 64, 64, 128, 1024,
                      torch.float32, "mma")
    assert ss._bwd_route("x", 64, 128, 128, 1024, torch.bfloat16,
                         "mma") == "mma"


def test_chip_smoke_ssd_bwd_cases_reach_the_hopper_edges(chip_smoke):
    """Phase 3 holds the Hopper forms to the plain stages at both training
    shapes and at their edges: a ragged tail with h0 and dh, 16 chunks at
    both N, one chunk of S < 128, S = 1, H = 3 (a cluster of three one-head
    blocks) and H = 4; the other bf16 cases stay on mma.sync."""
    route = lambda c: ss.ssd_bwd_kernel(
        c[3], c[4], min(c[5], c[2]), c[2],
        torch.bfloat16 if c[6] == "bf16" else torch.float32)
    hopper = [c for c in chip_smoke.SSD_BWD_CASES if route(c) == "wgmma"]
    for N in (64, 128):
        assert any(c[2] == 1024 and c[4] == N and c[0] == 4 for c in hopper)
        assert any(-(-c[2] // 128) == 16 and c[4] == N for c in hopper)
    assert any(c[2] % 128 and c[2] > 128 and c[7] and c[8] for c in hopper)
    assert any(1 < c[2] < 128 for c in hopper)
    assert any(c[2] == 1 for c in hopper)
    assert {3, 4} <= {c[1] for c in hopper}
    assert any(c[9] >= 1.4 for c in hopper)
    assert any(c[9] <= 0.01 for c in hopper)
    assert any(route(c) == "mma" for c in chip_smoke.SSD_BWD_CASES)
    assert chip_smoke.SSD_BWD_WGMMA == {
        "ssd_scan_bwd_states": (64, 128),
        "ssd_scan_bwd_states_scan": (64, 128),
        "ssd_scan_bwd_grads": (64, 128)}


def _sass(drop=None):
    """A disassembly as ``cuobjdump -sass`` prints it: the Hopper forms of
    the SSD backward's states, fused states and scan, and grads kernels at
    NT = 1, 2 (N = 64 NT), each with HGMMA and UTMALDG instructions but
    ``drop`` ((kernel, NT, instruction))."""
    lines = []
    for name, n in (("ssd_scan_bwd_states_wgmma_kernel", 32),
                    ("ssd_scan_bwd_states_scan_wgmma_kernel", 37),
                    ("ssd_scan_bwd_grads_wgmma_kernel", 31)):
        for nt in (1, 2):
            lines.append(f"Function : _Z{n}{name}ILi{nt}EEv14CUtensorMap_st")
            for op, text in (("UTMALDG", "UTMALDG.4D [UR8], [UR4] ;"),
                             ("HGMMA", "HGMMA.64x64x16.F32.BF16 R24, "
                                       "gdesc[UR4], RZ, !UPT ;")):
                if (name, nt, op) != drop:
                    lines.append(f"  /*0100*/  {text}")
    return "\n".join(lines)


@pytest.mark.parametrize("drop", [
    None, ("ssd_scan_bwd_grads_wgmma_kernel", 1, "HGMMA"),
    ("ssd_scan_bwd_grads_wgmma_kernel", 2, "UTMALDG"),
    ("ssd_scan_bwd_states_wgmma_kernel", 2, "HGMMA"),
    ("ssd_scan_bwd_states_wgmma_kernel", 1, "UTMALDG"),
    ("ssd_scan_bwd_states_scan_wgmma_kernel", 1, "HGMMA"),
    ("ssd_scan_bwd_states_scan_wgmma_kernel", 2, "UTMALDG")])
def test_ssd_bwd_wgmma_check(chip_smoke, monkeypatch, capsys, drop):
    """Phase 2 fails unless the states, fused states and scan, and grads
    kernels each have their two Hopper instantiations (N = 64 and 128) and
    both hold wgmma (HGMMA) products and TMA (UTMALDG) loads."""
    class Done:
        stdout = _sass(drop)
    monkeypatch.setattr(chip_smoke.subprocess, "run", lambda *a, **k: Done)
    if drop is None:
        chip_smoke.ssd_bwd_wgmma_check("lib.so", "/cuda/bin/nvcc")
        out = capsys.readouterr().out
        for name in chip_smoke.SSD_BWD_WGMMA:
            assert f"{name} bf16 Hopper: HGMMA [1, 1], UTMALDG [1, 1]" in out
    else:
        with pytest.raises(AssertionError,
                           match=f"{drop[0][:-13]}: expected 2 \\(N = 64, "
                                 f"128\\) Hopper instantiations"):
            chip_smoke.ssd_bwd_wgmma_check("lib.so", "/cuda/bin/nvcc")
