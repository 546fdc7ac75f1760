"""The SSD scan where its bf16 Hopper kernel (``ssd_scan_wgmma_kernel``:
P = 64, N = 64 or 128, chunks of 128 rows) splits its work, on the CPU.

The kernel runs the chunks of a batch*head in parallel, a thread block
cluster of min(nc, 8) blocks, block r taking chunk t min(nc, 8) + r in
round t.  Each block computes from its own chunk y_diag = (C B^T .* L) x
and the chunk's map h -> a h + s from a zero start (s = B^T (exp(cs_Q -
cs) .* x), a = exp(cs_Q)).  At N = 64 an exclusive scan of the maps over
the cluster in three steps (distances 1, 2, 4; X, the block's inclusive
map, and Y, its exclusive one) gives the state entering each chunk, block
0 of a round folding in its entry state (h0, zero, or the previous
round's last state); at N = 128 the states pass block to block, the
sequential recurrence that ``ssd_chunked`` itself runs.  y = y_diag +
exp(cs) .* (C h).  ``_decomposed`` writes the scan out in
torch and is held to the JAX package's ``ssd_scan_pallas`` (interpret
mode; S a multiple of the chunk, no initial state: padded with zeros,
which leave the state as it is) and ``models/ssm.py`` ``ssd_chunked``
(ragged S, an initial state), for nc = 1, 8, 9 and 16 chunks, S = 1 and a
ragged S = 1,000, with and without h0, x and dA folded and as the views of
the model's layout, and slow decay (dA ~ -U(0, 0.01)), so that every far
block carries weight.  Also: ``ssd_smem_bytes`` of the new kernel, the
route table (``ssd_kernel``), ``chip_smoke.py``'s SSD cases and its
disassembly check of the Hopper kernel.

Inputs are seeded numpy in float32.  Tolerance 2e-5 * max(|reference|,
1): float32 sums in another order (the scan composes the chunk maps in
another order than the sequential recurrence).  The kernel itself runs
only on the card (``tests/test_torch_cuda.py``).
"""
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan import ssd_scan_pallas
from repro.models.ssm import ssd_chunked as j_ssd_chunked
from repro_torch.kernels.build import SMEM_LIMIT
from repro_torch.kernels.ssd_scan import (SSD_WGMMA_SHAPES, ssd_cuda,
                                          ssd_kernel, ssd_smem_bytes)

ROOT = pathlib.Path(__file__).resolve().parents[1]
CLUSTER = 8     # blocks of a cluster, at most (SW_CLUSTER)


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


def _decomposed(x, dA, Bm, Cm, H, Q, h0=None):
    """The Hopper kernel's decomposition in float32.  x: [BH, S, P] or the
    [G, H, S, P] view of the model's layout, dA likewise; Bm, Cm: [G, S,
    N]; h0: [BH, N, P] or None.  Returns (y in x's shape, h [BH, N, P])."""
    x4 = x if x.dim() == 4 else x.unflatten(0, (x.shape[0] // H, H))
    a4 = dA if dA.dim() == 3 else dA.unflatten(0, (dA.shape[0] // H, H))
    G, _, S, P = x4.shape
    N = Bm.shape[-1]
    nc = -(-S // Q)
    pad = nc * Q - S
    xp = torch.nn.functional.pad(x4.float(), (0, 0, 0, pad))
    ap = torch.nn.functional.pad(a4.float(), (0, pad))
    bp = torch.nn.functional.pad(Bm.float(), (0, 0, 0, pad))
    cp = torch.nn.functional.pad(Cm.float(), (0, 0, 0, pad))
    xc = xp.reshape(G, H, nc, Q, P)
    cs = torch.cumsum(ap.reshape(G, H, nc, Q), -1)
    bc = bp.reshape(G, nc, Q, N)[:, None]                  # [G, 1, nc, Q, N]
    cc = cp.reshape(G, nc, Q, N)[:, None]
    keep = torch.tril(torch.ones(Q, Q, dtype=torch.bool))
    L = torch.where(keep, torch.exp(torch.where(
        keep, cs[..., :, None] - cs[..., None, :], 0.0)), 0.0)
    scores = cc @ bc.transpose(-1, -2)                     # [G, H, nc, Q, Q]
    y_diag = (scores * L) @ xc
    # each chunk's map from a zero start: a = exp(cs_Q), s = B^T (w .* x)
    a = torch.exp(cs[..., -1])                             # [G, H, nc]
    w = torch.exp(cs[..., -1:] - cs)
    s = bc.transpose(-1, -2) @ (w[..., None] * xc)         # [G, H, nc, N, P]
    entry = (torch.zeros((G, H, N, P)) if h0 is None
             else h0.float().reshape(G, H, N, P))
    h_in = torch.empty_like(s)
    csz = min(nc, CLUSTER)
    for t in range(-(-nc // csz)):
        cnt = min(csz, nc - t * csz)
        js = [t * csz + r for r in range(cnt)]
        # X: (a, s) of the block's chunk, block 0's with the entry state
        # folded in (the constant map to a h + s); Y: the identity
        xa = [a[..., j].clone() for j in js]
        xs = [s[..., j, :, :].clone() for j in js]
        xs[0] = xa[0][..., None, None] * entry + xs[0]
        xa[0] = torch.zeros_like(xa[0])
        ya = [torch.ones_like(xa[0]) for _ in js]
        ys = [torch.zeros_like(entry) for _ in js]
        d = 1
        while d < cnt:   # Y = Y o X', X = X o X', X' of block r - d
            ra = [xa[r - d] if r >= d else None for r in range(cnt)]
            rs = [xs[r - d] if r >= d else None for r in range(cnt)]
            for r in range(d, cnt):
                ys[r] = ya[r][..., None, None] * rs[r] + ys[r]
                xs[r] = xa[r][..., None, None] * rs[r] + xs[r]
                ya[r] = ya[r] * ra[r]
                xa[r] = xa[r] * ra[r]
            d *= 2
        for r, j in enumerate(js):
            h_in[..., j, :, :] = entry if r == 0 else ys[r]
        entry = xs[cnt - 1]          # the state after the round's last
    y = y_diag + torch.exp(cs)[..., None] * (cc @ h_in)
    y = y.reshape(G, H, nc * Q, P)[:, :, :S]
    if x.dim() == 3:
        y = y.reshape(G * H, S, P)
    return y, entry.reshape(G * H, N, P)


def _inputs(seed, G, H, S, P, N, decay, model):
    """Seeded float32 inputs, x and dA folded or as the [G, H, S, .] views
    of the model's [G, S, H, .]."""
    rng = np.random.RandomState(seed)
    x = torch.tensor(rng.randn(G, S, H, P).astype(np.float32) * 0.5)
    dA = -torch.tensor(rng.rand(G, S, H).astype(np.float32) * decay)
    Bm, Cm = (torch.tensor(rng.randn(G, S, N).astype(np.float32) * 0.3)
              for _ in range(2))
    h0 = torch.tensor(rng.randn(G * H, N, P).astype(np.float32) * 0.2)
    xv, av = x.transpose(1, 2), dA.transpose(1, 2)
    if not model:
        xv = xv.reshape(G * H, S, P).contiguous()
        av = av.reshape(G * H, S).contiguous()
    return xv, av, Bm, Cm, h0


def _close(got, want):
    want = np.asarray(want, np.float32)
    tol = 2e-5 * max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(np.asarray(got), want, atol=tol, rtol=0)


# (G, H, S, P, N, chunk, h0, dA scale, model layout): nc = 1, 8 (one full
# round), 9 (block 0's second round alone), 16 (two rounds), S = 1, a
# ragged S = 1,000 at chunk 128; slow decay where far blocks must count
CASES = [(1, 2, 16, 8, 4, 16, False, 0.8, False),
         (2, 3, 128, 8, 4, 16, False, 0.01, True),
         (1, 2, 144, 16, 8, 16, True, 0.01, False),
         (1, 2, 256, 8, 8, 16, True, 0.01, True),
         (1, 3, 256, 8, 4, 16, False, 0.3, False),
         (2, 2, 1, 8, 4, 128, True, 0.8, True),
         (1, 2, 1000, 16, 8, 128, True, 0.01, False)]


@pytest.mark.parametrize("G,H,S,P,N,Q,with_h0,decay,model", CASES)
def test_decomposition_matches_ssd_chunked(G, H, S, P, N, Q, with_h0, decay,
                                           model):
    """Against the JAX model function (ragged S and an initial state
    allowed; model layout, its state [B, H, P, N])."""
    x, dA, Bm, Cm, h0 = _inputs(S + N, G, H, S, P, N, decay, model)
    h0 = h0 if with_h0 else None
    y, h = _decomposed(x, dA, Bm, Cm, H, Q, h0)
    x4 = x if model else x.unflatten(0, (G, H))
    a4 = dA if model else dA.unflatten(0, (G, H))
    init = None if h0 is None else jnp.asarray(
        h0.reshape(G, H, N, P).transpose(-1, -2).numpy())
    jy, jh = jax.jit(j_ssd_chunked, static_argnames="chunk")(
        *(jnp.asarray(t.numpy()) for t in (x4.transpose(1, 2),
                                           a4.transpose(1, 2),
                                           Bm[:, :, None], Cm[:, :, None])),
        chunk=Q, init_state=init)
    y4 = y if model else y.unflatten(0, (G, H))
    _close(y4.transpose(1, 2), jy)
    _close(h.reshape(G, H, N, P).transpose(-1, -2), jh)


@pytest.mark.parametrize("G,H,S,P,N,Q,with_h0,decay,model",
                         [c for c in CASES if not c[6]]
                         + [(1, 2, 144, 16, 8, 16, False, 0.01, True)])
def test_decomposition_matches_pallas_kernel(G, H, S, P, N, Q, with_h0,
                                             decay, model):
    """Against the TPU kernel itself in interpret mode (folded layout, no
    initial state, S padded with zeros to a multiple of the chunk)."""
    x, dA, Bm, Cm, _ = _inputs(S + P, G, H, S, P, N, decay, model)
    y, h = _decomposed(x, dA, Bm, Cm, H, Q)
    xf = x.reshape(G * H, S, P) if model else x
    af = dA.reshape(G * H, S) if model else dA
    pad = -S % Q
    pz = lambda t, d: np.pad(t.contiguous().numpy(),
                             [(0, 0), (0, pad)] + [(0, 0)] * d)
    py, ph = ssd_scan_pallas(jnp.asarray(pz(xf, 1)), jnp.asarray(pz(af, 0)),
                             jnp.asarray(pz(Bm, 1)), jnp.asarray(pz(Cm, 1)),
                             n_heads_per_group=H, chunk=Q, interpret=True)
    yf = y.reshape(G * H, S, P) if model else y
    _close(yf, np.asarray(py)[:, :S])
    _close(h, ph)


def test_hopper_kernel_shared_memory():
    """x, B, C and the states a block receives (float32): at N = 64 the
    three of the scan over its cluster and the hand-over tile, at N = 128
    the one of the chain; two blocks an SM at both N (228 KB an SM, 1 KB
    of it reserved a block)."""
    bf = torch.bfloat16
    n64 = ssd_smem_bytes(64, 64, 128, bf, "wgmma")
    n128 = ssd_smem_bytes(64, 128, 128, bf, "wgmma")
    assert (n64, n128) == (115_296, 115_248)
    assert 2 * (max(n64, n128) + 1024) <= 228 * 1024
    # the other kernels' budgets are as they were
    assert ssd_smem_bytes(64, 64, 128, bf) == 100_352
    assert ssd_smem_bytes(64, 64, 128) == 132_352


@pytest.mark.parametrize("P,N,Q,S,dtype,want", [
    (64, 64, 128, 1024, torch.bfloat16, "wgmma"),
    (64, 128, 128, 1024, torch.bfloat16, "wgmma"),
    (64, 64, 100, 100, torch.bfloat16, "wgmma"),     # one chunk, S < 128
    (64, 128, 1, 1, torch.bfloat16, "wgmma"),        # S = 1
    (64, 64, 64, 1000, torch.bfloat16, "mma"),       # chunks of 64
    (64, 64, 64, 100, torch.bfloat16, "mma"),
    (64, 32, 128, 1024, torch.bfloat16, "mma"),
    (32, 64, 64, 300, torch.bfloat16, "mma"),
    (16, 16, 16, 77, torch.bfloat16, "mma"),
    (64, 64, 128, 1024, torch.float32, "fma")])
def test_route_table(P, N, Q, S, dtype, want):
    """The fixed table ``ssd_cuda`` launches by: the Hopper kernel at the
    full configs' (P, N) in chunks of 128 rows (or one chunk of S < 128),
    mma.sync for the other bf16 shapes, the FMA kernel in float32."""
    assert SSD_WGMMA_SHAPES == ((64, 64), (64, 128))
    assert ssd_kernel(P, N, Q, S, dtype) == want


def test_cuda_refuses_cpu_tensors_and_a_kernel_off_its_table():
    """No fallback: CPU tensors and a kernel asked for off its table are
    refused before anything launches."""
    x = torch.zeros((2, 256, 64), dtype=torch.bfloat16)
    bc = torch.zeros((1, 256, 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ssd_cuda(x, torch.zeros((2, 256)), bc, bc, 2, 128)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ssd_cuda(x, torch.zeros((2, 256)), bc, bc, 2, 128, kernel="mma")


def test_chip_smoke_ssd_cases_reach_the_hopper_kernel_edges(chip_smoke):
    """Phase 3 holds the Hopper kernel to the plain version at both full
    shapes and at its edges: 16 chunks (two rounds) with h0 at both N, 9
    chunks, S < 128, S = 1 at both N, the model layout; the other bf16
    shapes stay on mma.sync and float32 on the FMA kernel."""
    cases = chip_smoke.SSD_CASES
    route = lambda c: ssd_kernel(c[3], c[4], min(c[5], c[2]), c[2],
                                 torch.bfloat16 if c[6] == "bf16"
                                 else torch.float32)
    hopper = [c for c in cases if route(c) == "wgmma"]
    for N in (64, 128):
        assert any(c[2] == 1024 and c[4] == N for c in hopper)
        assert any(-(-c[2] // 128) == 16 and c[4] == N and c[7]
                   for c in hopper)
        assert any(c[2] == 1 and c[4] == N for c in hopper)
    assert any(-(-c[2] // 128) == 9 and c[7] for c in hopper)
    assert any(1 < c[2] < 128 for c in hopper)
    assert any(c[2] % 128 and c[2] > 128 for c in hopper)
    assert any(c[9] for c in hopper) and any(not c[9] for c in hopper)
    assert any(c[8] <= 0.01 for c in hopper)
    assert any(route(c) == "mma" for c in cases)
    assert any(route(c) == "fma" for c in cases)
    assert set(chip_smoke.WGMMA_KERNELS["ssd_scan"]) == {64, 128}


def _sass(ssd_nt=(1, 2), hgmma=True, tma=True):
    """A disassembly as ``cuobjdump -sass`` prints it: every model
    kernel's forms, the attention kernels' Hopper instantiations whole,
    the SSD scan's at ``ssd_nt`` (N = 64 nt) with or without wgmma and TMA
    instructions."""
    lines = []
    for fn in ("_Z33flash_attention_bwd_dq_mma_kernelILi5EEvPK13__nv_b",
               "_Z35flash_attention_bwd_dkdv_mma_kernelILi5EEvPK13__nv",
               "_Z26flash_attention_mma_kernelILi5EEvPK13__nv_bfloat16",
               "_Z19ssd_scan_mma_kernelILi4ELi4EEvPK13__nv_bfloat16"):
        lines += [f"Function : {fn}",
                  "  /*0a10*/  HMMA.16816.F32.BF16 R4, R8, R12, R4 ;"]
    fns = [(f"_Z28flash_attention_wgmma_kernelILi{d}EEv14CUtensorMapS_",
            True, True) for d in (64, 80, 128)]
    fns += [(f"_Z35flash_attention_bwd_{kernel}_wgmma_kernelILi{db}EEv14CUt",
             True, True) for kernel in ("dq", "dkdv") for db in (1, 2)]
    fns += [(f"_Z21ssd_scan_wgmma_kernelILi{nt}EEv14CUtensorMap_st", hgmma,
             tma) for nt in ssd_nt]
    for fn, with_hgmma, with_tma in fns:
        lines.append(f"Function : {fn}")
        if with_tma:
            lines.append("  /*0100*/  UTMALDG.4D [UR8], [UR4] ;")
        if with_hgmma:
            lines.append("  /*0200*/  HGMMA.64x64x16.F32.BF16 R24, "
                         "gdesc[UR4], RZ, !UPT ;")
    return "\n".join(lines)


@pytest.mark.parametrize("sass,ok", [
    (_sass(), True), (_sass(hgmma=False), False), (_sass(tma=False), False),
    (_sass((1,)), False), (_sass((2,)), False)])
def test_tensor_core_check_requires_the_scan_on_wgmma_and_tma(
        chip_smoke, monkeypatch, capsys, sass, ok):
    """Phase 2 fails unless the SSD scan has its two Hopper instantiations
    (N = 64 and 128) and both hold wgmma (HGMMA) products and TMA
    (UTMALDG) loads."""
    class Done:
        stdout = sass
    monkeypatch.setattr(chip_smoke.subprocess, "run",
                        lambda *a, **k: Done)
    if ok:
        chip_smoke.tensor_core_check("lib.so", "/cuda/bin/nvcc")
        assert "ssd_scan bf16 Hopper: HGMMA [1, 1], UTMALDG [1, 1]" in \
            capsys.readouterr().out
    else:
        with pytest.raises(AssertionError,
                           match=r"ssd_scan: expected 2 \(N = 64, 128\) "
                                 r"Hopper instantiations with wgmma"):
            chip_smoke.tensor_core_check("lib.so", "/cuda/bin/nvcc")
