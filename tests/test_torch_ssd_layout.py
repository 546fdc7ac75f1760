"""The SSD scan in the model's own layout, and the budgets of the bf16
model kernels (CPU).

``models/ssm.py:ssd`` hands the scan the ``[B, H, S, .]`` transpose views
of the model's ``[B, S, H, .]`` x and dA, and takes y back as such a view:
``ssd_plain`` on those views must equal it on folded copies, and the model
function must still match the JAX package's ``ssd_chunked`` (float32, sums
in another order: 1e-3, as in ``tests/test_kernels.py``).  The bf16 CUDA
kernel's shared-memory budget admits mamba2-130m's N=128 at chunk 128,
and so does the float32 kernel's, its [scores | C] rows staged in strips.  The CUDA kernels themselves are held to these
plain versions on the card (``tests/test_torch_cuda.py``), and
``chip_smoke.py``'s checks of the bf16 scan pass a correct scan and catch
one that skips the blocks far below the diagonal, given slow decay.
"""
import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.models.ssm import ssd_chunked as j_ssd_chunked
from repro_torch.configs import get_reduced
from repro_torch.kernels import build
from repro_torch.kernels.ssd_scan import ssd_plain, ssd_smem_bytes
from repro_torch.models.ssm import ssd

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _inputs(seed, B, S, H, P, N):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, S, H, P) * 0.5, -rng.rand(B, S, H) * 0.8,
            rng.randn(B, S, 1, N) * 0.3, rng.randn(B, S, 1, N) * 0.3,
            rng.randn(B, H, P, N) * 0.2)


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a, np.float32)).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,chunk,with_h0", [(64, 16, False), (77, 16, True),
                                             (40, 128, True)])
def test_ssd_plain_on_model_views_equals_folded(S, chunk, with_h0, dtype):
    """The transpose views the model passes give what folded contiguous
    copies give, bit for bit, and y comes back in x's [B, H, S, P] shape."""
    B, H, P, N = 2, 3, 16, 8
    x, dA, Bm, Cm, h0 = _inputs(S, B, S, H, P, N)
    xm, am = _t(x, dtype), _t(dA)
    bm, cm = _t(Bm[:, :, 0], dtype), _t(Cm[:, :, 0], dtype)
    hf = _t(h0).transpose(-1, -2).reshape(B * H, N, P) if with_h0 else None
    yv, hv = ssd_plain(xm.transpose(1, 2), am.transpose(1, 2), bm, cm, H,
                       chunk, hf)
    yf, hfold = ssd_plain(xm.transpose(1, 2).reshape(B * H, S, P)
                          .contiguous(),
                          am.transpose(1, 2).reshape(B * H, S).contiguous(),
                          bm, cm, H, chunk, hf)
    assert yv.shape == (B, H, S, P) and yv.dtype == dtype
    assert torch.equal(yv.reshape(B * H, S, P), yf)
    assert torch.equal(hv, hfold)


@pytest.mark.parametrize("S,with_state", [(37, True), (48, False),
                                          (50, True)])
def test_model_ssd_matches_jax_ssd_chunked(S, with_state):
    """``models/ssm.py:ssd`` (views in, a view out) at the reduced zamba2
    config (P = N = 16, chunk 16; 8 heads of a 128-wide inner dim), ragged
    and from an initial state, against the JAX package's model
    function."""
    cfg = get_reduced("zamba2-2.7b")
    B, H, P, N = 2, cfg.ssm_heads, cfg.headdim, cfg.d_state
    x, dA, Bm, Cm, h0 = _inputs(S + 7, B, S, H, P, N)
    h0 = h0 if with_state else None
    jy, jh = j_ssd_chunked(*(jnp.asarray(a, jnp.float32)
                             for a in (x, dA, Bm, Cm)), chunk=cfg.ssd_chunk,
                           init_state=None if h0 is None
                           else jnp.asarray(h0, jnp.float32))
    y, h = ssd(_t(x), _t(dA), _t(Bm), _t(Cm), cfg.ssd_chunk,
               None if h0 is None else _t(h0), kernels="torch")
    assert y.shape == (B, S, H, P) and h.shape == (B, H, P, N)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-3,
                               rtol=1e-3)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=1e-3,
                               rtol=1e-3)


def test_ssd_smem_budget_admits_state_128_in_bf16_only():
    """The bf16 kernel keeps x and B in bf16 (two stages), C in bf16 (one
    stage) and h's operand copy as bf16 hi + lo: two blocks an SM at the
    path's sizes, and mamba2-130m's N=128 at chunk 128 fits.  The float32
    kernel, which once refused N=128 (a whole chunk of [scores | C] rows
    took 263,680 bytes), now stages those rows in strips of 64 and fits it
    too; N=256 it still refuses."""
    bf = torch.bfloat16
    assert ssd_smem_bytes(64, 64, 128, bf) == 100_352
    assert 2 * (ssd_smem_bytes(64, 64, 128, bf) + 1024) <= 228 * 1024
    assert ssd_smem_bytes(64, 128, 128, bf) == 165_888 <= build.SMEM_LIMIT
    assert ssd_smem_bytes(64, 128, 128) == 197_888 <= build.SMEM_LIMIT
    assert ssd_smem_bytes(64, 256, 128) > build.SMEM_LIMIT
    assert ssd_smem_bytes(64, 64, 128) == ssd_smem_bytes(
        64, 64, 128, torch.float32) == 132_352
    # a chunk is padded to a multiple of 16 rows
    assert ssd_smem_bytes(16, 16, 50, bf) == ssd_smem_bytes(16, 16, 64, bf)


def _chip_smoke():
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    return chip_smoke


def _scan(x, dA, Bm, Cm, H, Q, h0, skip=None):
    """The SSD scan by its definition, chunk by chunk in float64 (folded
    layout: x [BH, S, P], dA [BH, S], Bm/Cm [G, S, N], h0 [BH, N, P]).
    ``skip`` drops what a faulty kernel could leave out: "intra" the
    16-column blocks of (C B^T .* L) x two or more blocks left of the
    diagonal, "state" every 16-row tile of the state product but the
    chunk's last."""
    x, dA, Bm, Cm, h0 = (np.asarray(t.double()) for t in (x, dA, Bm, Cm, h0))
    y, hs = np.zeros_like(x), np.zeros_like(h0)
    for bh in range(x.shape[0]):
        b, c, h = Bm[bh // H], Cm[bh // H], h0[bh]
        for c0 in range(0, x.shape[1], Q):
            sl = slice(c0, min(c0 + Q, x.shape[1]))
            n = sl.stop - c0
            cs = np.cumsum(dA[bh, sl])
            i, j = np.arange(n)[:, None], np.arange(n)[None, :]
            keep = j <= i
            if skip == "intra":
                keep &= j // 16 >= i // 16 - 1
            L = np.where(keep, np.exp(np.minimum(cs[:, None] - cs[None, :],
                                                 0.0)), 0.0)
            y[bh, sl] = ((c[sl] @ b[sl].T) * L) @ x[bh, sl] \
                + np.exp(cs)[:, None] * (c[sl] @ h)
            w = np.exp(cs[-1] - cs)
            if skip == "state":
                w = np.where(np.arange(n) // 16 == (n - 1) // 16, w, 0.0)
            h = np.exp(cs[-1]) * h + (b[sl] * w[:, None]).T @ x[bh, sl]
        hs[bh] = h
    return (torch.as_tensor(y, dtype=torch.float32).to(torch.bfloat16),
            torch.as_tensor(hs, dtype=torch.float32))


def _bf16_scan_inputs(decay, Bg=1, H=2, S=256, P=16, N=16):
    g = torch.Generator().manual_seed(int(decay * 1000) + S)
    x = (torch.randn((Bg * H, S, P), generator=g) * 0.5).to(torch.bfloat16)
    dA = -torch.rand((Bg * H, S), generator=g) * decay
    Bm, Cm = ((torch.randn((Bg, S, N), generator=g) * 0.3)
              .to(torch.bfloat16) for _ in range(2))
    h0 = torch.randn((Bg * H, N, P), generator=g) * 0.2
    return x, dA, Bm, Cm, H, 128, h0


def _smoke_ssd_checks(cs, y, h, args):
    """chip_smoke.py's checks of a bf16 scan: y against the bf16 plain
    version (2e-2), h against it (1e-3), y against the float32 oracle."""
    yp, hp = ssd_plain(*args)
    cs.close_err(torch, "ssd_scan", "y", (y,), (yp,), 2e-2, 2e-2)
    cs.close_err(torch, "ssd_scan state", "h", (h,), (hp,), 1e-3, 1e-3)
    cs.ssd_oracle_err(torch, "y", y, *args, ssd_plain)


@pytest.mark.parametrize("decay", [1.4, 0.01])
def test_smoke_ssd_checks_pass_a_correct_scan(decay):
    """The scan by its definition in float64, y rounded to bf16 once,
    passes every check chip_smoke.py holds the bf16 kernel to."""
    cs = _chip_smoke()
    args = _bf16_scan_inputs(decay)
    _smoke_ssd_checks(cs, *_scan(*args), args)


@pytest.mark.parametrize("skip", ["intra", "state"])
def test_smoke_ssd_checks_catch_skipped_blocks_at_slow_decay(skip):
    """With dA ~ -U(0, 0.01) a scan that leaves out the blocks far below
    the diagonal, or the state product's earlier row tiles, fails those
    checks."""
    cs = _chip_smoke()
    args = _bf16_scan_inputs(0.01)
    with pytest.raises(AssertionError, match="largest excess"):
        _smoke_ssd_checks(cs, *_scan(*args, skip=skip), args)


def test_close_err_keeps_the_element_closest_to_its_limit():
    """close_err records, per name, the element nearest its limit (share of
    the limit, |d|, |want|, label) and names it when it fails."""
    cs = _chip_smoke()
    want = torch.tensor([1.0, 10.0, 100.0])
    use = {}
    cs.close_err(torch, "k", "a", (want + torch.tensor([0.0, 0.1, 0.5]),),
                 (want,), 0.1, 0.01, use)
    share, d, mag, label = use["k"]
    assert (d, mag, label) == (pytest.approx(0.1, rel=1e-5), 10.0, "a")
    assert share == pytest.approx(0.5, rel=1e-5)
    assert "0.5 of its limit" in cs.limit_use_line(use)
    with pytest.raises(AssertionError, match=r"\|want\|=100.0"):
        cs.close_err(torch, "k", "b", (want + torch.tensor([0.0, 0, 2.0]),),
                     (want,), 0.1, 0.01, use)


def test_tensor_core_check_reads_sass():
    """``chip_smoke.py`` counts HMMA / HGMMA per model-kernel function of
    ``cuobjdump -sass`` output and names each function's kernel."""
    chip_smoke = _chip_smoke()
    sass = "\n".join([
        "Function : _Z26flash_attention_mma_kernelILi5ELi8EEvPK13__nv_bf",
        "  /*0a10*/  HMMA.16816.F32.BF16 R4, R8, R12, R4 ;",
        "  /*0a20*/  HMMA.16816.F32.BF16 R16, R8, R14, R16 ;",
        "Function : _Z26flash_attention_fma_kernelILi5EEvPKfS1_S1_Pfiiiifi",
        "  /*0100*/  FFMA R1, R2, R3, R1 ;",
        "Function : _Z19ssd_scan_mma_kernelILi4ELi4EEvPK13__nv_bfloat16",
        "  /*0200*/  HGMMA.64x64x16.F32.BF16 gdesc[UR4], R24 ;",
        "Function : _Z19version_scan_kernelPKiS0_S0_S0_PiS1_iii",
        "  /*0300*/  HMMA.16816.F32 R0, R0, R0, R0 ;"])
    counts = chip_smoke.tensor_core_counts(sass)
    assert sorted(counts.values()) == [0, 1, 2]
    assert {chip_smoke.kernel_of(f) for f in counts} == {"flash_attention",
                                                         "ssd_scan"}
    assert chip_smoke.kernel_of("void ssd_scan_fma_kernel(float const*)") \
        == "ssd_scan"
    assert chip_smoke.kernel_of("void version_scan_kernel<int>") \
        == "version_scan"
    assert chip_smoke.kernel_of("aten::copy_") is None
