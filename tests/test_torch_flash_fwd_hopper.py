"""The attention forward where its bf16 Hopper kernel
(``flash_attention_wgmma_kernel``, D = 64, 80 and 128) splits its work, on
the CPU: ``flash_attention_plain`` with its lse against the reference's
``layers.attention`` (and the log-sum-exp of the reference's scores) at
those shapes (ragged S, Sq != Sk, G = 5 and 7); the zero padding that
the D = 80 route rests on (q, k and v padded from 80 to 128 columns with
the scale held at 1/sqrt(80) give the same first 80 output columns and
the same lse); and what ``chip_smoke.py`` holds the kernel to: the edges
of its forward checks and the disassembly check that each Hopper
instantiation of the forward issues wgmma products and TMA loads.

Inputs are seeded numpy in float32; tolerance 1e-4 * max(|reference|, 1),
float32 sums in another order.  The kernel itself runs only on the card
(``tests/test_torch_cuda.py``).
"""
import math
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jl
from repro_torch.kernels.flash_attention import flash_attention_plain

ROOT = pathlib.Path(__file__).resolve().parents[1]

# (B, Sq, Sk, H, KH, D, causal): ragged q tiles (a second consumer group
# with few or no rows), Sq != Sk both ways (causal top-left), G = 5 and 7,
# one query row, at the Hopper kernel's three head dims
SPLIT_CASES = [(1, 200, 200, 5, 1, 64, True),
               (1, 50, 300, 7, 1, 64, True),
               (1, 130, 77, 4, 2, 80, True),
               (2, 100, 100, 10, 2, 80, False),
               (1, 1, 150, 7, 1, 128, False),
               (1, 90, 260, 14, 2, 128, True),
               (1, 150, 150, 7, 1, 128, True)]


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


def _inputs(B, Sq, Sk, H, KH, D, seed=0):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, Sq, H, D) * 1.5
    k = rng.randn(B, Sk, KH, D) * 1.5
    v = rng.randn(B, Sk, KH, D)
    return [a.astype(np.float32) for a in (q, k, v)]


def _reference_lse(q, k, causal):
    """[B, H, Sq]: the log-sum-exp of the reference's scaled, masked scores
    (``layers._dense_attention``'s, GQA by reshape), in JAX."""
    B, Sq, H, D = q.shape
    Sk, KH = k.shape[1], k.shape[2]
    s = jnp.einsum("bqkgd,bskd->bkgqs", q.reshape(B, Sq, KH, H // KH, D), k,
                   preferred_element_type=jnp.float32) / math.sqrt(D)
    if causal:
        s = jnp.where(jnp.arange(Sq)[:, None] >= jnp.arange(Sk)[None, :], s,
                      jl.NEG_INF)
    return jax.nn.logsumexp(s, axis=-1).reshape(B, H, Sq)


def _within(got, want):
    err = float(np.abs(got - want).max())
    assert err <= 1e-4 * max(float(np.abs(want).max()), 1.0), err


@pytest.mark.parametrize("case", SPLIT_CASES)
def test_plain_forward_matches_reference_at_split_shapes(case):
    *shape, causal = case
    q, k, v = _inputs(*shape, seed=6)
    o, lse = flash_attention_plain(*(torch.as_tensor(a) for a in (q, k, v)),
                                   causal, with_lse=True)
    want = jl.attention(*(jnp.asarray(a) for a in (q, k, v)), causal=causal)
    _within(o.numpy(), np.asarray(want, np.float32))
    _within(lse.numpy(), np.asarray(_reference_lse(q, k, causal)))


def _attention_np(q, k, v, causal, scale):
    """float64 softmax attention with an explicit scale: (o, lse)."""
    B, Sq, H, D = q.shape
    Sk, KH = k.shape[1], k.shape[2]
    kk = np.repeat(k.astype(np.float64), H // KH, axis=2)
    vv = np.repeat(v.astype(np.float64), H // KH, axis=2)
    s = np.einsum("bqhd,bshd->bhqs", q.astype(np.float64), kk) * scale
    if causal:
        s = np.where(np.arange(Sq)[:, None] >= np.arange(Sk)[None, :], s,
                     -1e30)
    m = s.max(-1, keepdims=True)
    p = np.exp(s - m)
    lse = np.log(p.sum(-1)) + m[..., 0]
    return np.einsum("bhqs,bshd->bqhd", p / p.sum(-1, keepdims=True), vv), lse


@pytest.mark.parametrize("shape,causal", [((1, 130, 130, 4, 2), True),
                                          ((2, 64, 200, 4, 4), False),
                                          ((1, 1, 77, 2, 1), False)])
def test_zero_padded_head_dim_80_gives_the_same_attention(shape, causal):
    """The D = 80 route's argument: q, k and v padded with zeros from 80 to
    128 columns (what TMA fills past the tensor map's extent), the scale
    held at 1/sqrt(80), give the unpadded call's first 80 output columns
    and lse, and zeros in columns 80-127."""
    B, Sq, Sk, H, KH = shape
    q, k, v = _inputs(B, Sq, Sk, H, KH, 80, seed=7)
    pad = lambda a: np.concatenate(
        [a, np.zeros(a.shape[:-1] + (48,), np.float32)], axis=-1)
    o_pad, lse_pad = _attention_np(pad(q), pad(k), pad(v), causal,
                                   1.0 / math.sqrt(80))
    o, lse = flash_attention_plain(*(torch.as_tensor(a) for a in (q, k, v)),
                                   causal, with_lse=True)
    assert not o_pad[..., 80:].any()
    _within(o_pad[..., :80], o.numpy())
    _within(lse_pad, lse.numpy())
    # the scale must be 1/sqrt(80): the padded width's 1/sqrt(128) differs
    o_wide, _ = _attention_np(pad(q), pad(k), pad(v), causal,
                              1.0 / math.sqrt(128))
    assert float(np.abs(o_wide[..., :80] - o.numpy()).max()) > 1e-2


def test_forward_cases_cover_the_edges(chip_smoke):
    """``ATTENTION_FWD_CASES`` (phase 3's forward checks) holds, on the
    Hopper kernel (bf16 at D = 64, 80 or 128): the three path shapes, D =
    128 at Sq = 1 over Sk = 1,000, causal with Sk > Sq at D = 128, ragged
    S = 1,000 at D = 64 with G = 7, a 2,048-row causal walk at D = 64 and
    every head dim; the float32 kernel, and the mma.sync kernel (bf16 at
    another head dim) on a ragged GQA case; all within what the kernels
    take."""
    cases = chip_smoke.ATTENTION_FWD_CASES
    hopper = [c for c in cases
              if c[6] == "bf16" and c[5] in chip_smoke.HOPPER_FWD_DIMS]
    assert {c[5] for c in hopper} == {64, 80, 128}
    for path in ((4, 1024, 1024, 32, 32, 80), (4, 1024, 1024, 40, 8, 128),
                 (4, 128, 1024, 16, 16, 64)):
        assert any(c[:6] == path for c in hopper), path
    assert any(c[1] == 1 and c[2] == 1000 and c[5] == 128 for c in hopper)
    assert any(c[7] and c[2] > c[1] and c[5] == 128 for c in hopper)
    assert any(c[1] == c[2] == 1000 and c[5] == 64 and c[3] // c[4] == 7
               for c in hopper)
    assert any(c[7] and c[1] == c[2] == 2048 and c[5] == 64 for c in hopper)
    assert any(c[1] % 128 and c[1] % 128 <= 64 for c in hopper)
    assert any(c[6] == "f32" for c in cases)
    mma = [c for c in cases
           if c[6] == "bf16" and c[5] not in chip_smoke.HOPPER_FWD_DIMS]
    assert any(c[1] % 128 and c[3] > c[4] for c in mma)
    for B, Sq, Sk, H, KH, D, dt, causal in cases:
        assert D % 16 == 0 and 16 <= D <= 128 and H % KH == 0
        assert dt in ("bf16", "f32")


def test_kernel_of_names_the_forward_hopper_kernel(chip_smoke):
    assert chip_smoke.kernel_of(
        "_Z28flash_attention_wgmma_kernelILi80EEv14CUtensorMapS_S_P13__nv_"
        "bfloat16Pfiiiifi") == "flash_attention"
    assert chip_smoke.kernel_of(
        "flash_attention_wgmma_kernel<128>") == "flash_attention"


def _sass(fwd_dims=(64, 80, 128), fwd_hgmma=True, fwd_tma=True):
    """A disassembly as ``cuobjdump -sass`` prints it: every model kernel's
    forms, the forward's Hopper instantiations at ``fwd_dims`` with or
    without wgmma and TMA instructions, the backward's and the SSD scan's
    with both."""
    lines = []
    for fn in ("_Z33flash_attention_bwd_dq_mma_kernelILi5EEvPK13__nv_b",
               "_Z35flash_attention_bwd_dkdv_mma_kernelILi5EEvPK13__nv",
               "_Z26flash_attention_mma_kernelILi5EEvPK13__nv_bfloat16",
               "_Z19ssd_scan_mma_kernelILi4ELi4EEvPK13__nv_bfloat16"):
        lines += [f"Function : {fn}",
                  "  /*0a10*/  HMMA.16816.F32.BF16 R4, R8, R12, R4 ;"]
    fns = [(f"_Z28flash_attention_wgmma_kernelILi{d}EEv14CUtensorMapS_",
            fwd_hgmma, fwd_tma) for d in fwd_dims]
    fns += [(f"_Z35flash_attention_bwd_{kernel}_wgmma_kernelILi{db}EEv14CUt",
             True, True) for kernel in ("dq", "dkdv") for db in (1, 2)]
    fns += [(f"_Z21ssd_scan_wgmma_kernelILi{nt}EEv14CUtensorMap_st", True,
             True) for nt in (1, 2)]
    for fn, hgmma, tma in fns:
        lines.append(f"Function : {fn}")
        if tma:
            lines.append("  /*0100*/  UTMALDG.4D [UR8], [UR4] ;")
        if hgmma:
            lines.append("  /*0200*/  HGMMA.64x128x16.F32.BF16 R24, "
                         "gdesc[UR4], RZ, !UPT ;")
    return "\n".join(lines)


@pytest.mark.parametrize("sass,ok", [
    (_sass(), True), (_sass((64, 128)), False),
    (_sass(fwd_hgmma=False), False), (_sass(fwd_tma=False), False),
    (_sass((64,)), False), (_sass((64, 80, 96, 128)), False)])
def test_tensor_core_check_requires_the_forward_on_wgmma_and_tma(
        chip_smoke, monkeypatch, capsys, sass, ok):
    """Phase 2 fails unless the forward has exactly its three Hopper
    instantiations (D = 64, 80 and 128: none routed back to mma.sync) and
    they all hold wgmma (HGMMA) products and TMA (UTMALDG) loads."""
    class Done:
        stdout = sass
    monkeypatch.setattr(chip_smoke.subprocess, "run",
                        lambda *a, **k: Done)
    if ok:
        chip_smoke.tensor_core_check("lib.so", "/cuda/bin/nvcc")
        n = sass.count("flash_attention_wgmma_kernel")
        assert (f"flash_attention bf16 Hopper: HGMMA {[1] * n}, UTMALDG "
                f"{[1] * n}") in capsys.readouterr().out
    else:
        with pytest.raises(AssertionError,
                           match="flash_attention: expected .*wgmma "
                                 "products and TMA"):
            chip_smoke.tensor_core_check("lib.so", "/cuda/bin/nvcc")
