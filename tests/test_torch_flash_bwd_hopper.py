"""The attention backward where its bf16 Hopper kernels (D = 64 and 128)
split their work, on the CPU: ``flash_attention_bwd_plain`` against
``jax.vjp`` of the reference's ``layers.attention`` at those shapes (an odd
count of (query head, q tile) pairs a kv tile, D = 128 at G = 7, causal
with Sk > Sq, whose key rows past the last query get zero dk and dv), and
what ``chip_smoke.py`` holds the kernels to: their launch geometry and
longest walks (``attention_bwd_walks``, against a count of the pairs
themselves), the cases of its backward checks, and the disassembly check
that each Hopper instantiation issues wgmma products and TMA loads.

Inputs are seeded numpy in float32; tolerance 1e-4 * max(|reference|, 1),
float32 sums in another order.  The kernels themselves run only on the
card (``tests/test_torch_cuda.py``).
"""
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jl
from repro_torch.kernels.flash_attention import (flash_attention_bwd_plain,
                                                 flash_attention_plain)

ROOT = pathlib.Path(__file__).resolve().parents[1]

# (B, Sq, Sk, H, KH, D, causal): odd pair counts a kv tile (G = 3 over 2
# and 4 q tiles), D = 128 at G = 7, causal with Sk > Sq, non-causal ragged
SPLIT_CASES = [(1, 70, 70, 3, 1, 64, True),
               (1, 200, 200, 3, 1, 64, True),
               (1, 80, 80, 7, 1, 128, True),
               (1, 40, 150, 4, 2, 64, True),
               (1, 40, 150, 2, 1, 128, True),
               (1, 90, 90, 7, 1, 128, False)]


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
    do = rng.randn(B, Sq, H, D)
    return [a.astype(np.float32) for a in (q, k, v, do)]


def _plain_bwd(q, k, v, do, causal):
    t = [torch.as_tensor(a) for a in (q, k, v, do)]
    o, lse = flash_attention_plain(*t[:3], causal, with_lse=True)
    return flash_attention_bwd_plain(*t[:3], o, lse, t[3], causal)


@pytest.mark.parametrize("case", SPLIT_CASES)
def test_plain_backward_matches_reference_vjp_at_split_shapes(case):
    *shape, causal = case
    q, k, v, do = _inputs(*shape, seed=3)
    _, vjp = jax.vjp(lambda a, b, c: jl.attention(a, b, c, causal=causal),
                     *(jnp.asarray(x) for x in (q, k, v)))
    for name, g, w in zip("qkv", _plain_bwd(q, k, v, do, causal),
                          vjp(jnp.asarray(do))):
        w = np.asarray(w, np.float32)
        err = float(np.abs(g.numpy() - w).max())
        assert err <= 1e-4 * max(float(np.abs(w).max()), 1.0), (name, err)


@pytest.mark.parametrize("case", [c for c in SPLIT_CASES
                                  if c[6] and c[2] > c[1]])
def test_keys_past_the_last_query_get_no_gradient(case):
    """Causal, top-left aligned: key j is seen only by queries i >= j, so
    the keys past Sq get exactly zero dk and dv (what the dk/dv kernel
    writes for a kv tile that no query reaches)."""
    *shape, causal = case
    B, Sq = shape[0], shape[1]
    _, dk, dv = _plain_bwd(*_inputs(*shape, seed=4), causal)
    assert bool((dk[:, Sq:] == 0).all()) and bool((dv[:, Sq:] == 0).all())
    assert bool(dk[:, :Sq].abs().amax() > 0)


def _pairs(B, Sq, Sk, H, KH, D, causal=True):
    """The dk/dv kernel's (query head, q tile) pairs of each 64-row kv
    tile, counted one by one: q tiles that reach the kv tile under the
    causal mask."""
    G, nq, nk = H // KH, -(-Sq // 64), -(-Sk // 64)
    return [G * sum(1 for t in range(nq)
                    if not causal or t * 64 + 63 >= j * 64)
            for j in range(nk)]


@pytest.mark.parametrize("shape", [(4, 1024, 1024, 14, 2, 64),
                                   (4, 1024, 1024, 40, 8, 128),
                                   (1, 200, 200, 3, 1, 64),
                                   (1, 70, 70, 3, 1, 64)])
def test_walks_match_the_pairs_counted(chip_smoke, shape):
    """``attention_bwd_walks``: the dk/dv grid is two blocks a kv tile, the
    longest walk is kv tile 0's pairs, half to a block and a quarter to a
    consumer group, rounded up (the four groups take them in turn); dq's
    grid is a block a 128-row q tile, whose last tile walks the most kv
    tiles."""
    B, Sq, Sk, H, KH, D = shape
    walks = chip_smoke.attention_bwd_walks(*shape)
    pairs = _pairs(*shape)
    grid, group, block = walks["flash_attention_bwd_dkdv"]
    assert grid == (2 * len(pairs), B * KH)
    assert block == max(-(-p // 2) for p in pairs) == -(-pairs[0] // 2)
    assert group == max(len(range(c, p, 4)) for p in pairs
                        for c in range(4))
    grid, group, block = walks["flash_attention_bwd_dq"]
    assert grid == (-(-Sq // 128), B * H)
    last_q = (grid[0] - 1) * 128
    assert block == group == len([j for j in range(-(-Sk // 64))
                                  if j * 64 <= last_q + 127])


def test_walks_at_the_training_shape(chip_smoke):
    """qwen2-0.5b's step: 256 dk/dv blocks (128 clusters) whose longest
    walk is 56 pairs a block and 28 a group (112 for one block of the
    mma.sync kernel); 448 dq blocks of 128 rows, at most 16 kv tiles."""
    w = chip_smoke.attention_bwd_walks(4, 1024, 1024, 14, 2, 64)
    assert w == {"flash_attention_bwd_dkdv": ((32, 8), 28, 56),
                 "flash_attention_bwd_dq": ((8, 56), 16, 16)}


def test_backward_cases_cover_the_split(chip_smoke):
    """``ATTENTION_BWD_CASES`` (phase 3's backward checks) holds the
    training shape, G = 1, 3 and 7, D = 128 at G = 7, Sq = 1, causal with
    Sk > Sq, a kv tile with an odd pair count on the Hopper path (bf16,
    D = 64 or 128) and the mma.sync head dims, all within what the kernels
    take."""
    cases = chip_smoke.ATTENTION_BWD_CASES
    assert (4, 1024, 1024, 14, 2, 64, "bf16", True) in cases
    hopper = [c for c in cases if c[6] == "bf16" and c[5] in (64, 128)]
    assert {c[3] // c[4] for c in hopper} >= {1, 3, 7}
    assert any(c[5] == 128 and c[3] // c[4] == 7 for c in hopper)
    assert any(c[7] and c[2] > c[1] for c in hopper)
    assert any(c[1] == 1 for c in hopper)
    assert any(c[7] and any(p % 2 for p in _pairs(*c[:6])) for c in hopper)
    assert any(c[6] == "bf16" and c[5] not in (64, 128) for c in cases)
    for B, Sq, Sk, H, KH, D, dt, causal in cases:
        assert D % 16 == 0 and 16 <= D <= 128 and H % KH == 0
        assert dt in ("bf16", "f32")


def test_kernel_of_names_the_hopper_kernels(chip_smoke):
    for mangled, name in (
            ("_Z35flash_attention_bwd_dq_wgmma_kernelILi1EEv14CUtensorMap",
             "flash_attention_bwd_dq"),
            ("_Z37flash_attention_bwd_dkdv_wgmma_kernelILi2EEv14CUtensor",
             "flash_attention_bwd_dkdv")):
        assert chip_smoke.kernel_of(mangled) == name


def _sass(hgmma=True, tma=True):
    lines = []
    for fn in ("_Z33flash_attention_bwd_dq_mma_kernelILi5EEvPK13__nv_b",
               "_Z35flash_attention_bwd_dkdv_mma_kernelILi5EEvPK13__nv",
               "_Z26flash_attention_mma_kernelILi5ELi8EEvPK13__nv_bf",
               "_Z19ssd_scan_mma_kernelILi4ELi4EEvPK13__nv_bfloat16"):
        lines += [f"Function : {fn}",
                  "  /*0a10*/  HMMA.16816.F32.BF16 R4, R8, R12, R4 ;"]
    for kernel in ("dq", "dkdv"):
        for db in (1, 2):
            lines.append(f"Function : _Z35flash_attention_bwd_{kernel}_"
                         f"wgmma_kernelILi{db}EEv14CUtensorMap_st")
            if tma:
                lines.append("  /*0100*/  UTMALDG.4D [UR8], [UR4] ;")
            if hgmma:
                lines.append("  /*0200*/  HGMMA.64x64x16.F32.BF16 R24, "
                             "gdesc[UR4], RZ, !UPT ;")
    for fn in [f"_Z28flash_attention_wgmma_kernelILi{d}EEv14CU"
               for d in (64, 80, 128)] + [
            f"_Z21ssd_scan_wgmma_kernelILi{nt}EEv14CUtensorMap_st"
            for nt in (1, 2)]:   # the forward's, the SSD scan's, whole
        lines += [f"Function : {fn}",
                  "  /*0100*/  UTMALDG.4D [UR8], [UR4] ;",
                  "  /*0200*/  HGMMA.64x128x16.F32.BF16 R24, gdesc[UR4], "
                  "RZ, !UPT ;"]
    return "\n".join(lines)


@pytest.mark.parametrize("hgmma,tma,ok", [(True, True, True),
                                          (False, True, False),
                                          (True, False, False)])
def test_tensor_core_check_requires_wgmma_and_tma(chip_smoke, monkeypatch,
                                                  capsys, hgmma, tma, ok):
    """Phase 2 fails unless both Hopper instantiations of each backward
    kernel hold wgmma (HGMMA) products and TMA (UTMALDG) loads."""
    class Done:
        stdout = _sass(hgmma, tma)
    monkeypatch.setattr(chip_smoke.subprocess, "run",
                        lambda *a, **k: Done)
    if ok:
        chip_smoke.tensor_core_check("lib.so", "/cuda/bin/nvcc")
        out = capsys.readouterr().out
        assert "flash_attention_bwd_dkdv bf16 Hopper: HGMMA [1, 1], " \
            "UTMALDG [1, 1]" in out
    else:
        with pytest.raises(AssertionError, match="wgmma products and TMA"):
            chip_smoke.tensor_core_check("lib.so", "/cuda/bin/nvcc")


def test_sdpa_backward_times_runs_every_backend(chip_smoke, monkeypatch):
    """The SDPA yardstick's control flow on the CPU: the unforced call is
    timed, and each forced backend is timed or, where it refuses the
    inputs even with K and V expanded to H heads (cuDNN here), reported
    refused with the reason; the profiler sees no device time here, so no
    device ms is made up."""
    monkeypatch.setattr(chip_smoke, "cuda_ms", lambda torch_, fn, **kw: (
        fn(), 1.0)[1])
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    rng = np.random.RandomState(5)
    q, do = (torch.tensor(rng.randn(1, 16, 4, 16).astype(np.float32))
             for _ in range(2))
    k, v = (torch.tensor(rng.randn(1, 16, 2, 16).astype(np.float32))
            for _ in range(2))
    out = chip_smoke.sdpa_backward_times(torch, q, k, v, do, 4, 2)
    assert list(out) == ["unforced", "flash", "efficient", "cuDNN"]
    dev_ms, events, how, _ = out["unforced"]
    assert dev_ms is None and events == 1.0 and how == "enable_gqa"
    for name in ("flash", "efficient", "cuDNN"):
        dev_ms, events, how, names = out[name]
        assert dev_ms is None
        if how.startswith("refused: "):
            assert events is None and names == []
        else:
            assert events == 1.0 and how in (
                "enable_gqa", "K and V expanded to H heads (refuses "
                "enable_gqa)")
    assert out["cuDNN"][2].startswith("refused: ")
