"""ssd_scan: the Mamba2 SSD chunked scan.

Port of ``repro.kernels.ssd_scan.ssd_scan_pallas``, in its folded layout:
x ``[BH, S, P]``, dA ``[BH, S]``, B/C ``[BH // H, S, N]`` shared by the H
heads of a group; it returns (y ``[BH, S, P]``, h ``[BH, N, P]``).  It also
takes x and dA as the ``[G, H, S, P]`` / ``[G, H, S]`` transpose views of
the model's ``[G, S, H, P]`` / ``[G, S, H]`` and then returns y as such a
view, so the model's layout is read and written in place: the kernel
indexes by the strides it is given.  The CUDA kernels
(``csrc/ssd_scan.cu``), chosen by a fixed table (:func:`ssd_kernel`):
bf16 at P = 64 with N = 64 or 128 in chunks of 128 rows on the Hopper
kernel (a block a chunk, the chunks of a batch*head a thread block
cluster passing the state on through distributed shared memory, wgmma
products on TMA tiles); the other bf16 shapes on the mma.sync kernel and
float32 on the FMA kernel, both a block per batch*head walking the chunks
in order with the state on chip.  Beyond the Pallas kernel it takes an
initial state ``h0`` (or None) and any S: the tail chunk is masked
in-kernel as the reference's zero padding would leave it.

Its plain version, :func:`ssd_plain`, folds the layout onto
:func:`ssd_chunked`, the port of the reference model's
``models/ssm.py:ssd_chunked`` (model layout ``[B, S, H, P]``, intra-chunk
products plus a linear scan over chunks); it serves CPU tensors and the
``torch`` route.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .build import SMEM_LIMIT, check_input, launch, stream_of

__all__ = ["ssd_chunked", "ssd_cuda", "ssd_kernel", "ssd_plain",
           "ssd_scan", "ssd_smem_bytes"]

NEG_INF = -1.0e30
SSD_STRIP = 64          # the float32 kernel's strip of [M | C] rows
_DTYPES = (torch.float32, torch.bfloat16)
# the bf16 (P, N) of the Hopper kernel (ssd_scan_wgmma_kernel), zamba2-2.7b's
# and mamba2-130m's, and its chunk; the C entry's kernel codes
SSD_WGMMA_SHAPES = ((64, 64), (64, 128))
SSD_WGMMA_CHUNK = 128
_KIND = {"fma": 0, "mma": 1, "wgmma": 2}


def _segsum(a):
    """a: [..., Q] log-decays -> [..., Q, Q] cumulative segment sums,
    -1e30 above the diagonal."""
    Q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    seg = cs[..., :, None] - cs[..., None, :]   # sum_{k=j+1..i} a_k
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=a.device))
    return torch.where(mask, seg, NEG_INF)


def ssd_chunked(x, dA, Bm, Cm, chunk: int, init_state=None):
    """Chunked SSD scan (model layout).

    x: [B, S, H, P] (already multiplied by dt); dA: [B, S, H] (log decay,
    negative); Bm, Cm: [B, S, G, N]; init_state: [B, H, P, N] or None.
    Returns (y [B, S, H, P] in x's dtype, final state [B, H, P, N] float32).
    """
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    HG = H // G
    Q = min(chunk, S)
    S0 = S
    if S % Q:
        # zero-pad to a chunk multiple: padded x=0 contributes nothing to the
        # states and padded dA=0 (decay 1) leaves the recurrence unchanged
        pad = Q - S % Q
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dA = F.pad(dA, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, 0, 0, pad))
        S = S + pad
    nc = S // Q

    xg = x.reshape(B, nc, Q, G, HG, P).float()
    ac = dA.float().reshape(B, nc, Q, H).permute(0, 3, 1, 2)     # [B,H,nc,Q]
    bc = Bm.reshape(B, nc, Q, G, N).float()
    cc = Cm.reshape(B, nc, Q, G, N).float()
    a_cum = torch.cumsum(ac, dim=-1)                             # [B,H,nc,Q]

    # (1) intra-chunk (diagonal blocks)
    Lmat = torch.exp(_segsum(ac)).reshape(B, G, HG, nc, Q, Q)
    scores = torch.einsum("bcqgn,bcsgn->bgcqs", cc, bc)         # [B,G,nc,Q,Q]
    y_diag = torch.einsum("bgcqs,bghcqs,bcsghp->bcqghp", scores, Lmat, xg)

    # (2) per-chunk end states
    ds = torch.exp(a_cum[..., -1:] - a_cum).reshape(B, G, HG, nc, Q)
    states = torch.einsum("bcqgn,bghcq,bcqghp->bcghpn", bc, ds, xg)

    # (3) inter-chunk recurrence (linear scan over chunks)
    chunk_decay = torch.exp(a_cum[..., -1]).reshape(B, G, HG, nc)
    h = (torch.zeros((B, G, HG, P, N), dtype=torch.float32, device=x.device)
         if init_state is None
         else init_state.float().reshape(B, G, HG, P, N))
    h_prev = []
    for c in range(nc):
        h_prev.append(h)
        h = h * chunk_decay[..., c, None, None] + states[:, c]
    h_prev = torch.stack(h_prev, dim=1)                          # [B,nc,G,HG,P,N]

    # (4) off-diagonal contribution
    sd_out = torch.exp(a_cum).reshape(B, G, HG, nc, Q)
    y_off = torch.einsum("bcqgn,bcghpn,bghcq->bcqghp", cc, h_prev, sd_out)

    y = (y_diag + y_off).reshape(B, S, H, P)
    return y[:, :S0].to(x.dtype), h.reshape(B, H, P, N)


def _unfold(x, dA, H):
    """Views of x [BH, S, P] or [G, H, S, P] and dA [BH, S] or [G, H, S]
    as [G, H, S, P] and [G, H, S] (no copy)."""
    if x.dim() == 3:
        x = x.unflatten(0, (x.shape[0] // H, H))
    if dA.dim() == 2:
        dA = dA.unflatten(0, (dA.shape[0] // H, H))
    return x, dA


def ssd_plain(x, dA, Bm, Cm, n_heads_per_group: int, chunk: int = 128,
              h0=None):
    """Plain PyTorch version of :func:`ssd_cuda` (same arguments, either
    layout): unfolded onto :func:`ssd_chunked`.  y comes back in x's
    shape."""
    H = n_heads_per_group
    x4, a4 = _unfold(x, dA, H)
    Bg, _, S, P = x4.shape
    N = Bm.shape[-1]
    init = None if h0 is None else h0.reshape(Bg, H, N, P).transpose(-1, -2)
    y, h = ssd_chunked(x4.transpose(1, 2), a4.transpose(1, 2),
                       Bm[:, :, None], Cm[:, :, None], chunk, init)
    return (y.transpose(1, 2).reshape(x.shape),
            h.transpose(-1, -2).reshape(Bg * H, N, P))


def ssd_kernel(P: int, N: int, Q: int, S: int,
               dtype: torch.dtype) -> str:
    """The kernel :func:`ssd_cuda` launches for chunks of Q rows over S
    positions: "wgmma" (bf16 on Hopper) at the (P, N) of
    ``SSD_WGMMA_SHAPES`` in chunks of 128 rows or in one chunk of S < 128
    rows (the same as 128 rows with zeros after S), "mma" for the other
    bf16 shapes, "fma" for float32."""
    if dtype != torch.bfloat16:
        return "fma"
    if (P, N) in SSD_WGMMA_SHAPES and (
            Q == SSD_WGMMA_CHUNK or Q == S < SSD_WGMMA_CHUNK):
        return "wgmma"
    return "mma"


def ssd_smem_bytes(P: int, N: int, Q: int,
                   dtype: torch.dtype = torch.float32,
                   kernel: str | None = None) -> int:
    """Shared memory of one block of ``kernel`` (default: "mma" for bf16,
    "fma" for float32), in bytes: ``ssd_fma_smem_bytes`` /
    ``ssd_mma_smem_bytes`` / ``sw_smem_bytes`` in ``csrc/ssd_scan.cu``
    (the last at P = 64 and chunks of 128 rows)."""
    kernel = kernel or ("mma" if dtype == torch.bfloat16 else "fma")
    if kernel == "wgmma":
        # x, B, C (128 rows of bf16); at N = 64 the three float32 states a
        # block receives in the scan over its cluster, the hand-over tile
        # and the states' a; at N = 128 the float32 state arriving from
        # the previous block; cs, the warp sums, four mbarriers
        if N == 64:
            return 16384 * 7 + 16 * 3 + 128 * 4 + 16 + 32
        return 16384 * 7 + 128 * 4 + 16 + 32
    if kernel == "mma":
        Qp = -(-Q // 16) * 16
        return 4 * Qp * (P + N) + 2 * Qp * N + 16 * Qp + 4 * N * P
    Qs = min(Q, SSD_STRIP)          # rows of [M | C] staged at a time
    return 4 * (Qs * (Q + N + 1) + Q * (N + 1) + (Q + N) * P + Q)


def ssd_cuda(x, dA, Bm, Cm, n_heads_per_group: int, chunk: int = 128,
             h0=None, kernel: str | None = None):
    """CUDA kernel.  x: [BH, S, P] or the [G, H, S, P] view of the model's
    [G, S, H, P] (any strides, last dimension dense); Bm/Cm: [G, S, N]
    (G = BH // H, last dimension dense), one dtype with x: bfloat16 (the
    tensor-core kernels: P in {16, 32, 64}, N in {16, 32, 64, 128}) or
    float32 (the FMA kernel); dA: [BH, S] or [G, H, S] float32, any
    strides; h0: [BH, N, P] float32 contiguous or None (zero state).
    Chunks of min(chunk, S) rows.  ``kernel``: the one :func:`ssd_kernel`
    names (None), or "mma" / "wgmma" to time one against the other (raises
    where that kernel does not take the shape).  Returns (y in x's shape,
    dtype and layout order, h [BH, N, P] float32)."""
    H = n_heads_per_group
    S, P = x.shape[-2:]
    N = Bm.shape[-1]
    BH = x.shape[0] * (x.shape[1] if x.dim() == 4 else 1)
    if H < 1 or BH % H or (x.dim() == 4 and x.shape[1] != H):
        raise ValueError(f"ssd_scan: {BH} rows do not fold into groups of "
                         f"{H} heads")
    G = BH // H
    x4, a4 = _unfold(x, dA, H)
    check_input("ssd_scan.x", x4, (G, H, S, P), _DTYPES, "rows")
    check_input("ssd_scan.dA", a4, (G, H, S), torch.float32, "any")
    check_input("ssd_scan.Bm", Bm, (G, S, N), x.dtype, "rows")
    check_input("ssd_scan.Cm", Cm, (G, S, N), x.dtype, "rows")
    if h0 is not None:
        check_input("ssd_scan.h0", h0, (BH, N, P), torch.float32)
    if Bm.stride() != Cm.stride():
        raise ValueError("ssd_scan: B and C must share strides")
    Q = max(1, min(chunk, S))
    routed = ssd_kernel(P, N, Q, S, x.dtype)
    if kernel is not None and kernel != routed and not (
            kernel == "mma" and routed == "wgmma"):
        raise ValueError(f"ssd_scan: the {kernel} kernel does not take "
                         f"P={P}, N={N}, chunk {Q}, {x.dtype}")
    kernel = kernel or routed
    if x.dtype == torch.bfloat16:
        if P not in (16, 32, 64) or N not in (16, 32, 64, 128):
            raise ValueError(f"ssd_scan: the bf16 kernel takes P in (16, 32,"
                             f" 64) and N in (16, 32, 64, 128), got P={P}, "
                             f"N={N}")
        if any(t.data_ptr() % 16 for t in (x4, Bm, Cm)) or any(
                r % 8 for r in x4.stride()[:3] + Bm.stride()[:2]):
            raise ValueError("ssd_scan: bf16 rows of x, B and C must start "
                             "16-byte aligned")
    smem = ssd_smem_bytes(P, N, Q, x.dtype, kernel)
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"ssd_scan: chunk {Q} with N={N}, P={P} needs {smem} bytes of "
            f"shared memory, above the {SMEM_LIMIT} a block may use")
    # y in the order of x's layout: the model's [G, S, H, P] for a view of
    # it, else [BH, S, P]
    if x.dim() == 4:
        y = torch.empty((G, S, H, P), dtype=x.dtype,
                        device=x.device).transpose(1, 2)
    else:
        y = torch.empty_like(x, memory_format=torch.contiguous_format)
    y4 = y if y.dim() == 4 else y.unflatten(0, (G, H))
    h = torch.empty((BH, N, P), dtype=torch.float32, device=x.device)
    if BH and S:
        launch("ssd_scan", "ssd_scan_launch", x.data_ptr(), dA.data_ptr(),
               Bm.data_ptr(), Cm.data_ptr(),
               None if h0 is None else h0.data_ptr(), y.data_ptr(),
               h.data_ptr(), BH, S, P, N, H, Q, _KIND[kernel],
               *x4.stride()[:3], *a4.stride(), *y4.stride()[:3],
               *Bm.stride()[:2], stream_of(x))
    elif h0 is not None:
        h.copy_(h0)
    else:
        h.zero_()
    return y, h


def ssd_scan(x, dA, Bm, Cm, n_heads_per_group: int, chunk: int = 128,
             h0=None):
    """The wrapper: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors (the kernel has no CPU form)."""
    if x.is_cuda:
        return ssd_cuda(x, dA, Bm, Cm, n_heads_per_group, chunk, h0)
    return ssd_plain(x, dA, Bm, Cm, n_heads_per_group, chunk, h0)
