"""ssd_scan: the Mamba2 SSD chunked scan.

Port of ``repro.kernels.ssd_scan.ssd_scan_pallas``, in its folded layout:
x ``[BH, S, P]``, dA ``[BH, S]``, B/C ``[BH // H, S, N]`` shared by the H
heads of a group; it returns (y ``[BH, S, P]``, h ``[BH, N, P]``).  The
CUDA kernel (``csrc/ssd_scan.cu``) runs one block per batch*head over the
chunks in order with the state in shared memory.  Beyond the Pallas kernel
it takes an initial state ``h0`` (or None) and any S: the tail chunk is
masked in-kernel as the reference's zero padding would leave it.

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

__all__ = ["ssd_chunked", "ssd_cuda", "ssd_plain", "ssd_scan",
           "ssd_smem_bytes"]

NEG_INF = -1.0e30
_DTYPES = (torch.float32, torch.bfloat16)


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


def ssd_plain(x, dA, Bm, Cm, n_heads_per_group: int, chunk: int = 128,
              h0=None):
    """Plain PyTorch version of :func:`ssd_cuda` (same arguments): the
    folded layout unfolded onto :func:`ssd_chunked`."""
    BH, S, P = x.shape
    Bg, _, N = Bm.shape
    H = n_heads_per_group
    xm = x.reshape(Bg, H, S, P).transpose(1, 2)
    am = dA.reshape(Bg, H, S).transpose(1, 2)
    init = None if h0 is None else h0.reshape(Bg, H, N, P).transpose(-1, -2)
    y, h = ssd_chunked(xm, am, Bm[:, :, None], Cm[:, :, None], chunk, init)
    return (y.transpose(1, 2).reshape(BH, S, P),
            h.transpose(-1, -2).reshape(BH, N, P))


def ssd_smem_bytes(P: int, N: int, Q: int) -> int:
    """Shared memory of one block of the kernel (``ssd_smem_bytes`` in
    ``csrc/ssd_scan.cu``)."""
    return 4 * (Q * (Q + N + 1) + Q * (N + 1) + (Q + N) * P + Q)


def ssd_cuda(x, dA, Bm, Cm, n_heads_per_group: int, chunk: int = 128,
             h0=None):
    """CUDA kernel.  x: [BH, S, P] and Bm/Cm: [BH // H, S, N], one dtype
    (float32 or bfloat16); dA: [BH, S] float32; h0: [BH, N, P] float32 or
    None (zero state); all contiguous.  Chunks of min(chunk, S) rows.
    Returns (y [BH, S, P] in x's dtype, h [BH, N, P] float32)."""
    BH, S, P = x.shape
    N = Bm.shape[-1]
    H = n_heads_per_group
    if H < 1 or BH % H:
        raise ValueError(f"ssd_scan: {BH} rows do not fold into groups of "
                         f"{H} heads")
    check_input("ssd_scan.x", x, (BH, S, P), _DTYPES)
    check_input("ssd_scan.dA", dA, (BH, S), torch.float32)
    check_input("ssd_scan.Bm", Bm, (BH // H, S, N), x.dtype)
    check_input("ssd_scan.Cm", Cm, (BH // H, S, N), x.dtype)
    if h0 is not None:
        check_input("ssd_scan.h0", h0, (BH, N, P), torch.float32)
    Q = max(1, min(chunk, S))
    if ssd_smem_bytes(P, N, Q) > SMEM_LIMIT:
        raise ValueError(
            f"ssd_scan: chunk {Q} with N={N}, P={P} needs "
            f"{ssd_smem_bytes(P, N, Q)} bytes of shared memory, above the "
            f"{SMEM_LIMIT} a block may use")
    y = torch.empty_like(x)
    h = torch.empty((BH, N, P), dtype=torch.float32, device=x.device)
    if BH and S:
        launch("ssd_scan", "ssd_scan_launch", x.data_ptr(), dA.data_ptr(),
               Bm.data_ptr(), Cm.data_ptr(),
               None if h0 is None else h0.data_ptr(), y.data_ptr(),
               h.data_ptr(), BH, S, P, N, H, Q,
               int(x.dtype == torch.bfloat16), stream_of(x))
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
